"""Find a cell, its configuration, its traffic mix, its metrics and its
limits by the names ``BENCHMARK.json`` gives them.

Layout (every file found by name, so that a later cell, configuration,
traffic mix or metric is a new file and a new entry, never an edit):

* ``BENCHMARK.json`` at the root of the checkout;
* a configuration at the ``file`` its entry names;
* a traffic mix at ``portbench/traffic/<traffic>.json``;
* a metric's reader at ``portbench/metrics/<metric>.py``;
* a cell's correctness limits at ``portbench/limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} not found: run from the root of a checkout")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    return json.loads(path.read_text())


class Cell:
    """One entry of ``workloads`` with what it names, read from its files."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"unknown workload {name!r}; choose from {sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(root / self.config_entry["file"])
        self.traffic_name = self.entry["traffic"]
        self.traffic = _json(root / "portbench" / "traffic" / f"{self.traffic_name}.json")
        self.limits = _json(root / "portbench" / "limits" / f"{name}.json")
        self.end_to_end = applicable(manifest, "end_to_end", name)
        self.per_layer = applicable(manifest, "per_layer", name)


def applicable(manifest: dict, kind: str, cell: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it under ``workloads``, and those
    without the key. An end-to-end metric without ``workloads`` is every
    cell's; a per-layer one without it is the metric of every cell that
    reports its ``moves``."""
    e2e = {m["name"] for m in applicable_e2e(manifest, cell)}
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def applicable_e2e(manifest: dict, cell: str) -> list[dict]:
    return [m for m in manifest["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str, root: Path = ROOT):
    """The module ``portbench/metrics/<metric>.py``: ``read(run)`` gives the
    metric's value or None, ``SPANS`` (optional) the calls it times."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
