"""BENCHMARK.json against the benchmark's contract: keys, names, units,
which cell reports what, and the files each name leads to."""

import json
import re

import pytest

from portbench import manifest as M

MAN = M.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    assert (M.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)


def test_command_and_paths():
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (M.ROOT / p).is_dir()
    assert 1 <= len(MAN["command"]) <= 32
    assert all(1 <= len(w) <= 200 and "\t" not in w and "\n" not in w for w in MAN["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_entries_have_exactly_their_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_units_better_and_lines():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in MAN["configs"] + MAN["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in MAN["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in MAN["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16


def test_setup_s_is_everyones():
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_reports_enough(cell):
    e2e = {m["name"] for m in M.applicable_e2e(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert M.applicable(MAN, "per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    assert m["moves"] in {x["name"] for x in MAN["end_to_end"]}
    for cell in m["workloads"]:
        assert m["moves"] in {x["name"] for x in M.applicable_e2e(MAN, cell)}


def test_one_layer_name_per_layer():
    # metrics of one layer give it letter for letter; the model step's MFUs share one
    layers = {m["name"]: m["layer"] for m in MAN["per_layer"]}
    assert layers["prefill_mfu"] == layers["train_mfu"]
    assert layers["device_idle.prefill"] == layers["device_idle.train"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_files_found_by_name(cell):
    c = M.Cell(MAN, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.config_entry["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert callable(M.reader(m["name"]).read)


def test_every_config_is_used_and_its_file_its_own():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        body = json.loads((M.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"].startswith(c["source"])
