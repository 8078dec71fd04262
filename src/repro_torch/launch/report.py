"""Aggregate dry-run JSON cells into the roofline table.

Port of ``repro.launch.report`` over the port's records
(``launch/dryrun.py``): the same table but for one header, "GFLOPs/dev"
where the reference has "HLO GFLOPs/dev" (the port's FLOPs are counted
on meta tensors, not read from HLO). Cells are named
``<arch>__<shape>__<mesh>.json``.

  PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun_torch [--mesh 1x1]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x*1e3:.1f}ms"


def fmt_b(x) -> str:
    if x is None:
        return "-"
    for unit, div in [("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)]:
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def load_cells(d: Path, pod: str):
    """The records of ``d`` for one mesh (``pod``: the cell name's last
    part, e.g. ``1x1``), keyed by (arch, shape)."""
    cells = {}
    for f in sorted(d.glob(f"*__{pod}.json")):
        rec = json.loads(f.read_text())
        cells[(rec["arch"], rec["shape"])] = rec
    return cells


ARCH_ORDER = [
    "granite-3-8b", "gemma3-12b", "command-r-35b", "mistral-nemo-12b",
    "seamless-m4t-medium", "llama-3.2-vision-90b", "arctic-480b",
    "kimi-k2-1t-a32b", "mamba2-780m", "hymba-1.5b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def markdown_table(cells, show_memory=False) -> str:
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "GFLOPs/dev | bytes/dev | coll/dev | useful | roofline frac | HBM/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            rec = cells.get((arch, shape))
            if rec is None:
                continue
            if rec.get("skipped"):
                lines.append(f"| {arch} | {shape} | — | — | — | {rec['reason']} | — | — | — | — | — | — |")
                continue
            if not rec.get("ok"):
                lines.append(f"| {arch} | {shape} | FAIL | | | {rec.get('error','')[:60]} | | | | | | |")
                continue
            t = rec["terms_seconds"]
            mem = rec.get("memory_analysis", {})
            hbm = (mem.get("argument_size_in_bytes") or 0) + (
                mem.get("temp_size_in_bytes") or 0
            )
            lines.append(
                f"| {arch} | {shape} | {fmt_s(t['compute'])} | {fmt_s(t['memory'])} "
                f"| {fmt_s(t['collective'])} | **{rec['dominant']}** "
                f"| {rec['flops_per_device']/1e9:.0f} | {fmt_b(rec['bytes_per_device'])} "
                f"| {fmt_b(rec['collective_traffic_per_device'])} "
                f"| {rec['useful_ratio']:.2f} | {rec['roofline_fraction']:.3f} "
                f"| {fmt_b(hbm)} |"
            )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="1x1", help="the cells' mesh, as dryrun's --mesh")
    args = ap.parse_args(argv)
    cells = load_cells(Path(args.dir), args.mesh)
    print(markdown_table(cells))
    n_ok = sum(1 for r in cells.values() if r.get("ok"))
    n_skip = sum(1 for r in cells.values() if r.get("skipped"))
    n_fail = len(cells) - n_ok - n_skip
    print(f"\ncells: {n_ok} ok, {n_skip} skipped-by-design, {n_fail} failed")
    return n_ok, n_skip, n_fail


if __name__ == "__main__":
    main()


def compare_tables(base_dir: Path, opt_dir: Path, pod: str = "1x1") -> str:
    """Baseline vs optimized dominant-term comparison."""
    base = load_cells(base_dir, pod)
    # optimized cells carry a __opt suffix in the filename but the same
    # arch/shape keys inside the JSON.
    opt = {}
    for f in sorted(opt_dir.glob(f"*__{pod}__opt.json")):
        rec = json.loads(f.read_text())
        opt[(rec["arch"], rec["shape"])] = rec
    lines = [
        "| arch | shape | dominant (base) | base | opt | factor | useful base→opt |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            b = base.get((arch, shape))
            o = opt.get((arch, shape))
            if not b or not o or not b.get("ok") or not o.get("ok"):
                continue
            dom = b["dominant"]
            tb = b["terms_seconds"][dom]
            to = o["terms_seconds"][dom]
            factor = tb / to if to else float("inf")
            lines.append(
                f"| {arch} | {shape} | {dom} | {fmt_s(tb)} | {fmt_s(to)} "
                f"| {factor:.2f}× | {b['useful_ratio']:.2f}→{o['useful_ratio']:.2f} |"
            )
    return "\n".join(lines)


def main_compare(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="results/dryrun_torch")
    ap.add_argument("--opt", default="results/dryrun_opt_torch")
    args = ap.parse_args(argv)
    print(compare_tables(Path(args.base), Path(args.opt)))
