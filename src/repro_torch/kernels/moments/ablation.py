"""Where K1 (``moments_edges_stats``) and K3 (``moments_stats``) spend their
time: the kernels with one part taken out or one knob turned, timed beside
the whole on a Set1 window on the card.

    PYTHONPATH=src python -m repro_torch.kernels.moments.ablation [--against DIR ...]

Each variant is ``csrc/`` with a statement replaced, built with the same
flags (and ``-Xptxas -v``) into ``build/kernels/ablation/moments/<variant>/``
and bound with ctypes: ``loads_only`` adds the values to four registers
(no shift, powers, min or max), ``no_minmax`` drops the NaN-aware min and
max, ``select_minmax`` takes them as compares and selects (common.cuh)
instead of PTX's min.NaN and max.NaN, ``tail_only`` reads no value (the
row's reduction, finalize and stores alone), ``min_blocks10`` asks ptxas
for registers enough for ten blocks an SM, ``no_edges`` compiles K1's
edges out (so K1 is K3), ``scalar`` reads
every row with 4-byte loads (the route of a row that does not start on a
16-byte boundary), ``float_tree`` adds the threads' sums in float instead
of double, and ``RxB_lN`` give a row R threads, a block B rows and a
thread N 16-byte loads a round. Some outputs are wrong by design; only
their times mean anything. ``--against DIR ...`` adds each ``DIR/fitpdf.cu`` and
``DIR/moments.cu`` (with the headers in DIR), other versions of the
kernels, built and timed in the same turns (``kernels/_ablation.py``).

Cases: K1 at L = 64 and K3 on the first window of Set1's slice 201 (6,275
x 1,000 float32), and K3 on the same window one float off a 16-byte
boundary. Each time is the kernel's own (``_timing.kernel_times``: bare C
launches, L2 flushed clean before each), a median of 20, variants in turns,
two rounds; then two yardsticks with the same timing (a launch that does
nothing, PyTorch's row sum of the window). Prints the card's name and power
limit, each kernel's ptxas report (registers, spills) and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels._ablation import build_variants, ptxas_report
from repro_torch.kernels._timing import kernel_times, median

SLICE, WINDOW_LINES, NUM_BINS = 201, 25, 64  # Set1's slice, PDFConfig's window_lines and num_bins

_ADD4 = """  __device__ __forceinline__ void add4(float4 v) {
    add(v.x);
    add(v.y);
    add(v.z);
    add(v.w);
  }"""
_MINMAX = "    mn = min_nan1(mn, v);\n    mx = max_nan1(mx, v);\n  }\n  __device__ __forceinline__ void add4"
_PARTIAL = "  if (live && rt == nq % kMomRowThreads)"
_BOUNDS = "__global__ void __launch_bounds__(kMomThreads)\nrow_moments_kernel("
_SHAPE = """constexpr int kMomRowThreads = 32;  // threads a row: a warp
constexpr int kMomRows = 4;         // rows a block
constexpr int kMomLoads = 8;        // 16-byte loads a thread keeps in flight"""


def _shape(row_threads: int, rows: int, loads: int) -> list:
    return [("row_moments.cuh", _SHAPE, f"constexpr int kMomRowThreads = {row_threads};\n"
             f"constexpr int kMomRows = {rows};\nconstexpr int kMomLoads = {loads};")]


# (file, statement, replacement) a variant makes in csrc/.
VARIANTS = {
    "whole": [],
    "loads_only": [("row_moments.cuh", _ADD4, "  __device__ __forceinline__ void add4(float4 v) {\n"
                    "    s1 += v.x;\n    s2 += v.y;\n    s3 += v.z;\n    s4 += v.w;\n  }")],
    "no_minmax": [("row_moments.cuh", _MINMAX, "  }\n  __device__ __forceinline__ void add4")],
    "no_edges": [("row_moments.cuh", "  if constexpr (kEdges) {", "  if constexpr (false) {")],
    "scalar": [("row_moments.cuh", "  if (((uintptr_t)xr & 15) == 0) {", "  if (false) {")],
    "float_tree": [("row_moments.cuh", "  double s1, s2, s3, s4;", "  float s1, s2, s3, s4;"),
                   ("row_moments.cuh", "void merge(double o1, double o2, double o3, double o4,",
                    "void merge(float o1, float o2, float o3, float o4,"),
                   ("row_moments.cuh", "  double k0 = a", "  float k0 = a"),
                   ("row_moments.cuh", "  double c = b", "  float c = b")],
    "tail_only": [("row_moments.cuh", "  const int nq = live ? n >> 2 : 0;", "  const int nq = 0;"),
                  ("row_moments.cuh", _PARTIAL, "  if (false)")],
    "select_minmax": [("row_moments.cuh", _MINMAX, _MINMAX.replace("_nan1", "_nan"))],
    "min_blocks10": [("row_moments.cuh", _BOUNDS, _BOUNDS.replace("(kMomThreads)", "(kMomThreads, 10)"))],
    # Threads a row x rows a block, 16-byte loads a thread a round.
    "16x8_l16": _shape(16, 8, 16),
    "16x8_l8": _shape(16, 8, 8),
    "32x2_l8": _shape(32, 2, 8),
    "32x4_l4": _shape(32, 4, 4),
    "64x2_l4": _shape(64, 2, 4),
    "128x1_l4": _shape(128, 1, 4),
}
KERNELS = ("row_moments_kernel",)


def build(against: list[Path]) -> tuple[dict, dict]:
    """Write and compile every variant (fitpdf.cu and moments.cu each), one
    nvcc a source, all at once. Returns ({variant: (fitpdf lib, moments
    lib)}, {variant: ptxas report})."""
    built = build_variants("moments", VARIANTS, ("fitpdf", "moments"), against, ("-Xptxas", "-v"))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs, reports = {}, {}
    for name, (d, logs) in built.items():
        fit, mom = ctypes.CDLL(str(d / "fitpdf.so")), ctypes.CDLL(str(d / "moments.so"))
        fit.fitpdf_moments_edges_stats.argtypes = [vp] * 3 + [i32] * 4 + [vp]
        fit.fitpdf_moments_edges_stats.restype = i32
        mom.moments_stats.argtypes = [vp] * 2 + [i32] * 3 + [vp]
        mom.moments_stats.restype = i32
        libs[name] = (fit, mom)
        reports[name] = ptxas_report(logs["fitpdf"], KERNELS) + ptxas_report(logs["moments"], KERNELS)
    return libs, reports


def inputs(dev: torch.device) -> dict:
    """The ablation's calls' tensors: the Set1 window, and a copy of it one
    float off a 16-byte boundary."""
    from repro_torch.core.regions import Window
    from repro_torch.data.simulation import SeismicSimulation

    x = torch.from_numpy(SeismicSimulation().load_window(Window(SLICE, 0, WINDOW_LINES))).to(dev)
    p, n = x.shape
    off = torch.empty(p * n + 1, device=dev)[1:].view(p, n)
    off.copy_(x)
    stats = torch.empty((p, 8), device=dev)
    edges = torch.empty((p, NUM_BINS + 1), device=dev)
    return {"k1_L64": dict(kernel="k1", x=x, stats=stats, edges=edges),
            "k3": dict(kernel="k3", x=x, stats=stats),
            "k3_misaligned": dict(kernel="k3", x=off, stats=stats)}


def launcher(libs, c: dict, stream):
    fit, mom = libs
    p, n = c["x"].shape
    if c["kernel"] == "k1":
        fn = fit.fitpdf_moments_edges_stats
        args = (c["x"].data_ptr(), c["stats"].data_ptr(), c["edges"].data_ptr(), p, n, NUM_BINS,
                0, stream)
    else:
        fn, args = mom.moments_stats, (c["x"].data_ptr(), c["stats"].data_ptr(), p, n, 0, stream)

    def run():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", default=[],
                    help="directories with other fitpdf.cu and moments.cu (and their headers) to time beside them")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the ablation times kernels on the card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs, reports = build(args.against)
    for name, rep in reports.items():
        for line in rep:
            print(f"[ptxas {name}] {line}", flush=True)
    cases = inputs(dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    flush = torch.empty(128 * 1024 * 1024 // 4, device=dev)
    runs = {(c, v): launcher(lib, case, stream) for c, case in cases.items() for v, lib in libs.items()}
    rounds = [{c: {v: median(kernel_times(runs[(c, v)], 20, flush)) for v in libs} for c in cases}
              for _ in range(2)]
    x, one = cases["k3"]["x"], torch.zeros(1, device=dev)
    yard = {"empty_launch": median(kernel_times(one.zero_, 20, flush)),
            "torch_row_sum": median(kernel_times(lambda: x.sum(dim=1), 20, flush))}
    print(f"[yardstick] {yard}", flush=True)
    for c in cases:
        print(f"[ablation] {c}: " + ", ".join(
            f"{v} {[r[c][v] for r in rounds]}" for v in libs), flush=True)
    print(json.dumps({"device": smi, "shape": list(x.shape), "L": NUM_BINS, "ms": rounds,
                      "yardstick_ms": yard, "ptxas": reports}), flush=True)


if __name__ == "__main__":
    main()
