"""Where K2 (``fit_error_counts``) and K4 (``hist_counts``) spend their
time: the kernels with one part taken out, timed beside the whole on a
Set1 window on the card.

    PYTHONPATH=src python -m repro_torch.kernels.fitpdf.ablation [--against DIR ...]

Each variant is ``csrc/`` with a statement or two replaced, built with the
same flags (and ``-Xptxas -v``) into ``build/kernels/ablation/fitpdf/<variant>/``
and bound with ctypes: ``loads_only`` sums each thread's values into a
register and stores it where the counts would go (no bin, no atomics, no
epilogue), ``no_epilogue`` writes one count per type instead of the Eq.-5
error, ``epilogue_only`` reads and counts nothing, ``no_special`` makes the
gamma and student_t CDFs a constant. Their outputs are wrong by design;
only their times mean anything. ``chunked_code`` is the exception: it
launches K2's chunked instantiation for one chunk too (c0 = 0, C = L),
which gives the same bits; it is what K2's separate one-chunk
instantiation saves. K4 has no epilogue, so its
``no_epilogue``, ``no_special`` and ``chunked_code`` are its whole and its
``epilogue_only`` only zeroes and writes the counts. ``--against DIR
...`` adds each ``DIR/fitpdf.cu`` and ``DIR/hist.cu`` (with the headers
in DIR), other versions of the kernels, built and timed in the same
turns (``kernels/_ablation.py`` builds them all).

Cases: K2 at T = 4, L = 64 and at T = 10, L = 20 on the first window of
Set1's slice 201 (6,275 x 1,000 float32), K2 through ``row_indices`` on
that window's grouped representatives (T = 4, L = 64), K4 at L = 64 on
the window, and K4 on a window whose rows put every value but two in one
bin (every atomic of a row on one counter). Each time is the kernel's own
(``_timing.kernel_times``: bare C launches, L2 flushed clean before each),
a median of 20, variants in turns, two rounds; then the whole kernels
once more with a flush that leaves L2 dirty, and two yardsticks with the
same timing (a launch that does nothing, PyTorch's row sum of the window).
Prints the card's name and power limit, each kernel's ptxas report
(registers, spills) and one JSON line.
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

SLICE, WINDOW_LINES = 201, 25  # Set1's slice and PDFConfig.window_lines

_EPILOGUE = "  for (int t = warp; t < T; t += kHistWarps) {\n    const int code"
_NO_EPILOGUE = ("  if (threadIdx.x < T) err[row * T + threadIdx.x] = (float)hist[threadIdx.x % C];\n"
                "  for (int t = warp; t < 0; t += kHistWarps) {\n    const int code")
_COUNT = """  auto count = [&](float v) {
    const int b = interval_bin(v, lo, span, fl, top);
    if constexpr (kChunked) {
      if ((unsigned)(b - c0) < (unsigned)C) atomicAdd(hist + (b - c0), 1);  // repro: allow[DET]: int count, exact in any order
    } else {
      atomicAdd(hist + b, 1);  // repro: allow[DET]: int count, exact in any order
    }
  };"""
_END = "  __syncthreads();\n}\n"  # the histogram's last statement
_HEAD_TAIL = "  if (tid < head) count(__ldg(xr + tid));\n  if (tid < n - tail) count(__ldg(xr + tail + tid));"
_BODY = "  for (int base = 0; base < nv; base += kHistThreads * kHistLoads) {"
_GAMMA = "      if constexpr (kSpecial) return gamma_cdf(p0, p1, x); else return kNaN;"
_STUDENT_T = "      if constexpr (kSpecial) return student_t_cdf(p0, p1, p2, x); else return kNaN;"
_INSTANCE = "  const FitErrorKernel kernel = fit_error_instance(has_special(codes, T), chunked);"
# (file, statement, replacement) a variant makes in csrc/.
VARIANTS = {
    "whole": [],
    "loads_only": [("row_hist.cuh", _COUNT, "  float sum = 0.0f;\n  auto count = [&](float v) { sum += v; };"),
                   ("row_hist.cuh", _END, "  hist[tid % C] = __float_as_int(sum);\n" + _END),
                   ("fitpdf.cu", _EPILOGUE, _NO_EPILOGUE)],
    "no_epilogue": [("fitpdf.cu", _EPILOGUE, _NO_EPILOGUE)],
    "epilogue_only": [("row_hist.cuh", _HEAD_TAIL, ""),
                      ("row_hist.cuh", _BODY, _BODY.replace("base < nv", "base < 0"))],
    "no_special": [("fitpdf.cu", _GAMMA, "      return 0.5f;"), ("fitpdf.cu", _STUDENT_T, "      return 0.5f;")],
    "chunked_code": [("fitpdf.cu", _INSTANCE, _INSTANCE.replace("chunked);", "true);"))],
}
KERNELS = ("fit_error_kernel", "hist_counts_kernel")


def build(against: list[Path]) -> tuple[dict, dict]:
    """Write and compile every variant (fitpdf.cu and hist.cu each), one
    nvcc a source, all at once. Returns ({variant: (fitpdf lib, hist lib)},
    {variant: ptxas report})."""
    built = build_variants("fitpdf", VARIANTS, ("fitpdf", "hist"), against, ("-Xptxas", "-v"))
    vp, i32, ull = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    libs, reports = {}, {}
    for name, (d, logs) in built.items():
        fit, hist = ctypes.CDLL(str(d / "fitpdf.so")), ctypes.CDLL(str(d / "hist.so"))
        # Sources with fitpdf_fit_error_attributes take the window's row count
        # after P; older ones do not. Sources with fitpdf_fit_error_chunk take
        # the most bins a block holds (0: the card's) and a scratch before
        # the device in K2, and a chunk of bins (0: its own route) in K4.
        fit.bounded = hasattr(fit, "fitpdf_fit_error_attributes")
        fit.chunked = hasattr(fit, "fitpdf_fit_error_chunk")
        fit.fitpdf_fit_error_counts.argtypes = (
            [vp] * 7 + [i32] * (5 if fit.bounded else 4) + [ull] + ([i32, vp] if fit.chunked else [])
            + [i32, vp])
        fit.fitpdf_fit_error_counts.restype = i32
        hist.hist_counts.argtypes = [vp] * 4 + [i32] * (5 if fit.chunked else 4) + [vp]
        hist.hist_counts.restype = i32
        libs[name] = (fit, hist)
        reports[name] = ptxas_report(logs["fitpdf"], KERNELS) + ptxas_report(logs["hist"], KERNELS)
    return libs, reports


def inputs(dev: torch.device) -> dict:
    """The ablation's four calls' tensors: K2 at (T 4, L 64) and (T 10,
    L 20) and through the representatives, K4 at L 64."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import grouping as grp
    from repro_torch.core import pdf_error as pe
    from repro_torch.core.regions import Window
    from repro_torch.data.simulation import SeismicSimulation
    from repro_torch.kernels.fitpdf.kernel import _type_codes

    x = torch.from_numpy(SeismicSimulation().load_window(Window(SLICE, 0, WINDOW_LINES))).to(dev)
    m = dists.moments_from_values(x)
    groups = grp.group_device(grp.quantize_keys(m.mean, m.var))
    reps = grp.compact_representatives(groups.rep_for_point, groups.is_rep)[0]

    def k2(types, num_bins, idx=None):
        sub = m if idx is None else dists.Moments(*(f[idx] for f in m))
        g = len(sub.vmin)
        params = dists.fit_all(types, sub).reshape(g, -1).contiguous()
        edges = pe.interval_edges(sub.vmin, sub.vmax, num_bins).contiguous()
        err = torch.empty((g, len(types)), device=dev)
        return dict(kernel="k2", x=x, idx=idx, vmin=sub.vmin.contiguous(), vmax=sub.vmax.contiguous(),
                    edges=edges, params=params, out=err, g=g, L=num_bins, T=len(types),
                    codes=_type_codes(types))

    cases = {"k2_T4_L64": k2(dists.TYPES_4, 64), "k2_T10_L20": k2(dists.TYPES_10, 20),
             "k2_rows_T4_L64": k2(dists.TYPES_4, 64, reps)}
    cases["k4_L64"] = dict(kernel="k4", x=x, vmin=m.vmin.contiguous(), vmax=m.vmax.contiguous(),
                           out=torch.empty((len(x), 64), device=dev), g=len(x), L=64)
    # Every value of every row in one bin but the row's two ends: all of a
    # row's atomics on one counter (a sub-histogram's worth of conflicts).
    one_bin = torch.full_like(x, 5.0)
    one_bin[:, 0], one_bin[:, -1] = 0.0, 10.0
    cases["k4_one_bin_L64"] = dict(kernel="k4", x=one_bin, vmin=torch.zeros(len(x), device=dev),
                                   vmax=torch.full((len(x),), 10.0, device=dev),
                                   out=torch.empty((len(x), 64), device=dev), g=len(x), L=64)
    return cases


def launcher(libs, c: dict, stream):
    fit, hist = libs
    p, n = c["x"].shape
    if c["kernel"] == "k4":
        args = (c["x"].data_ptr(), c["vmin"].data_ptr(), c["vmax"].data_ptr(), c["out"].data_ptr(),
                p, n, c["L"], *((0,) if fit.chunked else ()), 0, stream)
        fn = hist.hist_counts
    else:
        rows = (c["g"], p) if fit.bounded else (c["g"],)
        args = (c["x"].data_ptr(), None if c["idx"] is None else c["idx"].data_ptr(),
                c["vmin"].data_ptr(), c["vmax"].data_ptr(), c["edges"].data_ptr(),
                c["params"].data_ptr(), c["out"].data_ptr(), *rows, n, c["L"], c["T"], c["codes"],
                *((0, None) if fit.chunked else ()), 0, stream)
        fn = fit.fitpdf_fit_error_counts

    def run():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", default=[],
                    help="directories with other fitpdf.cu and hist.cu (and their headers) to time beside them")
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
    # Yardsticks with the same timing: a launch that does nothing, and
    # PyTorch's row sum, which reads the window once.
    x, one = cases["k2_T4_L64"]["x"], torch.zeros(1, device=dev)
    yard = {"empty_launch": median(kernel_times(one.zero_, 20, flush)),
            "torch_row_sum": median(kernel_times(lambda: x.sum(dim=1), 20, flush))}
    print(f"[yardstick] {yard}", flush=True)
    # The whole kernels again with L2 left dirty by the flush (zeroed, not read).
    dirty = {c: {v: median(kernel_times(runs[(c, v)], 20, flush, dirty=True)) for v in libs
                 if v == "whole" or v.startswith("against")} for c in cases}
    for c in cases:
        print(f"[ablation] {c}: " + ", ".join(
            f"{v} {[r[c][v] for r in rounds]}" for v in libs), flush=True)
        print(f"[ablation dirty L2] {c}: {dirty[c]}", flush=True)
    shapes = {c: dict(rows=case["g"], n=case["x"].shape[1], L=case["L"], T=case.get("T"))
              for c, case in cases.items()}
    print(json.dumps({"device": smi, "shapes": shapes, "ms": rounds, "ms_dirty_l2": dirty, "yardstick_ms": yard,
                      "ptxas": reports}), flush=True)


if __name__ == "__main__":
    main()
