"""Where K5's bf16 kernel spends its time: the kernel with one part taken
out, timed beside the whole at the serving shape on the card.

    PYTHONPATH=src python -m repro_torch.kernels.band_attn.ablation [--against DIR]

Each variant is ``csrc/band_attn.cu`` with a statement or two replaced,
built with the same flags into
``build/kernels/ablation/band_attn/<variant>/`` (``kernels/_ablation.py``)
and bound with ctypes: ``no_copies`` issues no K/V copy after the first
tile (every tile then reads the first two buffers, and waits only for
the first), ``no_exp`` makes ``exp2f`` the identity, ``no_qk`` and
``no_pv`` drop the Q K^T and the P V products, ``no_products`` both.
Their outputs are wrong by design; only their times mean anything.
``--against DIR`` adds ``DIR/band_attn.cu`` (with its own ``wgmma.cuh``),
another version of the kernel, built and timed in the same turns. Then
the whole kernel at windows 64 to 4,096, to separate the cost of a
block from the cost of a key tile. Kernel-only medians of 20
(``_timing.kernel_times``: bare C launches, L2 flushed clean before
each), variants in turns (two rounds). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from repro_torch.kernels._ablation import build_variants
from repro_torch.kernels._timing import kernel_times, median

SHAPE = (4, 4096, 16, 8, 256, 1024)  # (B, S, H, KV, hd, W): gemma3-12b's serving shape

_QK = "      wgmma::ss_n64(s, descriptor(qt + off, 16, kAtom), descriptor(kt_s + off, 16, kAtom), 1);"
_PV = "      wgmma::rs<HDP>(acc, pa[kk], descriptor(vt_s + kk * 2 * kAtom, kBoxBytes, kAtom), 1);"
_COPY = "    if (tid == 0 && kt + kRows <= q_last) {"
_WAIT = "    mbar_wait(bar_kv + 8 * stage, (t >> 1) & 1);"
_INCLUDE = '#include "wgmma.cuh"'
_SRC = "band_attn.cu"
# (file, statement, replacement) a variant makes in csrc/.
VARIANTS = {
    "whole": [],
    "no_copies": [(_SRC, _COPY, "    if (false) {"), (_SRC, _WAIT, "    if (t == 0) mbar_wait(bar_kv, 0);")],
    "no_exp": [(_SRC, _INCLUDE, _INCLUDE + "\n#define exp2f(x) (x)")],
    "no_qk": [(_SRC, _QK, "      (void)off;")],
    "no_pv": [(_SRC, _PV, "      ;")],
    "no_products": [(_SRC, _QK, "      (void)off;"), (_SRC, _PV, "      ;")],
}


def build(against: Path | None) -> dict[str, ctypes.CDLL]:
    """Write and compile every variant (and ``against``), one nvcc each, all
    at once."""
    built = build_variants("band_attn", VARIANTS, ("band_attn",), [] if against is None else [against])
    libs = {}
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for name, (d, _) in built.items():
        lib = ctypes.CDLL(str(d / "band_attn.so"))
        lib.band_attn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, vp]
        lib.band_attn.restype = i32
        libs["against" if name.startswith("against") else name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, help="a directory with another band_attn.cu to time beside it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the ablation times kernels on the card")
    dev = torch.device("cuda", 0)
    libs = build(args.against)
    b, s, h, kvh, hd, w = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    q = (0.5 * torch.randn(b, s, h, hd, generator=gen, device=dev)).bfloat16()
    k = (0.5 * torch.randn(b, s, kvh, hd, generator=gen, device=dev)).bfloat16()
    v = torch.randn(b, s, kvh, hd, generator=gen, device=dev).bfloat16()
    o = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    flush = torch.empty(32 * 1024 * 1024, device=dev)

    def median_ms(lib, window, reps=20) -> float:
        def run():
            rc = lib.band_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, b, s, h, kvh,
                               hd, window, hd**-0.5, 0, stream)
            if rc:
                raise RuntimeError(f"band_attn launch failed: CUDA error {rc}")
        return median(kernel_times(run, reps, flush))

    rounds = [{name: median_ms(lib, w) for name, lib in libs.items()} for _ in range(2)]
    windows = {win: median_ms(libs["whole"], win) for win in (64, 256, 1024, 4096)}
    print(json.dumps({"shape": SHAPE, "device": torch.cuda.get_device_name(0), "ms": rounds,
                      "whole_by_window_ms": windows}), flush=True)


if __name__ == "__main__":
    main()
