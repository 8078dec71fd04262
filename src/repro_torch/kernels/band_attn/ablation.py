"""Where K5's bf16 kernel spends its time: the kernel with one part taken
out, timed beside the whole at the serving shape on the card.

    PYTHONPATH=src python -m repro_torch.kernels.band_attn.ablation [--against DIR]

Each variant is ``csrc/band_attn.cu`` with a statement or two replaced,
built with the same flags into ``build/kernels/ablation/`` and bound with
ctypes: ``no_copies`` issues no K/V copy after the first tile (every tile
then reads the first two buffers, and waits only for the first),
``no_exp`` makes ``exp2f`` the identity, ``no_qk`` and ``no_pv`` drop the
Q K^T and the P V products, ``no_products`` both. Their outputs are wrong by design; only their times mean anything.
``--against DIR`` adds ``DIR/band_attn.cu`` (with its own ``wgmma.cuh``),
another version of the kernel, built and timed in the same turns. Then
the whole kernel at windows 64 to 4,096, to separate the cost of a
block from the cost of a key tile. CUDA-event medians, L2 flushed before
each launch, variants in turns (two rounds). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build

SHAPE = (4, 4096, 16, 8, 256, 1024)  # (B, S, H, KV, hd, W): gemma3-12b's serving shape

_QK = "      wgmma::ss_n64(s, descriptor(qt + off, 16, kAtom), descriptor(kt_s + off, 16, kAtom), 1);"
_PV = "      wgmma::rs<HDP>(acc, pa[kk], descriptor(vt_s + kk * 2 * kAtom, kBoxBytes, kAtom), 1);"
_COPY = "    if (tid == 0 && kt + kRows <= q_last) {"
_WAIT = "    mbar_wait(bar_kv + 8 * stage, (t >> 1) & 1);"
_INCLUDE = '#include "wgmma.cuh"'
VARIANTS = {
    "whole": [],
    "no_copies": [(_COPY, "    if (false) {"), (_WAIT, "    if (t == 0) mbar_wait(bar_kv, 0);")],
    "no_exp": [(_INCLUDE, _INCLUDE + "\n#define exp2f(x) (x)")],
    "no_qk": [(_QK, "      (void)off;")],
    "no_pv": [(_PV, "      ;")],
    "no_products": [(_QK, "      (void)off;"), (_PV, "      ;")],
}


def build(against: Path | None) -> dict[str, ctypes.CDLL]:
    """Write and compile every variant, one nvcc each, all at once."""
    src = (_build.CSRC / "band_attn.cu").read_text()
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / "wgmma.cuh").write_text((_build.CSRC / "wgmma.cuh").read_text())
    procs = {}
    if against is not None:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "against.so"), str(against / "band_attn.cu")]
        procs["against"] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: statement not found in band_attn.cu: {old!r}")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, failed = {}, []
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
            continue
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.band_attn.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, vp]
        lib.band_attn.restype = i32
        libs[name] = lib
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
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
        for _ in range(3):
            run()
        times = []
        for _ in range(reps):
            flush.zero_()
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
            run()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        return sorted(times)[reps // 2]

    rounds = [{name: median_ms(lib, w) for name, lib in libs.items()} for _ in range(2)]
    windows = {win: median_ms(libs["whole"], win) for win in (64, 256, 1024, 4096)}
    print(json.dumps({"shape": SHAPE, "device": torch.cuda.get_device_name(0), "ms": rounds,
                      "whole_by_window_ms": windows}), flush=True)


if __name__ == "__main__":
    main()
