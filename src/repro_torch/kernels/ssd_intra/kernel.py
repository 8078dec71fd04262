"""``ssd_intra_kernel``: the SSD's intra-chunk product, the CUDA wrapper
beside its plain version.

Replaces no Pallas kernel: the reference computes this term of
``repro/models/ssm.py`` with einsums around a float32 decay matrix. For
each chunk c of Q steps and head h of group g,

    y[b, c, i, h, :] = sum over j <= i of
        bf16(float(cb[b, c, g, i, j]) exp(ca[b, c, i, h] - ca[b, c, j, h])) xdt[b, c, j, h, :]

with cb (B, Nc, G, Q, Q) bf16, ca (B, Nc, Q, H) float32 and xdt (B, Nc,
Q, H, P) bf16 -> y (B, Nc, Q, H, P) bf16. Bound on an H100 at
mamba2-780m's prefill (B 4, Nc 16, Q 256, H 48, P 64): 212.9 MB of xdt,
y, cb and ca read or written once, 0.0636 ms a layer at 3.35 TB/s, above
its 1.61e10 FLOPs (0.0163 ms at the bf16 peak). Design
(``csrc/ssd_intra.cu``): a warpgroup a 64-row tile of one (b, c, h),
walking the tiles of j up to the diagonal; the decay tile built in float32
registers and rounded to bf16 as wgmma's A operand, the xdt tile (TMA,
double-buffered) its B operand, the sum in float32; no (B, Nc, H, Q, Q)
tensor in device memory, no padded copy of xdt, a fixed order of
summation and no atomics, so a repeat is bitwise equal.

The wrapper dispatches on the tensor's device: a CPU tensor gets the plain
version (``ref.ssd_intra_ref``), a CUDA tensor the kernel or an exception,
a meta tensor its output's shape and the dry run's charge
(``_launch.on_meta``, by ``roofline.ssd_intra_work``). It counts its
launches in ``ssd_intra_kernel.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels.ssd_intra.ref import ssd_intra_ref

TILE = 64  # the chunk length Q must be a multiple of it
MAX_HEAD_DIM = 256


def _library():
    vp, i32 = _launch.VP, _launch.I32
    return _launch.bind("ssd_intra", {
        "ssd_intra": ([vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp], i32),
        "ssd_intra_attributes": ([i32, i32, ctypes.POINTER(ctypes.c_int)], i32),
    })


def _check(cb: torch.Tensor, ca: torch.Tensor, xdt: torch.Tensor) -> None:
    for name, t, dtype in (("cb", cb, torch.bfloat16), ("ca", ca, torch.float32),
                           ("xdt", xdt, torch.bfloat16)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
    if xdt.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"xdt on unsupported device {xdt.device}")
    if xdt.ndim != 5 or cb.ndim != 5:
        raise ValueError(f"xdt must be (B, Nc, Q, H, P) and cb (B, Nc, G, Q, Q), got "
                         f"{tuple(xdt.shape)}, {tuple(cb.shape)}")
    b, nc, q, h, p = xdt.shape
    g = cb.shape[2]
    if tuple(cb.shape) != (b, nc, g, q, q) or tuple(ca.shape) != (b, nc, q, h):
        raise ValueError(f"cb must be (B, Nc, G, Q, Q) = {(b, nc, g, q, q)} and ca (B, Nc, Q, H) = "
                         f"{(b, nc, q, h)}, got {tuple(cb.shape)}, {tuple(ca.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"heads {h} not a multiple of groups {g}")
    if q < TILE or q % TILE:
        raise ValueError(f"chunk {q} unsupported: it must be a multiple of {TILE}")
    if p < 2 or p % 2 or p + (6 if p % 8 else 0) > MAX_HEAD_DIM or (h * p) % 8:
        raise ValueError(f"head_dim {p} unsupported: it must be even, at most {MAX_HEAD_DIM} (at most "
                         f"{MAX_HEAD_DIM - 6} if no multiple of 8), and heads x head_dim ({h} x {p}) a "
                         f"multiple of 8")


def ssd_intra_kernel(cb: torch.Tensor, ca: torch.Tensor, xdt: torch.Tensor) -> torch.Tensor:
    """cb (B, Nc, G, Q, Q), ca (B, Nc, Q, H), xdt (B, Nc, Q, H, P) ->
    y_intra (B, Nc, Q, H, P) in xdt's type."""
    _check(cb, ca, xdt)
    if xdt.device.type == "cpu":
        return ssd_intra_ref(cb, ca, xdt)
    b, nc, q, h, p = xdt.shape
    if xdt.device.type == "meta":
        _launch.on_meta("ssd_intra_kernel", b, nc, q, h, p, cb.shape[2])
        return torch.empty_like(xdt)
    for name, t in (("cb", cb), ("ca", ca), ("xdt", xdt)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if h > 65535:
        raise ValueError(f"heads {h} exceed the kernel's grid")
    y = torch.empty_like(xdt)
    if y.numel() == 0:
        return y
    lib = _library()
    rc = lib.ssd_intra(cb.data_ptr(), ca.data_ptr(), xdt.data_ptr(), y.data_ptr(), b * nc, q, cb.shape[2],
                       h, p, _launch.device_index(xdt.device), _launch.stream(xdt.device))
    _launch.raise_if_failed(lib, "ssd_intra", rc, "ssd_intra_kernel")
    ssd_intra_kernel.launches += 1
    return y


ssd_intra_kernel.launches = 0


def attributes(head_dim: int, chunk: int) -> dict:
    """Registers a thread, local memory bytes a thread (nonzero if it
    spills) and dynamic shared memory bytes a block of the kernel's
    instantiation for this head dim and chunk, from the CUDA runtime."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    rc = lib.ssd_intra_attributes(head_dim, chunk, out)
    _launch.raise_if_failed(lib, "ssd_intra", rc, "ssd_intra_attributes")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2])
