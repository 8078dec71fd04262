"""K5 ``banded_attention_kernel``: the CUDA wrapper beside its plain version.

Replaces the Pallas TPU kernel
``repro/kernels/band_attn/kernel.py::banded_attention_kernel``: causal
sliding-window GQA attention, q (B, S, H, hd), k/v (B, S, KV, hd) in
float32 or bfloat16 -> (B, S, H, hd) in q's type, key j valid for query i
iff ``i - window < j <= i``. Bound on an H100 at the serving shape (B 4,
S 4096, H 16, KV 8, hd 256, W 1024, bf16): operations, 2.41e11 useful
FLOPs (4 hd per valid pair), 0.243 ms at the bf16 tensor-core peak, above
the 402.7 MB of q, k, v and out (0.120 ms). Design (``csrc/band_attn.cu``):
an online softmax in float32 over tiles of the band, a fixed order of
summation and no atomics, so a repeat is bitwise equal; the ragged tail is
masked in the kernel, with no padded copy. bfloat16 runs on the tensor
cores (wgmma: Q K^T and P V with float32 accumulators, P rounded to bf16
as the reference's oracle rounds its weights; 64-row query tiles, one
warpgroup per head of a kv group, double-buffered 64-key K/V tiles copied
by TMA in the 128-byte swizzle layout).
float32 runs on the CUDA cores, so it keeps float32 products.

The wrapper dispatches on the tensor's device: a CPU tensor gets the plain
version (``ref.banded_attention_ref``), a CUDA tensor the kernel or an
exception, a meta tensor its output's shape and the dry run's charge
(``_launch.on_meta``). It counts its launches, of either dtype, in
``banded_attention_kernel.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels.band_attn.ref import banded_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _library():
    vp, i32 = _launch.VP, _launch.I32
    return _launch.bind("band_attn", {
        "band_attn": ([vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, ctypes.c_float,
                       i32, vp], i32),
        "band_attn_tc_attributes": ([i32, i32, i32, ctypes.POINTER(ctypes.c_int)], i32),
    })


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q and k must be (B, S, heads, hd), got {tuple(q.shape)}, {tuple(k.shape)}")
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if tuple(k.shape) != (b, s, kvh, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, S, KV, hd) = {(b, s, kvh, hd)}, got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if hd > MAX_HEAD_DIM or hd % 8 or hd < 8:
        raise ValueError(f"head_dim {hd} unsupported: it must be a multiple of 8 up to {MAX_HEAD_DIM}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"q on unsupported device {q.device}")


def banded_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            window: int) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd) in q's type."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return banded_attention_ref(q, k, v, window)
    b, s, h, hd = q.shape
    if q.device.type == "meta":
        _launch.on_meta("banded_attention_kernel", b, s, h, k.shape[2], hd, window, q.dtype)
        return torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the kernel's grid")
    out = torch.empty_like(q)
    if b * s == 0:
        return out
    lib = _library()
    rc = lib.band_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
                       b, s, h, k.shape[2], hd, window, hd**-0.5,
                       _launch.device_index(q.device), _launch.stream(q.device))
    _launch.raise_if_failed(lib, "band_attn", rc, "banded_attention_kernel")
    banded_attention_kernel.launches += 1
    return out


banded_attention_kernel.launches = 0


def tc_attributes(head_dim: int, heads: int, kv_heads: int) -> dict:
    """Registers a thread, local memory bytes a thread (nonzero if it
    spills) and dynamic shared memory bytes a block of the bf16 kernel's
    instantiation for these widths, from the CUDA runtime."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    rc = lib.band_attn_tc_attributes(head_dim, heads, kv_heads, out)
    _launch.raise_if_failed(lib, "band_attn", rc, "band_attn_tc_attributes")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2])
