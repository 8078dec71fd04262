"""K4 ``hist_counts``: the CUDA wrapper beside its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/hist/kernel.py::hist_counts``.
values (P, n) f32, vmin/vmax (P,) f32 -> counts (P, L) f32 over the Eq.-5
intervals: bin ``floor((x - lo) / max(hi - lo, 1e-12) * L)`` clipped to
[0, L-1]. Bound on an H100: bytes. It must read the window once, P*n*4 B
(25.1 MB for a Set1 window, about 7.5 us at 3.35 TB/s), and write P*L*4 B.
Design: K2's histogram phase (``csrc/row_hist.cuh``) without its CDF
epilogue (``csrc/hist.cu``): one warp per row counts into L int counters in
shared memory with integer atomic adds, which are exact and order-free, and
computes the bin with IEEE-rounded intrinsics, so the counts equal the plain
version's exactly. A constant row (vmin == vmax) counts everything in bin 0.

The wrapper dispatches on the tensor's device: a CPU tensor gets the plain
version (``pe.histogram_scatter``), a CUDA tensor the kernel or an
exception. It counts its launches in ``hist_counts.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.core import pdf_error as pe
from repro_torch.kernels import _launch


def _library():
    vp, i32 = _launch.VP, _launch.I32
    return _launch.bind("hist", {
        "hist_counts": ([vp, vp, vp, vp, i32, i32, i32, i32, vp], i32),
        "hist_smem_bytes": ([i32], _launch.SIZE_T),
    })


def hist_counts_plain(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
                      num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of K4: the scatter-add histogram."""
    return pe.histogram_scatter(values, vmin, vmax, num_bins)


def hist_counts(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
                num_bins: int) -> torch.Tensor:
    """values (P, n), vmin/vmax (P,) f32 -> counts (P, num_bins) f32."""
    _launch.check_values(values)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    p, n = values.shape
    _launch.check_operand("vmin", vmin, (p,), values.device)
    _launch.check_operand("vmax", vmax, (p,), values.device)
    if values.device.type == "cpu":
        return hist_counts_plain(values, vmin, vmax, num_bins)
    _launch.check_contiguous(values)
    lib = _library()
    _launch.check_smem(lib.hist_smem_bytes(num_bins), num_bins)
    counts = torch.empty((p, num_bins), dtype=torch.float32, device=values.device)
    if p:
        rc = lib.hist_counts(values.data_ptr(), vmin.data_ptr(), vmax.data_ptr(),
                             counts.data_ptr(), p, n, num_bins,
                             _launch.device_index(values.device), _launch.stream(values.device))
        _launch.raise_if_failed(lib, "hist", rc, "hist_counts")
        hist_counts.launches += 1
    return counts


hist_counts.launches = 0
