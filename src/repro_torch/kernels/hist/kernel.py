"""K4 ``hist_counts``: the CUDA wrapper beside its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/hist/kernel.py::hist_counts``.
values (P, n) f32, vmin/vmax (P,) f32 -> counts (P, L) f32 over the Eq.-5
intervals: bin ``floor((x - lo) / max(hi - lo, 1e-12) * L)`` clipped to
[0, L-1]. Bound on an H100: bytes. It must read the window once, P*n*4 B
(25.1 MB for a Set1 window, about 7.5 us at 3.35 TB/s), and write P*L*4 B.
Design: K2's histogram phase (``csrc/row_hist.cuh``) without its CDF
epilogue (``csrc/hist.cu``): one block of 128 threads a row with every
16-byte load of the row in flight at once, the counts as one histogram of
L integer counters in shared memory (integer atomic adds are exact and
order-free), the bin computed with IEEE-rounded intrinsics, so the counts
equal the plain version's exactly. A constant row (vmin == vmax) counts everything in bin
0. It takes up to ``MAX_BINS`` bins.

The wrapper dispatches on the tensor's device: a CPU tensor gets the plain
version (``pe.histogram_scatter``), a CUDA tensor the kernel or an
exception. It counts its launches in ``hist_counts.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import pdf_error as pe
from repro_torch.kernels import _launch


# The largest L the kernel takes: that of the one-warp-a-row design before
# it, whose eight rows a block filled 48 KB of shared memory at L = 1,536.
# A block of this design holds one row's L int counters.
MAX_BINS = 1536


def _library():
    vp, i32 = _launch.VP, _launch.I32
    return _launch.bind("hist", {
        "hist_counts": ([vp, vp, vp, vp, i32, i32, i32, i32, vp], i32),
        "hist_attributes": ([i32, ctypes.POINTER(ctypes.c_int)], i32),
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
    _launch.check_bins(num_bins, MAX_BINS)
    lib = _library()
    counts = torch.empty((p, num_bins), dtype=torch.float32, device=values.device)
    if p:
        rc = lib.hist_counts(values.data_ptr(), vmin.data_ptr(), vmax.data_ptr(),
                             counts.data_ptr(), p, n, num_bins,
                             _launch.device_index(values.device), _launch.stream(values.device))
        _launch.raise_if_failed(lib, "hist", rc, "hist_counts")
        hist_counts.launches += 1
    return counts


hist_counts.launches = 0


def hist_attributes(num_bins: int) -> dict:
    """Registers a thread, local memory bytes a thread (nonzero if it
    spills) and dynamic shared memory bytes a block of K4 at ``num_bins``,
    from the CUDA runtime."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    rc = lib.hist_attributes(num_bins, out)
    _launch.raise_if_failed(lib, "hist", rc, "hist_attributes")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2])
