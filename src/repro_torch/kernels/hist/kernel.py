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
equal the plain version's exactly. A constant row (vmin == vmax) counts
everything in bin 0. Any L: past the int counters a block's shared memory
holds (58,112 on an H100, after opting in past the default 48 KB), the
block counts the bins in chunks, reading the row again for each.

The wrapper dispatches on the tensor's device: a CPU tensor gets the plain
version (``pe.histogram_scatter``), a CUDA tensor the kernel or an
exception, a meta tensor its output's shape and the dry run's charge
(``_launch.on_meta``). It counts its kernel launches, one a chunk of bins, in
``hist_counts.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import pdf_error as pe
from repro_torch.kernels import _launch


def _library():
    vp, i32 = _launch.VP, _launch.I32
    return _launch.bind("hist", {
        "hist_counts": ([vp, vp, vp, vp, i32, i32, i32, i32, i32, vp], i32),
        "hist_attributes": ([i32, i32, ctypes.POINTER(ctypes.c_int)], i32),
    })


def hist_counts_plain(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
                      num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of K4: the scatter-add histogram."""
    return pe.histogram_scatter(values, vmin, vmax, num_bins)


def hist_counts(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
                num_bins: int) -> torch.Tensor:
    """values (P, n), vmin/vmax (P,) f32 -> counts (P, num_bins) f32."""
    return _hist_counts(values, vmin, vmax, num_bins)


def _hist_counts(values, vmin, vmax, num_bins: int, chunk: int = 0) -> torch.Tensor:
    """``hist_counts`` with the kernel's chunk of bins forced to ``chunk``
    (a multiple of 32, or ``num_bins`` or more) when it is not 0: the tests'
    way to run the chunked route at any L."""
    _launch.check_values(values)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    p, n = values.shape
    _launch.check_operand("vmin", vmin, (p,), values.device)
    _launch.check_operand("vmax", vmax, (p,), values.device)
    if values.device.type == "cpu":
        return hist_counts_plain(values, vmin, vmax, num_bins)
    counts = torch.empty((p, num_bins), dtype=torch.float32, device=values.device)
    if values.device.type == "meta":
        _launch.on_meta("hist_counts", p, n, num_bins)
        return counts
    _launch.check_contiguous(values)
    lib = _library()
    if p:
        dev = _launch.device_index(values.device)
        rc = lib.hist_counts(values.data_ptr(), vmin.data_ptr(), vmax.data_ptr(),
                             counts.data_ptr(), p, n, num_bins, chunk, dev,
                             _launch.stream(values.device))
        _launch.raise_if_failed(lib, "hist", rc, "hist_counts")
        # One launch a chunk of bins.
        hist_counts.launches += -(-num_bins // (chunk or _hist_chunk(dev, num_bins)))
    return counts


hist_counts.launches = 0


@functools.lru_cache(maxsize=None)
def _hist_chunk(device: int, num_bins: int) -> int:
    """The bins a K4 block counts at once at ``num_bins`` on CUDA device
    ``device`` when no chunk is forced (``num_bins`` itself while the
    counters fit the card's opt-in shared memory)."""
    return hist_attributes(num_bins, device)["chunk"]


def hist_attributes(num_bins: int, device: int = 0) -> dict:
    """Registers a thread, local memory bytes a thread (nonzero if it
    spills), dynamic shared memory bytes a block and the chunk of bins a
    block counts at once of K4 at ``num_bins`` on CUDA device ``device``,
    from the CUDA runtime."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    rc = lib.hist_attributes(num_bins, device, out)
    _launch.raise_if_failed(lib, "hist", rc, "hist_attributes")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2], chunk=out[3])
