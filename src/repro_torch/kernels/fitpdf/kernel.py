"""The fused fit path's two kernels: CUDA wrappers beside their plain versions.

``moments_edges_stats`` (K1)
    Replaces the Pallas TPU kernel
    ``repro/kernels/fitpdf/kernel.py::moments_edges_stats``. values (P, n)
    f32 -> stats (P, 8) [mean, var, skew, kurt, vmin, vmax, 0, 0] and the
    Eq.-5 edges (P, L+1). Bound on an H100: bytes. It must read the window
    once, P*n*4 B (25.1 MB for a Set1 window of 6,275 x 1,000, about 7.5 us
    at 3.35 TB/s); its arithmetic is ~10 float operations per value. Design:
    one warp per row, lanes striding over the row so loads coalesce, the
    TPU's sequential observation-chunk grid axis turned into a loop inside
    the warp, and a fixed-order shuffle butterfly instead of atomics, so the
    result is bitwise reproducible.

``fit_error_counts`` (K2)
    Replaces the Pallas TPU kernel
    ``repro/kernels/fitpdf/kernel.py::fit_error_counts``. values (P, n),
    vmin/vmax (P,), edges (P, L+1), params (P, 3T) -> Eq.-5 errors (P, T).
    Bound: bytes, the same P*n*4 B read once; the epilogue's CDF work is
    P*T*(L+1) evaluations, small beside it. Design: one warp per row, the
    row's histogram as L integer counters in shared memory (integer atomic
    adds are exact and order-free), and, with the counts still there, the
    epilogue evaluates each candidate CDF at the edges into shared memory
    and reduces sum |freq/n - mass| in a fixed order; only (P, T) floats are
    written. The incomplete gamma and beta run in double on the device.

    ``row_indices`` (G,) int64 is the grouping methods' representative
    gather (``repro/kernels/fitpdf/ops.py:79-128``): output row r reads
    window row ``row_indices[r]`` while vmin, vmax, edges and params are
    already per representative. The kernel computes that address itself, so
    no gathered copy of the G rows is made; its bound is the G rows read.
    The result is bitwise equal to a launch on ``values[row_indices]``.

Each wrapper dispatches on the tensor's device: a CPU tensor gets the plain
PyTorch version (``*_plain``, the same arithmetic, the CPU tests' path), a
CUDA tensor gets the kernel or an exception. Each counts its launches in
``<wrapper>.launches`` (the CPU path counts nothing).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.core import distributions as dists
from repro_torch.core import pdf_error as pe
from repro_torch.kernels import _launch
from repro_torch.kernels.moments.kernel import NUM_STATS, moments_stats_plain

# The kernels' type codes index this tuple (csrc/fitpdf.cu: cdf_eval).
_TYPE_CODES = {name: i for i, name in enumerate(dists.TYPES_10)}
_MAX_TYPES = 16  # four bits per type code in one 64-bit word


def _library():
    vp, i32 = _launch.VP, _launch.I32
    return _launch.bind("fitpdf", {
        "fitpdf_moments_edges_stats": ([vp, vp, vp, i32, i32, i32, i32, vp], i32),
        "fitpdf_fit_error_counts": (
            [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, ctypes.c_ulonglong, i32, vp], i32),
        "fitpdf_fit_error_smem_bytes": ([i32], _launch.SIZE_T),
    })


# ---------------------------------------------------------------------------
# K1: moments_edges_stats
# ---------------------------------------------------------------------------


def moments_edges_stats_plain(values: torch.Tensor, num_bins: int):
    """Plain PyTorch version of K1: K3's plain stats (the reference kernel's
    shifted power sums and finalize) and the Eq.-5 edges of their range."""
    stats = moments_stats_plain(values)
    return stats, pe.interval_edges(stats[:, 4], stats[:, 5], num_bins)


def moments_edges_stats(values: torch.Tensor, num_bins: int):
    """values (P, n) f32 -> (stats (P, 8), edges (P, L+1)) f32."""
    _launch.check_values(values)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    if values.device.type == "cpu":
        return moments_edges_stats_plain(values, num_bins)
    _launch.check_contiguous(values)
    p, n = values.shape
    stats = torch.empty((p, NUM_STATS), dtype=torch.float32, device=values.device)
    edges = torch.empty((p, num_bins + 1), dtype=torch.float32, device=values.device)
    if p:
        lib = _library()
        rc = lib.fitpdf_moments_edges_stats(
            values.data_ptr(), stats.data_ptr(), edges.data_ptr(),
            p, n, num_bins, _launch.device_index(values.device), _launch.stream(values.device))
        _launch.raise_if_failed(lib, "fitpdf", rc, "moments_edges_stats")
        moments_edges_stats.launches += 1
    return stats, edges


moments_edges_stats.launches = 0


# ---------------------------------------------------------------------------
# K2: fit_error_counts
# ---------------------------------------------------------------------------


def fit_error_counts_plain(values, vmin, vmax, edges, params,
                           types: Sequence[str], num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of K2: scatter histogram, each type's CDF at
    the edges, masses and the Eq.-5 L1 error."""
    p, n = values.shape
    freq = pe.histogram_scatter(values, vmin.reshape(-1), vmax.reshape(-1), num_bins)
    rel = freq / float(max(n, 1))
    errs = []
    for t, name in enumerate(types):
        pk = params[:, 3 * t : 3 * t + 3][:, None, :]  # (P, 1, 3) against (P, L+1)
        c = dists.cdf(name, pk, edges)
        masses = c[:, 1:] - c[:, :-1]
        errs.append(torch.sum(torch.abs(rel - masses), dim=1))
    return torch.stack(errs, dim=1)


def _type_codes(types: Sequence[str]) -> int:
    if not 1 <= len(types) <= _MAX_TYPES:
        raise ValueError(f"between 1 and {_MAX_TYPES} types, got {len(types)}")
    codes = 0
    for t, name in enumerate(types):
        if name not in _TYPE_CODES:
            raise ValueError(f"unknown distribution type {name!r}")
        codes |= _TYPE_CODES[name] << (4 * t)
    return codes


def fit_error_counts(values, vmin, vmax, edges, params, types: Sequence[str],
                     num_bins: int, row_indices: torch.Tensor | None = None) -> torch.Tensor:
    """values (P, n), vmin/vmax (G,), edges (G, L+1), params (G, 3T) f32
    -> Eq.-5 errors (G, T) f32, where G = P without ``row_indices`` and
    G = len(row_indices) with them (row r reads ``values[row_indices[r]]``)."""
    _launch.check_values(values)
    t = len(types)
    codes = _type_codes(types)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    g = values.shape[0] if row_indices is None else row_indices.shape[0]
    if row_indices is not None:
        if row_indices.ndim != 1:
            raise ValueError(f"row_indices must be 1-D, got {tuple(row_indices.shape)}")
        _launch.check_operand("row_indices", row_indices, (g,), values.device, torch.int64)
    _launch.check_operand("vmin", vmin, (g,), values.device)
    _launch.check_operand("vmax", vmax, (g,), values.device)
    _launch.check_operand("edges", edges, (g, num_bins + 1), values.device)
    _launch.check_operand("params", params, (g, 3 * t), values.device)
    if values.device.type == "cpu":
        rows = values if row_indices is None else values[row_indices]
        return fit_error_counts_plain(rows, vmin, vmax, edges, params, types, num_bins)
    _launch.check_contiguous(values)
    lib = _library()
    _launch.check_smem(lib.fitpdf_fit_error_smem_bytes(num_bins), num_bins)
    if row_indices is not None and g and bool(
            ((row_indices < 0) | (row_indices >= values.shape[0])).any()):
        raise IndexError(f"row_indices out of range for {values.shape[0]} rows")
    err = torch.empty((g, t), dtype=torch.float32, device=values.device)
    if g:
        rc = lib.fitpdf_fit_error_counts(
            values.data_ptr(), None if row_indices is None else row_indices.data_ptr(),
            vmin.data_ptr(), vmax.data_ptr(), edges.data_ptr(), params.data_ptr(),
            err.data_ptr(), g, values.shape[1], num_bins, t, codes,
            _launch.device_index(values.device), _launch.stream(values.device))
        _launch.raise_if_failed(lib, "fitpdf", rc, "fit_error_counts")
        fit_error_counts.launches += 1
        if row_indices is not None:
            fit_error_counts.row_index_launches += 1
    return err


fit_error_counts.launches = 0
# The launches that read their rows through ``row_indices`` (a subset of
# ``launches``): the grouping methods' device Select path.
fit_error_counts.row_index_launches = 0
