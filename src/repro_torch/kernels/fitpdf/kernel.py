"""The fused fit path's two kernels: CUDA wrappers beside their plain versions.

``moments_edges_stats`` (K1)
    Replaces the Pallas TPU kernel
    ``repro/kernels/fitpdf/kernel.py::moments_edges_stats``. values (P, n)
    f32 -> stats (P, 8) [mean, var, skew, kurt, vmin, vmax, 0, 0] and the
    Eq.-5 edges (P, L+1). Bound on an H100: bytes. It must read the window
    once, P*n*4 B (25.1 MB for a Set1 window of 6,275 x 1,000, about 7.5 us
    at 3.35 TB/s); its arithmetic is ~10 float operations per value. Design
    (``csrc/row_moments.cuh``, shared with K3): a warp a row, four rows a
    block, every 16-byte load of a lane's share of the row in flight at
    once, the TPU's sequential observation-chunk grid axis turned into that
    loop; each lane's shifted power sums of its values in float, min and
    max in registers, then the lanes' sums in double through a fixed
    shuffle tree instead of atomics, so the result is bitwise reproducible
    and within a rounding or two of exact sums. Which lane adds a value, and
    in what order, depends on its index and n alone, so a row's stats do
    not depend on where the row lies (aligned rows read float4, others the
    same groups as scalars). The warp writes the edges.

``fit_error_counts`` (K2)
    Replaces the Pallas TPU kernel
    ``repro/kernels/fitpdf/kernel.py::fit_error_counts``. values (P, n),
    vmin/vmax (P,), edges (P, L+1), params (P, 3T) -> Eq.-5 errors (P, T).
    Bound: bytes, the same P*n*4 B read once, at T = 4; at T = 10 the
    float64 incomplete gamma and beta add work that the card runs as long
    instruction sequences. Design (``csrc/fitpdf.cu``, ``csrc/row_hist.cuh``):
    one block of 128 threads a row, every 16-byte load of the row in flight
    at once, the row's histogram as integer counters in shared memory
    (integer atomic adds are exact and order-free); then, with the counts
    still there, each warp takes a type and its lanes a slice of the edges
    and bins: the CDF at the edges into shared memory, and sum |freq/n -
    mass| by lane and a fixed butterfly. Only (P, T) floats are written.
    The gamma and student_t CDFs are compiled only into the instantiation
    for the type sets that hold them. Any L: a block holds C bins at once (C
    int counters and four warps' C + 1 CDFs), C = L up to the most that
    leaves an SM room for ten blocks (``_fit_error_chunk``: 1,088 on an
    H100); above, one launch a chunk of that many bins, each reading the
    rows again, each lane's running sums carried between them in a scratch
    of G * T * 32 floats. A lane adds the same bins in the same order in
    either route, so the errors are bitwise equal across routes.

    ``row_indices`` (G,) int64 is the grouping methods' representative
    gather (``repro/kernels/fitpdf/ops.py:79-128``): output row r reads
    window row ``row_indices[r]`` while vmin, vmax, edges and params are
    already per representative. The kernel computes that address itself, so
    no gathered copy of the G rows is made; its bound is the G rows read.
    A row's result depends on that row alone, so the result is bitwise
    equal to a launch on ``values[row_indices]``. The range check of the
    indices costs a host synchronisation; device Select, whose indices are
    in range by construction, calls ``_fit_error_counts_in_range``, which
    skips it. The kernel never reads outside the window whatever it is
    given: an index outside gives a row of NaN.

Each wrapper dispatches on the tensor's device: a CPU tensor gets the plain
PyTorch version (``*_plain``, the same arithmetic, the CPU tests' path), a
CUDA tensor gets the kernel or an exception. Each counts its kernel
launches in ``<wrapper>.launches``, one a chunk of bins for K2 (the CPU
path counts nothing).
"""

from __future__ import annotations

import ctypes
import functools
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
            [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, ctypes.c_ulonglong, i32, vp, i32,
             vp], i32),
        "fitpdf_fit_error_chunk": ([i32, ctypes.POINTER(ctypes.c_int)], i32),
        "fitpdf_fit_error_attributes": ([i32, i32, i32, ctypes.POINTER(ctypes.c_int)], i32),
        "fitpdf_moments_edges_attributes": ([i32, ctypes.POINTER(ctypes.c_int)], i32),
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
    G = len(row_indices) with them (row r reads ``values[row_indices[r]]``).

    An index outside [0, P) raises ``IndexError``, which on a CUDA tensor
    costs one host synchronisation. Device Select, whose indices are in
    range by construction, calls ``_fit_error_counts_in_range`` instead."""
    if row_indices is not None and row_indices.numel() and bool(
            ((row_indices < 0) | (row_indices >= len(values))).any()):
        raise IndexError(f"row_indices out of range for {len(values)} rows")
    return _fit_error_counts_in_range(values, vmin, vmax, edges, params, types, num_bins,
                                      row_indices)


def _fit_error_counts_in_range(values, vmin, vmax, edges, params, types: Sequence[str],
                               num_bins: int, row_indices: torch.Tensor | None,
                               chunk: int = 0) -> torch.Tensor:
    """``fit_error_counts`` with no range check of ``row_indices``, for
    indices that lie in [0, P) by construction (``compact_representatives``):
    no host synchronisation. An index outside gives a row of NaN on either
    device; the kernel never reads outside the window. ``chunk`` other than
    0 sets the most bins a block holds at once instead of the card's
    ``_fit_error_chunk`` (a multiple of 32, or ``num_bins`` or more for one
    launch): the tests' way to compare the routes at one L."""
    _launch.check_values(values)
    t = len(types)
    codes = _type_codes(types)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    p = values.shape[0]
    g = p if row_indices is None else row_indices.shape[0]
    if row_indices is not None:
        if row_indices.ndim != 1:
            raise ValueError(f"row_indices must be 1-D, got {tuple(row_indices.shape)}")
        _launch.check_operand("row_indices", row_indices, (g,), values.device, torch.int64)
    _launch.check_operand("vmin", vmin, (g,), values.device)
    _launch.check_operand("vmax", vmax, (g,), values.device)
    _launch.check_operand("edges", edges, (g, num_bins + 1), values.device)
    _launch.check_operand("params", params, (g, 3 * t), values.device)
    if values.device.type == "cpu":
        if row_indices is None:
            return fit_error_counts_plain(values, vmin, vmax, edges, params, types, num_bins)
        inside = (row_indices >= 0) & (row_indices < p)
        safe = torch.where(inside, row_indices, 0)
        rows = values[safe] if p else values.new_zeros((g, values.shape[1]))
        err = fit_error_counts_plain(rows, vmin, vmax, edges, params, types, num_bins)
        return torch.where(inside[:, None], err, float("nan"))
    _launch.check_contiguous(values)
    err = torch.empty((g, t), dtype=torch.float32, device=values.device)
    if g:
        lib = _library()
        dev = _launch.device_index(values.device)
        chunk = chunk or _fit_error_chunk(dev)
        # One launch a chunk past `chunk` bins, each lane's running sums
        # between them. Freed on return, the scratch goes back to this
        # stream's pool, behind the launches that use it.
        partial = (torch.empty(g * t * 32, dtype=torch.float32, device=values.device)
                   if chunk < num_bins else None)
        rc = lib.fitpdf_fit_error_counts(
            values.data_ptr(), None if row_indices is None else row_indices.data_ptr(),
            vmin.data_ptr(), vmax.data_ptr(), edges.data_ptr(), params.data_ptr(),
            err.data_ptr(), g, p, values.shape[1], num_bins, t, codes, chunk,
            None if partial is None else partial.data_ptr(), dev, _launch.stream(values.device))
        _launch.raise_if_failed(lib, "fitpdf", rc, "fit_error_counts")
        launches = -(-num_bins // chunk)  # one a chunk of bins
        fit_error_counts.launches += launches
        if row_indices is not None:
            fit_error_counts.row_index_launches += launches
    return err


fit_error_counts.launches = 0
# The launches that read their rows through ``row_indices`` (a subset of
# ``launches``): the grouping methods' device Select path.
fit_error_counts.row_index_launches = 0


@functools.lru_cache(maxsize=None)
def _fit_error_chunk(device: int) -> int:
    """The most bins a K2 block holds at once on CUDA device ``device``: the
    largest multiple of 32 that leaves an SM's shared memory room for ten
    blocks (csrc/fitpdf.cu fit_error_chunk; 1,088 on an H100)."""
    lib = _library()
    out = ctypes.c_int()
    rc = lib.fitpdf_fit_error_chunk(device, ctypes.byref(out))
    _launch.raise_if_failed(lib, "fitpdf", rc, "fitpdf_fit_error_chunk")
    return out.value


def fit_error_attributes(types: Sequence[str], num_bins: int, device: int = 0) -> dict:
    """Registers a thread, local memory bytes a thread (nonzero if it
    spills), dynamic shared memory bytes a block and the chunk of bins a
    block counts at once of the K2 instantiation these types launch (with
    the float64 special functions if they hold gamma or student_t) at
    ``num_bins`` on CUDA device ``device``, from the CUDA runtime."""
    lib = _library()
    out = (ctypes.c_int * 4)()
    special = int(any(name in ("gamma", "student_t") for name in types))
    rc = lib.fitpdf_fit_error_attributes(special, num_bins, device, out)
    _launch.raise_if_failed(lib, "fitpdf", rc, "fitpdf_fit_error_attributes")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2], chunk=out[3])


def moments_edges_attributes(device: int = 0) -> dict:
    """Registers a thread, local memory bytes a thread (nonzero if it
    spills) and static shared memory bytes a block of K1's kernel on CUDA
    device ``device``, from the CUDA runtime."""
    lib = _library()
    out = (ctypes.c_int * 3)()
    rc = lib.fitpdf_moments_edges_attributes(device, out)
    _launch.raise_if_failed(lib, "fitpdf", rc, "fitpdf_moments_edges_attributes")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2])
