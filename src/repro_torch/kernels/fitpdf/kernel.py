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

NUM_STATS = 8  # mean, var(unbiased), skew, kurt, min, max, (2 pad lanes)
_EPS = 1e-12
# The kernels' type codes index this tuple (csrc/fitpdf.cu: cdf_eval).
_TYPE_CODES = {name: i for i, name in enumerate(dists.TYPES_10)}
_MAX_TYPES = 16  # four bits per type code in one 64-bit word
_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block gets without opting in

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    """Build (first use only) and bind ``csrc/fitpdf.cu``."""
    global _lib
    if _lib is None:
        from repro_torch.kernels._build import library

        lib = library("fitpdf")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fitpdf_moments_edges_stats.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
        lib.fitpdf_moments_edges_stats.restype = i32
        lib.fitpdf_fit_error_counts.argtypes = [
            vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, ctypes.c_ulonglong, i32, vp]
        lib.fitpdf_fit_error_counts.restype = i32
        lib.fitpdf_fit_error_smem_bytes.argtypes = [i32]
        lib.fitpdf_fit_error_smem_bytes.restype = ctypes.c_size_t
        lib.fitpdf_error_string.argtypes = [i32]
        lib.fitpdf_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_if_failed(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.fitpdf_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_values(values: torch.Tensor) -> None:
    if values.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {values.dtype}")
    if values.ndim != 2 or values.shape[1] < 1:
        raise ValueError(f"values must be (P, n) with n >= 1, got {tuple(values.shape)}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"values on unsupported device {values.device}")
    if values.shape[0] >= 2**31 or values.shape[1] >= 2**31:
        raise ValueError(f"values shape {tuple(values.shape)} exceeds int32 extents")


def _check_operand(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, values on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# K1: moments_edges_stats
# ---------------------------------------------------------------------------


def moments_edges_stats_plain(values: torch.Tensor, num_bins: int):
    """Plain PyTorch version of K1: the shifted power sums of the reference
    kernel (one full-row sum per power), then its finalize, line by line."""
    p, n = values.shape
    shift = values[:, :1]
    d = values - shift
    d2 = d * d
    d3 = d2 * d
    s1, s2, s3, s4 = d.sum(1), d2.sum(1), d3.sum(1), (d3 * d).sum(1)
    mn, mx = torch.amin(values, dim=1), torch.amax(values, dim=1)

    nf = float(n)
    md = s1 / nf  # mean of shifted values
    e2, e3, e4 = s2 / nf, s3 / nf, s4 / nf
    mdsq = md * md
    m2 = torch.clamp(e2 - mdsq, min=0.0)
    m3 = e3 - 3.0 * md * e2 + 2.0 * (md * mdsq)
    m4 = e4 - 4.0 * md * e3 + 6.0 * md * md * e2 - 3.0 * (mdsq * mdsq)
    mean = shift[:, 0] + md
    var = m2 * nf / max(nf - 1.0, 1.0)
    sig = torch.sqrt(torch.clamp(m2, min=_EPS))
    skew = m3 / (sig * (sig * sig))
    m2c = torch.clamp(m2, min=_EPS)
    kurt = m4 / (m2c * m2c) - 3.0
    zero = torch.zeros_like(mean)
    stats = torch.stack([mean, var, skew, kurt, mn, mx, zero, zero], dim=1)
    return stats, pe.interval_edges(mn, mx, num_bins)


def moments_edges_stats(values: torch.Tensor, num_bins: int):
    """values (P, n) f32 -> (stats (P, 8), edges (P, L+1)) f32."""
    _check_values(values)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    if values.device.type == "cpu":
        return moments_edges_stats_plain(values, num_bins)
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    p, n = values.shape
    stats = torch.empty((p, NUM_STATS), dtype=torch.float32, device=values.device)
    edges = torch.empty((p, num_bins + 1), dtype=torch.float32, device=values.device)
    if p:
        lib = _library()
        rc = lib.fitpdf_moments_edges_stats(
            values.data_ptr(), stats.data_ptr(), edges.data_ptr(),
            p, n, num_bins, values.device.index or 0, _stream(values.device))
        _raise_if_failed(lib, rc, "moments_edges_stats")
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


def fit_error_counts(values, vmin, vmax, edges, params,
                     types: Sequence[str], num_bins: int) -> torch.Tensor:
    """values (P, n), vmin/vmax (P,), edges (P, L+1), params (P, 3T) f32
    -> Eq.-5 errors (P, T) f32."""
    _check_values(values)
    p, n = values.shape
    t = len(types)
    codes = _type_codes(types)
    if num_bins < 1:
        raise ValueError(f"num_bins must be >= 1, got {num_bins}")
    _check_operand("vmin", vmin, (p,), values.device)
    _check_operand("vmax", vmax, (p,), values.device)
    _check_operand("edges", edges, (p, num_bins + 1), values.device)
    _check_operand("params", params, (p, 3 * t), values.device)
    if values.device.type == "cpu":
        return fit_error_counts_plain(values, vmin, vmax, edges, params, types, num_bins)
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    lib = _library()
    smem = lib.fitpdf_fit_error_smem_bytes(num_bins)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"num_bins={num_bins} needs {smem} B of shared memory per block, "
            f"more than the kernel's {_SMEM_LIMIT} B")
    err = torch.empty((p, t), dtype=torch.float32, device=values.device)
    if p:
        rc = lib.fitpdf_fit_error_counts(
            values.data_ptr(), vmin.data_ptr(), vmax.data_ptr(), edges.data_ptr(),
            params.data_ptr(), err.data_ptr(), p, n, num_bins, t, codes,
            values.device.index or 0, _stream(values.device))
        _raise_if_failed(lib, rc, "fit_error_counts")
        fit_error_counts.launches += 1
    return err


fit_error_counts.launches = 0
