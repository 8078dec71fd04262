"""Algorithm 3 (fit all candidate types, keep the least Eq.-5 error).

Port of ``repro.core.fitting`` (Algorithm 3; Algorithm 4's
``fit_predicted`` comes with the ML methods). Both modes run batched over a
window of points:

* ``mode='faithful'`` reproduces the paper's cost structure: the O(n)
  histogram pass runs once per candidate type.
* ``mode='fused'`` computes moments and the histogram once and shares them
  across all T types. Both modes return identical results.

The *fit backend* selects how the device work is implemented
(``FIT_BACKENDS``):

* ``reference`` — the plain PyTorch chain (scatter-add histogram).
* ``kernels``   — the chain with the moments kernel (K3,
  ``kernels/moments``) and the histogram kernel (K4, ``kernels/hist``)
  swapped in; the CDF masses stay PyTorch.
* ``fused``     — the two-launch path (``kernels/fitpdf``): K1 emits the
  moments, K2 streams the window once more and reduces histogram, CDF
  masses and Eq.-5 error in its epilogue. The default executor path.
  ``mode='faithful'`` keeps the per-type chain on every backend.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core import distributions as dists
from repro_torch.core import pdf_error as pe

_BIG = 1e30

FIT_BACKENDS = ("reference", "kernels", "fused")


class FitResult(NamedTuple):
    """Per-point PDF: distribution type index, its 3-slot params, Eq.-5 error."""

    type_idx: torch.Tensor  # (...,) int32 into the candidate `types` tuple
    params: torch.Tensor  # (..., 3)
    error: torch.Tensor  # (...,)


def _finite_or_big(err: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(err), err, _BIG)


def select_best(params_all: torch.Tensor, errs: torch.Tensor) -> FitResult:
    """(..., T, 3) params + (..., T) errors -> argmin-selected FitResult.
    Ties go to the first minimum, as ``jnp.argmin``'s do."""
    errs = _finite_or_big(errs)
    best = torch.argmin(errs, dim=-1)
    params = torch.take_along_dim(params_all, best[..., None, None], dim=-2)[..., 0, :]
    error = torch.take_along_dim(errs, best[..., None], dim=-1)[..., 0]
    return FitResult(best.to(torch.int32), params, error)


def compute_pdf_and_error(
    values: torch.Tensor,
    moments: dists.Moments,
    types: Sequence[str],
    num_bins: int,
    mode: str = "fused",
    histogram_fn=None,
) -> FitResult:
    """Algorithm 3 for a batch of points: values (..., n) -> FitResult (...,).
    ``histogram_fn(values, vmin, vmax, num_bins)`` defaults to the scatter-add
    histogram (the one-hot ``pe.histogram`` is the test oracle only)."""
    hist = histogram_fn or pe.histogram_scatter
    params_all = dists.fit_all(types, moments)  # (..., T, 3)
    edges = pe.interval_edges(moments.vmin, moments.vmax, num_bins)
    masses = pe.cdf_masses(types, params_all, edges)  # (..., T, L)

    if mode == "fused":
        freq = hist(values, moments.vmin, moments.vmax, num_bins)  # (..., L)
        errs = pe.pdf_error_from_freq(freq, masses)  # (..., T)
    elif mode == "faithful":
        # One histogram pass per candidate type — the paper's cost model (its
        # R subprocess re-reads the data for every candidate). Each pass reads
        # the data through its own unit scale, as the reference does.
        ones = torch.ones((len(types),), dtype=values.dtype, device=values.device)
        per_type = []
        for t in range(len(types)):
            freq_t = hist(values * ones[t], moments.vmin, moments.vmax, num_bins)
            per_type.append(pe.pdf_error_from_freq(freq_t, masses[..., t, :]))
        errs = torch.stack(per_type, dim=-1)
    else:
        raise ValueError(f"unknown mode {mode!r}")

    return select_best(params_all, errs)


def gather_rows(
    values: torch.Tensor, moments: dists.Moments, row_indices: torch.Tensor
) -> tuple[torch.Tensor, dists.Moments]:
    """Representative gather: the window's value rows and every moment
    field at ``row_indices``."""
    return values[row_indices], dists.Moments(*(f[row_indices] for f in moments))


def fit_all_rows(
    backend: "FitBackend",
    values: torch.Tensor,
    moments: dists.Moments,
    row_indices: torch.Tensor,
    types: Sequence[str],
    num_bins: int,
    mode: str = "fused",
) -> FitResult:
    """Algorithm 3 restricted to the ``row_indices`` rows of the window (the
    grouping representatives).

    On the fused backend (not faithful) the gather rides into K2 as its
    ``row_indices`` prologue: only the moments are gathered, and the kernel
    reads the representatives' rows of the full window. Other backends, and
    ``mode='faithful'``, gather with ``gather_rows`` and run their
    ``fit_all``. Both run the same per-row operations on the same rows, so
    the results are bitwise equal.

    ``row_indices`` must lie in [0, P), as ``compact_representatives``
    gives them: the fused backend does not check them on the host, so its
    launch costs no host synchronisation (an index outside gives NaN
    errors, never a read outside the window)."""
    if backend.name == "fused" and mode != "faithful":
        from repro_torch.kernels.fitpdf import ops as fops

        sub_mom = dists.Moments(*(f[row_indices] for f in moments))
        params_all = dists.fit_all(types, sub_mom)
        errs = fops._fit_errors_in_range(values, sub_mom, params_all, types, num_bins,
                                         row_indices)
        return select_best(params_all, errs)
    sub_vals, sub_mom = gather_rows(values, moments, row_indices)
    return backend.fit_all(sub_vals, sub_mom, types, num_bins, mode)


class FitBackend(NamedTuple):
    """One implementation of the per-window device work.

    ``moments`` maps values (..., n) -> Moments; ``histogram`` is the
    chain-path histogram_fn (also used by ``mode='faithful'``); ``fit_all``
    is Algorithm 3. ``fit_predicted`` (Algorithm 4) comes with the ML slice,
    ``merge_stats``/``merge_hist`` with streaming; they stay None here.
    """

    name: str
    moments: Callable[[torch.Tensor], dists.Moments]
    histogram: Callable[..., torch.Tensor]
    fit_all: Callable[..., FitResult]  # (values, moments, types, num_bins, mode)
    fit_predicted: Callable | None = None
    merge_stats: Callable | None = None
    merge_hist: Callable | None = None


@functools.lru_cache(maxsize=16)
def get_fit_backend(name: str = "fused", num_bins: int = 64) -> FitBackend:
    """Resolve a ``FIT_BACKENDS`` name; the kernel module is imported lazily
    so the reference backend never touches it."""
    if name == "reference":
        hist = pe.histogram_scatter

        def fit_all(values, moments, types, num_bins, mode="fused"):
            return compute_pdf_and_error(
                values, moments, types, num_bins, mode=mode, histogram_fn=hist
            )

        return FitBackend(name, dists.moments_from_values, hist, fit_all)

    if name == "kernels":
        from repro_torch.kernels.hist import ops as hops
        from repro_torch.kernels.moments import ops as mops

        def fit_all(values, moments, types, num_bins, mode="fused"):
            return compute_pdf_and_error(
                values, moments, types, num_bins, mode=mode,
                histogram_fn=hops.histogram,
            )

        return FitBackend(name, mops.moments, hops.histogram, fit_all)

    if name == "fused":
        from repro_torch.kernels.fitpdf import ops as fops

        def moments_fn(values):
            return fops.moments(values, num_bins)

        def fit_all(values, moments, types, num_bins, mode="fused"):
            if mode == "faithful":
                # The paper's per-type pass structure cannot be a single
                # fused launch; keep the chain (scatter histogram per type).
                return compute_pdf_and_error(
                    values, moments, types, num_bins, mode=mode,
                    histogram_fn=pe.histogram_scatter,
                )
            params_all = dists.fit_all(types, moments)
            errs = fops.fit_errors(values, moments, params_all, types, num_bins)
            return select_best(params_all, errs)

        return FitBackend(name, moments_fn, pe.histogram_scatter, fit_all)

    raise ValueError(f"fit_backend must be one of {FIT_BACKENDS}, got {name!r}")
