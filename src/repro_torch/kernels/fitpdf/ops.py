"""Wrappers of the fused fit kernels over (..., n) windows.

Port of ``repro.kernels.fitpdf.ops``. No row padding: the CUDA kernels mask
their own ragged edge. ``fit_errors`` recomputes the edges with
``pe.interval_edges`` (the reference formula) rather than chaining the
moments kernel's emitted edges, as the reference does: bit-identical edges
keep every backend's errors allclose where the incomplete gamma at large
shape amplifies an ulp of edge.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import pdf_error as pe
from repro_torch.core.distributions import Moments
from repro_torch.kernels.fitpdf.kernel import (
    _fit_error_counts_in_range,
    fit_error_counts,
    moments_edges_stats,
)


def moments_and_edges(values: torch.Tensor, num_bins: int) -> tuple[Moments, torch.Tensor]:
    """(..., n) -> (Moments, edges (..., L+1)): one pass over the data."""
    shape = values.shape
    lead = shape[:-1]
    stats, edges = moments_edges_stats(values.reshape(-1, shape[-1]), num_bins)
    fields = stats[:, :6].t().contiguous()  # one contiguous row per field
    m = Moments(*(fields[i].reshape(lead) for i in range(6)))
    return m, edges.reshape(lead + (num_bins + 1,))


def moments(values: torch.Tensor, num_bins: int = 64) -> Moments:
    """(..., n) -> Moments via the extended kernel (edges discarded)."""
    return moments_and_edges(values, num_bins)[0]


def fit_errors(
    values: torch.Tensor,
    moments: Moments,
    params_all: torch.Tensor,
    types: Sequence[str],
    num_bins: int,
    row_indices: torch.Tensor | None = None,
) -> torch.Tensor:
    """(..., n) values + (..., T, 3) params -> (..., T) Eq.-5 errors, in one
    launch: the histogram, CDF masses and Eq.-5 reduction never leave the
    kernel.

    ``row_indices`` (G,) int64 is the representative gather of the grouping
    methods' device Select: ``values`` stays the full window while
    ``moments`` and ``params_all`` are already per representative (leading
    shape (G,)); the kernel reads each representative's row of the window
    itself. Bitwise equal to passing ``values[row_indices]``. An index
    outside the window raises ``IndexError``."""
    return _fit_errors(fit_error_counts, values, moments, params_all, types, num_bins, row_indices)


def _fit_errors_in_range(values, moments, params_all, types, num_bins, row_indices):
    """``fit_errors`` through ``row_indices`` that lie in the window, as
    ``compact_representatives`` gives them: no range check, so no host
    synchronisation (``_fit_error_counts_in_range``)."""
    return _fit_errors(_fit_error_counts_in_range, values, moments, params_all, types, num_bins,
                       row_indices)


def _fit_errors(count, values, moments, params_all, types, num_bins, row_indices):
    t = len(types)
    edges = pe.interval_edges(moments.vmin, moments.vmax, num_bins)
    n = values.shape[-1]
    lead = values.shape[:-1] if row_indices is None else row_indices.shape
    errs = count(
        values.reshape(-1, n),
        moments.vmin.reshape(-1).contiguous(),
        moments.vmax.reshape(-1).contiguous(),
        edges.reshape(-1, num_bins + 1).contiguous(),
        params_all.reshape(-1, t * 3).contiguous(),
        tuple(types),
        num_bins,
        row_indices,
    )
    return errs.reshape(lead + (t,))
