"""PDF error (Eq. 5) and slice-average error (Eq. 6).

Port of ``repro.core.pdf_error``. Eq. 5 compares the empirical interval
frequencies of the observation values against the fitted distribution's
CDF mass over the same L intervals, where the intervals evenly split
[min(V), max(V)]:

    e = sum_k | Freq_k / n  -  (F(edge_{k+1}) - F(edge_k)) |

``interval_edges`` keeps the reference's ``vmin + span*k/L`` order, so its
edges are bitwise equal to the reference's; the histograms count exactly.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import distributions as dists

_EPS = 1e-12


def interval_edges(vmin: torch.Tensor, vmax: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(...,) min/max -> (..., L+1) evenly spaced edges (Eq. 5's intervals)."""
    span = torch.clamp(vmax - vmin, min=_EPS)
    k = torch.arange(num_bins + 1, dtype=vmin.dtype, device=vmin.device)
    return vmin[..., None] + span[..., None] * k / num_bins


def _bin_index(values, vmin, vmax, num_bins: int) -> torch.Tensor:
    span = torch.clamp(vmax - vmin, min=_EPS)
    idx = torch.floor((values - vmin[..., None]) / span[..., None] * num_bins)
    return torch.clamp(idx, 0, num_bins - 1).to(torch.int64)


def histogram(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
              num_bins: int) -> torch.Tensor:
    """(..., n) values -> (..., L) counts over the Eq.-5 intervals.

    One-hot reference (the test oracle; it builds an (..., n, L) tensor).
    The last interval is closed: values == vmax land in bin L-1.
    """
    idx = _bin_index(values, vmin, vmax, num_bins)
    one_hot = torch.nn.functional.one_hot(idx, num_bins).to(values.dtype)
    return torch.sum(one_hot, dim=-2)


def histogram_scatter(
    values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor, num_bins: int
) -> torch.Tensor:
    """Scatter-add histogram: one O(P*n) pass instead of the one-hot
    intermediate. Adding ones is exact in float32 below 2^24 counts, so the
    result does not depend on the order of the adds."""
    p = values.shape[:-1]
    flat = values.reshape(-1, values.shape[-1])
    idx = _bin_index(flat, vmin.reshape(-1), vmax.reshape(-1), num_bins)
    out = torch.zeros((flat.shape[0], num_bins), dtype=values.dtype, device=values.device)
    out.scatter_add_(1, idx, torch.ones_like(flat))  # repro: allow[DET]: adds ones, exact below 2^24 counts
    return out.reshape(p + (num_bins,))


def cdf_masses(
    types: Sequence[str], params: torch.Tensor, edges: torch.Tensor
) -> torch.Tensor:
    """params (..., T, 3), edges (..., L+1) -> (..., T, L) interval masses.

    Mass outside [min, max] is not renormalized (as in the paper), so a
    badly fitted type pays for its tail mass through a larger Eq.-5 error.
    """
    cdf_at_edges = dists.cdf_all(types, params, edges)  # (..., T, L+1)
    return cdf_at_edges[..., 1:] - cdf_at_edges[..., :-1]


def pdf_error_from_freq(freq: torch.Tensor, masses: torch.Tensor) -> torch.Tensor:
    """freq (..., L) counts, masses (..., [T,] L) -> (..., [T]) Eq.-5 error."""
    n = torch.sum(freq, dim=-1)
    rel = freq / torch.clamp(n, min=1.0)[..., None]
    if masses.ndim == rel.ndim + 1:
        rel = rel[..., None, :]
    return torch.sum(torch.abs(rel - masses), dim=-1)


def pdf_error(
    values: torch.Tensor,
    params: torch.Tensor,
    types: Sequence[str],
    num_bins: int,
    moments: dists.Moments | None = None,
) -> torch.Tensor:
    """End-to-end Eq. 5 for all types: values (..., n), params (..., T, 3)
    -> (..., T). Reference path used by tests and the faithful mode."""
    if moments is None:
        vmin = torch.amin(values, dim=-1)
        vmax = torch.amax(values, dim=-1)
    else:
        vmin, vmax = moments.vmin, moments.vmax
    edges = interval_edges(vmin, vmax, num_bins)
    freq = histogram(values, vmin, vmax, num_bins)
    masses = cdf_masses(types, params, edges)
    return pdf_error_from_freq(freq, masses)


def slice_average_error(errors: torch.Tensor,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 6: average per-point error over a slice (optionally masked)."""
    if valid is None:
        return torch.mean(errors)
    w = valid.to(errors.dtype)
    return torch.sum(errors * w) / torch.clamp(torch.sum(w), min=1.0)
