"""Plain oracle for the fused fit kernels: the chained reference path
(one-hot histogram, materialized masses tensor), as ``repro`` has it."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import distributions as dists
from repro_torch.core import pdf_error as pe


def fit_errors_ref(
    values: torch.Tensor,
    moments: dists.Moments,
    params_all: torch.Tensor,
    types: Sequence[str],
    num_bins: int,
) -> torch.Tensor:
    """(..., n) + (..., T, 3) -> (..., T) Eq.-5 errors via the full chain:
    edges -> one-hot histogram -> (..., T, L) masses -> L1 reduction."""
    edges = pe.interval_edges(moments.vmin, moments.vmax, num_bins)
    freq = pe.histogram(values, moments.vmin, moments.vmax, num_bins)
    masses = pe.cdf_masses(types, params_all, edges)
    return pe.pdf_error_from_freq(freq, masses)
