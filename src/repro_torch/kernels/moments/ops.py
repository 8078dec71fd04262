"""Wrapper of the moments kernel over (..., n) windows.

Port of ``repro.kernels.moments.ops``. No row padding: the CUDA kernel
masks its own ragged edge.
"""

from __future__ import annotations

import torch

from repro_torch.core.distributions import Moments
from repro_torch.kernels.moments.kernel import moments_stats


def moments(values: torch.Tensor) -> Moments:
    """(..., n) -> Moments (mean, var, skew, kurt, vmin, vmax)."""
    shape = values.shape
    stats = moments_stats(values.reshape(-1, shape[-1]))
    fields = stats[:, :6].t().contiguous()  # one contiguous row per field
    return Moments(*(fields[i].reshape(shape[:-1]) for i in range(6)))
