"""Wrapper of the histogram kernel over (..., n) windows.

Port of ``repro.kernels.hist.ops``. Its signature is
``pe.histogram_scatter``'s, so the fit chain takes it as ``histogram_fn``.
No row padding: the CUDA kernel masks its own ragged edge.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hist.kernel import hist_counts


def histogram(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
              num_bins: int) -> torch.Tensor:
    """(..., n) values + (...,) min/max -> (..., num_bins) counts."""
    shape = values.shape
    counts = hist_counts(values.reshape(-1, shape[-1]), vmin.reshape(-1).contiguous(),
                         vmax.reshape(-1).contiguous(), num_bins)
    return counts.reshape(shape[:-1] + (num_bins,)).to(values.dtype)
