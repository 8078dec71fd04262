"""Banded (sliding-window) causal attention for any S.

Port of ``repro.kernels.band_attn.ops``. The CUDA kernel masks the ragged
tail itself, so no padding is made. A CPU tensor gets the plain version
(``ref.banded_attention_ref``), a CUDA tensor the kernel (K5) or an
exception.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.band_attn.kernel import banded_attention_kernel


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd) in q's type."""
    return banded_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(), window)
