"""Banded (sliding-window) causal attention for any S.

Port of ``repro.kernels.band_attn.ops``. The CUDA kernel masks the ragged
tail itself, so no padding is made. A CPU tensor gets the plain version
(``ref.banded_attention_ref``), a CUDA tensor the kernel (K5) or an
exception.

Under autograd (grad enabled and an input that requires it) the call goes
through ``BandedAttention``: the forward is the same kernel call; the
backward recomputes from the saved q, k, v through
``ref.block_local_attention`` and takes its autograd gradient
(``banded_attention_backward``). The reference has no backward kernel
either: its K5 carries no ``custom_vjp``, and ``jax.grad`` differentiates
the plain ``_block_local_attention``. The blocked form keeps the
backward at O(S * 2W) scores: 3.4 GB a float32 tensor at hymba-1.5b's
(4, 4,096, 25 heads, W 1,024), against 6.7 GB for the full S x S.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.band_attn.kernel import banded_attention_kernel
from repro_torch.kernels.band_attn.ref import block_local_attention
from repro_torch.runtime import trace


def banded_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                              grad: torch.Tensor):
    """(dq, dk, dv) for the output gradient ``grad``: autograd of the
    blocked plain form, recomputed from q, k, v."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = block_local_attention(q, k, v, window)
        return torch.autograd.grad(out, (q, k, v), grad)


class BandedAttention(torch.autograd.Function):
    """K5 forward, the blocked plain form's gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        ctx.save_for_backward(q, k, v)
        return banded_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(), window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with trace.span("band_bwd", phase="backward"):
            return (*banded_attention_backward(q, k, v, ctx.window, grad), None)


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, KV, hd) -> (B, S, H, hd) in q's type."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return BandedAttention.apply(q, k, v, window)
    return banded_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(), window)
