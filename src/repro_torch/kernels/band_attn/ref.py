"""Plain PyTorch version of the banded attention kernel (K5): full masked
attention over the S x S scores (small inputs, or a check on the card).

By default it computes what the float32 kernel computes: f32 scores and
softmax, an f32 weighted sum, and one cast to q's type at the end. With
``round_weights`` it follows the reference package's oracle
(``repro/kernels/band_attn/ref.py``): the normalised weights are cast to
q's type and the weighted sum is taken in that type, which is where the
bf16 kernel rounds too (it feeds bf16 weights to the tensor cores). In f32
the two are the same.

``row_errors`` is the bf16 kernel's gate: per query row, the relative
2-norm distance from a float32 truth.
"""

from __future__ import annotations

import torch


def banded_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, round_weights: bool = False) -> torch.Tensor:
    """(B, S, H, hd) x (B, S, KV, hd) -> (B, S, H, hd); key j is valid for
    query i iff ``i - window < j <= i``."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qr = q.reshape(b, s, kvh, g, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qr, k.float())
    scores *= hd**-0.5
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(s, device=q.device)[None, :]
    ok = (kj <= qi) & (kj > qi - window)
    scores = scores.masked_fill_(~ok, -1e30)
    w = torch.softmax(scores, dim=-1)
    if round_weights:
        out = torch.einsum("bkgst,btkd->bskgd", w.to(q.dtype), v)
    else:
        out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def row_errors(got: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """``‖got − truth‖₂ / ‖truth‖₂`` for each query row (the last axis is
    hd), in float64. ``truth`` is the plain version on the float32 inputs,
    kept in float32."""
    got, truth = got.double(), truth.double()
    return (got - truth).norm(dim=-1) / truth.norm(dim=-1).clamp_min(1e-300)
