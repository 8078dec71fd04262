"""Plain PyTorch version of the banded attention kernel (K5): full masked
attention over the S x S scores (small inputs, or a check on the card).

It computes what the kernel computes: f32 scores and softmax, an f32
weighted sum, and one cast to q's type at the end. (The reference package's
oracle ``repro/kernels/band_attn/ref.py`` casts the softmax weights to q's
type before the weighted sum; in f32 the two are the same.)
"""

from __future__ import annotations

import torch


def banded_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int) -> torch.Tensor:
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
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
