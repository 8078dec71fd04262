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


def block_local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: int) -> torch.Tensor:
    """The same function in the reference's training form
    (``repro/models/layers.py::_block_local_attention``): queries in blocks
    of W, each block against the previous and its own key block, so
    O(S * 2W) scores instead of O(S^2). Scores and softmax in float32, the
    weights rounded to q's type before the weighted sum (where K5 rounds
    them). Differentiable; K5's backward is this function's autograd
    gradient."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g, w = h // kvh, window
    pad = (-s) % w
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    nb = (s + pad) // w
    qb = q.reshape(b, nb, w, kvh, g, hd)
    kb = k.reshape(b, nb, w, kvh, hd)
    vb = v.reshape(b, nb, w, kvh, hd)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1), kb], 2)  # (b, nb, 2w, kvh, hd)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1), vb], 2)
    # In place: the einsum's backward saves its inputs, not its output.
    scores = torch.einsum("bnikgd,bnjkd->bnkgij", qb, k2).float()
    scores.mul_(hd**-0.5)
    qi = torch.arange(w, device=q.device)[:, None]
    kj = torch.arange(2 * w, device=q.device)[None, :]
    ok = (kj > qi) & (kj <= qi + w)  # (w, 2w) window + causal band
    first = (torch.arange(nb, device=q.device)[:, None, None] > 0) | (kj >= w)[None]  # block 0 has no previous
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    neg = torch.full((), -1e30, dtype=torch.float32, device=q.device)
    mask = torch.where(ok[None], zero, neg) + torch.where(first, zero, neg)  # (nb, w, 2w)
    scores.add_(mask[None, :, None, None])
    wts = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    out = torch.einsum("bnkgij,bnjkd->bnikgd", wts, v2).reshape(b, nb * w, h, hd)
    return out[:, :s]
