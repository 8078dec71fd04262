"""Building blocks of the LM serving path: norm, RoPE, GQA attention (causal
/ sliding window, block-local through the banded kernel K5), one-token
decode attention and the gated MLP.

Port of the dense parts of ``repro.models.layers``. Parameters live in
``nn.Module``s under the reference's names (``wq``, ``q_norm.scale``, ...)
and never take gradients: the port serves, it does not train yet.

Conventions, as in the reference:

* parameters are stored in ``cfg.param_dtype`` and cast to
  ``cfg.compute_dtype`` at use;
* scores are computed in the compute type, then taken to float32 and
  scaled; the softmax weights are cast back to the compute type before
  the weighted sum (on the plain paths; K5 keeps them in float32, as the
  TPU kernel does);
* attention caches: full layers use a (B, max_len, KV, hd) buffer indexed
  by position; sliding-window layers a ring of the window's size (position
  mod W). ``decode_attention`` writes the new key and value into the cache
  in place (the reference donates the buffers to the same effect).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.band_attn.ops import banded_attention


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def dense_init_(p: torch.Tensor, generator: torch.Generator, scale: float | None = None) -> None:
    """The reference's ``_dense_init`` distribution: normal times
    ``fan_in ** -0.5`` (``fan_in`` = first dimension) unless ``scale`` is
    given; drawn in float32, then cast to the parameter's type."""
    fan_in = p.shape[0] if p.ndim >= 2 else 1
    scale = scale if scale is not None else fan_in**-0.5
    draw = torch.randn(p.shape, generator=generator, device=p.device, dtype=torch.float32)
    p.copy_(draw.mul_(scale))


# -- normalization ------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = empty_param((d,), dtype, device)

    def reset_parameters(self) -> None:
        self.scale.zero_()


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p.scale.float())).to(dt)


# -- rotary embeddings ---------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, hd), positions (..., S) -> rotated x."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- attention ----------------------------------------------------------------


class Attention(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.q_heads, cfg.kv_heads, cfg.head_dim
        dt = cfg.param_dtype
        self.wq = empty_param((d, h, hd), dt, device)
        self.wk = empty_param((d, kv, hd), dt, device)
        self.wv = empty_param((d, kv, hd), dt, device)
        self.wo = empty_param((h, hd, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, dt, device)
            self.k_norm = RMSNorm(hd, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``init_attention``'s distributions."""
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, generator)
        h, hd = self.wo.shape[:2]
        dense_init_(self.wo, generator, scale=(h * hd) ** -0.5)
        if hasattr(self, "q_norm"):
            self.q_norm.reset_parameters()
            self.k_norm.reset_parameters()


def _attn_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                      window: int | None) -> torch.Tensor:
    """(..., S_q) x (..., S_k) -> (..., S_q, S_k) additive mask in f32."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(dq.shape, dk.shape), dtype=torch.bool, device=dq.device)
    if causal:
        ok &= dk <= dq
    if window is not None:
        ok &= dk > dq - window
    zero = torch.zeros((), dtype=torch.float32, device=dq.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def _qkv(p: Attention, x: torch.Tensor, cdt):
    xq = x.to(cdt)
    q = torch.einsum("bsd,dhk->bshk", xq, p.wq.to(cdt))
    k = torch.einsum("bsd,dhk->bshk", xq, p.wk.to(cdt))
    v = torch.einsum("bsd,dhk->bshk", xq, p.wv.to(cdt))
    if hasattr(p, "q_norm"):
        q = rmsnorm(p.q_norm, q)
        k = rmsnorm(p.k_norm, k)
    return q, k, v


def attention(p: Attention, x: torch.Tensor, *, cfg, positions: torch.Tensor,
              causal: bool = True, window: int | None = None, return_kv: bool = False):
    """Full (prefill) self-attention. x (B, S, d) -> (B, S, d); with
    ``return_kv`` also the keys (after norm and RoPE) and values, each
    (B, S, KV, hd), that ``prefill`` keeps as its cache.

    A windowed layer with ``cfg.block_local_attn`` and S > window goes
    through ``banded_attention`` (K5 on the card); the other layers take
    the plain masked path."""
    cdt = cfg.compute_dtype
    q, k, v = _qkv(p, x, cdt)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if window is not None and cfg.block_local_attn and s > window:
        out = banded_attention(q, k, v, window)
    else:
        g = h // kvh
        mask = _attn_scores_mask(positions, positions, causal, window)
        scores = torch.einsum("bskgd,btkd->bkgst", q.reshape(b, s, kvh, g, hd), k).float()
        scores *= hd**-0.5
        scores += mask[:, None, None, :, :]
        w = torch.softmax(scores, dim=-1).to(cdt)
        del scores
        out = torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(cdt))
    return (y, k, v) if return_kv else y


def init_attn_cache(cfg, batch: int, max_len: int, window: int | None, dtype,
                    device=None) -> dict[str, torch.Tensor]:
    w = min(window, max_len) if window else max_len
    shape = (batch, w, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: Attention, x: torch.Tensor, cache: dict[str, torch.Tensor], pos: int, *,
                     cfg, window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode. x (B, 1, d), pos int -> (B, 1, d), cache.

    Full layers write at ``pos``; sliding layers write at ``pos mod W``
    (ring) and mask out slots older than the window. The cache is updated
    in place and returned."""
    cdt = cfg.compute_dtype
    q, k, v = _qkv(p, x, cdt)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)

    ck, cv = cache["k"], cache["v"]
    buf_len = ck.shape[1]
    slot = pos % buf_len if window else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    b, _, h, hd = q.shape
    kvh = ck.shape[2]
    g = h // kvh
    qr = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qr, ck.to(cdt)).float()
    scores *= hd**-0.5

    slots = torch.arange(buf_len, device=x.device)
    if window:
        # Ring buffer: valid iff the slot holds a position in (pos-W, pos].
        age = torch.remainder(slot - slots, buf_len)  # 0 = current token
        valid = (age <= pos) & (age < buf_len)
    else:
        valid = slots <= pos
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1).to(cdt)
    out = torch.einsum("bkgst,btkd->bskgd", w, cv.to(cdt)).reshape(b, 1, h, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p.wo.to(cdt))
    return y, {"k": ck, "v": cv}


# -- gated MLP ----------------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, cfg, device=None, d_ff: int | None = None):
        super().__init__()
        d, ff = cfg.d_model, d_ff or cfg.d_ff
        dt = cfg.param_dtype
        self.w_gate = empty_param((d, ff), dt, device)
        self.w_in = empty_param((d, ff), dt, device)
        self.w_out = empty_param((ff, d), dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``init_mlp``'s distributions."""
        dense_init_(self.w_gate, generator)
        dense_init_(self.w_in, generator)
        dense_init_(self.w_out, generator, scale=self.w_out.shape[0] ** -0.5)


def mlp(p: MLP, x: torch.Tensor, cfg) -> torch.Tensor:
    cdt = cfg.compute_dtype
    x = x.to(cdt)
    g = F.silu(x @ p.w_gate.to(cdt))
    u = x @ p.w_in.to(cdt)
    return (g * u) @ p.w_out.to(cdt)
