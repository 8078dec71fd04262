"""Encoder-decoder transformer of the serving path (the seamless-m4t-medium
backbone).

Port of ``repro.models.encdec``. As in the reference, the modality
frontend is a stub: the encoder takes precomputed frame embeddings (B,
S_enc, d_model); the decoder is a text decoder with cross-attention to the
encoder's output. The encoder's self-attention is
non-causal and rotates q and k; cross-attention rotates neither.

Entry points, as in ``models/transformer.py``:
  init_params(cfg, generator, device)               -> EncDec (random weights, on cuda
                                                       unless device says otherwise)
  encode(params, frames, cfg)                       -> (B, S_enc, d) memory
  forward(params, frames, tokens, cfg)              -> (B, S, V) f32 logits
  prefill(params, frames, tokens, cfg, max_len)     -> (last-position logits, caches)
  decode_step(params, token, caches, pos, cfg)      -> (logits, caches)
  loss_fn(params, frames, tokens, targets, cfg)     -> scalar CE, differentiable (the
                                                       encoder and decoder layers under
                                                       the config's remat)

The caches are the reference's layout: ``{"self": {"k", "v"}, "cross":
{"k", "v"}}``, each stacked over the decoder layers, (n, B, max_len, KV,
hd) and (n, B, S_enc, KV, hd). The cross K/V are computed once at prefill;
``decode_step`` writes each step's self K/V into its layer's slice in
place. The prefill takes both from the layer's own pass where the
reference projects them a second time: the same values.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, check_ported
from repro_torch.core.pipeline import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.models.transformer import _logits, _positions, _remat, cross_entropy


class EncBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp`` (the reference's ``_init_enc_block``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        self.ln1 = L.RMSNorm(d, dt, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(d, dt, device)
        self.mlp = L.MLP(cfg, device)


class DecBlock(nn.Module):
    """``ln1``, ``self_attn``, ``lnx``, ``cross_attn``, ``ln2``, ``mlp`` (the
    reference's ``_init_dec_block``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        self.ln1 = L.RMSNorm(d, dt, device)
        self.self_attn = L.Attention(cfg, device)
        self.lnx = L.RMSNorm(d, dt, device)
        self.cross_attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(d, dt, device)
        self.mlp = L.MLP(cfg, device)


class EncDec(nn.Module):
    """``embed`` (V, d), ``encoder`` (``cfg.enc_layers`` blocks), ``decoder``
    (``cfg.dec_layers``), ``enc_norm``, ``final_norm``, ``lm_head`` (d, V),
    uninitialised until ``init_params`` or
    ``interop.encdec_params_from_numpy`` fills them."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_ported(cfg)
        v, d, dt = cfg.padded_vocab, cfg.d_model, cfg.param_dtype
        self.embed = L.empty_param((v, d), dt, device)
        self.encoder = nn.ModuleList(EncBlock(cfg, device) for _ in range(cfg.enc_layers))
        self.decoder = nn.ModuleList(DecBlock(cfg, device) for _ in range(cfg.dec_layers))
        self.enc_norm = L.RMSNorm(d, dt, device)
        self.final_norm = L.RMSNorm(d, dt, device)
        self.lm_head = L.empty_param((d, v), dt, device)


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device: torch.device | str | None = None) -> EncDec:
    """Random weights with the reference's distributions (as
    ``transformer.init_params``), drawn from ``generator`` on ``device``
    (default ``cuda``; raises without a CUDA device unless the caller
    passes ``device="cpu"``)."""
    check_ported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = EncDec(cfg, device)
    L.dense_init_(model.embed, generator, scale=1.0)
    L.dense_init_(model.lm_head, generator)
    for mod in model.modules():
        if isinstance(mod, L.RMSNorm):
            mod.reset_parameters()
        elif isinstance(mod, (L.Attention, L.MLP)):
            mod.reset_parameters(generator)
    return model


def _enc_block(p: EncBlock, h: torch.Tensor, cfg: ArchConfig, positions) -> torch.Tensor:
    x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
    h = sh.as_rows(h + L.attention(p.attn, x, cfg=cfg, positions=positions, causal=False))
    return sh.as_rows(h + L.mlp(p.mlp, L.rmsnorm(p.ln2, h, cfg.norm_eps), cfg))


def _encode(params: EncDec, frames: torch.Tensor, cfg: ArchConfig, wrap=lambda fn: fn) -> torch.Tensor:
    """The encoder, each layer as ``wrap`` makes it (the remat policy in
    training)."""
    b, s, _ = frames.shape
    positions = _positions(b, s, frames.device)
    h = frames.to(cfg.compute_dtype)
    for p in params.encoder:
        h = wrap(functools.partial(_enc_block, p, cfg=cfg, positions=positions))(h)
    return L.rmsnorm(params.enc_norm, h, cfg.norm_eps)


@sh.serving
def encode(params: EncDec, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames (B, S_enc, d) stub embeddings -> the encoder's memory (B,
    S_enc, d) in the compute type."""
    return _encode(params, frames, cfg)


def _dec_block(p: DecBlock, h: torch.Tensor, memory: torch.Tensor, cfg: ArchConfig, positions):
    """One decoder layer over the whole sequence -> (h, self K, self V,
    cross K, cross V)."""
    x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
    a, sk, sv = L.attention(p.self_attn, x, cfg=cfg, positions=positions, return_kv=True)
    h = sh.as_rows(h + a)
    x = L.rmsnorm(p.lnx, h, cfg.norm_eps)
    a, ck, cv = L.attention(p.cross_attn, x, cfg=cfg, positions=positions, kv_x=memory,
                            causal=False, use_rope=False, return_kv=True)
    h = sh.as_rows(h + a)
    return sh.as_rows(h + L.mlp(p.mlp, L.rmsnorm(p.ln2, h, cfg.norm_eps), cfg)), sk, sv, ck, cv


def _forward(params: EncDec, frames: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig,
             wrap=lambda fn: fn) -> torch.Tensor:
    memory = _encode(params, frames, cfg, wrap)
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    h = sh.as_rows(sh.lookup(params, tokens).to(cfg.compute_dtype))
    for p in params.decoder:
        h = wrap(lambda h, p=p: _dec_block(p, h, memory, cfg, positions)[0])(h)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(params, h, cfg)


@sh.serving
def forward(params: EncDec, frames: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames (B, S_enc, d), tokens (B, S) -> (B, S, V) f32 logits (the
    decode oracle)."""
    return _forward(params, frames, tokens, cfg)


def loss_fn(params: EncDec, frames: torch.Tensor, tokens: torch.Tensor, targets: torch.Tensor,
            cfg: ArchConfig) -> torch.Tensor:
    """The CE of ``forward``'s logits, differentiable; every encoder and
    decoder layer under ``_remat`` (as the reference's scan bodies)."""
    return cross_entropy(_forward(params, frames, tokens, cfg, lambda fn: _remat(fn, cfg)), targets)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, mem_len: int, dtype=None,
               device=None) -> dict:
    """Zero caches in ``prefill``'s layout."""
    dtype = dtype or cfg.compute_dtype
    n, kv, hd = cfg.dec_layers, cfg.kv_heads, cfg.head_dim

    def zeros(length):
        return torch.zeros((n, batch, length, kv, hd), dtype=dtype, device=device)

    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(mem_len), "v": zeros(mem_len)}}


@sh.serving
def prefill(params: EncDec, frames: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Encode, then run the decoder over the prompt building the self and
    cross caches; returns (logits at the last position (B, V) f32, caches).
    ``max_len`` sizes the self caches for later ``decode_step`` writes
    (default: the prompt length)."""
    memory = encode(params, frames, cfg)
    b, s = tokens.shape
    pad = (0, 0, 0, 0, 0, (max_len or s) - s)
    positions = _positions(b, s, tokens.device)
    h = sh.as_rows(sh.lookup(params, tokens).to(cfg.compute_dtype))
    kv = {"sk": [], "sv": [], "ck": [], "cv": []}
    for p in params.decoder:
        h, sk, sv, ck, cv = _dec_block(p, h, memory, cfg, positions)
        kv["sk"].append(torch.nn.functional.pad(sk, pad))
        kv["sv"].append(torch.nn.functional.pad(sv, pad))
        kv["ck"].append(ck)
        kv["cv"].append(cv)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    st = {key: torch.stack(v) for key, v in kv.items()}
    caches = {"self": {"k": st["sk"], "v": st["sv"]}, "cross": {"k": st["ck"], "v": st["cv"]}}
    return _logits(params, h[:, -1], cfg), caches


@sh.serving
def decode_step(params: EncDec, token: torch.Tensor, caches: dict, pos: int,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """token (B,) int, pos int -> (logits (B, V) f32, caches): the self K/V
    written at ``pos`` in place, the cross K/V read as they are."""
    h = sh.as_rows(sh.lookup(params, token[:, None]).to(cfg.compute_dtype))  # (B, 1, d)
    self_c, cross_c = caches["self"], caches["cross"]
    for i, p in enumerate(params.decoder):
        x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
        y, _ = L.decode_attention(p.self_attn, x, {"k": self_c["k"][i], "v": self_c["v"][i]}, pos,
                                  cfg=cfg)
        h = sh.as_rows(h + y)
        x = L.rmsnorm(p.lnx, h, cfg.norm_eps)
        h = sh.as_rows(h + L.cross_decode_attention(
            p.cross_attn, x, {"k": cross_c["k"][i], "v": cross_c["v"][i]}, cfg=cfg))
        h = sh.as_rows(h + L.mlp(p.mlp, L.rmsnorm(p.ln2, h, cfg.norm_eps), cfg))
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(params, h[:, 0], cfg), caches
