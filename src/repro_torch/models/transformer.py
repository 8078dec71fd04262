"""Decoder LM of the serving path: the dense, attention-only family.

Port of ``repro.models.transformer`` for ``attn`` mixers and ``dense``
FFNs. A model is ``cfg.prefix`` blocks followed by ``cfg.pattern`` repeated
``cfg.num_repeats`` times; the reference stacks each pattern position's
repeats and runs them under ``lax.scan``, the port keeps one flat list of
layers (layer ``len(prefix) + r * len(pattern) + j`` is repeat r of pattern
position j) and loops over it in Python.

Entry points:
  init_params(cfg, generator, device)      -> Transformer (random weights, on cuda
                                              unless device says otherwise)
  forward(params, tokens, cfg)             -> (B, S, V) f32 logits
  prefill(params, tokens, cfg, max_len)    -> (last-position logits, caches)
  decode_step(params, token, caches, pos)  -> (logits, caches)

Caches are one dict per layer, ``{"attn": {"k", "v"}}``, in the reference's
layouts (a ring of the window for sliding layers); ``decode_step`` updates
them in place. Everything runs under ``torch.inference_mode``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig, BlockDef, check_ported
from repro_torch.core.pipeline import resolve_device
from repro_torch.models import layers as L


def _mask_padded_logits(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Vocab padding (pad_vocab_to_multiple) adds never-trained columns;
    mask them out of softmax/argmax."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits, torch.full_like(logits, -1e30))


# -- per-block init/apply -------------------------------------------------------


class Block(nn.Module):
    """One layer (the reference's ``init_block``): ``ln1``, ``attn``,
    ``ln2``, ``mlp``, the reference's keys."""

    def __init__(self, bd: BlockDef, cfg: ArchConfig, device=None):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, cfg.param_dtype, device)
        self.attn = L.Attention(cfg, device)
        self.ln2 = L.RMSNorm(cfg.d_model, cfg.param_dtype, device)
        self.mlp = L.MLP(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.ln1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.ln2.reset_parameters()
        self.mlp.reset_parameters(generator)


class Transformer(nn.Module):
    """``embed`` (V, d), ``final_norm``, ``lm_head`` (d, V) and ``layers``,
    uninitialised (``torch.empty``) until ``init_params`` or
    ``interop.lm_params_from_numpy`` fills them."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        check_ported(cfg)
        v, d, dt = cfg.padded_vocab, cfg.d_model, cfg.param_dtype
        self.embed = L.empty_param((v, d), dt, device)
        self.final_norm = L.RMSNorm(d, dt, device)
        self.lm_head = L.empty_param((d, v), dt, device)
        self.layers = nn.ModuleList(Block(bd, cfg, device) for bd in cfg.layer_defs())


def _mixer(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig, positions) -> torch.Tensor:
    x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
    return L.attention(p.attn, x, cfg=cfg, positions=positions, window=bd.window)


def _ffn(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = L.rmsnorm(p.ln2, h, cfg.norm_eps)
    return L.mlp(p.mlp, x, cfg)


def apply_block(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig, positions) -> torch.Tensor:
    h = h + _mixer(bd, p, h, cfg, positions)
    return h + _ffn(bd, p, h, cfg)


# -- model init -------------------------------------------------------------------


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device: torch.device | str | None = None) -> Transformer:
    """Random weights with the reference's distributions (``_dense_init``:
    embed N(0, 1), each matrix N(0, 1/fan_in), ``wo`` N(0, 1/(H hd)),
    ``w_out`` N(0, 1/d_ff), norms zero), drawn from ``generator`` on
    ``device`` (default ``cuda``; raises without a CUDA device unless the
    caller passes ``device="cpu"``). The same distributions as the
    reference, not the same bits: carry the reference's own weights with
    ``interop.lm_params_from_numpy``."""
    check_ported(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = Transformer(cfg, device)
    L.dense_init_(model.embed, generator, scale=1.0)
    model.final_norm.reset_parameters()
    L.dense_init_(model.lm_head, generator)
    for blk in model.layers:
        blk.reset_parameters(generator)
    return model


# -- forward ----------------------------------------------------------------------


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _logits(params: Transformer, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    cdt = cfg.compute_dtype
    return _mask_padded_logits((h.to(cdt) @ params.lm_head.to(cdt)).float(), cfg)


@torch.inference_mode()
def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """tokens (B, S) -> (B, S, V) f32 logits (the decode oracle)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    h = params.embed[tokens].to(cfg.compute_dtype)
    for bd, p in zip(cfg.layer_defs(), params.layers):
        h = apply_block(bd, p, h, cfg, positions)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(params, h, cfg)


# -- serving: prefill + decode --------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None) -> list[dict]:
    """Zero caches in ``prefill``'s layout (``max_len`` >= every window)."""
    dtype = dtype or cfg.compute_dtype
    return [{"attn": L.init_attn_cache(cfg, batch, max_len, bd.window, dtype, device)}
            for bd in cfg.layer_defs()]


def _block_with_cache(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig, positions,
                      max_len: int | None) -> tuple[torch.Tensor, dict]:
    """``apply_block`` that also returns the layer's cache, built from the
    keys and values its attention computed."""
    s = h.shape[1]
    x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
    y, k, v = L.attention(p.attn, x, cfg=cfg, positions=positions, window=bd.window,
                          return_kv=True)
    w = bd.window
    if w:
        # Ring layout: position p lives at slot p % w. The last min(s, w)
        # positions are a contiguous run, so a roll (s >= w) or
        # right-padding (s < w) produces the ring.
        cov = min(s, w)
        ks_, vs_ = k[:, -cov:], v[:, -cov:]
        if s >= w:
            ks_ = torch.roll(ks_, s % w, dims=1)
            vs_ = torch.roll(vs_, s % w, dims=1)
        else:
            ks_ = torch.nn.functional.pad(ks_, (0, 0, 0, 0, 0, w - s))
            vs_ = torch.nn.functional.pad(vs_, (0, 0, 0, 0, 0, w - s))
        cache = {"attn": {"k": ks_, "v": vs_}}
    else:
        pad = (max_len or s) - s
        cache = {"attn": {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
                          "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}}
    h = h + y
    return h + _ffn(bd, p, h, cfg), cache


@torch.inference_mode()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig,
            max_len: int | None = None) -> tuple[torch.Tensor, list[dict]]:
    """Full-sequence pass building the decode cache; returns (logits at the
    last position (B, V) f32, caches). ``max_len`` sizes full-attention
    caches for later ``decode_step`` writes (default: the prompt length)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    h = params.embed[tokens].to(cfg.compute_dtype)
    caches = []
    for bd, p in zip(cfg.layer_defs(), params.layers):
        h, c = _block_with_cache(bd, p, h, cfg, positions, max_len)
        caches.append(c)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(params, h[:, -1], cfg), caches


@torch.inference_mode()
def decode_step(params: Transformer, token: torch.Tensor, caches: list[dict], pos: int,
                cfg: ArchConfig) -> tuple[torch.Tensor, list[dict]]:
    """token (B,) int, pos int -> (logits (B, V) f32, caches, updated in place)."""
    h = params.embed[token[:, None]].to(cfg.compute_dtype)  # (B, 1, d)
    new = []
    for bd, p, c in zip(cfg.layer_defs(), params.layers, caches):
        x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
        y, c2 = L.decode_attention(p.attn, x, c["attn"], pos, cfg=cfg, window=bd.window)
        h = h + y
        h = h + _ffn(bd, p, h, cfg)
        new.append({**c, "attn": c2})
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(params, h[:, 0], cfg), new


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
