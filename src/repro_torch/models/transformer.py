"""Decoder LM of the serving path: the dense, MoE, SSM, hybrid and VLM
families.

Port of ``repro.models.transformer`` for every mixer (``attn``, ``ssm``,
``hybrid``: attention and the SSD side by side, their normed outputs
averaged as Hymba does; ``cross_attn``: attention from the text to
``extras["memory"]``, the VLM's image patches) and every FFN (``dense``,
``moe``, ``moe_dense``: the MoE plus a parallel dense MLP, as arctic has it,
or ``none``). A model is ``cfg.prefix`` blocks followed by ``cfg.pattern``
repeated ``cfg.num_repeats`` times; the reference stacks each pattern
position's repeats and runs them under ``lax.scan``, the port keeps one
flat list of layers (layer ``len(prefix) + r * len(pattern) + j`` is repeat
r of pattern position j) and loops over it in Python.

Entry points:
  init_params(cfg, generator, device)            -> Transformer (random weights, on cuda
                                                    unless device says otherwise)
  forward(params, tokens, cfg, extras)           -> (B, S, V) f32 logits
  loss_fn(params, tokens, targets, cfg, extras)  -> scalar CE (+ MoE aux), differentiable
  prefill(params, tokens, cfg, extras, max_len)  -> (last-position logits, caches)
  decode_step(params, token, caches, pos, cfg)   -> (logits, caches)

Caches are one dict per layer, ``{"attn": {"k", "v"}, "ssm": {"state",
"conv"}, "cross": {"k", "v"}}`` with the keys of the layer's mixer, in the
reference's layouts (a ring of the window for sliding layers; the
memory's K/V for a cross layer, computed once at prefill and only read by
the decode steps); ``decode_step`` updates them in place. The reference's
prefill runs each layer's SSD and K/V projections a second time to build
the cache; the port keeps what the layer's own pass computed, the same
values. The serving entry points run under ``torch.inference_mode`` (on
DTensor parameters ``no_grad``: ``sharding.serving``);
``loss_fn`` runs with autograd, the layers after the prefix under the
config's ``remat`` policy (``_remat``), as the reference's scan body.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ArchConfig, BlockDef, check_ported
from repro_torch.core.pipeline import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import sharding as sh
from repro_torch.models import ssm as S
from repro_torch.runtime import trace


def _mask_padded_logits(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Vocab padding (pad_vocab_to_multiple) adds never-trained columns;
    mask them out of softmax/argmax."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab, logits, torch.full_like(logits, -1e30))


# -- per-block init/apply -------------------------------------------------------


class Block(nn.Module):
    """One layer (the reference's ``init_block``) under the reference's
    keys: ``ln1``; ``attn`` and/or ``ssm`` by mixer (``attn`` for
    ``cross_attn`` too), with ``norm_attn`` and ``norm_ssm`` for
    ``hybrid``; ``ln2`` unless ``ffn="none"``, then ``mlp`` (``dense``),
    ``moe`` (``moe``) or both (``moe_dense``)."""

    def __init__(self, bd: BlockDef, cfg: ArchConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, cfg.param_dtype
        if bd.mixer not in ("attn", "ssm", "hybrid", "cross_attn"):
            raise ValueError(bd.mixer)
        if bd.ffn not in ("dense", "moe", "moe_dense", "none"):
            raise ValueError(bd.ffn)
        self.ln1 = L.RMSNorm(d, dt, device)
        if bd.mixer in ("attn", "hybrid", "cross_attn"):
            self.attn = L.Attention(cfg, device)
        if bd.mixer in ("ssm", "hybrid"):
            self.ssm = S.SSD(cfg, device)
        if bd.mixer == "hybrid":
            self.norm_attn = L.RMSNorm(d, dt, device)
            self.norm_ssm = L.RMSNorm(d, dt, device)
        if bd.ffn != "none":
            self.ln2 = L.RMSNorm(d, dt, device)
        if bd.ffn in ("moe", "moe_dense"):
            self.moe = L.MoE(cfg, device)
        if bd.ffn in ("dense", "moe_dense"):
            self.mlp = L.MLP(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for mod in self.children():
            if isinstance(mod, L.RMSNorm):
                mod.reset_parameters()
            else:
                mod.reset_parameters(generator)


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


def _fuse(p: Block, a, m, cfg: ArchConfig) -> torch.Tensor:
    """The mixer's output from its attention (a) and SSD (m) outputs, the
    one that ran; both for ``hybrid``: Hymba's fusion, each path normed,
    then their mean."""
    if m is None:
        return a
    if a is None:
        return m
    return 0.5 * (L.rmsnorm(p.norm_attn, a, cfg.norm_eps) + L.rmsnorm(p.norm_ssm, m, cfg.norm_eps))


def _cross(p: Block, x: torch.Tensor, cfg: ArchConfig, positions, extras, return_kv=False):
    """Cross-attention to ``extras["memory"]`` (B, T, d): no mask, no RoPE."""
    return L.attention(p.attn, x, cfg=cfg, positions=positions, kv_x=extras["memory"],
                       causal=False, use_rope=False, return_kv=return_kv)


def _mixer(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig, positions,
           extras) -> torch.Tensor:
    x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
    if bd.mixer == "cross_attn":
        return _cross(p, x, cfg, positions, extras)
    a = m = None
    if bd.mixer in ("attn", "hybrid"):
        a = L.attention(p.attn, x, cfg=cfg, positions=positions, window=bd.window)
    if bd.mixer in ("ssm", "hybrid"):
        m = S.ssd(p.ssm, x, cfg)
    return _fuse(p, a, m, cfg)


def _with_ffn(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """h plus the layer's FFN of h (h itself when ``ffn="none"``): the MLP,
    the MoE, or for ``moe_dense`` the MoE plus the MLP. On DTensors the
    residual stream is kept whole across ``model`` after each sum
    (``sharding.as_rows``)."""
    h = sh.as_rows(h)
    if bd.ffn == "none":
        return h
    with trace.span("ffn"):
        x = L.rmsnorm(p.ln2, h, cfg.norm_eps)
        if bd.ffn == "dense":
            return sh.as_rows(h + L.mlp(p.mlp, x, cfg))
        f = L.moe(p.moe, x, cfg)
        if bd.ffn == "moe_dense":
            f = f + L.mlp(p.mlp, x, cfg)
        return sh.as_rows(h + f)


def apply_block(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig, positions,
                extras=None) -> torch.Tensor:
    return _with_ffn(bd, p, h + _mixer(bd, p, h, cfg, positions, extras), cfg)


# -- model init -------------------------------------------------------------------


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device: torch.device | str | None = None) -> Transformer:
    """Random weights with the reference's distributions (``_dense_init``:
    embed N(0, 1), each matrix N(0, 1/fan_in), ``wo`` N(0, 1/(H hd)),
    ``w_out`` N(0, 1/d_ff), norms zero; the SSD's and the MoE's as their
    ``reset_parameters`` say), drawn from ``generator`` on
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


@sh.serving
def forward(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig, extras=None) -> torch.Tensor:
    """tokens (B, S) -> (B, S, V) f32 logits (the decode oracle).
    ``extras["memory"]`` (B, T, d) is what cross-attention layers attend."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    h = sh.as_rows(sh.lookup(params, tokens).to(cfg.compute_dtype))
    for bd, p in zip(cfg.layer_defs(), params.layers):
        h = apply_block(bd, p, h, cfg, positions, extras)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(params, h, cfg)


# -- training -----------------------------------------------------------------------

_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default})


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the products' outputs that autograd records,
    recompute the rest (the reference's ``dots_with_no_batch_dims_saveable``).
    A product inside an ``autograd.Function``'s forward (grad off there,
    as in K5's plain version) is not recorded, so it is not kept."""
    if op in _MATMULS and torch.is_grad_enabled():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ArchConfig):
    """``fn`` under the config's rematerialisation policy: ``"full"`` keeps
    only its inputs and recomputes the rest in the backward (non-reentrant
    ``torch.utils.checkpoint``), ``"dots"`` keeps the matrix products'
    outputs too, ``"none"`` keeps everything. The values and gradients are
    the same; what moves is memory (``"full"`` is what lets hymba-1.5b
    train at 4 x 4,096 tokens on one 80 GB card) and the recompute."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls))
    raise ValueError(cfg.remat)


def _aux(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The layer's MoE load-balancing loss on the FFN's input (float32
    zero without a MoE)."""
    if bd.ffn not in ("moe", "moe_dense"):
        return torch.zeros((), dtype=torch.float32, device=h.device)
    return L.moe_aux_loss(p.moe, L.rmsnorm(p.ln2, h, cfg.norm_eps), cfg)


def _train_block(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig, positions,
                 extras=None, layer: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``apply_block`` that also returns the layer's aux loss; the span
    ``block`` of layer ``layer``."""
    with trace.span("block", layer=layer):
        h = h + _mixer(bd, p, h, cfg, positions, extras)
        return _with_ffn(bd, p, h, cfg), _aux(bd, p, h, cfg)


def _ce_terms(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Each token's logsumexp minus its target's logit. The vocabulary's
    dimension is named by its positive index: DTensor (torch 2.11) keeps a
    negative one unnormalised in a placement it builds."""
    v = logits.ndim - 1
    logits = sh.replicate_dim(logits, v)
    logz = torch.logsumexp(logits, dim=v)
    return logz - logits.gather(v, targets.unsqueeze(v).long()).squeeze(v)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The mean of ``_ce_terms`` (the reference's CE)."""
    return torch.mean(_ce_terms(logits, targets))


def loss_fn(params: Transformer, tokens: torch.Tensor, targets: torch.Tensor, cfg: ArchConfig,
            extras=None, aux_weight: float = 0.01) -> torch.Tensor:
    """tokens, targets (B, S) -> float32 scalar: the CE of the masked logits
    plus ``aux_weight`` times the layers' summed MoE aux loss over
    ``num_layers``. Differentiable; the layers after the prefix run under
    ``_remat`` (the reference rematerialises its scan body, not the
    prefix)."""
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    h = sh.as_rows(sh.lookup(params, tokens).to(cfg.compute_dtype))
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    n_pre = len(cfg.prefix)
    for i, (bd, p) in enumerate(zip(cfg.layer_defs(), params.layers)):
        fn = functools.partial(_train_block, bd, p, cfg=cfg, positions=positions, extras=extras,
                               layer=i)
        h, aux = (fn if i < n_pre else _remat(fn, cfg))(h)
        aux_total = aux_total + aux
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    h_rows = sh.rows_over_model(h, params.lm_head)
    if sh.split_over_model(h_rows):
        # A head whole over model: each model rank takes the CE of its own
        # rows with the whole head (its gradient a partial sum).
        tgt = sh.rows_over_model(targets, params.lm_head).to_local()
        ce = sh.local_rows(_ce_sum, params, h_rows, tgt, cfg, params=("lm_head",)).sum() / (b * s)
    else:
        ce = cross_entropy(_logits(params, h, cfg), targets)
    return ce + aux_weight * aux_total / max(cfg.num_layers, 1)


def _ce_sum(params: Transformer, h: torch.Tensor, targets: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """(1,): the summed CE of rows h (B, S, d) on plain tensors."""
    return torch.sum(_ce_terms(_logits(params, h, cfg), targets))[None]


# -- serving: prefill + decode --------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, device=None) -> list[dict]:
    """Zero caches in ``prefill``'s layout (``max_len`` >= every window; a
    cross layer's memory ``cfg.num_patches`` long)."""
    dtype = dtype or cfg.compute_dtype
    caches = []
    for bd in cfg.layer_defs():
        c = {}
        if bd.mixer in ("attn", "hybrid"):
            c["attn"] = L.init_attn_cache(cfg, batch, max_len, bd.window, dtype, device)
        if bd.mixer in ("ssm", "hybrid"):
            c["ssm"] = S.init_ssd_cache(cfg, batch, dtype, device)
        if bd.mixer == "cross_attn":
            shape = (batch, cfg.num_patches, cfg.kv_heads, cfg.head_dim)
            c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                          "v": torch.zeros(shape, dtype=dtype, device=device)}
        caches.append(c)
    return caches


def _attn_cache(k: torch.Tensor, v: torch.Tensor, window: int | None,
                max_len: int | None) -> dict[str, torch.Tensor]:
    """The decode cache from a prefill's keys and values (B, S, KV, hd),
    laid out by ``layers.cache_layout`` (the layout ``layers.own_cache``
    builds on each rank)."""
    length = window or max_len or k.shape[1]
    return {"k": L.cache_layout(k, window, length), "v": L.cache_layout(v, window, length)}


def _attention_with_cache(p: L.Attention, x: torch.Tensor, cfg: ArchConfig, positions,
                          window: int | None, max_len: int | None) -> tuple[torch.Tensor, dict]:
    """A self-attention layer's output and decode cache: the cache from
    the keys and values the attention computed (``_attn_cache``), or on
    DTensors whose K and V weights are whole over ``model`` while the
    query heads split there, built on each rank where the decode takes
    it (``layers.own_cache``), the attention then projecting only each
    rank's own KV heads from the weights ``own_cache`` gathered."""
    made = L.own_cache(p, x, cfg, positions, window, window or max_len or x.shape[1])
    if made is not None:
        cache, gathered = made
        return L.attention(gathered, x, cfg=cfg, positions=positions, window=window), cache
    a, k, v = L.attention(p, x, cfg=cfg, positions=positions, window=window, return_kv=True)
    return a, _attn_cache(k, v, window, max_len)


def _block_with_cache(bd: BlockDef, p: Block, h: torch.Tensor, cfg: ArchConfig, positions,
                      max_len: int | None, extras, layer: int | None = None) -> tuple[torch.Tensor, dict]:
    """``apply_block`` that also returns the layer's cache, built from the
    keys and values its attention computed (the memory's for a cross
    layer) and its SSD's final state and conv tail; the span ``block`` of
    layer ``layer``."""
    with trace.span("block", layer=layer):
        x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
        cache, a, m = {}, None, None
        if bd.mixer == "cross_attn":
            a, k, v = _cross(p, x, cfg, positions, extras, return_kv=True)
            cache["cross"] = {"k": k, "v": v}
        if bd.mixer in ("attn", "hybrid"):
            a, cache["attn"] = _attention_with_cache(p.attn, x, cfg, positions, bd.window, max_len)
        if bd.mixer in ("ssm", "hybrid"):
            m, (state, conv) = S.ssd(p.ssm, x, cfg, return_final_state=True)
            cache["ssm"] = {"state": state, "conv": conv}
        return _with_ffn(bd, p, h + _fuse(p, a, m, cfg), cfg), cache


@sh.serving
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ArchConfig, extras=None,
            max_len: int | None = None) -> tuple[torch.Tensor, list[dict]]:
    """Full-sequence pass building the decode cache; returns (logits at the
    last position (B, V) f32, caches). ``max_len`` sizes full-attention
    caches for later ``decode_step`` writes (default: the prompt length).
    On DTensors the attention and SSD caches leave placed as the decode
    steps take them (``sharding.place_caches``). Traced as a unit, the
    span ``prefill``."""
    with trace.span("prefill", unit=True, phase="forward"):
        b, s = tokens.shape
        positions = _positions(b, s, tokens.device)
        h = sh.as_rows(sh.lookup(params, tokens).to(cfg.compute_dtype))
        caches = []
        for i, (bd, p) in enumerate(zip(cfg.layer_defs(), params.layers)):
            h, c = _block_with_cache(bd, p, h, cfg, positions, max_len, extras, layer=i)
            caches.append(c)
        h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
        return _logits(params, h[:, -1], cfg), sh.place_caches(caches)


def _flash(bd: BlockDef, cfg: ArchConfig, extras) -> bool:
    """Whether layer ``bd`` decodes by flash decode: the reference's rule
    (``cfg.flash_decode``, an attention layer with no window, a mesh in
    ``extras``)."""
    return bool(cfg.flash_decode and bd.mixer == "attn" and bd.window is None
                and extras and "mesh" in extras)


def shard_decode_caches(cfg: ArchConfig, caches: list[dict], extras) -> list[dict]:
    """``caches`` (whole on every rank, as ``prefill`` leaves them) with
    each flash-decode layer's K/V placed on ``extras["mesh"]`` by
    ``sharding.cache_pspecs`` (batch over the data axes when it divides,
    sequence over ``model``), each rank keeping its block; the other
    layers' caches as they are. Without flash decode, ``caches``."""
    from repro_torch.launch.mesh import describe

    for bd, c in zip(cfg.layer_defs(), caches):
        if _flash(bd, cfg, extras):
            mesh = extras["mesh"]
            batch = c["attn"]["k"].shape[0]
            specs = sh.cache_pspecs(describe(mesh), c["attn"], batch)
            c["attn"] = {k: sh.place(t, sh.Sharding(mesh, sh.to_placements(specs[k], mesh)))
                         for k, t in c["attn"].items()}
    return caches


@sh.serving
def decode_step(params: Transformer, token: torch.Tensor, caches: list[dict], pos: int,
                cfg: ArchConfig, extras=None) -> tuple[torch.Tensor, list[dict]]:
    """token (B,) int, pos int -> (logits (B, V) f32, caches, updated in
    place). A cross layer reads the memory's K/V from its cache. With
    ``cfg.flash_decode`` and a ``DeviceMesh`` in ``extras["mesh"]``
    (``extras["batch_axes"]``, default ``("data",)``, the axes the batch
    is split over), attention layers without a window decode by
    ``flash_decode_attention`` against caches that ``shard_decode_caches``
    placed; without a mesh they take the plain path, as the reference's."""
    h = sh.as_rows(sh.lookup(params, token[:, None]).to(cfg.compute_dtype))  # (B, 1, d)
    for bd, p, c in zip(cfg.layer_defs(), params.layers, caches):
        x = L.rmsnorm(p.ln1, h, cfg.norm_eps)
        a = m = None
        if bd.mixer == "cross_attn":
            a = L.cross_decode_attention(p.attn, x, c["cross"], cfg=cfg)
        if _flash(bd, cfg, extras):
            a, _ = L.flash_decode_attention(p.attn, x, c["attn"], pos, cfg=cfg, mesh=extras["mesh"],
                                            batch_axes=extras.get("batch_axes", ("data",)))
        elif bd.mixer in ("attn", "hybrid"):
            a, _ = L.decode_attention(p.attn, x, c["attn"], pos, cfg=cfg, window=bd.window)
        if bd.mixer in ("ssm", "hybrid"):
            m, _ = S.ssd_decode(p.ssm, x, c["ssm"], cfg)
        h = _with_ffn(bd, p, h + _fuse(p, a, m, cfg), cfg)
    h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
    return _logits(params, h[:, 0], cfg), caches


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
