"""Building blocks of the LM serving path: norm, RoPE, GQA attention (causal
/ sliding window, block-local through the banded kernel K5, cross), one-token
decode attention (self and cross), the gated MLP and the top-k MoE.

Port of ``repro.models.layers``, ``flash_decode_attention`` included (one
token against a KV cache split over a mesh's sequence axis, combined
with ``all_reduce``). Parameters live in ``nn.Module``s under the
reference's names (``wq``, ``q_norm.scale``, ...); they are created with
``requires_grad=False`` for serving, and the trainer
(``launch/train.py``) turns gradients on. Every function here is
differentiable: the in-place updates of the attention scores touch only
tensors no backward saves, and the banded path goes through
``banded_attention``'s ``autograd.Function`` when gradients are wanted.

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

import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.band_attn.ops import banded_attention
from repro_torch.models import sharding as sh
from repro_torch.runtime import trace


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def dense_init_(p: torch.Tensor, generator: torch.Generator, scale: float | None = None) -> None:
    """The reference's ``_dense_init`` distribution: normal times
    ``fan_in ** -0.5`` (``fan_in`` = first dimension) unless ``scale`` is
    given; drawn in float32, then cast to the parameter's type. For an
    expert stack (E, d, f) the first dimension is E, so the reference draws
    N(0, 1/E) there: its distribution, kept."""
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
    return scaled_rmsnorm(x, p.scale, eps)


def scaled_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, group=None,
                   width: int = 0) -> torch.Tensor:
    """RMS norm of x (..., w) with ``1 + scale``. With ``group``, x is a
    block of ``width`` columns split over that process group: the sum of
    squares is all-reduced over it and ``scale`` is the block's."""
    dt = x.dtype
    x = x.float()
    if group is None:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        import torch.distributed as dist

        var = torch.sum(x * x, dim=-1, keepdim=True)
        dist.all_reduce(var, group=group)
        var = var / width
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


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


def _kv(p: Attention, xkv: torch.Tensor, cdt):
    return (torch.einsum("btd,dhk->bthk", xkv, sh.fsdp_whole(p.wk).to(cdt)),
            torch.einsum("btd,dhk->bthk", xkv, sh.fsdp_whole(p.wv).to(cdt)))


def qkv_elems(d: int, count: int, cols: int) -> tuple[int, int]:
    """``sharding.moves_rows``' counts for the projections' exchange
    (``_project_rows``) over ``count`` ranks: a token moves its block of
    ``d`` (the all-to-all) and the partial sums of its q, k and v rows,
    ``cols`` = heads x hd of the rank's blocks (the reduce-scatter); the
    blocks are (d / count, cols)."""
    blk = d // count
    return blk + cols, blk * cols


def out_elems(d: int, count: int, cols: int) -> tuple[int, int]:
    """``sharding.moves_rows``' counts for the output projection's exchange
    (``_out_rows``): a token moves the ``cols`` (heads x hd) of its
    attention output that the rank's block of ``wo`` reads (the
    all-gather) and its block of ``d`` of the output (the all-to-all); the
    block is (cols, d / count)."""
    blk = d // count
    return cols + blk, cols * blk


def experts_elems(d: int, count: int, k: int, n: int, f: int) -> tuple[int, int]:
    """``sharding.moves_rows``' counts for the MoE's exchange
    (``_exchange_rows``): a token moves its row (``d``, the all-gather), its
    ``k`` choices' gate and input products and activation (3 k f) and
    their blocks of the output (k d / count); the blocks are the three
    stacks' of ``n`` experts, 3 n f d / count."""
    blk = d // count
    return d + 3 * k * f + k * blk, 3 * n * f * blk


def _rows_split(x, ws: tuple, d_dim: int):
    """The ``DataSplit`` over which the ranks move the rows of x (B, S,
    ...) for the weights ``ws`` (their ``d`` at ``d_dim``: 0 for
    ``wq``/``wk``/``wv``, 2 for ``wo``) rather than gather their FSDP
    blocks: every weight's ``d`` split over the one data dimension that
    splits x's rows (``sharding.fsdp_split``), and the rows the fewer
    bytes (``sharding.moves_rows`` of ``qkv_elems`` or ``out_elems``, from
    shapes every rank shares): a decode step's few tokens move, a
    prefill's many gather the blocks. None: gather the blocks; always
    under autograd, since the exchanges serve inference (the serving
    entry points run without it) and FSDP's backward reduce-scatters the
    gathered weights' gradients."""
    if torch.is_grad_enabled():
        return None
    split = sh.fsdp_split(x, ws[0], d_dim)
    if split is None or any(sh.fsdp_split(x, w, d_dim) != split for w in ws[1:]):
        return None
    if d_dim == 0:
        elems = qkv_elems(ws[0].shape[0], split.count, sum(w.to_local()[0].numel() for w in ws))
    else:
        elems = out_elems(ws[0].shape[2], split.count, _wo_cols(ws[0])[1])
    tokens = x.to_local().shape[0] * x.shape[1]
    return split if sh.moves_rows(tokens, *elems, x.dtype, ws[0].dtype) else None


def _project_rows(x, ws: tuple, split) -> tuple:
    """``einsum("bsd,dhk->bshk", x, w)`` for each weight of ``ws`` (d, h,
    hd) whose ``d`` is split over ``split`` (FSDP), the weights staying
    where they lie: an all-to-all gives each rank its block of ``d`` of
    every rank's rows (x's rows, (B, S, d) split over the split's
    dimension), each rank contracts that block with its own block of
    each weight, and one reduce-scatter of the partial sums gives each
    rank its own rows' products. Each result is a DTensor (B, S, h, hd)
    placed as x's rows, its heads split over ``model`` as the weight's
    are. The FLOPs are a rank's products over its own rows with ``d``
    whole; what moves is a token's block of ``d`` and its products
    (``qkv_elems``). Without autograd (``_rows_split``)."""
    mesh, rows = x.device_mesh, tuple(x.placements)
    xl = x.to_local()
    b, s, d = xl.shape
    t, n = b * s, split.count
    xs = split.all_to_all(xl.reshape(t, n, d // n).transpose(0, 1))  # (n, t, d / n)
    locs = [w.to_local() for w in ws]
    part = torch.cat([torch.einsum("jtd,dhk->jthk", xs, w.to(xl.dtype)) for w in locs], dim=2)
    own = split.reduce_scatter(part)  # (t, sum h, hd): the rank's rows, summed over d
    out, lo = [], 0
    for w, loc in zip(ws, locs):
        h = loc.shape[1]
        blk = own[:, lo:lo + h].reshape(b, s, h, loc.shape[2])
        lo += h
        pls = sh.split_over(rows, mesh, 2) if sh.model_split_dim(w) == 1 else rows
        out.append(sh.from_local(blk, mesh, pls, (x.shape[0], s, w.shape[1], w.shape[2])))
    return tuple(out)


def _wo_cols(wo) -> tuple[int, int]:
    """(first, count) of the columns of the attention output, its (heads,
    hd) flattened, that this rank's block of ``wo`` (H, hd, d) contracts:
    its own heads where ``model`` splits them; where it does not (heads
    that do not divide the axis) a block of the flattened H hd when that
    divides, the product then a partial sum over ``model`` as where the
    heads split; else every column."""
    h, hd = wo.to_local().shape[:2]
    mesh = wo.device_mesh
    m = mesh.size(mesh.mesh_dim_names.index(sh.MODEL_AXIS))
    if sh.model_split_dim(wo) is not None or m == 1 or (h * hd) % m:
        return 0, h * hd
    cols = h * hd // m
    return mesh.get_local_rank(sh.MODEL_AXIS) * cols, cols


def _out_rows(out, wo, split):
    """``einsum("bshk,hkd->bsd", out, wo)`` with ``wo`` (H, hd, d) whose
    output ``d`` is split over ``split`` (FSDP), the weight staying where
    it lies: the attention outputs of every rank's rows (B, S, H, hd),
    each rank's heads as ``wo`` splits them over ``model``, are
    all-gathered (only the columns ``_wo_cols`` gives this rank), each
    rank forms its block of ``d`` for all of them, and an all-to-all
    returns each rank its own rows' blocks. A DTensor (B, S, d) placed as
    the rows, a partial sum over ``model`` where the ranks of ``model``
    contract different columns (the row-parallel product). What moves is
    a token's columns and its output's block (``out_elems``)."""
    from torch.distributed.tensor import Partial

    mesh = out.device_mesh
    i = mesh.mesh_dim_names.index(sh.MODEL_AXIS)
    rows = tuple(out.placements)
    split_heads = sh.model_split_dim(wo) == 0
    ol = sh.local_as(out, mesh, sh.split_over(rows, mesh, 2) if split_heads else rows)
    b, s, h, hd = ol.shape
    first, cols = _wo_cols(wo)
    wl = wo.to_local().reshape(h * hd, -1)[first:first + cols]
    acts = split.all_gather(ol.reshape(b * s, h * hd)[:, first:first + cols])  # (n, t, cols)
    y = torch.matmul(acts, wl.to(ol.dtype))  # (n, t, d / n): every rank's rows
    own = split.all_to_all(y).permute(1, 0, 2).reshape(b, s, -1)  # block j from rank j
    partial = cols < h * hd or split_heads
    pls = rows[:i] + (Partial() if partial else rows[i],) + rows[i + 1:]
    return sh.from_local(own, mesh, pls, (out.shape[0], s, wo.shape[2]))


def _out_proj(p: Attention, out, cdt):
    """The attention's output projection, out (B, S, H, hd) -> (B, S, d):
    ``_out_rows`` where ``_rows_split`` says the rows move, else the
    row-parallel product on out's heads split as ``wo``'s
    (``sharding.heads_like``; DTensor gathering ``wo``'s FSDP blocks)."""
    split = _rows_split(out, (p.wo,), 2)
    if split is not None:
        return _out_rows(out, p.wo, split)
    out = sh.heads_like(out, p.wo)
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(cdt))


def _qk_normed(p: Attention, q: torch.Tensor, k: torch.Tensor):
    """q and k normed under ``qk_norm`` (the config gives the layer
    ``q_norm`` and ``k_norm``), else as they are."""
    if hasattr(p, "q_norm"):
        return rmsnorm(p.q_norm, q), rmsnorm(p.k_norm, k)
    return q, k


def _qkv(p: Attention, x: torch.Tensor, cdt, kv_x: torch.Tensor | None = None):
    """The query, key and value projections of x (B, S, d), each (B, S,
    heads, hd), normed under ``qk_norm``; keys and values from ``kv_x``
    when given. On DTensors whose weights' ``d`` is split over data (FSDP)
    the ranks move their rows where that is fewer bytes (``_rows_split``,
    ``_project_rows``); otherwise DTensor's products, FSDP's blocks
    gathered (``sharding.fsdp_whole``)."""
    xq = x.to(cdt)
    split = _rows_split(xq, (p.wq, p.wk, p.wv), 0) if kv_x is None else None
    if split is not None:
        q, k, v = _project_rows(xq, (p.wq, p.wk, p.wv), split)
    else:
        q = torch.einsum("bsd,dhk->bshk", xq, sh.fsdp_whole(p.wq).to(cdt))
        if kv_x is None:
            k, v = _kv(p, xq, cdt)
        else:
            # A DTensor memory (B, T, d): each rank projects its own rows with
            # whole wk and wv (DTensor cannot unflatten the batch-by-patches
            # product its einsum makes when the KV heads do not split).
            k, v = sh.local_rows(_kv, p, kv_x.to(cdt), cdt, params=("wk", "wv"))
    return (*_qk_normed(p, q, k), v)


def _own_qkv(p: Attention, x: torch.Tensor, cdt):
    """``_qkv`` of a self-attention core whose K and V weights are whole
    over ``model`` while its query heads split there
    (``sharding.kv_whole_under_split_queries``): each model rank projects
    only the KV heads its own query heads read, aligned with them
    (``sharding.own_kv_heads``), so neither a whole K/V product nor
    ``expand_kv`` runs."""
    xq = x.to(cdt)
    q = torch.einsum("bsd,dhk->bshk", xq, sh.fsdp_whole(p.wq).to(cdt))
    k, v = (sh.own_kv_heads(xq, sh.fsdp_whole(w), p.wq) for w in (p.wk, p.wv))
    return (*_qk_normed(p, q, k), v)


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions, causal: bool,
                      window: int | None, cdt) -> torch.Tensor:
    """The plain attention core: q (B, S, H, hd) against k, v (B, T, KV,
    hd) -> (B, S, H, hd), scores in float32 with the additive mask of
    ``positions`` (B, S) (none for cross-attention, ``positions=None``)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    scores = torch.einsum("bskgd,btkd->bkgst", q.reshape(b, s, kvh, g, hd), k).float()
    if scores.dtype == cdt and torch.is_grad_enabled():
        # float32 compute: .float() returned the product itself, which
        # remat="dots" keeps for the backward, so no write into it.
        scores = scores * hd**-0.5
    else:
        scores *= hd**-0.5
    if positions is not None:
        scores += _attn_scores_mask(positions, positions, causal, window)[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1).to(cdt)
    del scores
    return torch.einsum("bkgst,btkd->bskgd", w, v).reshape(b, s, h, hd)


def attention(p: Attention, x: torch.Tensor, *, cfg, positions: torch.Tensor,
              kv_x: torch.Tensor | None = None, causal: bool = True, window: int | None = None,
              use_rope: bool = True, return_kv: bool = False):
    """Full (prefill) attention. x (B, S, d) -> (B, S, d); with
    ``return_kv`` also the keys (after norm and RoPE) and values, each
    (B, S, KV, hd), that ``prefill`` keeps as its cache.

    ``kv_x`` (B, T, d) switches to cross-attention: keys and values are
    projected from it, no mask applies, and its keys are never rotated
    (the queries are unless ``use_rope`` is off, as every caller sets it
    for cross-attention). A windowed self-attention layer with
    ``cfg.block_local_attn`` and S > window goes through
    ``banded_attention`` (K5 on the card); the other layers take the plain
    masked path (``_masked_attention``). On DTensors either runs on each
    rank's rows and heads (``sharding.local_heads``), so its backward
    does too; where the KV heads do not split over ``model`` as the query
    heads do, each rank projects only the KV heads its query heads read
    (``_own_qkv``; with ``return_kv`` every KV head, which the caller's
    cache takes). The projections and the output projection move the
    rows instead of FSDP's blocks where ``_rows_split`` says so."""
    if kv_x is None and sh.split_over_model(x := sh.rows_over_model(x, p.wq)):
        # Heads whole over model: each model rank runs the whole block on its
        # own rows, the weights whole (their gradients partial sums).
        return sh.local_rows(_attention_rows, p, x, sh.rows_like(positions, x).to_local(), cfg, causal,
                             window, use_rope, return_kv)
    cdt = cfg.compute_dtype
    if kv_x is None and not return_kv and sh.kv_whole_under_split_queries(x, p.wk, p.wq):
        q, k, v = _own_qkv(p, x, cdt)
    else:
        q, k, v = _qkv(p, x, cdt, kv_x)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        if kv_x is None:
            k = rope(k, positions, cfg.rope_theta)

    if kv_x is None and window is not None and cfg.block_local_attn and q.shape[1] > window:
        with trace.span("attn.band"):
            out = sh.local_heads(banded_attention, q, k, v, window)
    else:
        rows = None if kv_x is not None else sh.rows_like(positions, q)
        # The span attn.global, its backward too: a self-attention layer without a window.
        sp = trace.span("attn.global") if kv_x is None and window is None else trace.OFF
        q, k, v = sp.grad_in(q, k, v)
        with sp:
            out = sh.local_heads(_masked_attention, q, k, v, rows, causal, window, cdt)
        out = sp.grad_out(out)
    y = _out_proj(p, out, cdt)
    return (y, k, v) if return_kv else y


def _attention_rows(p: Attention, x, positions, cfg, causal, window, use_rope, return_kv):
    return attention(p, x, cfg=cfg, positions=positions, causal=causal, window=window,
                     use_rope=use_rope, return_kv=return_kv)


def cache_layout(t: torch.Tensor, window: int | None, length: int) -> torch.Tensor:
    """t (B, S, ...) laid out along dimension 1 as a prefill of S tokens
    leaves its decode cache of ``length`` slots: a full layer's positions
    in order, zero-padded; a window's ring holds position p at slot p mod
    W, the last W positions rolled into place (S >= W) or the S < W
    positions zero-padded."""
    s = t.shape[1]
    if window:
        t = t[:, s - min(s, window):]
        if s >= window:
            return torch.roll(t, s % window, dims=1)
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, length - t.shape[1]))


def cache_slots(s: int, window: int | None, length: int) -> torch.Tensor:
    """(length,) int64: the position of a prompt of ``s`` tokens that each
    slot of a prefill's decode cache holds, -1 for an empty slot
    (``cache_layout`` of the positions)."""
    return cache_layout(torch.arange(1, s + 1)[None], window, length)[0] - 1


def own_cache(p: Attention, x, cfg, positions: torch.Tensor, window: int | None, length: int):
    """A prefill's decode cache {"k", "v"} (B, length, KV, hd) built where
    ``sharding.cache_pspecs`` places it, each rank its own block of the
    slots (``cache_slots``) with every KV head, from its own rows of x (B,
    S, d): the keys and values of the positions its slots hold, projected,
    normed and rotated as ``attention`` does, zero in an empty slot;
    nothing moves but FSDP's gather of wk and wv. For a prefill on
    DTensors whose K and V weights are whole over ``model`` while the
    query heads split there (``sharding.kv_whole_under_split_queries``):
    the attention then projects only each rank's own KV heads
    (``sharding.own_kv_heads``) and the cache, whose sequence ``model``
    splits, only its block, where every rank would otherwise project every
    KV head of every position. Returns (cache, the layer with wk and wv
    gathered, on which the attention reads them without a second
    gather), or None in any other case (the cache then comes from the
    attention's K/V)."""
    if not sh.kv_whole_under_split_queries(x, p.wk, p.wq):
        return None
    from repro_torch.launch.mesh import describe

    mesh, b = x.device_mesh, x.shape[0]
    shape = (b, length) + tuple(p.wk.shape[1:])
    spec = sh.cache_pspecs(describe(mesh), {"k": types.SimpleNamespace(shape=shape)}, b)["k"]
    pls = sh.to_placements(spec, mesh)
    i = mesh.mesh_dim_names.index(sh.MODEL_AXIS)
    if spec[1] != sh.MODEL_AXIS or pls[:i] + pls[i + 1:] != tuple(x.placements[:i] + x.placements[i + 1:]):
        return None
    cdt, per = cfg.compute_dtype, length // mesh.size(i)
    slots = cache_slots(x.shape[1], window, length)
    mine = slots[mesh.get_local_rank(sh.MODEL_AXIS) * per:][:per].to(x.device)
    here = mine.clamp(min=0)
    xl = x.to_local().to(cdt)[:, here]  # (b, per, d): the rows of the positions the slots hold
    pos = sh.rows_like(positions, x).to_local()[:, here]
    wk, wv = sh.fsdp_whole(p.wk), sh.fsdp_whole(p.wv)
    k, v = (torch.einsum("btd,dhk->bthk", xl, w.to_local().to(cdt)) for w in (wk, wv))
    if hasattr(p, "k_norm"):
        k = scaled_rmsnorm(k, sh.local_as(p.k_norm.scale, mesh))
    k = rope(k, pos, cfg.rope_theta)
    empty = (mine < 0)[None, :, None, None]
    cache = {name: sh.from_local(torch.where(empty, torch.zeros_like(t), t), mesh, pls, shape)
             for name, t in (("k", k), ("v", v))}
    gathered = types.SimpleNamespace(**{n: getattr(p, n) for n in ("wq", "wo", "q_norm", "k_norm")
                                        if hasattr(p, n)}, wk=wk, wv=wv)
    return cache, gathered


def init_attn_cache(cfg, batch: int, max_len: int, window: int | None, dtype,
                    device=None) -> dict[str, torch.Tensor]:
    w = min(window, max_len) if window else max_len
    shape = (batch, w, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_core(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, pos: int, window: int | None, cdt, group=None, idx: int = 0,
                 shards: int = 1) -> torch.Tensor:
    """One token against a KV cache, on plain tensors: q (b, 1, H, hd) and
    the new k, v (b, 1, KV, hd) -> (b, 1, H, hd) in the compute type.

    ``ck``/``cv`` (b, T, KV, hd) are block ``idx`` of ``shards`` equal
    blocks of the cache's sequence (the whole cache: idx 0 of 1). A full
    layer's slot is ``pos``, a sliding layer's ``pos mod W`` of its ring
    of W = T x shards slots; the block that owns the slot writes the new
    K/V there, in place. Validity is judged on global slot indices: a
    full layer's slots up to ``pos``, a ring slot whose age (slots behind
    the newest) is at most ``pos`` and under W. With ``group`` (the
    sequence's process group) each block's partial max, exp-sum and
    weighted V are combined by an ``all_reduce(MAX)`` and two
    ``all_reduce(SUM)`` into the exact softmax; without one the block is
    the whole cache and the softmax is the plain one. A full layer's
    ``pos`` past its last slot raises ``IndexError`` on every block."""
    shard_len = ck.shape[1]
    buf_len = shard_len * shards
    if not window and pos >= buf_len:
        raise IndexError(f"decode position {pos} is past the cache's {buf_len} slots")
    slot = pos % buf_len if window else pos
    if slot // shard_len == idx:
        ck[:, slot % shard_len] = k_new[:, 0].to(ck.dtype)
        cv[:, slot % shard_len] = v_new[:, 0].to(cv.dtype)

    b, _, h, hd = q.shape
    kvh = ck.shape[2]
    qr = q.reshape(b, 1, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qr, ck.to(cdt)).float()
    scores *= hd**-0.5
    slots = idx * shard_len + torch.arange(shard_len, device=q.device)
    if window:
        # Ring buffer: valid iff the slot holds a position in (pos-W, pos].
        age = torch.remainder(slot - slots, buf_len)  # 0 = current token
        valid = (age <= pos) & (age < buf_len)
    else:
        valid = slots <= pos
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    if group is None:
        w = torch.softmax(scores, dim=-1).to(cdt)
        return torch.einsum("bkgst,btkd->bskgd", w, cv.to(cdt)).reshape(b, 1, h, hd)
    import torch.distributed as dist

    m = torch.amax(scores, dim=-1, keepdim=True)  # (b, kv, g, 1, 1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(scores - m)
    den = torch.sum(w, dim=-1)  # (b, kv, g, 1)
    dist.all_reduce(den, op=dist.ReduceOp.SUM, group=group)
    num = torch.einsum("bkgst,btkd->bskgd", w.to(cdt), cv.to(cdt))  # (b, 1, kv, g, hd)
    dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
    den_r = den.permute(0, 3, 1, 2)[..., None]  # (b, 1, kv, g, 1)
    return (num / torch.clamp(den_r, min=1e-30)).reshape(b, 1, h, hd).to(cdt)


def _decode_on_shards(q, k_new, v_new, cache: dict, pos: int, window: int | None, cdt, rows,
                      seq_axis: str):
    """``_decode_core`` on each rank's block of a DTensor cache placed on its
    ``DeviceMesh`` with the batch over ``rows``' ``Shard(0)`` mesh
    dimensions and the sequence over ``seq_axis`` (or whole on each rank):
    q and the new K/V (DTensors, or plain tensors whole on every rank)
    brought to the rank's rows with every head, nothing of the cache
    moved. Returns the (B, 1, H, hd) output as a DTensor placed as
    ``rows``."""
    from torch.distributed.tensor import DTensor, Shard

    ck, cv = cache["k"], cache["v"]
    mesh = ck.device_mesh
    seq_dim = mesh.mesh_dim_names.index(seq_axis)
    split = ck.placements[seq_dim] == Shard(1)
    out = _decode_core(*(sh.local_as(t, mesh, rows) for t in (q, k_new, v_new)), ck.to_local(),
                       cv.to_local(), pos, window, cdt,
                       group=mesh.get_group(seq_axis) if split else None,
                       idx=mesh.get_local_rank(seq_axis) if split else 0,
                       shards=mesh.size(seq_dim) if split else 1)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def decode_attention(p: Attention, x: torch.Tensor, cache: dict[str, torch.Tensor], pos: int, *,
                     cfg, window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode. x (B, 1, d), pos int -> (B, 1, d), cache.

    Full layers write at ``pos``; sliding layers write at ``pos mod W``
    (ring) and mask out slots older than the window. The cache is updated
    in place and returned.

    On a DTensor cache (placed as ``sharding.cache_pspecs`` says: batch
    over the data axes, sequence over ``model``) each rank decodes its
    rows against its block of the sequence, as ``flash_decode_attention``
    does, full and ring layers alike: the cache never moves, only the
    token's q, k and v (every head of the rank's rows), and the softmax is
    combined by all-reduces over ``model`` (``_decode_core``). A cache
    placed otherwise raises (``sharding.cache_rows``). Where the
    attention's weights have their ``d`` split over data (FSDP) the data
    ranks exchange the token's rows instead of gathering the weights'
    blocks, when that moves fewer bytes (``_qkv``, ``_out_proj``)."""
    cdt = cfg.compute_dtype
    q, k, v = _qkv(p, x, cdt)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    if sh.is_dtensor(cache["k"]):
        out = _decode_on_shards(q, k, v, cache, pos, window, cdt, sh.cache_rows(cache["k"]),
                                sh.MODEL_AXIS)
    else:
        out = _decode_core(q, k, v, cache["k"], cache["v"], pos, window, cdt)
    return _out_proj(p, out, cdt), cache


def flash_decode_attention(p: Attention, x: torch.Tensor, cache: dict, pos: int, *, cfg, mesh,
                           batch_axes=("data",), seq_axis: str = "model") -> tuple[torch.Tensor, dict]:
    """Flash decode: one-token attention against a sequence-sharded KV cache
    without gathering it. x (B, 1, d), pos int -> (B, 1, d), cache.

    ``mesh`` is a ``DeviceMesh``; the cache's k and v are DTensors on it
    (B, S, KV, hd), the sequence split over ``seq_axis`` and the batch
    over ``batch_axes`` or replicated (``models.sharding.cache_pspec``;
    ``shard_decode_caches`` places a prefill's caches so). Each rank
    takes its rows of the batch (every head), computes partial (max,
    exp-sum, weighted V) statistics over its slice of the cache, and an
    ``all_reduce(MAX)`` and two ``all_reduce(SUM)`` over the sequence
    axis's group combine them into the exact softmax (``_decode_core``,
    which ``decode_attention`` runs on a DTensor cache too). The new K/V
    lands in the one shard that owns ``pos``, at ``pos % shard_len``, in
    place. ``x`` and the parameters may be plain tensors (whole on every
    rank; the output is gathered whole again) or DTensors. Every rank of
    the mesh must call it. No sliding window: ring caches stay on the
    plain path, as in the reference. Under FSDP the projections exchange
    the token's rows as ``decode_attention``'s do."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    cdt = cfg.compute_dtype
    q, k_new, v_new = _qkv(p, x, cdt)
    posv = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=cache["k"].device)
    q = rope(q, posv, cfg.rope_theta)
    k_new = rope(k_new, posv, cfg.rope_theta)

    ck = cache["k"]
    names = mesh.mesh_dim_names
    seq_dim = names.index(seq_axis)
    if mesh.size(seq_dim) > 1 and ck.placements[seq_dim] != Shard(1):
        raise ValueError(f"flash decode: the cache's sequence must be split over {seq_axis!r}, "
                         f"it is placed as {ck.placements}")
    # This rank's rows of the batch, every head, as the cache holds them.
    rows = tuple(Shard(0) if names[i] in batch_axes and pl == Shard(0) else Replicate()
                 for i, pl in enumerate(ck.placements))
    out = _decode_on_shards(q, k_new, v_new, cache, pos, None, cdt, rows, seq_axis)
    if not isinstance(x, DTensor):
        out = out.full_tensor() if any(isinstance(r, Shard) for r in rows) else out.to_local()
    return _out_proj(p, out, cdt), cache


def cross_decode_attention(p: Attention, x: torch.Tensor, cache: dict[str, torch.Tensor], *,
                           cfg) -> torch.Tensor:
    """One query token against a cross K/V computed once at prefill (the
    memory's keys and values, (B, T, KV, hd), unrotated). x (B, 1, d) ->
    (B, 1, d); no mask, no RoPE. Like the reference's decode, it applies no
    ``q_norm``: no config sets ``qk_norm`` with cross-attention. Under FSDP
    the query and output projections exchange the token's rows as
    ``decode_attention``'s do."""
    cdt = cfg.compute_dtype
    xq = x.to(cdt)
    split = _rows_split(xq, (p.wq,), 0)
    if split is not None:
        (q,) = _project_rows(xq, (p.wq,), split)
    else:
        q = torch.einsum("bsd,dhk->bshk", xq, p.wq.to(cdt))
    ck, cv = cache["k"].to(cdt), cache["v"].to(cdt)
    q = sh.replicate_dim(q, 2)
    b, _, h, hd = q.shape
    kvh = ck.shape[2]
    qr = q.reshape(b, 1, kvh, h // kvh, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qr, ck).float() * hd**-0.5
    w = torch.softmax(scores, dim=-1).to(cdt)
    out = torch.einsum("bkgst,btkd->bskgd", w, cv).reshape(b, 1, h, hd)
    return _out_proj(p, out, cdt)


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


# -- mixture of experts ---------------------------------------------------------


class MoE(nn.Module):
    """The reference's ``init_moe`` leaves: ``router`` (d, E), float32
    whatever ``cfg.param_dtype`` is; ``w_gate`` and ``w_in`` (E, d, f),
    ``w_out`` (E, f, d); with ``cfg.moe_shared_ff`` a ``shared`` MLP of that
    width."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
        dt = cfg.param_dtype
        self.router = empty_param((d, e), torch.float32, device)
        self.w_gate = empty_param((e, d, ff), dt, device)
        self.w_in = empty_param((e, d, ff), dt, device)
        self.w_out = empty_param((e, ff, d), dt, device)
        if cfg.moe_shared_ff:
            self.shared = MLP(cfg, device, d_ff=cfg.moe_shared_ff)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``init_moe``'s distributions: ``router`` N(0, 1/d); ``w_gate``
        and ``w_in`` N(0, 1/E) (``dense_init_``'s fan-in of a stack),
        ``w_out`` N(0, 1/f); each stack drawn one expert at a time, so the
        float32 draw is one expert's (an arctic-480b stack is 17.8 GB in
        float32)."""
        dense_init_(self.router, generator)
        e, ff = self.w_out.shape[:2]
        for w, scale in ((self.w_gate, e**-0.5), (self.w_in, e**-0.5), (self.w_out, ff**-0.5)):
            for slab in w:
                dense_init_(slab, generator, scale=scale)
        if hasattr(self, "shared"):
            self.shared.reset_parameters(generator)


def moe_capacity(tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float | None = None) -> int:
    """Slots an expert has: every token (drop-free) up to 256 tokens, else
    ``k T / E`` times 1.25, truncated as Python's ``int`` does; with
    ``capacity_factor`` that factor at any T."""
    if capacity_factor is None:
        if tokens <= 256:
            return tokens
        capacity_factor = 1.25
    return max(1, int(top_k * tokens / num_experts * capacity_factor))


def router_probs(p: MoE, xt: torch.Tensor) -> torch.Tensor:
    """The router's softmax over the experts, float32. xt (T, d) -> (T, E)."""
    return torch.softmax(xt.float() @ p.router, dim=-1)


def _route(p: MoE, xt: torch.Tensor, cfg, slab=None):
    """``moe_route`` on a rank's rows, plus ``slot``: each choice's position
    among the rank's own choices of its expert. Without a slab (every row
    here) ``pos`` is ``slot``; with one, ``pos`` adds the expert's choices
    on every earlier batch shard (``sharding.Slab.earlier``)."""
    e, k = cfg.num_experts, cfg.moe_top_k
    probs = router_probs(p, xt)  # (T, E)
    gates, experts = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = experts.reshape(-1)
    onehot = F.one_hot(flat, e)  # (T k, E)
    slot = (torch.cumsum(onehot, dim=0) - onehot).gather(1, flat[:, None])[:, 0]
    pos = slot if slab is None else slot + slab.earlier(onehot.sum(0))[flat]
    return gates, experts, slot, pos


def moe_route(p: MoE, xt: torch.Tensor, cfg):
    """Router, top-k and each choice's slot. xt (T, d) -> gates (T, k)
    float32 (renormalised over the k choices), experts (T, k) int64 in
    descending probability, and pos (T k,): the choice's position in its
    expert's buffer, counting the earlier choices of that expert in
    token-major order (token t's choice j is entry t k + j). On DTensors
    the rows stay split and the positions count over the whole batch, as
    the reference's jitted ``moe`` counts them (``_route`` on each rank's
    rows, ``sharding.local_experts``)."""
    gates, experts, _, pos = sh.local_experts(_route, p, xt, cfg, shared=("router",))
    return gates, experts, pos


_STACKS = ("w_gate", "w_in", "w_out")


def _exchange_rows(p: MoE, xt: torch.Tensor, kept: torch.Tensor, where, rows: int, k: int,
                   t_max: int, cdt, split) -> torch.Tensor:
    """The three expert products for a rank's kept choices when the slab's
    ``d`` is split over ``split`` (block ``index`` of ``count``) and the
    weights stay where they are: every rank's tokens (padded to ``t_max``)
    and kept choices are all-gathered, each rank contracts its block of
    ``d`` for all of them in one (E_slab, count R, d / count) buffer, a
    reduce-scatter gives each rank its own choices' gate and input
    products, their activation is all-gathered back, each rank forms its
    block of ``d`` of ``w_out``'s product for every choice, and an
    all-to-all returns each rank its own choices' blocks. Returns (t k, d)
    rows, a kept choice's output at its index (zero elsewhere). A rank's
    products have as many FLOPs as over its own R rows with ``d`` whole;
    what moves is t_max (d + 3 k f + k d / count) elements a rank."""
    t, d = xt.shape
    n, blk, f = p.w_gate.shape
    ranks, lo = split.count, split.index * blk
    code = torch.full((t_max * k,), -1, dtype=torch.int64, device=xt.device)
    code[kept] = where[0] * rows + where[1]
    codes = split.all_gather(code)  # (D, t_max k): expert-local row of each kept choice
    xs = split.all_gather(F.pad(xt, (0, 0, 0, t_max - t)))[..., lo:lo + blk]  # (D, t_max, blk)
    jj, cc = (codes >= 0).nonzero(as_tuple=True)
    e, r = codes[jj, cc] // rows, jj * rows + codes[jj, cc] % rows

    buf = xs.new_zeros((n, ranks * rows, blk))
    buf[e, r] = xs[jj, cc // k]
    gu = torch.cat([torch.bmm(buf, p.w_gate.to(cdt)), torch.bmm(buf, p.w_in.to(cdt))], dim=-1)
    part = gu.new_zeros((ranks, t_max * k, 2 * f))
    part[jj, cc] = gu[e, r]
    g, u = split.reduce_scatter(part).chunk(2, dim=-1)  # (t_max k, f) each: own choices, summed
    acts = split.all_gather(F.silu(g) * u)  # (D, t_max k, f)
    abuf = acts.new_zeros((n, ranks * rows, f))
    abuf[e, r] = acts[jj, cc]
    out = torch.bmm(abuf, p.w_out.to(cdt))  # (E_slab, D R, blk)
    back = out.new_zeros((ranks, t_max * k, blk))
    back[jj, cc] = out[e, r]
    own = split.all_to_all(back)  # (D, t_max k, blk): block j of own choices from rank j
    return own.permute(1, 0, 2).reshape(t_max * k, d)[:t * k]


def _experts(p: MoE, x: torch.Tensor, cfg, cap: int, slab=None) -> torch.Tensor:
    """The routed experts' sum for a rank's rows x (B, S, d) -> (B, S, d):
    its choices kept by the global capacity ``cap`` whose expert lies in
    its slab (``p``'s stacks: every expert without a slab). The kept
    choices are written into a (E_slab, R, d) buffer by index assignment
    (their (expert, slot) pairs are unique, so it holds what the
    reference's scatter-add into zeros holds, with no atomics); the three
    expert products are batched GEMMs over the slab; each kept choice reads
    its row back, scaled by its gate, and a token's k rows are summed (a
    choice not kept here adds zero). R is ``cap`` without a slab, the
    reference's buffer; with one the largest kept count among the slab's
    experts from these rows (data-dependent, as ``nonzero`` is; on meta the
    bound min(cap, T k), every choice kept). When the slab's ``d`` is split
    over data (``slab.split``, FSDP) the rank either moves its rows
    (``_exchange_rows``, R the largest over the split's ranks) or gathers
    the stacks' blocks, as ``sharding.moves_rows`` picks from
    ``experts_elems``."""
    cdt = cfg.compute_dtype
    b, s, d = x.shape
    t, k = b * s, cfg.moe_top_k
    xt = x.reshape(t, d).to(cdt)
    gates, experts, slot, pos = _route(p, xt, cfg, slab)
    flat = experts.reshape(-1)
    mine = pos < cap
    if slab is None:  # every row and every expert here: the reference's (E, C, d) buffer
        first, n, rows = 0, cfg.num_experts, cap
    else:
        first, n = slab.first, p.w_gate.shape[0]
        mine &= (flat >= first) & (flat < first + n)
        if xt.is_meta:
            rows = min(cap, t * k)
        else:
            rows = int(torch.where(mine, slot + 1, 0).max()) if t else 0
    kept = mine.nonzero()[:, 0]
    where = (flat[kept] - first, slot[kept])

    split = None if slab is None else slab.split
    w_gate, w_in, w_out = p.w_gate, p.w_in, p.w_out
    if split is not None:
        rows_max, t_max = (rows, t) if xt.is_meta else split.max_of(rows, t, device=x.device)
        elems = experts_elems(d, split.count, k, n, p.w_gate.shape[2])
        if sh.moves_rows(t_max, *elems, cdt, p.w_gate.dtype):
            gathered = _exchange_rows(p, xt, kept, where, rows_max, k, t_max, cdt, split)
            y = (gathered.reshape(t, k, d) * (gates * mine.reshape(t, k))[..., None].to(cdt)).sum(dim=1)
            return y.reshape(b, s, d)
        w_gate, w_in, w_out = split.whole(w_gate, 1), split.whole(w_in, 1), split.whole(w_out, 2)

    buf = torch.zeros((n, rows, d), dtype=cdt, device=x.device)
    buf[where] = xt[kept // k]
    g = F.silu(torch.bmm(buf, w_gate.to(cdt)))
    u = torch.bmm(buf, w_in.to(cdt))
    del buf
    out_buf = torch.bmm(g * u, w_out.to(cdt))  # (E_slab, R, d)
    del g, u

    gathered = torch.zeros((t * k, d), dtype=cdt, device=x.device)
    gathered[kept] = out_buf[where]
    y = (gathered.reshape(t, k, d) * (gates * mine.reshape(t, k))[..., None].to(cdt)).sum(dim=1)
    return y.reshape(b, s, d)


def moe(p: MoE, x: torch.Tensor, cfg, capacity_factor: float | None = None) -> torch.Tensor:
    """Top-k MoE with capacity-based dispatch, as the reference's ``moe``:
    a choice past its expert's capacity (``moe_capacity`` of all B S
    tokens) is dropped and adds nothing. x (B, S, d) -> (B, S, d); the
    experts by ``_experts``, then ``shared``'s MLP of x where the config
    has one.

    On DTensors each rank runs ``_experts`` on its own rows and its own
    slab of experts (``sharding.local_experts``: the stacks split over
    ``model``; under FSDP their ``d`` split over ``data``, the data ranks
    exchanging their rows' activations at decode sizes, ``_experts``), with
    the capacity and the positions of the whole batch; no rank routes
    another batch shard's tokens. The slabs' partial sums are reduced over
    ``model`` (one all-reduce). On a 1x1 mesh the computation is the
    one-device one."""
    b, s, _ = x.shape
    cap = moe_capacity(b * s, cfg.num_experts, cfg.moe_top_k, capacity_factor)
    y = sh.as_rows(sh.local_experts(_experts, p, x, cfg, cap, stacks=_STACKS, shared=("router",)))
    if hasattr(p, "shared"):
        y = y + mlp(p.shared, x, cfg)
    return y


def _aux_sums(p: MoE, x: torch.Tensor, cfg, slab=None) -> torch.Tensor:
    """(1, 2, E): the rows' count of top-k choices of each expert and their
    summed router probabilities."""
    probs = router_probs(p, x.reshape(-1, x.shape[-1]))
    _, idx = torch.topk(probs, cfg.moe_top_k, dim=-1, sorted=True)
    chosen = F.one_hot(idx, cfg.num_experts).float().sum(dim=(0, 1))
    return torch.stack([chosen, probs.sum(dim=0)])[None]


def moe_aux_loss(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E * sum_e f_e * p_e,
    f_e the share of the top-k choices that pick expert e (``topk`` ordered
    as ``lax.top_k``, as ``moe_route`` takes it) and p_e its mean router
    probability over all B S tokens. x (B, S, d) -> float32 scalar. On
    DTensors each rank sums its own rows and one all-reduce over the
    batch's mesh dimensions adds the sums."""
    t = x.shape[0] * x.shape[1]
    sums = sh.replicate_dim(sh.local_experts(_aux_sums, p, x, cfg, shared=("router",)).sum(0), 0)
    frac = sums[0] / (t * cfg.moe_top_k)
    return cfg.num_experts * torch.sum(frac * (sums[1] / t))
