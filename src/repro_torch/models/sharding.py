"""Sharding rules: each parameter and cache tensor's placement on a mesh.

Port of ``repro.models.sharding``'s rules. TP over the ``model`` axis
(attention heads / ffn / experts / vocab), DP over ``data`` (+ ``pod``),
optional FSDP (large parameter dims also over ``data``). A placement is a
tuple with one entry a dimension: an axis name, a tuple of axis names, or
``None`` (replicated), as the reference's ``PartitionSpec``.

The reference stacks each pattern position's repeats (and the enc-dec's
encoder and decoder layers) into one leaf with a leading stack dimension;
the port keeps one tensor a layer (``models/transformer.py``). A port
tensor's placement is the reference's spec of the stacked leaf with the
stack dimension dropped: ``_rule`` runs on the stacked shape, so it sees
what the reference sees (a dim that does not divide a mesh axis is
replicated there).

``per_device_bytes`` is what one device holds under the placements. Placing
real DTensors (the reference's ``make_shardings``) comes with the
multi-device pieces of ROADMAP.md queue 1, item 18.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh

MODEL_AXIS = "model"
DATA_AXIS = "data"


def _rule(names: tuple[str, ...], shape: tuple[int, ...], cfg: ArchConfig, mesh_shape: dict) -> tuple:
    name = names[-1]
    in_moe = "moe" in names[:-1]
    msize = mesh_shape.get(MODEL_AXIS, 1)
    dsize = mesh_shape.get(DATA_AXIS, 1)

    def m(dim: int):  # model axis if divisible
        return MODEL_AXIS if shape[dim] % msize == 0 else None

    def f(dim: int):  # fsdp: data axis if enabled and divisible
        return DATA_AXIS if cfg.fsdp and shape[dim] % dsize == 0 else None

    def spec(base_rank: int, *axes) -> tuple:
        lead = len(shape) - base_rank
        return tuple([None] * lead + list(axes))

    if name == "embed":
        return (m(0), None)
    if name == "lm_head":
        return (None, m(1))
    if name == "wq":
        return spec(3, f(-3), m(-2), None)  # (d, H, hd)
    if name in ("wk", "wv"):
        return spec(3, f(-3), m(-2), None)  # (d, KV, hd); replicates if KV % m != 0
    if name == "wo":
        return spec(3, m(-3), None, f(-1))  # (H, hd, d)
    if name in ("w_gate", "w_in"):
        if in_moe:
            return spec(3, m(-3), f(-2), None)  # (E, d, ff): EP on experts
        return spec(2, f(-2), m(-1))  # (d, ff): TP on ff
    if name == "w_out":
        if in_moe:
            return spec(3, m(-3), None, f(-1))  # (E, ff, d)
        return spec(2, m(-2), f(-1))  # (ff, d)
    if name == "in_proj":
        return spec(2, f(-2), m(-1))  # (d, packed): TP on the packed dim
    if name == "out_proj":
        return spec(2, m(-2), f(-1))  # (d_inner, d)
    if name == "router":
        return spec(2, None, None)
    # conv / norms / scalars: replicate (tiny).
    return (None,) * len(shape)


def _stack_size(name: str, cfg: ArchConfig) -> int | None:
    """The reference's stack length of the leaf a port parameter is one
    slice of: the repeats for a layer after the prefix, the encoder's or
    decoder's depth for an enc-dec block; None for an unstacked leaf."""
    head, _, rest = name.partition(".")
    if head in ("encoder", "decoder"):
        return cfg.enc_layers if head == "encoder" else cfg.dec_layers
    if head == "layers" and int(rest.split(".")[0]) >= len(cfg.prefix):
        return cfg.num_repeats
    return None


def make_pspecs(cfg: ArchConfig, mesh: Mesh, model: torch.nn.Module) -> dict[str, tuple]:
    """``{parameter name: placement}`` for ``model`` (a ``Transformer`` or
    ``EncDec``, on any device: only shapes are read)."""
    out = {}
    for name, p in model.named_parameters():
        names, shape = tuple(name.split(".")), tuple(p.shape)
        stack = _stack_size(name, cfg)
        if stack is None:
            out[name] = _rule(names, shape, cfg, mesh.axis_sizes)
        else:
            out[name] = _rule(names, (stack,) + shape, cfg, mesh.axis_sizes)[1:]
    return out


def _batch_axes(mesh: Mesh):
    axes = tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
    return axes if len(axes) > 1 else axes[0]


def batch_pspec(mesh: Mesh) -> tuple:
    """Token batches shard over every non-model axis (pod x data)."""
    return (_batch_axes(mesh), None)


def cache_pspec(mesh: Mesh, seq_over_model: bool = True) -> tuple:
    """KV caches (B, S, KV, hd): batch over data axes; sequence over model
    (flash-decode-style partial-KV attention)."""
    return (_batch_axes(mesh), MODEL_AXIS if seq_over_model else None, None, None)


def cache_pspecs(mesh: Mesh, cache, batch: int):
    """Placements of a decode cache (``transformer.init_cache``'s list of
    per-layer dicts or ``encdec.init_cache``'s dict), the same structure
    with a placement at each tensor (leaf-name driven):

    * attention k/v  (..., B, S, KV, hd): batch over data axes (when it
      divides), sequence over model (flash-decode partial-KV attention).
    * ssm state      (..., B, H, N, P):   batch over data, heads over model.
    * ssm conv       (..., B, K-1, C):    batch over data, channels over model.
    * cross k/v      (..., B, M, KV, hd): like attention (memory over model).
    """
    msize = mesh.axis_sizes.get(MODEL_AXIS, 1)
    data_axes = tuple(a for a in mesh.axis_names if a != MODEL_AXIS)
    dprod = math.prod(mesh.axis_sizes[a] for a in data_axes)
    ba = _batch_axes(mesh) if batch % dprod == 0 else None

    def rule(leaf: str, shp) -> tuple:
        if leaf == "conv":
            ch = MODEL_AXIS if shp[-1] % msize == 0 else None
            return (None,) * (len(shp) - 3) + (ba, None, ch)
        if leaf == "state":
            hx = MODEL_AXIS if shp[-3] % msize == 0 else None
            return (None,) * (len(shp) - 4) + (ba, hx, None, None)
        # attention-like: (..., B, S, KV, hd)
        seq = MODEL_AXIS if shp[-3] % msize == 0 else None
        return (None,) * (len(shp) - 4) + (ba, seq, None, None)

    def walk(tree, leaf=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, leaf) for v in tree)
        return rule(leaf, tuple(tree.shape))

    return walk(cache)


def _shards(placement: tuple, mesh: Mesh) -> int:
    """How many pieces a tensor is cut into under ``placement``."""
    sizes, n = mesh.axis_sizes, 1
    for entry in placement:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                n *= sizes[axis]
    return n


def _pairs(tree, placements):
    """(tensor, placement) pairs of a tensor tree and its placements."""
    if isinstance(tree, torch.nn.Module):
        for name, p in tree.named_parameters():
            yield p, placements[name]
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, placements[k])
    elif isinstance(tree, (list, tuple)):
        for v, pl in zip(tree, placements, strict=True):
            yield from _pairs(v, pl)
    else:
        yield tree, placements


def per_device_bytes(model_or_cache, placements, mesh: Mesh) -> int:
    """Bytes one device holds of ``model_or_cache`` (a module with
    ``make_pspecs``'s placements, or a cache with ``cache_pspecs``'): each
    tensor's bytes over the number of pieces its placement cuts it into
    (a dimension that does not divide rounds up, as a shard does)."""
    total = 0
    for t, placement in _pairs(model_or_cache, placements):
        total += -(-t.numel() * t.element_size() // _shards(placement, mesh))
    return total
