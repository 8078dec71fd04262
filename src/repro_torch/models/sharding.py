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

``per_device_bytes`` is what one device holds under the placements.

On a real mesh (``launch.mesh.device_mesh``, a ``DeviceMesh`` whose
dimensions carry the axis names) a placement becomes DTensor placements,
one a mesh dimension (``to_placements``): an axis name on tensor dim d
is ``Shard(d)`` on that mesh dimension, a tuple of axes ``Shard(d)`` on
each of them (row-major, as the reference's ``P((a, b))``), and a mesh
dimension no entry names is ``Replicate()``. ``make_shardings`` gives
each parameter its ``Sharding`` (the reference's ``NamedSharding``),
``distribute_params`` places a module's parameters by them and
``shard_batch`` places a batch by ``batch_pspec``. A sharded program runs
the model's code on DTensors under ``implicit_replication`` (a plain
tensor made inside the model, a position or a mask, counts as
replicated). Where the model needs a layout of its own it asks here:
``as_rows`` (the residual stream between layers, its gradient reduced as
Megatron's), ``lookup`` (the embedding on a split vocabulary),
``rows_over_model`` (the LM head's tokens when its vocabulary is whole),
``replicate_dim`` (the loss's vocabulary), ``expand_kv`` (KV heads that
do not split as the query heads do), ``own_kv_heads`` (K and V projected
for a rank's own query heads where the KV heads do not divide
``model``), ``local_heads`` (the attention core and K5 on each rank's
heads, through ``local_map``), ``local_rows`` (the SSD and the cross K/V
projection on each rank's rows), ``local_experts`` (the MoE's dispatch on
each rank's rows and expert slab), ``fsdp_split`` and ``moves_rows`` (an
FSDP weight's data ranks exchanging their rows instead of gathering its
blocks, one rule for the MoE and the attention's decode), and for decode
``place_caches``, ``cache_rows`` and ``ssm_cache_rows`` (the caches
placed as ``cache_pspecs`` says, each rank stepping its own block).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh, flat_index

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


# -- placing tensors on a DeviceMesh ---------------------------------------------------


class Sharding(NamedTuple):
    """Where a tensor lives: a ``DeviceMesh`` and one DTensor placement a
    mesh dimension (the reference's ``NamedSharding``)."""

    mesh: object
    placements: tuple


def _dtensor_types():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    return DTensor, Replicate, Shard


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def to_placements(spec: tuple, dmesh) -> tuple:
    """A placement tuple (one entry a tensor dimension) -> DTensor
    placements on ``dmesh`` (one a mesh dimension). A mesh dimension of
    one device replicates: splitting over it keeps the whole tensor, and
    DTensor's view rules refuse some reshapes of a dimension marked split
    even there."""
    _, Replicate, Shard = _dtensor_types()
    names = dmesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None and dmesh.size(names.index(axis)) > 1:
                out[names.index(axis)] = Shard(dim)
    return tuple(out)


def make_shardings(cfg: ArchConfig, dmesh, model: torch.nn.Module) -> dict[str, Sharding]:
    """``{parameter name: Sharding}`` on ``dmesh`` by ``make_pspecs``."""
    from repro_torch.launch.mesh import describe

    specs = make_pspecs(cfg, describe(dmesh), model)
    return {n: Sharding(dmesh, to_placements(spec, dmesh)) for n, spec in specs.items()}


def place(t: torch.Tensor, sharding: Sharding):
    """``t`` (the whole tensor, the same on every rank) as a DTensor: each
    rank keeps its own block, and nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)


@torch.no_grad()
def distribute_params(cfg: ArchConfig, dmesh, model: torch.nn.Module) -> torch.nn.Module:
    """Replaces every parameter of ``model`` (the same weights on every
    rank) by a DTensor parameter placed by ``make_shardings``, in place;
    returns ``model``."""
    shardings = make_shardings(cfg, dmesh, model)
    for mod_name, mod in model.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{mod_name}.{name}" if mod_name else name
            mod._parameters[name] = torch.nn.Parameter(place(p.detach(), shardings[full]),
                                                       requires_grad=p.requires_grad)
    return model


def batch_sharding(dmesh, ndim: int, dim: int = 0) -> Sharding:
    """A batch tensor's ``Sharding``: dimension ``dim`` (the batch; 1 under
    gradient accumulation, whose micro-batches lead) over every non-model
    axis (``batch_pspec``), the rest replicated."""
    from repro_torch.launch.mesh import describe

    spec = [None] * ndim
    spec[dim] = batch_pspec(describe(dmesh))[0]
    return Sharding(dmesh, to_placements(tuple(spec), dmesh))


def shard_batch(batch: dict, dmesh, dim: int = 0) -> dict:
    """Every tensor of ``batch`` (the whole global batch on every rank)
    placed by ``batch_sharding``."""
    return {k: place(v, batch_sharding(dmesh, v.ndim, dim)) for k, v in batch.items()}


def _rows(placements) -> tuple:
    """Placements with the batch (dimension 0) split as they split it and
    every other dimension whole."""
    _, Replicate, Shard = _dtensor_types()
    return tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in placements)


def as_rows(t):
    """``t`` with its batch split as it is over the data axes and every
    other dimension whole on every rank (a batch DTensor split over
    ``model`` too, as it may split a product whose heads do not divide the
    axis, is gathered there): the residual stream's layout between layers
    (Megatron's;
    the row-parallel products' partial sums reduced, so the next layer's
    column-parallel products split their heads and FFN, not the hidden
    dimension). Under autograd its gradient is brought to the same layout
    (a partial sum over ``model`` reduced: Megatron's all-reduce of the
    column-parallel products' dx), so the backward of the layer that
    produced ``t`` runs on its own heads and FFN columns as the forward
    does; DTensor would otherwise carry the partial sum on and gather the
    weights to multiply it. A plain tensor as it is."""
    if not is_dtensor(t):
        return t
    names = t.device_mesh.mesh_dim_names
    _, Replicate, _ = _dtensor_types()
    rows = tuple(Replicate() if names[i] == MODEL_AXIS else p for i, p in enumerate(_rows(t.placements)))
    if rows != tuple(t.placements):
        t = t.redistribute(t.device_mesh, rows)
    if not (t.requires_grad and torch.is_grad_enabled()):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local(), t.device_mesh, rows, run_check=False, shape=t.shape,
                              stride=t.stride())


def lookup(module: torch.nn.Module, tokens):
    """``module.embed[tokens]`` (the embedding's rows for each token). On a
    table split over the mesh (the vocabulary over ``model``) through
    ``F.embedding``, DTensor's rule for it: each rank looks up the tokens
    its rows hold and zeroes the rest, a partial sum the residual stream
    reduces, and the table never moves (indexing would gather it whole).
    On a whole table each rank indexes its own rows of tokens
    (``local_rows``; DTensor's rule for the indexing's backward fails on
    torch 2.11). Plain indexing otherwise, the one-device path's bits."""
    table = module.embed
    if not is_dtensor(table):
        return table[tokens]
    if any(p.is_shard() for p in table.placements):
        return torch.nn.functional.embedding(tokens, table)
    return local_rows(_embed_rows, module, tokens, params=("embed",))


def _embed_rows(module, tokens):
    return module.embed[tokens]


def split_over_model(t) -> bool:
    """Whether a DTensor's rows (dimension 0) are split over ``model``."""
    if not is_dtensor(t):
        return False
    _, _, Shard = _dtensor_types()
    return t.placements[t.device_mesh.mesh_dim_names.index(MODEL_AXIS)] == Shard(0)


def rows_over_model(t, weight):
    """``t`` (batch first) with its rows split over ``model`` too, each rank
    keeping its block (nothing moves), when ``weight`` (a DTensor the rows
    multiply: the LM head (d, V), an attention's ``wq`` (d, H, hd)) is
    whole over ``model`` (a vocabulary or head count that does not divide
    the axis) and each rank's rows divide evenly over it: each model rank
    then computes its own rows' products with the whole weight, not every
    row of its data shard; under autograd the gradient comes back to
    ``t``'s layout (one all-gather). ``t`` as it is otherwise."""
    if not (is_dtensor(t) and is_dtensor(weight)):
        return t
    i = t.device_mesh.mesh_dim_names.index(MODEL_AXIS)
    m = t.device_mesh.size(i)
    _, Replicate, Shard = _dtensor_types()
    if (m == 1 or weight.placements[i] != Replicate() or t.placements[i] != Replicate()
            or t.to_local().shape[0] % m):
        return t
    return t.redistribute(t.device_mesh, t.placements[:i] + (Shard(0),) + t.placements[i + 1:])


def fsdp_whole(w):
    """A parameter with its FSDP split gathered: every ``Shard`` on a mesh
    dimension other than ``model`` made ``Replicate`` (the all-gather FSDP
    makes before a layer uses its weights; in the backward the gradient's
    partial sums are reduce-scattered back to the split). The batch splits
    over those dimensions, and DTensor cannot always place a product whose
    rows and contraction split over one of them (it fails to unflatten the
    batch-by-sequence product at 16x16). A plain or unsplit tensor as it
    is."""
    if not is_dtensor(w):
        return w
    _, Replicate, Shard = _dtensor_types()
    names = w.device_mesh.mesh_dim_names
    pls = tuple(Replicate() if isinstance(p, Shard) and names[i] != MODEL_AXIS else p
                for i, p in enumerate(w.placements))
    return w if pls == tuple(w.placements) else w.redistribute(w.device_mesh, pls)


def replicate_dim(t, dim: int):
    """``t`` with dimension ``dim`` whole on every rank (a DTensor sharded
    or partial there is gathered or reduced over those mesh dimensions);
    a plain tensor as it is. The loss's gather over the vocabulary needs
    it: DTensor has no rule for a gather along a sharded dimension."""
    if not is_dtensor(t):
        return t
    _, Replicate, Shard = _dtensor_types()
    dim %= t.ndim
    pls = tuple(Replicate() if (isinstance(p, Shard) and p.dim == dim) or p.is_partial() else p
                for p in t.placements)
    return t if pls == tuple(t.placements) else t.redistribute(t.device_mesh, pls)


def cache_rows(t) -> tuple:
    """The rows placements of a DTensor cache tensor (B, S, ...) placed as
    ``cache_pspecs`` places it: ``Shard(0)`` on the mesh dimensions that
    split its batch, ``Replicate`` elsewhere (its sequence split over
    ``model`` or whole). Any other placement raises: the decode paths
    work on each rank's own block and never gather a cache."""
    _, Replicate, Shard = _dtensor_types()
    names, out = t.device_mesh.mesh_dim_names, []
    for name, p in zip(names, t.placements):
        if isinstance(p, Shard) and p.dim == (1 if name == MODEL_AXIS else 0):
            out.append(p if p.dim == 0 else Replicate())
        elif isinstance(p, Replicate):
            out.append(p)
        else:
            raise ValueError(f"a decode cache placed as {tuple(t.placements)} on {names}: expected "
                             "its batch over the data axes and its sequence over model "
                             "(cache_pspecs)")
    return tuple(out)


def ssm_cache_rows(state, conv) -> tuple:
    """The rows placements of an SSD decode cache placed as
    ``cache_pspecs`` places it (state (B, H, N, P): batch over the data
    axes, heads over ``model``; conv (B, K - 1, C): channels over
    ``model``; either whole over ``model`` where it does not divide):
    ``Shard(0)`` on the mesh dimensions that split the batch, ``Replicate``
    elsewhere. Any other placement raises."""
    _, Replicate, Shard = _dtensor_types()
    names, out = state.device_mesh.mesh_dim_names, []
    for name, ps, pc in zip(names, state.placements, conv.placements):
        if name == MODEL_AXIS and ps in (Shard(1), Replicate()) and pc in (Shard(2), Replicate()):
            out.append(Replicate())
        elif name != MODEL_AXIS and ps == pc and ps in (Shard(0), Replicate()):
            out.append(ps)
        else:
            raise ValueError(f"an SSD decode cache placed as {tuple(state.placements)} / "
                             f"{tuple(conv.placements)} on {names}: expected cache_pspecs' layout")
    return tuple(out)


def local_as(t, mesh, placements: tuple | None = None) -> torch.Tensor:
    """This rank's block of ``t`` laid out as ``placements`` on ``mesh``
    (default: whole on every rank; a DTensor redistributed there first; a
    plain tensor counts as whole on every rank, as under
    ``implicit_replication``)."""
    from torch.distributed.tensor import DTensor

    _, Replicate, _ = _dtensor_types()
    whole = (Replicate(),) * mesh.ndim
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, whole, run_check=False)
    return t.redistribute(mesh, tuple(placements or whole)).to_local()


def split_over(rows: tuple, mesh, dim: int) -> tuple:
    """``rows`` with tensor dimension ``dim`` split over ``model`` too: the
    placements of a rank's rows whose ``dim`` holds only its own block."""
    _, _, Shard = _dtensor_types()
    i = mesh.mesh_dim_names.index(MODEL_AXIS)
    return rows[:i] + (Shard(dim),) + rows[i + 1:]


def heads_like(out, wo):
    """A DTensor (B, S, H, hd) with its heads whole, split over each mesh
    dimension that splits ``wo``'s heads (dimension 0): each rank keeps
    its own heads' block (nothing moves), so the output projection is
    Megatron's row-parallel product, a partial sum."""
    if not is_dtensor(wo):
        return out
    _, _, Shard = _dtensor_types()
    pls = tuple(Shard(2) if isinstance(w, Shard) and w.dim == 0 else p
                for p, w in zip(out.placements, wo.placements))
    return out if pls == tuple(out.placements) else out.redistribute(out.device_mesh, pls)


def place_caches(caches: list[dict]) -> list[dict]:
    """A decoder's per-layer caches (``transformer.init_cache``'s layout)
    with every attention K/V and SSD state and conv tail that is a DTensor
    redistributed, in the list, to the placement ``cache_pspecs`` gives it
    on its mesh: a prefill leaves K/V split as the heads are and the SSD's
    cache as the rows, and the decode paths take them as the reference's
    caches are placed (the sequence and the SSD's heads and channels over
    ``model``; where the KV heads do not divide the model axis, or the
    cache is whole over it, each rank keeps its block and nothing moves).
    Plain tensors as they are."""
    from repro_torch.launch.mesh import describe

    for c in caches:
        for kind in ("attn", "ssm"):
            part = c.get(kind)
            if part is None or not all(is_dtensor(t) for t in part.values()):
                continue
            dmesh = next(iter(part.values())).device_mesh
            batch = next(iter(part.values())).shape[0]
            specs = cache_pspecs(describe(dmesh), part, batch)
            c[kind] = {name: t.redistribute(dmesh, to_placements(specs[name], dmesh))
                       for name, t in part.items()}
    return caches


def expand_kv(q, k, v):
    """(q, k, v) for attention with k and v (B, S, KV, hd) placed as q
    (B, S, H, hd), when q is a DTensor whose heads are split where k's are
    not (KV heads that do not divide the model axis, as 8 on a 16-way
    one): each KV head repeated for its group of query heads, a local copy
    of a replicated tensor, and each rank keeps its own heads' keys, so
    the grouped einsum never splits a sharded head dimension (the group
    count is 1 then). A q that is a partial sum is reduced first. Plain
    tensors as they are."""
    if not is_dtensor(q):
        return q, k, v
    if any(p.is_partial() for p in q.placements):
        _, Replicate, _ = _dtensor_types()
        q = q.redistribute(q.device_mesh, tuple(Replicate() if p.is_partial() else p
                                                for p in q.placements))
    if tuple(k.placements) == tuple(q.placements) and tuple(v.placements) == tuple(q.placements):
        return q, k, v
    g = q.shape[2] // k.shape[2]
    if g > 1:
        k, v = (t.repeat_interleave(g, dim=2) for t in (k, v))
    return (q,) + tuple(t.redistribute(q.device_mesh, q.placements) for t in (k, v))


class _Bound(torch.nn.Module):
    """``fn(module, *args)`` as a module's forward, for ``functional_call``."""

    def __init__(self, module: torch.nn.Module, fn):
        super().__init__()
        self.m, self.fn = module, fn

    def forward(self, *args, **kwargs):
        return self.fn(self.m, *args, **kwargs)


def local_rows(fn, module: torch.nn.Module, x, *rest, params: tuple[str, ...] | None = None):
    """``fn(module, x, *rest)`` run by each rank on plain tensors: its own
    rows of x (dimension 0 split as x has it, the rest whole) and the
    module's parameters whole (gathered where they are split); each tensor
    of the result placed back as those rows. Under autograd a parameter's
    gradient is a partial sum over the mesh dimensions that split the rows.
    A plain call when x is a plain tensor. ``params`` names the
    parameters ``fn`` reads (default: every one), the only ones gathered.
    For a computation DTensor has no rule for end to end (the SSD's
    chunked scan: its packed projection, its depthwise convolution, its
    reshapes of split dimensions). ``local_experts`` with no expert stack."""
    names = tuple(n for n, _ in module.named_parameters() if params is None or n in params)
    return local_experts(lambda m, *args, slab: fn(m, *args), module, x, *rest, shared=names)


class Slab(NamedTuple):
    """What a rank's MoE dispatch needs to know of the mesh
    (``local_experts``): ``first``, the first expert of its slab, and
    ``earlier``, which maps its rows' (E,) per-expert choice counts to the
    same experts' counts on every earlier batch shard (token-major order
    over the whole batch). Every rank of the mesh calls ``earlier``
    together: it is one all-reduce of a (shards, E) table over each mesh
    dimension that splits the batch. ``split`` is a ``DataSplit`` when the
    slab's ``d`` is split over a mesh dimension (FSDP), else None."""

    first: int
    earlier: object
    split: "DataSplit | None" = None


def _collective(name: str):
    """The differentiable functional collective ``name`` (``all_gather`` or
    ``reduce_scatter``): ``<name>_single_autograd`` where this torch has it,
    else its older name ``<name>_tensor_autograd`` (the same operator)."""
    import torch.distributed._functional_collectives as fc

    return getattr(fc, f"{name}_single_autograd", None) or getattr(fc, f"{name}_tensor_autograd")


class DataSplit(NamedTuple):
    """The mesh dimension that splits an expert slab's ``d`` under FSDP
    (``data``; it splits the batch's rows too): this rank's ``index``
    among its ``count`` ranks, whose block of ``d`` it holds, and the
    differentiable collectives over them (``layers._experts``). Every
    rank of the dimension calls each one together."""

    mesh: object
    dim: int
    index: int
    count: int

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(…) -> (count, …): every rank's ``t`` in rank order (the
        backward reduce-scatters the gradient)."""
        return _collective("all_gather")(t.contiguous()[None], 0, (self.mesh, self.dim))

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """(count, …) -> (…): entry ``index`` summed over the ranks (the
        backward all-gathers the gradient)."""
        return _collective("reduce_scatter")(t.contiguous(), "sum", 0, (self.mesh, self.dim))[0]

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """(count, …) -> (count, …): entry j of the result is entry
        ``index`` of rank j's ``t`` (the backward is the same exchange)."""
        from torch.distributed._functional_collectives import all_to_all_single_autograd

        return all_to_all_single_autograd(t.contiguous(), None, None, (self.mesh, self.dim))

    def whole(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """A stack's block (split along ``dim``) gathered whole: FSDP's
        all-gather of a weight (the backward reduce-scatters its gradient
        back to the block)."""
        parts = self.all_gather(w)  # (count, …)
        return torch.cat(parts.unbind(0), dim=dim)

    def max_of(self, *values: int, device=None) -> tuple[int, ...]:
        """The largest of the ranks' values, each (one all-reduce)."""
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.get_group(self.dim))
        return tuple(int(v) for v in t)


def moves_rows(tokens: int, row_elems: int, block_elems: int, cdt, pdt) -> bool:
    """Whether the ranks of a ``DataSplit`` (FSDP: a weight's ``d`` split
    over them) move their tokens' rows rather than gather the weights'
    blocks of ``d`` whole: true when the rows are no more bytes. Both sides
    count what a rank puts on the link in the ring model
    (``roofline.collective_traffic``) over ``count - 1``: ``tokens`` rows
    of ``row_elems`` elements in the compute type ``cdt`` against
    ``block_elems`` elements of the rank's blocks in the parameter type
    ``pdt`` (an all-gather of blocks moves each rank's block once to each
    other rank). The callers count their own exchanges' elements from
    shapes every rank of the split shares, so every rank picks the same
    way (``layers.qkv_elems``, ``out_elems``, ``experts_elems``): a decode
    step's few tokens move, a training or prefill batch's many tokens
    gather the blocks, as FSDP does."""
    return tokens * row_elems * cdt.itemsize <= block_elems * pdt.itemsize


def fsdp_split(rows, w, dim: int) -> DataSplit | None:
    """The ``DataSplit`` of a weight ``w`` whose dimension ``dim`` (its
    ``d``) is split over one non-model mesh dimension (FSDP) that splits
    ``rows`` (a DTensor, batch first, whole over ``model``) evenly too:
    the ranks of that dimension each hold a block of ``d`` and rows of
    their own, so they may exchange rows instead of gathering the blocks.
    None when either is a plain tensor, ``w`` is not split so, or the
    rows do not split evenly over their mesh dimensions."""
    if not (is_dtensor(rows) and is_dtensor(w)):
        return None
    _, Replicate, Shard = _dtensor_types()
    mesh, names = w.device_mesh, w.device_mesh.mesh_dim_names
    hits = [i for i, p in enumerate(w.placements) if names[i] != MODEL_AXIS and p == Shard(dim)]
    if len(hits) != 1 or rows.placements[hits[0]] != Shard(0):
        return None
    if rows.placements[names.index(MODEL_AXIS)] != Replicate():
        return None
    shards = math.prod(mesh.size(i) for i, p in enumerate(rows.placements) if p == Shard(0))
    if rows.shape[0] % shards or any(not (p == Shard(0) or isinstance(p, Replicate))
                                     for p in rows.placements):
        return None
    (i,) = hits
    return DataSplit(mesh, i, mesh.get_local_rank(i), mesh.size(i))


def model_split_dim(w) -> int | None:
    """The dimension of a DTensor weight that ``model`` splits, or None
    (whole there, or a plain tensor)."""
    if not is_dtensor(w):
        return None
    p = w.placements[w.device_mesh.mesh_dim_names.index(MODEL_AXIS)]
    return p.dim if p.is_shard() else None


def kv_whole_under_split_queries(x, w, wq) -> bool:
    """Whether a K or V weight ``w`` (d, KV, hd) is whole over ``model``
    (its ``d`` may be split over data, FSDP) while ``wq``'s query heads
    (d, H, hd) are split there, for rows x (a DTensor, batch first) split
    only over the data axes: the case where each model rank needs only
    its own query heads' KV heads (``own_kv_heads``)."""
    if not (is_dtensor(x) and is_dtensor(w) and is_dtensor(wq)):
        return False
    _, Replicate, Shard = _dtensor_types()
    i = x.device_mesh.mesh_dim_names.index(MODEL_AXIS)
    return (wq.placements[i] == Shard(1) and w.placements[i] == Replicate()
            and x.placements[i] == Replicate()
            and all(p == Shard(0) or isinstance(p, Replicate) for p in x.placements))


def own_kv_heads(x, w, wq):
    """``einsum("bsd,dhk->bshk", x, w)`` for a K or V weight ``w`` (d, KV,
    hd) whole over ``model`` while the query heads of ``wq`` (d, H, hd)
    are split there (``kv_whole_under_split_queries``: KV heads that do
    not divide the axis, as 8 on a 16-way one), ``w`` given with FSDP's
    split gathered: each model rank contracts its rows of x with only the
    KV heads its own block of query heads reads (query head h reads KV
    head h // (H / KV)) and repeats each for its query heads, so the
    result is a DTensor (B, S, H, hd) placed as the queries (``Shard(2)``
    on ``model``), which ``local_heads`` takes as it is. A local slice of
    a whole weight: no collective. Under autograd ``w``'s gradient is a
    partial sum over ``model`` and over the mesh dimensions that split the
    rows, x's a partial sum over ``model``, as DTensor's own product
    leaves them. Any other placement raises."""
    if not kv_whole_under_split_queries(x, w, wq) or any(p.is_shard() for p in w.placements):
        raise ValueError(f"own_kv_heads: K/V placed {tuple(w.placements)}, queries "
                         f"{tuple(wq.placements)}, rows {tuple(x.placements)}")
    from torch.distributed.tensor import Partial

    _, Replicate, Shard = _dtensor_types()
    mesh = x.device_mesh
    i = mesh.mesh_dim_names.index(MODEL_AXIS)
    h, kvh = wq.shape[1], w.shape[1]
    per = h // mesh.size(i)
    heads = torch.arange(mesh.get_local_rank(i) * per, (mesh.get_local_rank(i) + 1) * per) // (h // kvh)
    lo, hi = int(heads[0]), int(heads[-1]) + 1
    rows = tuple(Partial() if p == Shard(0) else Replicate() for p in x.placements)
    w_local = w.to_local(grad_placements=rows[:i] + (Partial(),) + rows[i + 1:])
    x_local = x.to_local(grad_placements=tuple(x.placements[:i]) + (Partial(),) + tuple(x.placements[i + 1:]))
    kv = torch.einsum("bsd,dhk->bshk", x_local, w_local[:, lo:hi].to(x_local.dtype))
    out = kv[:, :, (heads - lo).to(kv.device)]
    return from_local(out, mesh, split_over(tuple(x.placements), mesh, 2),
                      (x.shape[0], x.shape[1], h, w.shape[2]))


def from_local(t: torch.Tensor, mesh, placements: tuple, shape: tuple):
    """``DTensor.from_local`` of a rank's block with the global ``shape``
    given (contiguous strides), so rows split unevenly keep their global
    count."""
    from torch.distributed.tensor import DTensor

    stride = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _count_exchange(mesh, row_dims: tuple[int, ...]):
    """``Slab.earlier`` for rows split over ``row_dims`` of ``mesh`` (row-major
    in mesh order, as DTensor nests the shards of one dimension)."""
    if not row_dims:
        return lambda counts: torch.zeros_like(counts)
    index, shards = flat_index(mesh, tuple(mesh.mesh_dim_names[i] for i in row_dims))

    def earlier(counts: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        table = counts.new_zeros((shards, counts.numel()))
        table[index] = counts
        for i in row_dims:
            dist.all_reduce(table, group=mesh.get_group(i))
        return table[:index].sum(0)

    return earlier


def local_experts(fn, module: torch.nn.Module, x, *rest, stacks: tuple[str, ...] = (),
                  shared: tuple[str, ...] = ()):
    """``fn(module, x, *rest, slab=...)`` run by each rank on plain tensors, for
    the MoE: its own rows of x (dimension 0 split as x has it, the rest
    whole; with ``stacks``, x first laid out as the residual stream,
    ``as_rows``), its own block of each expert stack named in ``stacks`` (as the
    stack is placed: dimension 0 split over ``model``, and under FSDP its
    ``d`` split over ``data``, never gathered) and the parameters named in
    ``shared`` whole. ``slab`` is a ``Slab``, or None when the rank holds
    every row and every expert (a 1x1 mesh: ``fn`` then runs as on one
    device); its ``split`` says which block of ``d`` the rank holds (``fn``
    either moves the rows' activations over that dimension or gathers the
    blocks, whichever moves fewer bytes: ``layers._experts``). Each tensor
    of the result is placed back as those rows and, where the experts are
    split, as a partial sum over the mesh dimensions that split them (a
    rank's experts add their share).
    Under autograd a stack's gradient is its block's: whole over the
    dimension that splits ``d`` (the rank's products see every row of it),
    a partial sum over the other mesh dimensions that split the rows; a
    shared parameter's and x's a partial sum over the dimensions whose
    ranks each add a share. A plain call (``slab=None``) when x is a plain
    tensor. The rows and the experts may not be split over one mesh
    dimension (that needs an all-to-all, which the reference's placements
    never ask for), and a stack's ``d`` is split only over a dimension
    that splits the rows (at most one)."""
    if not is_dtensor(x):
        return fn(module, x, *rest, slab=None)
    from torch.distributed.tensor import DTensor, Partial
    from torch.func import functional_call
    from torch.utils._pytree import tree_map

    _, Replicate, Shard = _dtensor_types()
    if stacks or any(not (isinstance(p, Replicate) or p == Shard(0)) for p in x.placements):
        x = as_rows(x)  # the experts' rows may not split over model; rows split there stay for the rest
    mesh = x.device_mesh
    dims = range(mesh.ndim)
    row_dims = tuple(i for i, p in enumerate(x.placements) if isinstance(p, Shard))
    expert_dims = split_dims = ()
    if stacks:
        lead = module.get_parameter(stacks[0])
        if is_dtensor(lead):
            expert_dims = tuple(i for i, p in enumerate(lead.placements)
                                if isinstance(p, Shard) and p.dim == 0)
            split_dims = tuple(i for i, p in enumerate(lead.placements)
                               if isinstance(p, Shard) and p.dim != 0)
    if set(row_dims) & set(expert_dims):
        raise ValueError(f"local_experts: rows and experts split over one mesh dimension "
                         f"({x.placements} vs {module.get_parameter(stacks[0]).placements})")
    if len(split_dims) > 1 or not set(split_dims) <= set(row_dims):
        raise ValueError(f"local_experts: an expert stack's d split over mesh dimensions "
                         f"{split_dims} that are not one dimension of the rows' {row_dims}")

    def placed(row, expert, other):
        return tuple(row if i in row_dims else expert if i in expert_dims else other for i in dims)

    local = {}
    for name in stacks:
        w = module.get_parameter(name)
        local[f"m.{name}"] = w.to_local(grad_placements=tuple(
            Partial() if i in row_dims and isinstance(p, Replicate) else p
            for i, p in enumerate(w.placements))) if is_dtensor(w) else w
    for name in shared:
        w = module.get_parameter(name)
        local[f"m.{name}"] = w.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
            grad_placements=placed(Partial(), Partial(), Replicate())) if is_dtensor(w) else w
    first = 0
    if expert_dims:
        index, _ = flat_index(mesh, tuple(mesh.mesh_dim_names[i] for i in expert_dims))
        first = index * local[f"m.{stacks[0]}"].shape[0]
    split = None
    if split_dims:
        (dim,) = split_dims
        split = DataSplit(mesh, dim, mesh.get_local_rank(dim), mesh.size(dim))
    slab = Slab(first, _count_exchange(mesh, row_dims), split) if row_dims or expert_dims else None
    x_local = x.to_local(grad_placements=placed(Shard(0), Partial(), Replicate()))
    out = functional_call(_Bound(module, fn), local, (x_local, *rest), {"slab": slab}, strict=False)
    out_pl = placed(Shard(0), Partial(), Replicate())
    return tree_map(lambda t: DTensor.from_local(t, mesh, out_pl, run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)


def rows_like(t, like):
    """A plain tensor ``t`` (the same on every rank, batch first) placed as
    ``like``'s rows when ``like`` is a DTensor: dimension 0 split as
    ``like`` splits it, the rest whole (each rank keeps its block, nothing
    moves). ``t`` itself otherwise."""
    if not is_dtensor(like) or t is None:
        return t
    return place(t, Sharding(like.device_mesh, _rows(like.placements)))


def local_heads(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)`` for (B, S, heads, hd) tensors that may be
    DTensors: each rank runs ``fn`` on its own block of batch and heads
    (``local_map``), never on a gathered tensor, in the forward and in the
    backward. Only the head dimension (2) and the batch dimension (0) may
    be sharded. When k and v are not split over heads as q is (KV heads
    that do not divide the model axis), each KV head is repeated for its
    group of query heads first, a local copy, so every rank holds its
    heads' keys. A DTensor among ``rest`` reaches ``fn`` as its local
    block (``rows_like`` places the mask's positions so); anything else as
    it is. A plain call on plain tensors."""
    if not is_dtensor(q):
        return fn(q, k, v, *rest)
    from torch.distributed.tensor.experimental import local_map

    _, Replicate, Shard = _dtensor_types()
    q, k, v = expand_kv(q, k, v)
    for p in q.placements:
        if isinstance(p, Shard) and p.dim not in (0, 2):
            raise ValueError(f"local_heads: q placed as {q.placements}")
    pls = tuple(q.placements)
    # One output: its placements a list (local_map reads a tuple as one per output).
    rest_pls = tuple(tuple(r.placements) if is_dtensor(r) else None for r in rest)
    mapped = local_map(fn, out_placements=list(pls), in_placements=(pls, pls, pls) + rest_pls,
                       device_mesh=q.device_mesh)
    return mapped(q, k, v, *rest)


_DEPTH = threading.local()


@contextlib.contextmanager
def implicit_replication():
    """DTensor's ``implicit_replication`` (a plain tensor beside DTensors
    counts as replicated), re-entrant: DTensor's own switches the mode off
    when any nested use of it ends."""
    from torch.distributed.tensor.experimental import implicit_replication as on

    depth = getattr(_DEPTH, "n", 0)
    _DEPTH.n = depth + 1
    try:
        if depth:
            yield
        else:
            with on():
                yield
    finally:
        _DEPTH.n = depth


def serving_scope(model: torch.nn.Module):
    """``inference_mode`` for a model of plain tensors; for DTensor
    parameters ``no_grad`` and ``implicit_replication`` (DTensor does not
    run under inference mode, and the plain tensors a step makes, positions
    and masks, count as replicated)."""
    if not is_dtensor(next(model.parameters())):
        return torch.inference_mode()
    scope = contextlib.ExitStack()
    scope.enter_context(torch.no_grad())
    scope.enter_context(implicit_replication())
    return scope


def serving(fn):
    """``fn(model, ...)`` under ``serving_scope(model)``."""
    @functools.wraps(fn)
    def run(model, *args, **kwargs):
        with serving_scope(model):
            return fn(model, *args, **kwargs)

    return run
