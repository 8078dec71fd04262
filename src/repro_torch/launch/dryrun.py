"""Dry run: count every (arch x shape x mesh) cell's step on meta tensors,
with nothing allocated, and write the roofline record that ``report``
reads.

Port of ``repro.launch.dryrun``. The reference lowers each step with
``ShapeDtypeStruct`` inputs on a 512-device placeholder mesh and reads
XLA's ``cost_analysis``, ``memory_analysis`` and post-SPMD HLO. The port
has no XLA: it builds the model on ``device="meta"`` (no weights drawn;
``init_params`` is never called) and runs the cell's step under one
counting mode, a ``Meter`` inside ``torch.utils.flop_counter.FlopCounterMode``:

* **FLOPs**: ``FlopCounterMode``'s count (matrix products), charged at the
  bf16 peak, plus the operations of each hand-written kernel the step
  launches, charged by its work model (``roofline.KERNEL_WORK``: K5's and
  K6's bf16 products at the bf16 peak, K1-K4's float32 and float64
  operations at theirs).
* **Bytes**: each operator's input and output bytes, counted op by op with
  no fusion (the port's counterpart of XLA's "bytes accessed"; eager
  PyTorch fuses nothing either). A view moves nothing; an input broadcast
  along a dimension is read once along it; a gather reads the rows it
  gathers, a scatter writes the rows it scatters; ``copy_`` and fills do
  not read what they overwrite. A kernel launched on meta tensors (K1-K6)
  is charged its work model's bytes, never its plain version's operators.
* **Memory**: ``argument_size_in_bytes`` is exact (parameters, optimizer
  state, batch and caches of the meta tensors, split in ``arguments``);
  ``temp_size_in_bytes`` is the peak of the storages the step allocated
  that were alive at once (its outputs included); ``fits`` compares their
  sum with the card's memory.

The step: train is ``launch/train.build_step``'s (``loss_fn``, autograd
with the config's remat, the optimizer the config picks); prefill and
decode are ``serve_decode``'s (decode at ``pos = seq_len - 1``). A meta
pass runs every layer, so the full depth is counted and nothing is
extrapolated (``costs_extrapolated: false``; the reference extrapolates
from 2 and 4 repeats because XLA counts a ``while`` body once).

The MoE dispatch's ``nonzero`` has no data-independent shape: the meter
takes every choice as kept (``torch.fx.experimental._config.
meta_nonzero_assume_all_nonzero``'s assumption), an upper bound on the
index traffic; on one card the (E, C, d) expert products do not depend
on it. On a mesh a rank's expert buffer has as many rows as the largest
kept count among its slab's experts from its own tokens, which a meta
tensor cannot read: it takes min(C, T_local k), every choice kept, an
upper bound (``layers._experts``). The record says so
(``moe_dispatch``); grouping's dedup (``unique``) is taken the same way,
every row distinct.

**Meshes above 1x1.** The step is the sharded step of a world of
``mesh.size`` ranks, counted in this process as rank 0 of a fake world
(``launch.mesh.fake_world``: collectives dispatch and move nothing): the
parameters, the optimizer state, the batch and the caches are DTensors
on meta tensors, placed by ``models/sharding.py``'s rules
(``distribute_params``, the batch and caches by ``input_specs``'
placements), and the step runs the same code as on one card, DTensor
inserting the collectives. ``LocalMeter`` counts what rank 0 runs: its
local operators' FLOPs (``torch.utils.flop_counter``'s formulas on the
local shards) and bytes, and each collective priced by
``roofline.collective_traffic``'s ring factors from its result's bytes
and its group's size; DTensor's ``CommDebugMode`` counts the collectives
by operator beside it (``comm_debug_counts``). A decode step of a config
with ``flash_decode`` takes the mesh, as the reference's
(``extras["mesh"]``, the batch over the non-model axes). The argument
bytes are the local shards' bytes, which equal ``per_device_bytes``.
The dry run always runs on ``meta``; it sets no XLA flags and has no CPU
fallback.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh 1x1] [--out results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import SHAPES, ShapeDef, applicable, input_specs
from repro_torch.kernels import _launch
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh, make_mesh, parse_mesh
from repro_torch.models import sharding as sh

ONE_CARD = make_mesh((1, 1), ("data", "model"))
MOE_DISPATCH = ("every choice kept (nonzero on meta assumed all nonzero; on a mesh a rank's expert "
                "buffer min(C, T_local k) rows): an upper bound")

# -- the counting mode ----------------------------------------------------------

_ALLOC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
          "empty_permuted"}
_WRITE_ONLY = {"zeros", "ones", "full", "zeros_like", "ones_like", "full_like", "new_zeros",
               "new_ones", "new_full", "scalar_tensor", "arange", "fill_", "zero_"}
_GATHER = {"index", "_unsafe_index", "gather", "index_select", "embedding"}
_SCATTER = {"index_put_", "_index_put_impl_", "index_add_", "scatter_", "scatter_add_",
            "index_copy_"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _sid(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _span(t: torch.Tensor) -> int:
    """Bytes one pass over ``t`` touches: a broadcast dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride:
            n *= size
    return n * t.element_size()


def _inplace(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write for r in func._schema.returns)


def op_bytes(func, args, kwargs, out) -> int:
    """HBM bytes one operator moves: its inputs read once, its outputs
    written once (see the module docstring for views, gathers, scatters
    and fills)."""
    name = func._overloadpacket.__name__
    if name in _ALLOC:
        return 0
    ins, outs = _tensors((args, kwargs)), _tensors(out)
    in_sids = {_sid(t) for t in ins}
    if not _inplace(func) and outs and all(_sid(t) in in_sids for t in outs):
        return 0  # a view, or an input returned as it is
    if name in _WRITE_ONLY:
        return sum(_span(t) for t in outs)
    if name in _GATHER:  # the indices, and the gathered rows read and written
        return sum(_span(t) for t in ins[1:]) + 2 * sum(_span(t) for t in outs)
    if name == "copy_":
        return _span(ins[1]) + _span(ins[0])
    if name in _SCATTER:  # the indices and values read, the values' rows written
        dst, rest = ins[0], ins[1:]
        moved = [t for t in rest if t.dtype == dst.dtype]
        return sum(_span(t) for t in rest) + sum(_span(t) for t in moved)
    return sum(_span(t) for t in ins) + sum(_span(t) for t in outs)


class Meter(TorchDispatchMode):
    """Counts, op by op, the bytes a step on meta tensors moves (``op_bytes``),
    the hand-written kernels it launches with their work models' bytes and
    operations (``charge_kernel``, called by the wrappers through
    ``kernels._launch.on_meta``), and the peak bytes of the storages it
    allocates that are alive at once (``peak_bytes``). Use inside a
    ``FlopCounterMode`` for the products' FLOPs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.kernels: dict[str, dict] = {}
        self.assumed_nonzero = 0
        self.live = self.peak_bytes = 0
        self._refs: dict[int, list] = {}

    def __enter__(self):
        _launch.METERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _launch.METERS.remove(self)
        return super().__exit__(*exc)

    def charge_kernel(self, name: str, *shape) -> None:
        work = rl.KERNEL_WORK[name](*shape)
        k = self.kernels.setdefault(name, dict(launches=0, **{f: 0 for f in rl.Work._fields}))
        k["launches"] += 1
        for f, v in zip(rl.Work._fields, work):
            k[f] += v
        self.bytes += work.bytes

    def kernel_ops(self, unit: str) -> int:
        return sum(k[unit] for k in self.kernels.values())

    def _release(self, sid: int) -> None:
        ref = self._refs[sid]
        ref[0] -= 1
        if not ref[0]:
            self.live -= ref[1]
            del self._refs[sid]

    def _track(self, in_sids: set, outs) -> None:
        for t in outs:
            sid = _sid(t)
            ref = self._refs.get(sid)
            if ref is None:
                if sid in in_sids:
                    continue  # an argument's storage, viewed or written in place
                ref = self._refs[sid] = [0, t.untyped_storage().nbytes()]
                self.live += ref[1]
                self.peak_bytes = max(self.peak_bytes, self.live)
            ref[0] += 1
            weakref.finalize(t, self._release, sid)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.nonzero.default:
            x = args[0]
            self.assumed_nonzero += 1
            out = torch.empty((x.numel(), x.dim()), dtype=torch.long, device=x.device)
        elif func is torch.ops.aten.unique_dim.default and args[0].is_meta:
            # Grouping's dedup: every row taken as distinct, as nonzero above.
            x, dim = args[0], args[1]
            self.assumed_nonzero += 1
            n = x.shape[dim]
            out = (torch.empty_like(x), torch.empty((n,), dtype=torch.long, device=x.device),
                   torch.empty((n,), dtype=torch.long, device=x.device))
        else:
            out = func(*args, **kwargs)
        self.ops += 1
        self.bytes += op_bytes(func, args, kwargs, out)
        self._track({_sid(t) for t in _tensors((args, kwargs))}, _tensors(out))
        return out


_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, torch.ScriptObject):  # a c10d op's ProcessGroup
            a = torch.distributed.ProcessGroup.unbox(a)
        if isinstance(a, torch.distributed.ProcessGroup):
            return a.size()
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (KeyError, RuntimeError, ValueError):
                continue
    raise ValueError(f"no process group among a collective's {len(args)} arguments")


def collective_of(func, args, out) -> tuple[str, int, int] | None:
    """(kind, bytes of its result on one rank, group size) of a collective
    operator (the functional ops DTensor issues, ``torch.distributed``'s
    c10d ops), else None. The result is what ``collective_traffic`` prices:
    the gathered buffer, the scattered shard, the reduced tensor."""
    kind = _COLLECTIVES.get(func._overloadpacket.__name__)
    if kind is None:
        return None
    if kind == "all-gather":
        result = _tensors(args[0] if func._overloadpacket.__name__ != "all_gather_into_tensor"
                          else out)
    elif kind == "reduce-scatter":
        result = _tensors(out if func._overloadpacket.__name__ == "reduce_scatter_tensor"
                          else args[0])
    else:
        result = _tensors(args[0])
    nbytes = sum(t.numel() * t.element_size() for t in result)
    return kind, nbytes, _group_size(args)


class LocalMeter(Meter):
    """``Meter`` for a sharded step: counts what one rank runs. An operator
    on DTensors is handed to DTensor (``NotImplemented``), which runs it as
    local operators on the rank's shards, and those are counted: their
    bytes, their FLOPs by ``torch.utils.flop_counter``'s formulas, and each
    collective's link traffic (``collective_of`` priced by
    ``roofline.collective_traffic``). DTensor's own shape propagation runs
    on fake tensors and is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives = rl.CollectiveStats()
        self._propagating = 0
        self._restore = None

    _PROPAGATORS = ("_propagate_tensor_meta_non_cached", "propagate_op_sharding_non_cached")

    def __enter__(self):
        # DTensor derives a new operator's output shape and sharding by
        # running it (or its decomposition) on tensors of the global shapes,
        # whose kernels reach this mode as plain meta tensors: nothing of
        # that is a rank's work, so it is run uncounted.
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        saved = {name: getattr(ShardingPropagator, name) for name in self._PROPAGATORS}

        def quiet(orig):
            def run(*args, **kwargs):
                self._propagating += 1
                try:
                    return orig(*args, **kwargs)
                finally:
                    self._propagating -= 1
            return run

        for name, orig in saved.items():
            setattr(ShardingPropagator, name, quiet(orig))
        self._restore = lambda: [setattr(ShardingPropagator, n, f) for n, f in saved.items()]
        return super().__enter__()

    def __exit__(self, *exc):
        self._restore()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if self._propagating or any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        coll = collective_of(func, args, out)
        if coll is not None:
            kind, nbytes, n = coll
            self.collectives.add(kind, rl.collective_traffic(kind, nbytes, n))
        return out


def count_local(fn) -> tuple[object, dict]:
    """``count`` for a sharded step in a (fake) world: rank 0's local work
    (``LocalMeter``) and the collectives ``CommDebugMode`` saw, by operator
    (``comm_debug_counts``); ``collectives`` is the priced
    ``roofline.CollectiveStats``."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as comm, LocalMeter() as meter:
        out = fn()
    debug = {str(op): n for op, n in comm.get_comm_counts().items()}
    return out, dict(flops=meter.flops + meter.kernel_ops("bf16_ops"),
                     f32_ops=meter.kernel_ops("f32_ops"), f64_ops=meter.kernel_ops("f64_ops"),
                     bytes=meter.bytes, ops=meter.ops, kernels=meter.kernels,
                     temp_bytes=meter.peak_bytes, assumed_nonzero=meter.assumed_nonzero,
                     collectives=meter.collectives, comm_debug_counts=debug)


def count(fn) -> tuple[object, dict]:
    """Run ``fn()`` on meta tensors under the counting mode; returns its
    result and the counts: ``flops`` (products plus the kernels' bf16
    operations), ``f32_ops`` / ``f64_ops`` (the kernels'), ``bytes``,
    ``ops``, ``kernels``, ``temp_bytes``, ``assumed_nonzero``."""
    with FlopCounterMode(display=False) as fc, Meter() as meter:
        out = fn()
    return out, dict(flops=fc.get_total_flops() + meter.kernel_ops("bf16_ops"),
                     f32_ops=meter.kernel_ops("f32_ops"), f64_ops=meter.kernel_ops("f64_ops"),
                     bytes=meter.bytes, ops=meter.ops, kernels=meter.kernels,
                     temp_bytes=meter.peak_bytes, assumed_nonzero=meter.assumed_nonzero)


def step_roofline(costs: dict, model_flops: float, chips: int = 1) -> rl.Roofline:
    """``make_roofline`` for one device of ``chips`` (the collective term
    from ``costs["collectives"]``, none on one card), with the kernels'
    float32 and float64 operations charged at their own peaks."""
    r = rl.make_roofline(costs["flops"], costs["bytes"],
                         costs.get("collectives") or rl.CollectiveStats(), chips, model_flops)
    r.compute_s += costs["f32_ops"] / rl.F32_FLOPS + costs["f64_ops"] / rl.F64_FLOPS
    return r


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if sh.is_dtensor(t) else t


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (modules' parameters, dicts, lists,
    tuples, the optimizers' NamedTuples); of a DTensor, its local shard's."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters())
    else:
        tensors = _tensors(tree)
    return sum(_local(t).numel() * _local(t).element_size() for t in tensors)


# -- the cell's step ----------------------------------------------------------------


def meta_model(cfg: ArchConfig):
    """The family's model on ``meta``: shapes and types only."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T

    return (ED.EncDec if cfg.family == "encdec" else T.Transformer)(cfg, device="meta")


def make_step(cfg: ArchConfig, shape: ShapeDef, max_len: int | None = None, dmesh=None):
    """(state, step): the arguments the cell's step takes beside its batch
    (the model, and the optimizer for train) and ``step(state, batch)``.
    With ``dmesh`` (a ``DeviceMesh``) the parameters are placed on it."""
    from repro_torch.launch import serve_decode as sd
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig

    model = meta_model(cfg)
    if dmesh is not None:
        sh.distribute_params(cfg, dmesh, model)
    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        model.requires_grad_(True)
        opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
        fn = train.build_step(cfg, opt_cfg, total_steps=100)
        return {"params": model, "optimizer": opt}, lambda st, b: fn(st["params"], st["optimizer"], b)
    if shape.kind == "prefill":
        def prefill(st, b):
            extras = {k: b[k] for k in ("memory", "frames") if k in b} or None
            return sd.prefill(cfg, st["params"], b["tokens"], extras, max_len or shape.seq_len)

        return {"params": model}, prefill
    pos = shape.seq_len - 1  # one new token against a full cache
    extras = None
    if cfg.flash_decode and dmesh is not None:  # the reference's dryrun.py:82-86
        extras = {"mesh": dmesh,
                  "batch_axes": tuple(a for a in dmesh.mesh_dim_names if a != sh.MODEL_AXIS)}
    return {"params": model}, lambda st, b: sd.decode_step(cfg, st["params"], b["token"],
                                                           b["caches"], pos, extras)


def model_flops_of(cfg: ArchConfig, shape: ShapeDef) -> float:
    if shape.kind == "train":
        return rl.model_flops_train(cfg, shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return rl.model_flops_prefill(cfg, shape.global_batch, shape.seq_len)
    return rl.model_flops_decode(cfg, shape.global_batch, shape.seq_len)


def argument_bytes(state: dict, batch: dict) -> dict:
    """Bytes of the step's arguments on one device: each tensor's, or a
    DTensor's local shard's (``models.sharding.per_device_bytes`` of its
    placement, which the tests hold them to)."""
    out = {"params": tensor_bytes(state["params"]),
           "batch": tensor_bytes({k: v for k, v in batch.items() if k != "caches"})}
    if "optimizer" in state:
        out["optimizer"] = tensor_bytes(state["optimizer"])
    if "caches" in batch:
        out["caches"] = tensor_bytes(batch["caches"])
    return out


def place_inputs(batch, specs, dmesh):
    """``input_specs``' meta tensors as DTensors on ``dmesh`` by their
    placements (the same structure)."""
    if isinstance(batch, dict):
        return {k: place_inputs(v, specs[k], dmesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(place_inputs(v, pl, dmesh) for v, pl in zip(batch, specs, strict=True))
    return sh.place(batch, sh.Sharding(dmesh, sh.to_placements(specs, dmesh)))


def run_cell(cfg: ArchConfig, shape: ShapeDef, mesh: Mesh = ONE_CARD, verbose: bool = True,
             max_len: int | None = None) -> dict:
    """The cell's record (the reference's fields). ``max_len`` sizes a
    prefill's caches (default: the shape's sequence)."""
    if mesh.size == 1:
        return _run_cell(cfg, shape, mesh, verbose, max_len, None)
    from repro_torch.launch.mesh import device_mesh, fake_world

    with fake_world(mesh.size), sh.implicit_replication():
        return _run_cell(cfg, shape, mesh, verbose, max_len, device_mesh(mesh, "cpu"))


def _run_cell(cfg: ArchConfig, shape: ShapeDef, mesh: Mesh, verbose: bool, max_len, dmesh) -> dict:
    t0 = time.perf_counter()
    batch, specs = input_specs(cfg, shape, mesh)
    if dmesh is not None:
        batch = place_inputs(batch, specs, dmesh)
    state, step = make_step(cfg, shape, max_len, dmesh)
    args = argument_bytes(state, batch)
    arg_total = sum(args.values())
    model_flops = model_flops_of(cfg, shape)
    rec = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind, "mesh": list(mesh.shape),
        "axes": list(mesh.axis_names), "chips": mesh.size, "ok": True,
        "model_flops": model_flops, "total_params": rl.total_param_count(cfg),
        "active_params": rl.active_param_count(cfg),
    }
    _, costs = (count if dmesh is None else count_local)(lambda: step(state, batch))
    roof = step_roofline(costs, model_flops, mesh.size)
    coll = costs.get("collectives") or rl.CollectiveStats()
    temp = costs["temp_bytes"]
    rec.update({
        "count_seconds": round(time.perf_counter() - t0, 2),
        "costs_extrapolated": False,
        "flops_per_device": costs["flops"],
        "f32_ops_per_device": costs["f32_ops"],
        "f64_ops_per_device": costs["f64_ops"],
        "bytes_per_device": costs["bytes"],
        "collective_traffic_per_device": coll.per_device_traffic_bytes,
        "collective_ops": dict(coll.op_counts),
        "collective_traffic_by_op": dict(coll.op_traffic),
        "memory_analysis": {
            "argument_size_in_bytes": arg_total, "arguments": args, "temp_size_in_bytes": temp,
            "fits": arg_total + temp <= rl.HBM_BYTES, "device_bytes": rl.HBM_BYTES,
        },
        "operators": costs["ops"],
        "kernels": costs["kernels"],
        "terms_seconds": {"compute": roof.compute_s, "memory": roof.memory_s,
                          "collective": roof.collective_s},
        "bound_seconds": roof.bound_s,
        "dominant": roof.dominant,
        "useful_ratio": roof.useful_ratio,
        "roofline_fraction": roof.roofline_fraction,
    })
    if "comm_debug_counts" in costs:
        rec["comm_debug_counts"] = costs["comm_debug_counts"]
    if costs["assumed_nonzero"]:
        rec["moe_dispatch"] = MOE_DISPATCH
    if verbose:
        t = rec["terms_seconds"]
        print(f"[{cfg.name} x {shape.name} x {'x'.join(map(str, mesh.shape))}] counted in "
              f"{rec['count_seconds']}s, {costs['ops']} operators; collectives "
              f"{rec['collective_ops']} {coll.per_device_traffic_bytes:.3e} B/dev")
        print(f"  flops/dev {costs['flops']:.3e}  bytes/dev {costs['bytes']:.3e}  kernels "
              f"{ {k: v['launches'] for k, v in costs['kernels'].items()} }")
        print(f"  arguments {arg_total} B {args}; temporaries peak {temp} B; fits "
              f"{rec['memory_analysis']['fits']}")
        print(f"  terms: compute {t['compute']:.4f}s  memory {t['memory']:.4f}s  "
              f"collective {t['collective']:.4f}s  -> dominant {rec['dominant']}")
        print(f"  useful_ratio {roof.useful_ratio:.3f}  roofline_fraction "
              f"{roof.roofline_fraction:.3f}")
    return rec


def truncate_cfg(cfg: ArchConfig, r: int) -> ArchConfig:
    """Same architecture with r pattern repeats (the reference's analysis
    config; the port counts the full depth, and ``tests/`` checks that the
    counts are affine in r, which the reference's extrapolation assumes)."""
    if cfg.family == "encdec":
        return cfg.replace(enc_layers=r, dec_layers=r, num_layers=2 * r, scan_unroll=0)
    return cfg.replace(num_layers=len(cfg.prefix) + len(cfg.pattern) * r, scan_unroll=0)


def cell_id(arch: str, shape: str, mesh: Mesh) -> str:
    return f"{arch}__{shape}__{'x'.join(map(str, mesh.shape))}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=registry.names())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="1x1", help="DxM (data x model) or PxDxM (pod x data x model)")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    mesh = parse_mesh(args.mesh)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = registry.names() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = []
    for arch in archs:
        cfg = registry.get(arch)
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            cid = cell_id(arch, shape_name, mesh)
            path = out / f"{cid}.json"
            ok, reason = applicable(cfg, shape)
            if not ok:
                path.write_text(json.dumps({"arch": arch, "shape": shape_name, "ok": False,
                                            "skipped": True, "reason": reason,
                                            "mesh": list(mesh.shape)}))
                print(f"[{arch} x {shape_name}] {reason}")
                continue
            try:
                rec = run_cell(cfg, shape, mesh)
            except Exception as e:  # noqa: BLE001 - record and continue
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape_name, "ok": False,
                       "error": f"{type(e).__name__}: {e}", "mesh": list(mesh.shape)}
                failures.append(cid)
            path.write_text(json.dumps(rec, indent=1))

    if failures:
        print(f"FAILED cells: {failures}")
        raise SystemExit(1)
    print("dry-run complete")


if __name__ == "__main__":
    main()
