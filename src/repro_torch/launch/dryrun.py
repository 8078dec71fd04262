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
  launches, charged by its work model (``roofline.KERNEL_WORK``: K5's bf16
  products at the bf16 peak, K1-K4's float32 and float64 operations at
  theirs).
* **Bytes**: each operator's input and output bytes, counted op by op with
  no fusion (the port's counterpart of XLA's "bytes accessed"; eager
  PyTorch fuses nothing either). A view moves nothing; an input broadcast
  along a dimension is read once along it; a gather reads the rows it
  gathers, a scatter writes the rows it scatters; ``copy_`` and fills do
  not read what they overwrite. A kernel launched on meta tensors (K1-K5)
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
index traffic; the (E, C, d) expert products do not depend on it. The
record says so (``moe_dispatch``). A config that ``check_ported`` refuses
gets a skipped record with its reason.

Meshes above 1x1: only the per-device argument bytes are counted, from
``models/sharding.py``'s placements; FLOPs, bytes and collectives need a
sharded program (ROADMAP.md queue 1, item 18, the multi-device pieces), so
such a record is skipped with that reason. The dry run always runs on
``meta``; it sets no XLA flags and has no CPU fallback.

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
from repro_torch.configs.base import ArchConfig, unported
from repro_torch.configs.shapes import SHAPES, ShapeDef, applicable, input_specs
from repro_torch.kernels import _launch
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Mesh, make_mesh, parse_mesh
from repro_torch.models import sharding as sh

ONE_CARD = make_mesh((1, 1), ("data", "model"))
MULTI_DEVICE = "ROADMAP.md queue 1, item 18, the multi-device pieces"
MULTI_DEVICE_NOTE = f"FLOPs, bytes and collectives need a sharded program: {MULTI_DEVICE}"
MOE_DISPATCH = "every choice kept (nonzero on meta assumed all nonzero): an upper bound"

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
        else:
            out = func(*args, **kwargs)
        self.ops += 1
        self.bytes += op_bytes(func, args, kwargs, out)
        self._track({_sid(t) for t in _tensors((args, kwargs))}, _tensors(out))
        return out


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


def step_roofline(costs: dict, model_flops: float) -> rl.Roofline:
    """``make_roofline`` on one card, with the kernels' float32 and float64
    operations charged at their own peaks."""
    r = rl.make_roofline(costs["flops"], costs["bytes"], rl.CollectiveStats(), 1, model_flops)
    r.compute_s += costs["f32_ops"] / rl.F32_FLOPS + costs["f64_ops"] / rl.F64_FLOPS
    return r


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (modules' parameters, dicts, lists,
    tuples, the optimizers' NamedTuples)."""
    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


# -- the cell's step ----------------------------------------------------------------


def meta_model(cfg: ArchConfig):
    """The family's model on ``meta``: shapes and types only."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T

    return (ED.EncDec if cfg.family == "encdec" else T.Transformer)(cfg, device="meta")


def make_step(cfg: ArchConfig, shape: ShapeDef, max_len: int | None = None):
    """(state, step): the arguments the cell's step takes beside its batch
    (the model, and the optimizer for train) and ``step(state, batch)``."""
    from repro_torch.launch import serve_decode as sd
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig

    model = meta_model(cfg)
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
    return {"params": model}, lambda st, b: sd.decode_step(cfg, st["params"], b["token"], b["caches"], pos)


def model_flops_of(cfg: ArchConfig, shape: ShapeDef) -> float:
    if shape.kind == "train":
        return rl.model_flops_train(cfg, shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return rl.model_flops_prefill(cfg, shape.global_batch, shape.seq_len)
    return rl.model_flops_decode(cfg, shape.global_batch, shape.seq_len)


def argument_bytes(state: dict, batch: dict, mesh: Mesh, cfg: ArchConfig, specs: dict) -> dict:
    """Bytes of the step's arguments on one device: the whole tensors on
    1x1, else each over the pieces its placement cuts it into (the
    optimizer's moments placed as their parameters)."""
    caches = batch.get("caches")
    rest = {k: v for k, v in batch.items() if k != "caches"}
    if mesh.size == 1:
        out = {"params": tensor_bytes(state["params"]), "batch": tensor_bytes(rest)}
        if "optimizer" in state:
            out["optimizer"] = tensor_bytes(state["optimizer"])
        if caches is not None:
            out["caches"] = tensor_bytes(caches)
        return out
    pspecs = sh.make_pspecs(cfg, mesh, state["params"])
    out = {"params": sh.per_device_bytes(state["params"], pspecs, mesh),
           "batch": sum(sh.per_device_bytes(v, specs[k], mesh) for k, v in rest.items())}
    if "optimizer" in state:
        opt = state["optimizer"]
        out["optimizer"] = tensor_bytes(opt.step) + sum(
            sh.per_device_bytes(t, _moment_spec(pspecs[n], t), mesh)
            for moments in opt[1:] for n, t in moments.items())
    if caches is not None:
        out["caches"] = sh.per_device_bytes(caches, specs["caches"], mesh)
    return out


def _moment_spec(spec: tuple, t: torch.Tensor) -> tuple:
    """A moment's placement from its parameter's: AdamW's as it is, an
    Adafactor row or column factor with the reduced dim dropped (the
    reference's ``vr_spec`` / ``vc_spec``)."""
    if t.ndim == len(spec):
        return spec
    if t.ndim == len(spec) - 1 and t.ndim >= 1:
        return spec[:-1]  # vr: the last dim reduced
    return (None,) * t.ndim


def run_cell(cfg: ArchConfig, shape: ShapeDef, mesh: Mesh = ONE_CARD, verbose: bool = True,
             max_len: int | None = None) -> dict:
    """The cell's record (the reference's fields). ``max_len`` sizes a
    prefill's caches (default: the shape's sequence)."""
    t0 = time.perf_counter()
    batch, specs = input_specs(cfg, shape, mesh)
    state, step = make_step(cfg, shape, max_len)
    args = argument_bytes(state, batch, mesh, cfg, specs)
    arg_total = sum(args.values())
    model_flops = model_flops_of(cfg, shape)
    rec = {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind, "mesh": list(mesh.shape),
        "axes": list(mesh.axis_names), "chips": mesh.size, "ok": True,
        "model_flops": model_flops, "total_params": rl.total_param_count(cfg),
        "active_params": rl.active_param_count(cfg),
    }
    if mesh.size > 1:
        rec.update(ok=False, skipped=True, reason=MULTI_DEVICE_NOTE,
                   memory_analysis={"argument_size_in_bytes": arg_total, "arguments": args},
                   flops_per_device=None, bytes_per_device=None, collective_traffic_per_device=None)
        if verbose:
            print(f"[{cfg.name} x {shape.name} x {'x'.join(map(str, mesh.shape))}] argument bytes "
                  f"a device {arg_total} {args}; {MULTI_DEVICE_NOTE}")
        return rec
    _, costs = count(lambda: step(state, batch))
    roof = step_roofline(costs, model_flops)
    temp = costs["temp_bytes"]
    rec.update({
        "count_seconds": round(time.perf_counter() - t0, 2),
        "costs_extrapolated": False,
        "flops_per_device": costs["flops"],
        "f32_ops_per_device": costs["f32_ops"],
        "f64_ops_per_device": costs["f64_ops"],
        "bytes_per_device": costs["bytes"],
        "collective_traffic_per_device": 0.0,
        "collective_ops": {},
        "collective_traffic_by_op": {},
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
    if costs["assumed_nonzero"]:
        rec["moe_dispatch"] = MOE_DISPATCH
    if verbose:
        t = rec["terms_seconds"]
        print(f"[{cfg.name} x {shape.name} x 1x1] counted in {rec['count_seconds']}s, "
              f"{costs['ops']} operators")
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
            if ok and unported(cfg):
                ok, reason = False, f"skip(not ported: {', '.join(unported(cfg))})"
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
