"""The trainer: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro.launch.train``: config -> init on the device -> train step
(loss and gradients by autograd, remat, gradient accumulation, the
optimizer) -> checkpoints (async, restartable) -> step monitoring. It runs
on ``cuda`` unless ``--device`` says otherwise, e.g.

    python -m repro_torch.launch.train --arch granite-3-8b --reduced --device cpu --steps 20

The optimizer comes from the config, as the reference's dry-run builds it
(``repro/launch/dryrun.py:41-55``, the one place the reference reads these
knobs): Adafactor with ``use_adafactor``, else AdamW with bfloat16 moments
under ``adam_moments_bf16`` and float32 ones otherwise. Adafactor takes the
trainer's learning rate and schedule.

**Meshes.** ``--mesh 1x1`` (the default) is the one-device path. A mesh
above it runs in a ``torch.distributed`` world of as many ranks, one
device each, e.g.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch granite-3-8b --reduced \
        --device cpu --mesh 2x2

(or ``launch.mesh.run_world``): the parameters become DTensors placed by
``models/sharding.make_pspecs`` on a ``DeviceMesh`` with the reference's
``data`` and ``model`` axes, the token batch is split over ``data``, and
``build_step``'s step runs the same code on them. DTensor inserts the
collectives the placements call for (tensor parallelism over ``model``,
the gradients' data-parallel reduction over ``data``); K5 runs on each
rank's own heads (``sharding.local_heads``). The backend is ``nccl`` on
CUDA devices and ``gloo`` on the CPU. Every rank draws the same seed-0
weights and the same token batches and keeps its own blocks.

Determinism: a step from the same state gives the same bits. The
backward's scatters (the embedding gather's ``index_put_(accumulate=True)``,
the MoE's index reads) run on CUDA through PyTorch's sort-based
accumulation, not float atomics; the target gather of the loss scatters
one value an index.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os

import torch

from repro_torch.checkpoint import CheckpointManager, shardings_of
from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.core.pipeline import resolve_device
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import backend_for, device_mesh, parse_mesh
from repro_torch.models import encdec as ED
from repro_torch.models import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.optim import (AdamWConfig, adafactor_init, adafactor_update, adamw_init,
                               adamw_update, cosine_schedule, global_norm)
from repro_torch.runtime import StepMonitor, trace


def adamw_config(cfg: ArchConfig, opt_cfg: AdamWConfig) -> AdamWConfig:
    """``opt_cfg`` with the moment type ``cfg`` asks for."""
    return dataclasses.replace(opt_cfg, moment_dtype=torch.bfloat16) if cfg.adam_moments_bf16 else opt_cfg


def init_optimizer(cfg: ArchConfig, params: dict, opt_cfg: AdamWConfig):
    """The optimizer state ``build_step``'s step takes for ``cfg``."""
    if cfg.use_adafactor:
        return adafactor_init(params)
    return adamw_init(params, adamw_config(cfg, opt_cfg))


def loss_of(model, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.family == "encdec":
        return ED.loss_fn(model, batch["frames"], batch["tokens"], batch["targets"], cfg)
    extras = {"memory": batch["memory"]} if "memory" in batch else None
    return T.loss_fn(model, batch["tokens"], batch["targets"], cfg, extras)


def value_and_grad(model, batch: dict, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """(loss, {name: gradient}) of ``loss_of``; the parameters must require
    gradients."""
    names, params = zip(*model.named_parameters())
    with torch.enable_grad():
        with trace.span("train.forward", phase="forward"):
            loss = loss_of(model, batch, cfg)
        with trace.span("train.backward", phase="backward"):
            grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def build_step(cfg: ArchConfig, opt_cfg: AdamWConfig, total_steps: int, accum: int = 1):
    """step(model, opt, batch) -> (model, opt, loss, gnorm), the model's
    parameters and the optimizer's moments updated in place. With
    ``accum`` > 1 every batch entry leads with (accum, ...): the
    micro-batches' losses and gradients are summed in float32, then
    divided by ``accum``. The LR scale is the cosine schedule at the
    optimizer's step before the update. On DTensor parameters
    (``sharding.distribute_params``) the same code runs under
    ``implicit_replication``, each gradient placed as its parameter before
    the update, and the loss and norm come back whole. Traced as a unit,
    the span ``train.step``: ``train.forward``, ``train.backward`` (each
    micro-batch's) and ``train.optimizer``."""
    adamw_cfg = adamw_config(cfg, opt_cfg)

    def step(model, opt, batch):
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        sharded = sh.is_dtensor(next(iter(params.values())))
        # implicit_replication: the plain tensors the model makes (positions,
        # masks, the step counter) count as replicated beside the DTensors.
        with trace.span("train.step", unit=True), \
                sh.implicit_replication() if sharded else contextlib.nullcontext():
            return _step(model, opt, batch, params, sharded)

    def _step(model, opt, batch, params, sharded):
        if accum == 1:
            loss, grads = value_and_grad(model, batch, cfg)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=opt.step.device)
            grads = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
            for i in range(accum):
                l, g = value_and_grad(model, {k: v[i] for k, v in batch.items()}, cfg)
                loss = loss + l
                for n, acc in grads.items():
                    acc += _placed_as(g[n], acc) if sharded else g[n]
            loss = loss / accum
            grads = {n: g / accum for n, g in grads.items()}
        if sharded:
            grads = {n: _placed_as(g, params[n]) for n, g in grads.items()}
        with trace.span("train.optimizer"):
            lr_scale = cosine_schedule(opt.step, warmup=max(total_steps // 20, 1), total=total_steps)
            if cfg.use_adafactor:
                _, opt = adafactor_update(grads, opt, params, lr=opt_cfg.lr * lr_scale)
                gnorm = global_norm(grads.values())
            else:
                _, opt, gnorm = adamw_update(grads, opt, params, adamw_cfg, lr_scale)
        if sharded:  # the loss and the norm whole on every rank, as plain tensors
            loss, gnorm = (t.full_tensor() if sh.is_dtensor(t) else t for t in (loss, gnorm))
        return model, opt, loss, gnorm

    return step


def _placed_as(g, p):
    """The gradient ``g`` placed as its parameter ``p`` (a partial sum
    reduced, a replicated gradient cut to the parameter's block)."""
    if tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_batch(cfg: ArchConfig, tokens, targets, step: int, device, accum: int = 1) -> dict:
    """The step's batch on ``device``: the pipeline's tokens and targets,
    the VLM's memory (zeros) and the enc-dec's frames (standard normals
    seeded by the step), as the reference's loop makes them; with
    ``accum`` > 1 each entry split into (accum, B / accum, ...)."""
    b, s = tokens.shape
    batch = {"tokens": torch.from_numpy(tokens).to(device).long(),
             "targets": torch.from_numpy(targets).to(device).long()}
    if cfg.family == "vlm":
        batch["memory"] = torch.zeros((b, cfg.num_patches, cfg.d_model), dtype=torch.float32,
                                      device=device)
    if cfg.family == "encdec":
        gen = torch.Generator(device=device).manual_seed(step)
        batch["frames"] = torch.randn((b, s, cfg.d_model), generator=gen, device=device)
    if accum > 1:
        if b % accum:
            raise ValueError(f"batch {b} is not a multiple of accum {accum}")
        batch = {k: v.reshape(accum, b // accum, *v.shape[1:]) for k, v in batch.items()}
    return batch


def init_model(cfg: ArchConfig, device):
    """The family's model with seed-0 weights on ``device``, trainable."""
    init = ED.init_params if cfg.family == "encdec" else T.init_params
    return init(cfg, torch.Generator(device=device).manual_seed(0), device).requires_grad_(True)


def join_world(mesh, device: str | None):
    """(the ``DeviceMesh`` of ``mesh``, whether this call joined the world)
    for a rank that ``torchrun`` started: joins the world its environment
    describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``),
    with ``nccl`` on CUDA and ``gloo`` on the CPU, unless a world is up
    already. Without one it raises and says how to launch."""
    import torch.distributed as dist

    dev_type = resolve_device(device).type if device else "cuda"
    joined = not dist.is_initialized()
    if joined:
        if "RANK" not in os.environ:
            shape = "x".join(map(str, mesh.shape))
            raise RuntimeError(
                f"--mesh {shape} needs a world of {mesh.size} ranks: launch with torchrun "
                f"--nproc-per-node {mesh.size} -m repro_torch.launch.train --mesh {shape} ..., "
                "or call main() on every rank of launch.mesh.run_world")
        if dev_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend_for(dev_type))
    return device_mesh(mesh, dev_type), joined


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.names())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="data x model, e.g. 2x4; above 1x1 under torchrun (one rank a device)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = parse_mesh(args.mesh)
    dmesh, joined = join_world(mesh, args.device) if mesh.size > 1 else (None, False)
    dev = resolve_device(args.device)
    if dmesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    model = init_model(cfg, dev)
    if dmesh is not None:
        sh.distribute_params(cfg, dmesh, model)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt = init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)

    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if mgr and args.resume:
        like = {"params": dict(model.named_parameters()), "opt": opt}
        restored, manifest = mgr.restore_latest(like, placements=shardings_of(like))
        if restored is not None:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(restored["params"][n])
            opt = restored["opt"]
            start_step = manifest["step"]
            pipe.restore(manifest["extra"]["pipeline"])
            print(f"resumed from step {start_step}")

    step_fn = build_step(cfg, opt_cfg, args.steps, args.accum)
    monitor = StepMonitor()
    loss = float("nan")
    for step in range(start_step, args.steps):
        tokens, targets = pipe.next_batch()
        batch = make_batch(cfg, tokens, targets, step, dev, args.accum)
        if dmesh is not None:
            batch = sh.shard_batch(batch, dmesh, dim=1 if args.accum > 1 else 0)
        monitor.start(f"step{step}")
        model, opt, loss, gnorm = step_fn(model, opt, batch)
        loss = float(loss)
        dur = monitor.finish(f"step{step}")
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  gnorm {float(gnorm):.3f}  {dur*1e3:.0f}ms")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": dict(model.named_parameters()), "opt": opt},
                     extra={"pipeline": pipe.state()}, async_=True)
    if mgr:
        mgr.save(args.steps, {"params": dict(model.named_parameters()), "opt": opt},
                 extra={"pipeline": pipe.state()})
        mgr.wait()
    print("training done; final loss", loss)
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return loss


if __name__ == "__main__":
    main()
