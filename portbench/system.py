"""The system under test: the port's own entry points, built from a
configuration file and the benchmark's weights.

This is the only module of the harness that imports ``repro_torch``. It
takes from the program the model, ``launch.serve_decode.prefill`` (a
prefill cell's request) and ``launch.train.build_step`` (a training cell's
step); nothing else of the program runs. The port's ``init_params`` does
not run: ``build_model`` makes the model with empty parameters and fills
them with ``portbench.weights``' tensors, name by name.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import weights as W


def arch_config(config: dict):
    """The port's ``ArchConfig`` of a configuration file: every key that is
    one of its fields, the layer lists as ``BlockDef``s and the type names
    as torch types."""
    from repro_torch.configs.base import ArchConfig, BlockDef

    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    for key in ("prefix", "pattern"):
        if key in kw:
            kw[key] = tuple(BlockDef(**b) for b in kw[key])
    for key in ("param_dtype", "compute_dtype"):
        if key in kw:
            kw[key] = W.dtype(kw[key])
    return ArchConfig(**kw)


def build_model(config: dict, seed: int, device):
    """The port's model of ``config`` with the weights of ``seed``; raises
    if its parameters are not exactly those the configuration states."""
    from repro_torch.models import transformer as T

    cfg = arch_config(config)
    model = T.Transformer(cfg, device)
    params = dict(model.named_parameters())
    stated = {name: shape for _, leaves in W.layout(config) for name, shape, _, _ in leaves}
    if set(params) != set(stated):
        raise ValueError(f"the port's parameters differ from the configuration's: only in the port "
                         f"{sorted(set(params) - set(stated))[:5]}, only stated "
                         f"{sorted(set(stated) - set(params))[:5]}")
    with torch.no_grad():
        for _, tensors in W.draw(config, seed, device):
            for name, t in tensors.items():
                p = params[name]
                if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
                    raise ValueError(f"{name}: the port has {tuple(p.shape)} {p.dtype}, the "
                                     f"configuration {tuple(t.shape)} {t.dtype}")
                p.copy_(t)
            del tensors
    return cfg, model


class Prefill:
    """A prefill request: ``serve_decode.prefill`` with caches sized for
    the prompt plus ``cache_extra`` decode positions; returns the (B, V)
    float32 logits of each prompt's last position."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg, self.model = build_model(config, seed, device)
        self.max_len = traffic["seq_len"] + traffic["cache_extra"]

    def __call__(self, prompt: torch.Tensor) -> torch.Tensor:
        from repro_torch.launch import serve_decode

        logits, caches = serve_decode.prefill(self.cfg, self.model, prompt, None, self.max_len)
        del caches
        return logits

    def close(self) -> None:
        del self.model


class Train:
    """A training step: ``train.build_step``'s step on the port's AdamW, the
    job's settings, from the weights of ``seed``. ``__call__(batch)`` runs
    one step and returns (loss, gradient norm) as device tensors; the
    parameters and the optimizer's state change in place."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.launch import train
        from repro_torch.optim import AdamWConfig

        job = traffic["optimizer"]
        # build_step's cosine schedule warms up over max(total // 20, 1) steps
        # to a floor of 0.1: the job has to state the same.
        if job["warmup_steps"] != max(job["total_steps"] // 20, 1) or job["min_lr_ratio"] != 0.1:
            raise ValueError(f"the port's schedule cannot run {job}")
        self.cfg, self.model = build_model(config, seed, device)
        self.model.requires_grad_(True)
        opt_cfg = AdamWConfig(lr=job["lr"], b1=job["b1"], b2=job["b2"], eps=job["eps"],
                              weight_decay=job["weight_decay"], clip_norm=job["clip_norm"])
        self.b1 = job["b1"]
        self.opt = train.init_optimizer(self.cfg, dict(self.model.named_parameters()), opt_cfg)
        self.step = train.build_step(self.cfg, opt_cfg, job["total_steps"])

    def __call__(self, batch: dict):
        self.model, self.opt, loss, gnorm = self.step(self.model, self.opt, batch)
        return loss, gnorm

    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def first_moment(self) -> dict:
        """The optimizer's first moment of every leaf, by name."""
        return self.opt.mu

    def close(self) -> None:
        del self.model, self.opt, self.step
