"""AdamW with global-norm clipping and mixed-precision moments.

Port of ``repro.optim.adamw``. The reference is pure-function style,
``(grads, state, params) -> (new_params, new_state)``, and donates the old
buffers; the port updates the parameters and the moments in place (the
counterpart of ``donate_argnums``) and returns them. Parameters and
gradients are ``{name: tensor}`` mappings (``dict(model.named_parameters())``
and the gradients under the same names); moments and the update are float32
whatever ``moment_dtype`` stores, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, NamedTuple

import torch

from repro_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32  # bf16 halves the optimizer's memory


class OptState(NamedTuple):
    step: torch.Tensor  # int32, 0-d, on the parameters' device
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig = AdamWConfig()) -> OptState:
    device = next(iter(params.values())).device
    # zeros_like: a DTensor parameter gets DTensor moments placed as it is.
    zeros = {n: torch.zeros_like(p, dtype=cfg.moment_dtype) for n, p in params.items()}
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros,
                    nu={n: torch.zeros_like(z) for n, z in zeros.items()})


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every entry's square, in float32, the tensors
    summed one after another in the order given."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: OptState,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step: clip by the global norm, bias corrections with the
    step incremented first. Returns (params, state, gnorm): ``params`` and
    the moments updated in place, ``state`` with the new step. Traced as
    the span ``optim``: ``optim.norm`` (the norm and the clip's scale),
    then ``optim.update``."""
    with trace.span("optim"):
        with trace.span("optim.norm"):
            gnorm = global_norm(grads[n] for n in params)
            scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        with trace.span("optim.update"):
            step = state.step + 1
            stepf = step.float()
            b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
            b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)
            lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=stepf.device)
            for n, p in params.items():
                m, v = state.mu[n], state.nu[n]
                g = grads[n].float() * scale
                m32 = m.float() * cfg.b1 + g * (1.0 - cfg.b1)
                v32 = v.float() * cfg.b2 + g * g * (1.0 - cfg.b2)
                update = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
                update += cfg.weight_decay * p.float()
                p.copy_(p.float() - lr * update)
                m.copy_(m32)
                v.copy_(v32)
    return params, OptState(step, state.mu, state.nu), gnorm
