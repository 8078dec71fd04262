"""Adafactor (factored second moment): O(r + c) optimizer state per matrix
instead of O(r c), no first moment.

Port of ``repro.optim.adafactor``, over ``{name: tensor}`` mappings as
``optim.adamw``; parameters and the moments are updated in place."""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch


class FactoredState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    vr: dict[str, torch.Tensor]  # row second moment (the full moment for rank < 2)
    vc: dict[str, torch.Tensor]  # column second moment (a (1,) placeholder for rank < 2)


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def _zeros(p: torch.Tensor, shape, dropped: int | None) -> torch.Tensor:
    """float32 zeros of ``shape`` on ``p``'s device. For a DTensor ``p``
    a DTensor placed as ``p`` with dimension ``dropped`` removed (the
    reference's ``vr_spec`` / ``vc_spec``): a mesh dimension that split
    it replicates, one that split a later dimension splits the one
    before; ``dropped`` None replicates everything (the (1,) placeholder)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(p, DTensor):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    pls = []
    for pl in p.placements:
        if not isinstance(pl, Shard) or dropped is None or pl.dim == dropped:
            pls.append(Replicate())
        else:
            pls.append(Shard(pl.dim - 1) if pl.dim > dropped else pl)
    from torch.distributed.tensor import distribute_tensor

    full = torch.zeros(shape, dtype=torch.float32, device=p.to_local().device)
    return distribute_tensor(full, p.device_mesh, pls, src_data_rank=None)


def adafactor_init(params: Mapping[str, torch.Tensor]) -> FactoredState:
    def vr(p):
        if _factored(p):
            return _zeros(p, p.shape[:-1], p.ndim - 1)
        return torch.zeros_like(p, dtype=torch.float32)

    def vc(p):
        if _factored(p):
            return _zeros(p, p.shape[:-2] + p.shape[-1:], p.ndim - 2)
        return _zeros(p, (1,), None)

    device = next(iter(params.values())).device
    return FactoredState(torch.zeros((), dtype=torch.int32, device=device),
                         {n: vr(p) for n, p in params.items()}, {n: vc(p) for n, p in params.items()})


@torch.no_grad()
def adafactor_update(grads: Mapping[str, torch.Tensor], state: FactoredState,
                     params: Mapping[str, torch.Tensor], lr=1e-3, decay: float = 0.99,
                     eps: float = 1e-30, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    """One step; returns (params, state), both updated in place but the
    step. ``lr`` may be a float or a 0-d float32 tensor."""
    for n, p in params.items():
        vr, vc = state.vr[n], state.vc[n]
        g32 = grads[n].float()
        g2 = g32 * g32 + eps
        if _factored(p):
            new_vr = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
            new_vc = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
            r = new_vr / torch.clamp(torch.mean(new_vr, dim=-1, keepdim=True), min=eps)
            u = g32 / (torch.sqrt(r)[..., None] * torch.sqrt(new_vc)[..., None, :])
            vc.copy_(new_vc)
        else:
            new_vr = decay * vr + (1 - decay) * g2
            u = g32 / torch.sqrt(new_vr)
        vr.copy_(new_vr)
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        p32 = p.float()
        p.copy_(p32 - lr * (u + weight_decay * p32))
    return params, FactoredState(state.step + 1, state.vr, state.vc)
