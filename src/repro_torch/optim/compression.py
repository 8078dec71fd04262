"""Gradient compression for the cross-pod axis: int8 with a per-tensor
scale.

Port of ``repro.optim.compression``. Within a pod the links are fast;
across pods they are the thin pipe, so only the pod axis's all-reduce is
compressed: each participant quantises with its own symmetric scale,
the scales meet in a max, every participant rescales its int8 values
onto the shared grid, and the rescaled values are summed. Mathematically
it is a mean all-reduce with quantisation noise, which the tests bound.
The reference runs it inside ``shard_map`` with ``pmax`` / ``psum`` over
a mesh axis; the port runs it on a ``torch.distributed`` group (a
``DeviceMesh``'s ``get_group(axis)``) with ``all_reduce(MAX)`` and
``all_reduce(SUM)``."""

from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32/bf16 -> (int8 values, float32 scale)."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def pod_allreduce_compressed(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean all-reduce of ``x`` over ``group`` (default: the world) with an
    int8 payload; every participant gets the same result, in ``x``'s type.
    Every rank of the group must call it."""
    import torch.distributed as dist

    q, scale = compress_int8(x)
    max_scale = scale.clone()
    dist.all_reduce(max_scale, op=dist.ReduceOp.MAX, group=group)
    # Rescale the local int8 values onto the shared grid, sum in float32.
    total = q.float() * (scale / max_scale)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return (total * max_scale / n).to(x.dtype)
