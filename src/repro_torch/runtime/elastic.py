"""Elastic plans: respond to node/shard loss by re-planning the work.

A copy of ``repro.runtime.elastic`` (standard library only).

Two granularities live here. ``plan_remesh`` is the training-style contract
at 1000+ nodes: a failure shrinks the healthy device set; pick the largest
(data', model') grid that fits it, preserve model-axis divisibility, keep
the global batch via grad-accumulation, and let CheckpointManager.restore
re-layout.

``plan_redeal`` is the PDF pipeline's batch form of the same thing
(DESIGN.md §14): slices are dealt round-robin over shards
(``scheduler.assign_slices``), and whole slices are the unit of locality —
so when a shard dies mid-run (``faults.ShardLostError``), its *unfinished
slices* are simply re-dealt round-robin over the surviving shards. Safe by
the same argument as retry/speculation: slices are independently
recomputable, the watermark/resume machinery skips whatever the dead shard
already persisted, and re-running a window yields bitwise-identical bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    pods: int
    grad_accum: int  # multiplier to preserve global batch

    @property
    def devices(self) -> int:
        return self.data * self.model * self.pods


def plan_remesh(
    healthy_devices: int,
    model_divisors: tuple[int, ...],
    target_global_batch: int,
    old_plan: ElasticPlan,
) -> ElasticPlan:
    """Choose the best mesh for the healthy device count.

    ``model_divisors``: acceptable model-axis sizes for the architecture
    (e.g. (16, 8, 4) — d_ff/head divisibility). Prefers the largest total
    device usage, then the largest model axis (keeps per-device memory low).
    """
    best: ElasticPlan | None = None
    for m in sorted(model_divisors, reverse=True):
        if m > healthy_devices:
            continue
        d = healthy_devices // m
        used = d * m
        accum_scale = max(
            1, (old_plan.data * old_plan.pods * old_plan.grad_accum + d - 1) // d
        )
        cand = ElasticPlan(data=d, model=m, pods=1, grad_accum=accum_scale)
        if best is None or cand.devices > best.devices or (
            cand.devices == best.devices and cand.model > best.model
        ):
            best = cand
    if best is None:
        raise ValueError(f"no viable mesh for {healthy_devices} devices")
    return best


@dataclass(frozen=True)
class RedealPlan:
    """Recovery plan for lost shards: which slices move where."""

    lost_shards: tuple[int, ...]
    healthy_shards: tuple[int, ...]
    # slice -> healthy shard that takes it over, round-robin in slice order.
    assignments: tuple[tuple[int, int], ...]

    def slices_for(self, shard: int) -> tuple[int, ...]:
        return tuple(s for s, sh in self.assignments if sh == shard)


def plan_redeal(
    pending_slices: Sequence[int],
    healthy_shards: Sequence[int],
    lost_shards: Sequence[int] = (),
    joined: Sequence[int] = (),
) -> RedealPlan:
    """Re-deal a dead shard's unfinished slices over the healthy shards.

    Round-robin in the given slice order, mirroring ``assign_slices`` — the
    re-deal stays balanced to within one slice. ``joined`` adds shards that
    were NOT part of the original deal (grown capacity: an idle shard of a
    widened mesh, or a cluster join-only worker) — they take redealt slices
    exactly like survivors, which is the grow half of elastic execution.
    Raises when no shard (healthy or joined) remains: with every worker
    dead and nobody joining there is no degraded mode, the run must fail
    loudly."""
    healthy = tuple(dict.fromkeys([*healthy_shards, *joined]))
    if not healthy:
        raise ValueError(
            f"cannot re-deal slices {tuple(pending_slices)}: no healthy "
            f"shards remain (lost: {tuple(lost_shards)})")
    assignments = tuple(
        (s, healthy[i % len(healthy)]) for i, s in enumerate(pending_slices)
    )
    return RedealPlan(
        lost_shards=tuple(lost_shards),
        healthy_shards=healthy,
        assignments=assignments,
    )
