"""Slice-level scheduling across shards (paper §4/§6).

Port of ``repro.runtime.scheduler``; the shard count comes from a device
list or an int (the reference reads a JAX mesh's data axis).

The paper assigns each Spark worker *whole slices* — windows of one slice
stay on one node so the reuse cache and the resume watermark remain local.
``assign_slices`` reproduces that: slices are dealt round-robin over the
shards (balanced to within one slice), and each shard runs its own
``regions.Plan`` through a ``core.executor.StagedExecutor``.

The shards execute in turn in one process (or a single ``shard`` —
"this node's" assignment — runs alone); per-shard wall clocks and
per-window durations feed ``StepMonitor`` instances so straggler flagging
(runtime/monitor.py) works at both granularities.

This module deliberately does not import the executor: any object with
``data.geometry``, ``config.window_lines`` and ``run(plan, resume=...,
on_window=...)`` schedules fine, which also keeps the import graph acyclic
(core.executor already depends on runtime.monitor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

from repro_torch.core import regions
from repro_torch.runtime import elastic
from repro_torch.runtime.faults import ShardLostError
from repro_torch.runtime.monitor import StepMonitor, StragglerPolicy


@dataclass(frozen=True)
class ShardAssignment:
    shard: int
    slices: tuple[int, ...]


def assign_slices(slices: Sequence[int], num_shards: int) -> tuple[ShardAssignment, ...]:
    """Deal ``slices`` round-robin over ``num_shards`` (balanced within 1;
    preserves the given slice order within each shard)."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return tuple(
        ShardAssignment(i, tuple(slices[i::num_shards])) for i in range(num_shards)
    )


def mesh_num_shards(devices) -> int:
    """Shard count from a list of devices (one shard a device) or an int:
    the port's stand-in for the reference's mesh data axis."""
    if isinstance(devices, int):
        return devices
    return len(devices)


class SliceScheduler:
    """Runs per-shard slice plans and monitors them.

    ``num_shards`` may be given directly or derived from a device list
    (``mesh_num_shards``). ``shard_monitor`` times whole shard runs with the real clock (so
    ``check_stragglers`` can flag a hung shard from another thread);
    ``window_monitor`` accumulates per-window durations reported by the
    executors (medians across shards — the trailing distribution that
    re-dispatch decisions use).
    """

    def __init__(
        self,
        num_shards: int | None = None,
        devices=None,
        policy: StragglerPolicy | None = None,
    ):
        if num_shards is None:
            if devices is None:
                raise ValueError("pass num_shards or devices")
            num_shards = mesh_num_shards(devices)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        self.num_shards = num_shards
        self.shard_monitor = StepMonitor(policy or StragglerPolicy())
        self.window_monitor = StepMonitor(policy or StragglerPolicy())
        self.last_reports: dict[int, object] = {}
        self.lost_shards: tuple[int, ...] = ()
        self.last_redeal: elastic.RedealPlan | None = None

    def assignments(self, slices: Sequence[int]) -> tuple[ShardAssignment, ...]:
        return assign_slices(slices, self.num_shards)

    def plan_for(
        self, geom: regions.CubeGeometry, slices: Sequence[int],
        window_lines: int, shard: int,
    ) -> regions.Plan:
        a = self.assignments(slices)[shard]
        return regions.build_plan(geom, a.slices, window_lines)

    def run(
        self,
        executor_factory: Callable[[int], object],
        slices: Sequence[int],
        window_lines: int | None = None,
        shard: int | None = None,
        resume: bool = False,
        on_window: Callable | None = None,
        joined: Sequence[int] = (),
    ) -> Mapping[int, object]:
        """Execute the assignment; returns {slice -> SliceResult} merged
        over the shards that ran.

        ``executor_factory(shard)`` builds (or returns) the executor for one
        shard — on a cluster that is the per-node construction site; here it
        usually returns executors over the same data source. ``shard``
        restricts execution to one shard ("this node").

        Shard loss (``ShardLostError`` escaping an executor run) is
        survivable when other shards ran: the dead shard's *unfinished*
        slices are re-dealt over the healthy shards via
        ``elastic.plan_redeal`` and run there (with ``resume=True``, so
        windows the dead shard already persisted are skipped). One level
        only — a shard dying during its re-dealt work propagates.
        ``joined`` names shards outside the original deal that may take
        redealt slices (grown capacity — executors for them come from the
        same factory).
        """
        results: dict[int, object] = {}
        self.last_reports = {}
        self.last_redeal = None
        lost: list[int] = []
        pending: list[int] = []  # slices stranded on dead shards, in order
        healthy: list[int] = []
        for a in self.assignments(slices):
            if shard is not None and a.shard != shard:
                continue
            if not a.slices:
                healthy.append(a.shard)
                continue
            try:
                results.update(self._run_shard(
                    executor_factory, a.shard, a.slices, window_lines,
                    resume, on_window,
                ))
                healthy.append(a.shard)
            except ShardLostError:
                lost.append(a.shard)
                pending.extend(s for s in a.slices if s not in results)
        if lost:
            self.lost_shards = tuple(lost)
            plan = elastic.plan_redeal(pending, healthy, lost, joined=joined)
            self.last_redeal = plan
            for h in plan.healthy_shards:
                redealt = plan.slices_for(h)
                if redealt:
                    # resume=True: skip whatever the dead shard persisted
                    # before dying (the watermark is the recovery line).
                    results.update(self._run_shard(
                        executor_factory, h, redealt, window_lines,
                        True, on_window,
                    ))
        return results

    def _run_shard(
        self,
        executor_factory: Callable[[int], object],
        shard: int,
        shard_slices: Sequence[int],
        window_lines: int | None,
        resume: bool,
        on_window: Callable | None,
    ) -> Mapping[int, object]:
        ex = executor_factory(shard)
        wl = window_lines if window_lines is not None else ex.config.window_lines
        plan = regions.build_plan(ex.data.geometry, shard_slices, wl)

        def hook(ws):
            uid = f"s{ws.window.slice_i}/l{ws.window.line_start:05d}"
            self.window_monitor.start(uid, now=0.0)
            self.window_monitor.finish(
                uid, now=ws.load_seconds + ws.compute_seconds
            )
            if on_window:
                on_window(ws)

        sid = f"shard{shard}"
        self.shard_monitor.start(sid)
        try:
            out = ex.run(plan, resume=resume, on_window=hook)
        finally:
            self.shard_monitor.finish(sid)
        self.last_reports[shard] = getattr(ex, "last_report", None)
        return out
