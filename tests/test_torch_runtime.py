"""Port vs reference: the runtime's pure-Python layers.

``runtime.monitor`` (percentiles, straggler flags, medians), ``runtime.elastic``
(``plan_remesh``, ``plan_redeal``) and ``runtime.scheduler.assign_slices``
give the reference's answers on the same inputs, drawn with numpy from a
seed. All exact: nothing here is floating-point arithmetic beyond the
durations fed in, which both packages see as the same Python floats."""

import dataclasses

import numpy as np
import pytest
pytest.importorskip("torch")

from repro.runtime import elastic as r_el
from repro.runtime import monitor as r_mon
from repro.runtime import scheduler as r_sch
from repro_torch.core import regions as t_regions
from repro_torch.runtime import elastic as t_el
from repro_torch.runtime import monitor as t_mon
from repro_torch.runtime import scheduler as t_sch


def _durations(seed, n):
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.lognormal(0.0, 1.0, n)]


@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 7), (3, 100), (4, 9000)])
def test_percentiles_match_reference(seed, n):
    d = _durations(seed, n)
    for qs in ((0.5, 0.99), (0.1, 0.5, 0.9, 0.999)):
        assert t_mon.percentiles(d, qs) == r_mon.percentiles(d, qs)


def _drive(mod, policy_kw, durations, probes):
    """Feed a monitor ``durations`` on a synthetic clock, leave three units
    in flight, and record median, flags and percentiles at each probe."""
    mon = mod.StepMonitor(mod.StragglerPolicy(**policy_kw))
    t, out = 0.0, []
    for i, dur in enumerate(durations):
        mon.start(f"u{i}", now=t)
        if i % 7 == 3:
            mon.abandon(f"u{i}")  # a failed attempt: no duration recorded
        else:
            mon.finish(f"u{i}", now=t + dur)
        t += dur
    for j in range(3):
        mon.start(f"live{j}", now=t + j)
    for p in probes:
        out.append((mon.median(), mon.check_stragglers(now=t + p)))
    return out, list(mon.flagged), mon.completed, mon.history, mon.percentiles()


@pytest.mark.parametrize("policy_kw", [
    dict(), dict(window=8, threshold=2.0, min_samples=3, grace_seconds=0.0),
    dict(window=4, threshold=1.5, min_samples=1, grace_seconds=0.5),
    dict(min_samples=50),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_step_monitor_matches_reference(policy_kw, seed):
    durations = _durations(seed, 40)
    probes = [0.1, 1.0, 2.5, 5.0, 20.0]
    assert _drive(t_mon, policy_kw, durations, probes) == \
        _drive(r_mon, policy_kw, durations, probes)


def test_history_is_bounded_as_reference():
    assert t_mon.HISTORY_LIMIT == r_mon.HISTORY_LIMIT
    assert [f.name for f in dataclasses.fields(t_mon.StragglerPolicy)] == \
        [f.name for f in dataclasses.fields(r_mon.StragglerPolicy)]
    assert t_mon.StragglerPolicy() == t_mon.StragglerPolicy(
        **dataclasses.asdict(r_mon.StragglerPolicy()))


@pytest.mark.parametrize("healthy,divisors,old", [
    (240, (16, 8, 4), (16, 16, 1, 1)),
    (16, (8, 4, 2), (4, 4, 1, 1)),
    (7, (4, 2, 1), (2, 4, 1, 3)),
    (1000, (16, 8), (62, 16, 1, 1)),
    (3, (4, 2), (1, 2, 2, 1)),
])
def test_plan_remesh_matches_reference(healthy, divisors, old):
    got = t_el.plan_remesh(healthy, divisors, 256, t_el.ElasticPlan(*old))
    want = r_el.plan_remesh(healthy, divisors, 256, r_el.ElasticPlan(*old))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.devices == want.devices


def test_plan_remesh_impossible_raises_as_reference():
    for mod in (t_el, r_el):
        with pytest.raises(ValueError, match="no viable mesh"):
            mod.plan_remesh(1, (8,), 8, mod.ElasticPlan(1, 1, 1, 1))


@pytest.mark.parametrize("seed", range(6))
def test_plan_redeal_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pending = [int(s) for s in rng.permutation(40)[: rng.integers(0, 12)]]
    shards = [int(s) for s in rng.permutation(8)]
    cut = int(rng.integers(0, 8))
    lost, healthy = shards[:cut], shards[cut:]
    joined = [int(s) for s in rng.integers(0, 12, rng.integers(0, 3))]
    if not healthy and not joined:
        for mod in (t_el, r_el):
            with pytest.raises(ValueError, match="no healthy shards"):
                mod.plan_redeal(pending, healthy, lost, joined=joined)
        return
    got = t_el.plan_redeal(pending, healthy, lost, joined=joined)
    want = r_el.plan_redeal(pending, healthy, lost, joined=joined)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for h in got.healthy_shards:
        assert got.slices_for(h) == want.slices_for(h)


@pytest.mark.parametrize("num_slices,num_shards", [(0, 1), (1, 3), (7, 2), (12, 4), (5, 8)])
def test_assign_slices_matches_reference(num_slices, num_shards):
    slices = list(np.random.default_rng(num_slices).permutation(3 * num_slices + 1)[:num_slices])
    got = t_sch.assign_slices(slices, num_shards)
    want = r_sch.assign_slices(slices, num_shards)
    assert [(a.shard, a.slices) for a in got] == [(a.shard, a.slices) for a in want]
    with pytest.raises(ValueError):
        t_sch.assign_slices(slices, 0)


def test_shard_count_from_devices_or_int():
    assert t_sch.mesh_num_shards(3) == 3
    assert t_sch.mesh_num_shards(["cuda:0", "cuda:1"]) == 2
    assert t_sch.SliceScheduler(devices=["cpu"] * 4).num_shards == 4
    assert t_sch.SliceScheduler(num_shards=2).num_shards == 2
    with pytest.raises(ValueError, match="num_shards or devices"):
        t_sch.SliceScheduler()
    geom = t_regions.CubeGeometry(6, 10, 4)
    plan = t_sch.SliceScheduler(num_shards=2).plan_for(geom, [0, 1, 2, 3, 4], 4, shard=1)
    assert plan.slices == (1, 3)
    assert [tuple(u.window) for u in plan.units][:3] == [(1, 0, 4), (1, 4, 8), (1, 8, 10)]
