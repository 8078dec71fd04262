"""Port vs reference: the fault layer (``runtime/faults.py``) and the
executor's retry, speculation, quarantine and shard re-deal (DESIGN.md §14).

The invariant held everywhere: any completed result under injected faults
is bitwise equal to the port's fault-free run (loads are deterministic and
fits row-pure). Against the reference: a plan's JSON reads in both
packages, both injectors afflict the same (slice, line, attempt) grid, a
quarantine writes the same failed-unit manifest, and a clean run matches
``repro``'s ``StagedExecutor`` under the ROADMAP's parity rules. A small
seismic cube (3 slices of 12 lines x 30 points, 200 observations, windows
of 3 lines: 12 units) on the CPU."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import distributions as rd
from repro.core import executor as rex
from repro.core import regions as r_regions
from repro.data import simulation as r_sim
from repro.kernels import fitpdf as rfp
from repro.runtime import faults as rf
from repro_torch.core import executor as tex
from repro_torch.core import regions as t_regions
from repro_torch.data import file_source as t_fs
from repro_torch.data import simulation as t_sim
from repro_torch.data.loader import ShardedStager, WindowStager
from repro_torch.runtime import faults as tf
from repro_torch.runtime.scheduler import SliceScheduler

DIMS, OBS, WINDOW_LINES = (3, 12, 30), 200, 3
SLICES = (0, 1, 2)
PPL = DIMS[2]
MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)
# Near-zero backoff (the tests inject the delays they want); no
# speculation unless a test is about speculation.
FAST_RETRY = dict(retry_backoff_s=0.001, speculate=False)


def _sim():
    return t_sim.SeismicSimulation(t_sim.SimulationConfig(
        geometry=t_regions.CubeGeometry(*DIMS), num_simulations=OBS))


def _ref_sim():
    return r_sim.SeismicSimulation(r_sim.SimulationConfig(
        geometry=r_regions.CubeGeometry(*DIMS), num_simulations=OBS))


def _executor(source, method="grouping", injector=None, out_dir=None, **exec_kw):
    cfg = tex.PDFConfig(window_lines=WINDOW_LINES, method=method)
    return tex.StagedExecutor(cfg, source, "cpu", injector=injector, out_dir=out_dir,
                              exec_config=tex.ExecutorConfig(**{**FAST_RETRY, **exec_kw}))


def _run(ex, slices=SLICES, **kw):
    return ex.run(t_regions.build_plan(ex.data.geometry, list(slices), WINDOW_LINES), **kw)


def _bitwise(got, want, what=""):
    for f in tex.RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{what}{f}")
    assert got.avg_error == want.avg_error


@pytest.fixture(scope="module")
def clean():
    """The fault-free port runs every bitwise assertion compares against."""
    return {m: _run(_executor(_sim(), method=m)) for m in ("grouping", "baseline")}


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    return Path(t_fs.export_cube(_sim(), tmp_path_factory.mktemp("cube"), lines_per_chunk=4).path)


# -- the plan and the injector against the reference ---------------------------


PLAN_RULES = [
    dict(kind="read_error", slice_i=1, line_start=3, times=2),
    dict(kind="latency", seconds=0.0, rate=0.25),
    dict(kind="read_error", rate=0.5, times=2),
    dict(kind="corrupt", slice_i=0, rate=0.6),
    dict(kind="persist_error", line_start=6, times=3, rate=0.7),
    dict(kind="cache_error", slice_i=2),
    dict(kind="shard_death", shard=1, after_units=4),
]


def test_plan_json_roundtrips_across_packages():
    t_plan = tf.FaultPlan(seed=7, rules=tuple(tf.FaultRule(**r) for r in PLAN_RULES))
    r_plan = rf.FaultPlan(seed=7, rules=tuple(rf.FaultRule(**r) for r in PLAN_RULES))
    assert t_plan.to_json() == r_plan.to_json()
    assert rf.FaultPlan.from_json(t_plan.to_json()) == r_plan
    assert tf.FaultPlan.from_json(r_plan.to_json()) == t_plan
    assert tf.FaultPlan.from_dict(json.loads(r_plan.to_json(indent=None))).to_dict() == \
        r_plan.to_dict()
    assert tf.FAULT_KINDS == rf.FAULT_KINDS


def test_plan_validation():
    with pytest.raises(ValueError, match="kind"):
        tf.FaultRule("meteor_strike")
    with pytest.raises(ValueError, match="shard"):
        tf.FaultRule("shard_death")
    with pytest.raises(ValueError, match="rate"):
        tf.FaultRule("read_error", rate=0.0)
    with pytest.raises(ValueError, match="times"):
        tf.FaultRule("read_error", times=0)
    with pytest.raises(ValueError, match="unknown fault plan keys"):
        tf.FaultPlan.from_dict({"seed": 0, "rules": [], "extra": 1})


def _hook_pattern(mod, seed):
    """Every hook over a grid of (slice, line, attempt): which calls raise
    (and what), which chunk reads come back corrupted (their bytes)."""
    inj = mod.FaultInjector(mod.FaultPlan(seed=seed, rules=tuple(
        mod.FaultRule(**r) for r in PLAN_RULES)))
    chunk = np.arange(240, dtype=np.float32).reshape(2, 3, 40)
    out = []
    for s in range(4):
        for line in range(0, 20, 3):
            for attempt in range(4):
                for name, call in (
                        ("read", lambda: inj.on_read(s, line)),
                        ("read_shard", lambda: inj.on_read(s, line, shard=s % 2)),
                        ("persist", lambda: inj.on_persist(s, line)),
                        ("cache", lambda: inj.on_cache("lookup", s))):
                    try:
                        call()
                        out.append((s, line, attempt, name, None))
                    except (mod.InjectedFault, mod.ShardLostError) as e:
                        out.append((s, line, attempt, name, f"{type(e).__name__}: {e}"))
                got = inj.chunk_hook(s, line, chunk, attempt + 1)
                out.append((s, line, attempt, "chunk", got.tobytes()))
    return out, dict(inj.events)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_hooks_afflict_the_same_grid_as_reference(seed):
    """Affliction hashes (seed, rule, target) the same way in both packages,
    and attempt counts advance the same: one plan afflicts the same units."""
    got, got_events = _hook_pattern(tf, seed)
    want, want_events = _hook_pattern(rf, seed)
    assert got == want
    assert got_events == want_events
    assert got_events["read_error"] and got_events["shard_death"] and got_events["corrupt"]


def test_affliction_is_deterministic_and_partitions():
    plan = tf.FaultPlan(seed=3, rules=(tf.FaultRule("read_error", rate=0.5),))
    rplan = rf.FaultPlan(seed=3, rules=(rf.FaultRule("read_error", rate=0.5),))
    keys = [(s, line) for s in range(4) for line in range(0, 40, 3)]
    got = [tf.FaultInjector(plan)._afflicted(0, plan.rules[0], k) for k in keys]
    assert got == [rf.FaultInjector(rplan)._afflicted(0, rplan.rules[0], k) for k in keys]
    assert 0 < sum(got) < len(keys)


def test_is_transient_classification():
    assert tf.is_transient(tf.InjectedFault("hiccup"))
    assert tf.is_transient(tf.TransientError("retry me"))
    assert tf.is_transient(OSError("nfs wobble"))
    assert tf.is_transient(TimeoutError("slow"))
    assert not tf.is_transient(ValueError("bad shape"))
    assert not tf.is_transient(tf.ShardLostError(3))
    wrapped = RuntimeError("prefetch stage failed")
    wrapped.__cause__ = OSError("root cause")
    assert tf.is_transient(wrapped)
    fatal = RuntimeError("shard gone")
    fatal.__cause__ = tf.ShardLostError(1)
    assert not tf.is_transient(fatal)
    assert tf.shard_lost_from(fatal) is fatal.__cause__ and tf.shard_lost_from(wrapped) is None
    # The device's own errors are fatal, bare or wrapped around a transient.
    assert not tf.is_transient(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not tf.is_transient(torch.AcceleratorError("CUDA error: an illegal memory access"))
    oom = torch.OutOfMemoryError("CUDA out of memory")
    oom.__cause__ = OSError("unrelated")
    assert not tf.is_transient(oom)
    assert not tf.is_transient(RuntimeError("fitpdf launch failed: too many resources"))


# -- retry, speculation, corrupt chunks, persist errors --------------------------


def test_transient_read_errors_recover_bitwise(clean):
    """Every window's first read fails; retries recover every unit."""
    inj = tf.FaultInjector(tf.FaultPlan(rules=(tf.FaultRule("read_error", times=1),)))
    ex = _executor(inj.wrap_source(_sim()), injector=inj)
    res = _run(ex)
    for s in SLICES:
        assert not res[s].degraded and res[s].retries == 4
        _bitwise(res[s], clean["grouping"][s], f"slice{s}/")
    assert ex.last_report.retries == 12 and ex.last_report.quarantined == 0
    assert inj.events["read_error"] == 12


@pytest.mark.parametrize("exec_kw", [dict(prefetch=False), dict(prefetch_depth=1)])
def test_straggler_speculation_wins_bitwise(clean, exec_kw):
    """A latency spike on a late window trips the straggler limit; the
    speculative second load wins, with the first attempt's bits."""
    inj = tf.FaultInjector(tf.FaultPlan(rules=(
        tf.FaultRule("latency", slice_i=2, line_start=6, seconds=1.5, times=1),)))
    ex = _executor(inj.wrap_source(_sim()), injector=inj, speculate=True,
                   straggler_grace_s=0.3, **exec_kw)
    res = _run(ex)
    for s in SLICES:
        _bitwise(res[s], clean["grouping"][s], f"slice{s}/")
    rep = ex.last_report
    # (a load of another window slowed past the limit by a busy host would
    # be speculated too, and must give the same bits)
    assert rep.speculations >= 1 and rep.speculation_wins >= 1
    assert res[2].speculations >= 1 and inj.events["latency"] == 1
    assert "s2/l00006" in ex.monitors["load"].flagged


def test_corrupt_chunk_reread_recovers_bitwise(clean, cube):
    """A torn first read of one chunk is caught by the manifest sha256 and
    healed by the re-read: no unit retry, the run bitwise the clean one."""
    inj = tf.FaultInjector(tf.FaultPlan(rules=(
        tf.FaultRule("corrupt", slice_i=0, line_start=0, times=1),)))
    ex = _executor(inj.wrap_source(t_fs.FileCubeSource(cube)), injector=inj)
    res = _run(ex)
    for s in SLICES:
        _bitwise(res[s], clean["grouping"][s], f"slice{s}/")
    assert inj.events == {"corrupt": 1}
    assert ex.last_report.retries == 0 and ex.last_report.quarantined == 0


def test_persistent_corruption_is_fatal(cube):
    inj = tf.FaultInjector(tf.FaultPlan(rules=(
        tf.FaultRule("corrupt", slice_i=1, line_start=4, times=2),)))
    ex = _executor(inj.wrap_source(t_fs.FileCubeSource(cube)), injector=inj, prefetch=False)
    with pytest.raises(ValueError, match="corrupt after 2 read attempts"):
        _run(ex)


def test_corrupt_rules_require_file_source():
    inj = tf.FaultInjector(tf.FaultPlan(rules=(tf.FaultRule("corrupt"),)))
    with pytest.raises(ValueError, match="file-backed source"):
        inj.wrap_source(_sim())


def test_persist_errors_recover_bitwise(clean, tmp_path):
    """Two injected write failures of one window are absorbed by the
    persist stage's re-attempts: the files equal a clean persisted run's."""
    inj = tf.FaultInjector(tf.FaultPlan(rules=(
        tf.FaultRule("persist_error", slice_i=1, line_start=3, times=2),)))
    res = _run(_executor(_sim(), injector=inj, out_dir=tmp_path / "faulty"))
    _run(_executor(_sim(), out_dir=tmp_path / "clean"))
    assert inj.events == {"persist_error": 2}
    for s in SLICES:
        _bitwise(res[s], clean["grouping"][s])
    names = sorted(p.name for p in (tmp_path / "clean").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "faulty").iterdir())
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(tmp_path / "clean" / name), np.load(tmp_path / "faulty" / name)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")
        else:
            assert (tmp_path / "clean" / name).read_text() == \
                (tmp_path / "faulty" / name).read_text()
    # a third failure of the same write exhausts its attempts
    inj = tf.FaultInjector(tf.FaultPlan(rules=(
        tf.FaultRule("persist_error", slice_i=0, line_start=0, times=3),)))
    with pytest.raises(RuntimeError, match="persist stage failed"):
        _run(_executor(_sim(), injector=inj, out_dir=tmp_path / "broken"))


def test_compute_retry_reloads_and_recovers_bitwise(clean, monkeypatch):
    """A transient failure in the compute stage retries the unit with a
    fresh load; the result is the first attempt's."""
    ex = _executor(_sim())
    calls = []
    real = ex._compute_window

    def flaky(item, attempt=0):
        calls.append((item.unit.unit_id, attempt))
        if item.unit.unit_id == "s1/l00006" and attempt == 0:
            raise tf.TransientError("device hiccup")
        return real(item, attempt)

    monkeypatch.setattr(ex, "_compute_window", flaky)
    res = _run(ex)
    for s in SLICES:
        _bitwise(res[s], clean["grouping"][s])
    assert ("s1/l00006", 1) in calls and res[1].retries == 1
    assert "s1/l00006#c1" not in ex.monitors["load"]._inflight


def test_device_errors_are_not_retried():
    """A load that raises the device's out-of-memory error is fatal: one
    attempt, no retry, no quarantine; the run raises it."""
    sim = _sim()

    class Source:
        geometry = sim.geometry
        calls = 0

        def load_window(self, w):
            if w == t_regions.Window(1, 3, 6):
                Source.calls += 1
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return sim.load_window(w)

    ex = _executor(Source(), prefetch=False)
    with pytest.raises(torch.OutOfMemoryError):
        _run(ex)
    assert Source.calls == 1


# -- quarantine --------------------------------------------------------------------


def _quarantine_plan(mod):
    return mod.FaultPlan(seed=5, rules=(
        mod.FaultRule("read_error", slice_i=1, line_start=3, times=10_000),
        mod.FaultRule("read_error", slice_i=2, rate=0.5, times=1),))


def test_quarantine_matches_reference_manifest(clean, tmp_path):
    """A unit whose reads never succeed completes the run degraded: its
    window carries type_idx -1 and zeros, every other window is bitwise the
    clean run, and the failed-unit manifest equals the reference's under
    the same plan (unit, lines, attempts, error)."""
    inj = tf.FaultInjector(_quarantine_plan(tf))
    ex = _executor(inj.wrap_source(_sim()), method="baseline", injector=inj,
                   out_dir=tmp_path / "port", max_retries=1)
    res = _run(ex)
    r1 = res[1]
    assert r1.degraded and [q["line_start"] for q in r1.quarantined] == [3]
    assert r1.quarantined[0]["attempts"] == 2
    lo, hi = 3 * PPL, 6 * PPL
    assert (r1.type_idx[lo:hi] == -1).all()
    for f in ("params", "error", "mean", "std", "skew", "kurt"):
        assert not getattr(r1, f)[lo:hi].any()
    for f in tex.RESULT_FIELDS:
        got, want = getattr(r1, f), getattr(clean["baseline"][1], f)
        np.testing.assert_array_equal(got[:lo], want[:lo], err_msg=f)
        np.testing.assert_array_equal(got[hi:], want[hi:], err_msg=f)
    for s in (0, 2):
        assert not res[s].degraded
        _bitwise(res[s], clean["baseline"][s])
    assert ex.last_report.quarantined == 1 and res[2].retries > 0

    rinj = rf.FaultInjector(_quarantine_plan(rf))
    rexe = rex.StagedExecutor(
        rex.PDFConfig(window_lines=WINDOW_LINES), rinj.wrap_source(_ref_sim()),
        out_dir=tmp_path / "ref", injector=rinj,
        exec_config=rex.ExecutorConfig(max_retries=1, **FAST_RETRY))
    rres = rexe.run(r_regions.build_plan(rexe.data.geometry, list(SLICES), WINDOW_LINES))
    name = "slice1_failed_units.json"
    assert json.loads((tmp_path / "port" / name).read_text()) == \
        json.loads((tmp_path / "ref" / name).read_text())
    assert sorted(p.name for p in (tmp_path / "port").glob("*.json")) == \
        sorted(p.name for p in (tmp_path / "ref").glob("*.json"))
    assert [r.retries for r in res.values()] == [rres[s].retries for s in SLICES]
    assert rinj.events == inj.events

    # repair: a fault-free resume re-runs only the quarantined unit, fills
    # the hole bitwise and deletes the manifest
    again = _executor(_sim(), method="baseline", out_dir=tmp_path / "port")
    repaired = _run(again, slices=[1], resume=True)[1]
    assert not repaired.degraded and again.last_report.units == 1
    _bitwise(repaired, clean["baseline"][1])
    assert not (tmp_path / "port" / name).exists()


def test_degraded_mode_off_raises():
    inj = tf.FaultInjector(tf.FaultPlan(rules=(
        tf.FaultRule("read_error", slice_i=0, line_start=0, times=10_000),)))
    ex = _executor(inj.wrap_source(_sim()), degraded_mode=False, max_retries=1)
    with pytest.raises(RuntimeError, match="failed after 2 attempts"):
        _run(ex, slices=[0])


def test_resume_refuses_another_spec_hash(tmp_path):
    cfg = tex.PDFConfig(window_lines=WINDOW_LINES)
    tex.StagedExecutor(cfg, _sim(), "cpu", out_dir=tmp_path, spec_hash="aaa").run_slice(0)
    mark = json.loads((tmp_path / "slice0_watermark.json").read_text())
    assert mark == {"next_line": 12, "spec_hash": "aaa", "complete": True}
    assert "spec_hash" in np.load(tmp_path / "slice0_window_00000.npz").files
    with pytest.raises(ValueError, match="resume mismatch"):
        tex.StagedExecutor(cfg, _sim(), "cpu", out_dir=tmp_path,
                           spec_hash="bbb").run_slice(0, resume=True)


# -- shard death and re-deal ---------------------------------------------------------


def test_shard_death_redeals_bitwise(clean, tmp_path):
    """Shard 1 dies after two window loads; its slice is re-dealt to shard
    0 with resume (the windows it persisted are restored), and every slice
    completes bitwise equal to the clean run."""
    inj = tf.FaultInjector(tf.FaultPlan(rules=(
        tf.FaultRule("shard_death", shard=1, after_units=2),)))
    sched = SliceScheduler(num_shards=2)
    res = sched.run(lambda shard: _executor(inj.wrap_source(_sim(), shard=shard),
                                            injector=inj, out_dir=tmp_path), list(SLICES))
    assert set(res) == set(SLICES)
    for s in SLICES:
        assert not res[s].degraded
        _bitwise(res[s], clean["grouping"][s], f"slice{s}/")
    assert sched.lost_shards == (1,) and inj.events["shard_death"] >= 1
    assert sched.last_redeal.slices_for(0) == (1,)
    # shard 1 computed and persisted two windows of slice 1 before dying; the
    # re-deal resumes from its watermark and runs the other two
    assert sched.last_reports[0].units == 2
    assert sched.window_monitor.completed == 12


def test_all_shards_lost_is_fatal():
    inj = tf.FaultInjector(tf.FaultPlan(rules=(
        tf.FaultRule("shard_death", shard=0, after_units=0),)))
    with pytest.raises(ValueError, match="no healthy shards"):
        SliceScheduler(num_shards=1).run(
            lambda shard: _executor(inj.wrap_source(_sim(), shard=shard)), [0])


# -- the clean run against the reference ------------------------------------------


@pytest.mark.parametrize("method", ["baseline", "grouping"])
def test_clean_run_matches_reference(clean, method):
    """The port's staged executor against ``repro``'s, host Select, under
    the ROADMAP's parity rules: moments 2e-3; type_idx equal wherever the
    reference's best and second-best Eq.-5 errors differ by more than the
    error tolerance, the port's pick within it elsewhere; params and error
    where the types agree."""
    src = _ref_sim()
    rexe = rex.StagedExecutor(rex.PDFConfig(window_lines=WINDOW_LINES, method=method), src)
    ref = rexe.run(r_regions.build_plan(src.geometry, list(SLICES), WINDOW_LINES))
    for s in SLICES:
        r, t = ref[s], clean[method][s]
        v = jnp.asarray(np.concatenate([
            src.load_window(w) for w in r_regions.iter_windows(src.geometry, s, WINDOW_LINES)]))
        m = rfp.moments(v, 64)
        errs = np.asarray(rfp.fit_errors(v, m, rd.fit_all(rd.TYPES_4, m), rd.TYPES_4, 64))
        for name in ("mean", "std", "skew", "kurt"):
            np.testing.assert_allclose(getattr(t, name), getattr(r, name), **MOM_TOL)
        errs = np.where(np.isfinite(errs), errs, 1e30)
        srt = np.sort(errs, axis=1)
        tol = ERR_TOL["atol"] + ERR_TOL["rtol"] * srt[:, 0]
        clear = srt[:, 1] - srt[:, 0] > tol
        np.testing.assert_array_equal(t.type_idx[clear], r.type_idx[clear])
        picked = np.take_along_axis(errs, t.type_idx[:, None].astype(np.int64), axis=1)[:, 0]
        assert (picked - srt[:, 0] <= tol).all()
        same = t.type_idx == r.type_idx
        np.testing.assert_allclose(t.params[same], r.params[same], **MOM_TOL)
        np.testing.assert_allclose(t.error[same], r.error[same], **ERR_TOL)
        assert [(w.num_fitted, tuple(w.window)) for w in t.stats] == \
            [(w.num_fitted, tuple(w.window)) for w in r.stats]
        assert (t.retries, t.speculations, t.quarantined) == (r.retries, r.speculations,
                                                               r.quarantined)


# -- staging on the CPU ------------------------------------------------------------


def test_cpu_stager_is_from_numpy():
    """On the CPU the stager is ``torch.from_numpy``: no copy stream, no
    pinned buffer, no event; several parts stage as their concatenation."""
    st = WindowStager("cpu")
    a = np.random.default_rng(0).normal(size=(5, 7)).astype(np.float32)
    staged = st.stage(a)
    assert staged.ready is None and st.ready(staged).data_ptr() == a.ctypes.data
    both = st.ready(st.stage(a, a[:2].astype(np.float64)))
    np.testing.assert_array_equal(both.numpy(), np.concatenate([a, a[:2]]))
    assert st.copies == 0 and st.pool_waits == 0
    with pytest.raises(ValueError, match="pool_size"):
        WindowStager("cpu", pool_size=0)
    sharded = ShardedStager(st, divisor=4)
    got, p = sharded.stage(a)
    assert p == 5 and got.values.shape == (8, 7)
    np.testing.assert_array_equal(got.values.numpy(), np.concatenate([a, np.repeat(a[-1:], 3, 0)]))
    got, p = ShardedStager(st).stage(a)
    assert p == 5 and got.values.shape == (5, 7)
    with pytest.raises(ValueError, match="divisor"):
        ShardedStager(st, 0)


def test_executor_config_validation():
    for bad in (dict(prefetch_depth=0), dict(max_retries=-1), dict(retry_backoff_s=-1.0),
                dict(straggler_grace_s=-0.1)):
        with pytest.raises(ValueError):
            tex.ExecutorConfig(**bad)
    ex = _executor(_sim())
    assert [ex._backoff(t_regions.WorkUnit(t_regions.Window(0, 0, 3), 0), a) for a in range(3)] == \
        [ex._backoff(t_regions.WorkUnit(t_regions.Window(0, 0, 3), 0), a) for a in range(3)]
    assert ex.stager.pool_size == 8 and set(ex.monitors) == {"load", "compute", "persist"}
    assert ex.monitors["load"].policy.grace_seconds == ex.exec_config.straggler_grace_s
