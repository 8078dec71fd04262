"""``repro_torch.serve.PDFServer`` on the CPU: the cases of
tests/test_serve.py against the port, and the port's server against the
reference's.

The load-bearing guarantee is bitwise equality within the port: every
answer — coalesced or naive, computed or served from the hot-window LRU or
the ResultCache, under concurrent clients — matches the port's batch
pipeline exactly. Against the reference's server the answers follow the
ROADMAP's parity rules. The rest covers the queue lifecycle and the
failure model: drain on close, loud failure, validation, shedding,
deadlines, transient launch retry and invalidation after an append."""

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")

import repro.api as rapi
import repro.serve as rserve
from repro.core import distributions as rd
from repro.core import regions as r_regions
from repro.kernels import fitpdf as rfp
from repro_torch.api import (
    ComputeSpec,
    ExecSpec,
    MethodSpec,
    PDFSession,
    PipelineSpec,
    ServeSpec,
    SourceSpec,
    build_source,
)
from repro_torch.core import regions
from repro_torch.core.executor import RESULT_FIELDS
from repro_torch.runtime.faults import InjectedFault
from repro_torch.serve import (
    PDFServer,
    PointQuery,
    RegionQuery,
    ServerOverloadedError,
    WindowQuery,
)

# lines_per_slice=10 with window_lines=3 leaves a 1-line tail window
# ([9, 10)) so span math is exercised off the aligned grid.
SOURCE = SourceSpec(num_slices=3, lines_per_slice=10, points_per_line=8, observations=150)
PPL = SOURCE.points_per_line
WINDOW_LINES = 3
MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)


def make_spec(method="grouping", serve=ServeSpec(), source=SOURCE, **kw):
    return PipelineSpec(source=source, method=MethodSpec(name=method),
                        compute=ComputeSpec(window_lines=WINDOW_LINES, num_bins=20),
                        serve=serve, **kw)


def server(spec, **kw):
    return PDFServer(spec, device="cpu", **kw)


def reference(spec, slices):
    return PDFSession(spec, device="cpu").run_all(slices)


def assert_answer_matches(answer, ref_slice, lo, hi):
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(answer, name), getattr(ref_slice, name)[lo:hi],
                                      err_msg=name)


QUERIES = [
    (PointQuery(1, 4, 5), 1, 4 * PPL + 5, 4 * PPL + 6),
    (WindowQuery(1, 2, 7), 1, 2 * PPL, 7 * PPL),  # crosses 3 windows, unaligned
    (WindowQuery(2, 8, 10), 2, 8 * PPL, 10 * PPL),  # into the 1-line tail
    (RegionQuery(2), 2, 0, 10 * PPL),
]


# -- bitwise equivalence vs the port's batch pipeline -----------------------------


@pytest.mark.parametrize("method", ["baseline", "grouping", "reuse", "sampling"])
def test_answers_bitwise_equal_to_pipeline(method):
    spec = make_spec(method)
    ref = reference(spec, [1, 2])
    with server(spec) as srv:
        for q, s, lo, hi in QUERIES:
            a = srv.query(q)
            assert_answer_matches(a, ref[s], lo, hi)
            assert a.spec_hash == spec.content_hash()


@pytest.mark.parametrize("method", ["baseline", "grouping", "reuse"])
def test_run_window_batch_matches_serial_windows(method):
    windows = [regions.Window(0, 0, 3), regions.Window(0, 9, 10), regions.Window(1, 3, 6),
               regions.Window(2, 6, 9)]
    spec = make_spec(method)
    batched = PDFSession(spec, device="cpu").executor(0).run_window_batch(windows)
    serial_ex = PDFSession(spec, device="cpu").executor(0)
    for w, br in zip(windows, batched):
        sr = serial_ex.run_window(w)
        assert br.window == w == sr.window
        for name in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(br, name), getattr(sr, name),
                                          err_msg=f"{w}/{name}")


NAIVE = ServeSpec(coalesce=False, window_cache_entries=0, tick_seconds=0.0)


def test_coalesced_equals_naive_server():
    """Coalescing changes launch count, never results."""
    queries = [PointQuery(0, 1, 2), WindowQuery(0, 0, 5), RegionQuery(1), PointQuery(1, 9, 7),
               WindowQuery(2, 4, 10), PointQuery(0, 1, 2)]
    answers, stats = {}, {}
    for mode, serve in (("coalesced", ServeSpec(coalesce=True)), ("naive", NAIVE)):
        with server(make_spec("grouping", serve=serve)) as srv:
            futures = [srv.submit(q) for q in queries]
            answers[mode] = [f.result(timeout=60) for f in futures]
            stats[mode] = srv.stats()
    for qc, qn in zip(answers["coalesced"], answers["naive"]):
        assert qc.query == qn.query
        for name in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(qc, name), getattr(qn, name), err_msg=name)
    probe = server(make_spec())
    distinct = len({(w.slice_i, w.line_start) for q in queries
                    for w in probe._resolve_span(q).windows})
    assert stats["coalesced"].windows_computed <= distinct
    assert stats["naive"].windows_computed >= stats["coalesced"].windows_computed
    assert stats["naive"].launches == stats["naive"].windows_computed


def test_concurrent_clients_bitwise():
    spec = make_spec("grouping")
    ref = reference(spec, [0, 1, 2])
    errors: list[BaseException] = []

    def client(c: int) -> None:
        try:
            s = c % SOURCE.num_slices
            for i in range(6):
                line = (c + 2 * i) % SOURCE.lines_per_slice
                point = (3 * c + i) % PPL
                a = srv.query(PointQuery(s, line, point))
                assert_answer_matches(a, ref[s], line * PPL + point, line * PPL + point + 1)
            assert_answer_matches(srv.query(WindowQuery(s, 1, 8)), ref[s], PPL, 8 * PPL)
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    with server(spec) as srv:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = srv.stats()
    if errors:
        raise errors[0]
    assert stats.queries == 8 * 7
    assert stats.windows_computed <= 4 * SOURCE.num_slices  # each window once
    assert stats.windows_requested > stats.windows_computed and stats.coalesce_ratio > 1.0


# -- cache layers -------------------------------------------------------------------


@pytest.mark.parametrize("lru", [256, 0], ids=["lru", "no_lru"])
def test_repeat_query_and_the_memory_lru(lru):
    serve = ServeSpec(window_cache_entries=lru, tick_seconds=0.0)
    with server(make_spec("grouping", serve=serve)) as srv:
        first = srv.query(WindowQuery(0, 0, 6))
        again = srv.query(WindowQuery(0, 0, 6))
        stats = srv.stats()
    assert first.windows_computed == 2 and first.windows_from_memory == 0
    assert (again.windows_from_memory, again.windows_computed) == ((2, 0) if lru else (0, 2))
    assert stats.windows_computed == (2 if lru else 4)
    for name in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(first, name), getattr(again, name), err_msg=name)


def test_hot_path_from_result_cache_builds_nothing(tmp_path):
    """A server in front of a populated ResultCache answers without an
    executor, a tree or a launch; a server that computes a whole slice
    stores it back for the next one."""
    spec = make_spec("grouping", execution=ExecSpec(cache_dir=str(tmp_path / "cache")))
    ref = reference(spec, [0])  # populates the cache for slice 0
    with server(spec) as srv:
        a = srv.query(RegionQuery(0))
        assert_answer_matches(a, ref[0], 0, SOURCE.lines_per_slice * PPL)
        assert a.windows_from_disk == 4 and a.windows_computed == 0
        srv.query(RegionQuery(1))
        stats = srv.stats()
        assert stats.windows_computed > 0 and stats.slices_stored == 1
    with server(spec) as srv2:
        b = srv2.query(RegionQuery(1))
        assert b.windows_from_disk == 4 and b.windows_computed == 0
        assert srv2.stats().launches == 0
        assert not srv2.session._executors and srv2.session._tree is None


# -- lifecycle ------------------------------------------------------------------------


def test_graceful_drain_on_close():
    srv = server(make_spec("grouping")).start()
    futures = [srv.submit(PointQuery(s, line, 0)) for s in range(2) for line in range(0, 10, 3)]
    srv.close(timeout=120)
    for f in futures:
        assert f.done() and f.result(timeout=0).type_idx.shape == (1,)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(PointQuery(0, 0, 0))


def test_submit_before_start_raises():
    with pytest.raises(RuntimeError, match="not started"):
        server(make_spec("grouping")).submit(PointQuery(0, 0, 0))


class _FailingSource:
    """Delegates everything to a real source but fails its loads: ``fails``
    times with a transient ``InjectedFault``, or always with a fatal error."""

    def __init__(self, inner, fails=None):
        self._inner = inner
        self._fails = fails
        self.calls = 0

    def load_window(self, w):
        self.calls += 1
        if self._fails is None:
            raise RuntimeError("injected load failure")
        if self.calls <= self._fails:
            raise InjectedFault("injected transient load failure")
        return self._inner.load_window(w)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_serving_thread_failure_is_loud():
    srv = server(make_spec("grouping"), data_source=_FailingSource(build_source(SOURCE)))
    srv.start()
    fut = srv.submit(PointQuery(0, 0, 0))
    with pytest.raises(RuntimeError, match="injected load failure"):
        fut.result(timeout=60)
    srv._thread.join(timeout=60)
    with pytest.raises(RuntimeError, match="server thread failed"):
        srv.submit(PointQuery(0, 0, 0))
    with pytest.raises(RuntimeError, match="server thread failed"):
        srv.close()


@pytest.mark.parametrize("fails,ok", [(2, True), (3, False)], ids=["retried", "exhausted"])
def test_transient_launch_failure_is_retried(fails, ok):
    """A transient failure is retried ``serve.retry_transient`` times;
    past that only the affected request fails, and the server serves on."""
    spec = make_spec("grouping", serve=ServeSpec(retry_transient=2, tick_seconds=0.0))
    src = _FailingSource(build_source(SOURCE), fails=fails)
    with server(spec, data_source=src) as srv:
        fut = srv.submit(PointQuery(0, 0, 0))
        if ok:
            assert fut.result(timeout=60).windows_computed == 1
        else:
            with pytest.raises(InjectedFault):
                fut.result(timeout=60)
        after = srv.query(PointQuery(1, 0, 0))  # the server is still up
        stats = srv.stats()
    assert after.windows_computed == 1
    assert stats.launch_retries == min(fails, 3) and stats.windows_failed == (0 if ok else 1)


class _BlockingSource:
    """A real source whose loads wait for ``release`` (holding the serving
    thread inside a launch) and count the loads started."""

    def __init__(self, inner):
        self._inner = inner
        self.release = threading.Event()
        self.started = threading.Event()

    def load_window(self, w):
        self.started.set()
        assert self.release.wait(60)
        return self._inner.load_window(w)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_shedding_and_deadlines():
    """With the serving thread held in a launch, one request may queue
    (``max_queue_depth=1``) and the next is shed; the queued one outlives
    its deadline and fails with ``TimeoutError`` before any compute."""
    spec = make_spec("grouping", serve=ServeSpec(max_queue_depth=1, request_deadline_s=0.05,
                                                 tick_seconds=0.0))
    src = _BlockingSource(build_source(SOURCE))
    with server(spec, data_source=src) as srv:
        busy = srv.submit(PointQuery(0, 0, 0))
        assert src.started.wait(60)  # the first request is in its launch
        queued = srv.submit(PointQuery(1, 0, 0))
        with pytest.raises(ServerOverloadedError):
            srv.submit(PointQuery(2, 0, 0))
        time.sleep(0.1)
        src.release.set()
        assert busy.result(timeout=60).windows_computed == 1
        with pytest.raises(TimeoutError, match="expired"):
            queued.result(timeout=60)
        stats = srv.stats()
    assert stats.shed_requests == 1 and stats.deadline_expired == 1
    assert stats.launches == 1 and stats.max_queue_depth == 1


def test_submit_validation():
    with server(make_spec("grouping")) as srv:
        with pytest.raises(ValueError, match="slice"):
            srv.submit(RegionQuery(99))
        with pytest.raises(ValueError, match="point"):
            srv.submit(PointQuery(0, 0, PPL))
        with pytest.raises(ValueError, match="line"):
            srv.submit(PointQuery(0, SOURCE.lines_per_slice, 0))
        with pytest.raises(ValueError, match="lines"):
            srv.submit(WindowQuery(0, 5, 5))
        with pytest.raises(TypeError, match="unknown query"):
            srv.submit(("not", "a", "query"))


def test_stats_and_stage_percentiles():
    with server(make_spec("grouping")) as srv:
        srv.query(WindowQuery(0, 0, 6))
        srv.query(PointQuery(0, 1, 1))
        stats = srv.stats()
    assert stats.queries == 2 and stats.queries_by_kind == {"WindowQuery": 1, "PointQuery": 1}
    assert stats.launches >= 1 and stats.windows_computed == 2 and stats.batch_occupancy > 0
    assert stats.latency["p99"] >= stats.latency["p50"] > 0
    assert set(stats.launch_latency) == {"p50", "p99"}
    assert stats.stage_percentiles["compute"]["p50"] > 0
    assert srv.session.report().stage_percentiles.keys() == stats.stage_percentiles.keys()


def test_serve_spec_excluded_from_content_hash():
    tweaked = make_spec("grouping", serve=ServeSpec(coalesce=False, tick_seconds=0.5,
                                                    max_batch_windows=1, window_cache_entries=0))
    assert make_spec("grouping").content_hash() == tweaked.content_hash()


def test_invalidate_after_an_append(tmp_path):
    """An append to slice 1 of a file cube: ``invalidate`` reports it, drops
    slice 1's hot windows (recomputed over the new observations) and keeps
    slice 0's (served from memory, bitwise as before)."""
    from repro.streaming import append_realizations
    from repro_torch.data.file_source import FileCubeSource, export_cube

    cube = export_cube(SOURCE, tmp_path / "cube", lines_per_chunk=5)
    with server(make_spec("grouping", source=cube)) as srv:
        before = {s: srv.query(WindowQuery(s, 0, 3)) for s in (0, 1)}
        obs = FileCubeSource(cube.path).load_window(regions.Window(1, 0, 10))
        append_realizations(cube.path, {1: obs[:, :4].reshape(10, PPL, 4)})
        info = srv.invalidate()
        assert (info["old_version"], info["new_version"], info["changed_slices"]) == (1, 2, [1])
        after = {s: srv.query(WindowQuery(s, 0, 3)) for s in (0, 1)}
        assert srv.session.spec_hash != before[0].spec_hash
    assert after[0].windows_from_memory == 1 and after[1].windows_computed == 1
    np.testing.assert_array_equal(after[0].mean, before[0].mean)
    assert not np.array_equal(after[1].mean, before[1].mean)


# -- against the reference's server -----------------------------------------------------


@pytest.fixture(scope="module")
def reference_errors():
    """The reference's per-type Eq.-5 errors of every point, for the tie rule."""
    src = rapi.build_source(rapi.SourceSpec(**dataclasses.asdict(SOURCE)))
    out = {}
    for s in range(SOURCE.num_slices):
        v = jnp.asarray(np.concatenate([
            src.load_window(w) for w in r_regions.iter_windows(src.geometry, s, WINDOW_LINES)]))
        m = rfp.moments(v, 20)
        out[s] = np.asarray(rfp.fit_errors(v, m, rd.fit_all(rd.TYPES_4, m), rd.TYPES_4, 20))
    return out


def _assert_parity(got, ref, errs):
    for name in ("mean", "std", "skew", "kurt"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), **MOM_TOL, err_msg=name)
    e = np.where(np.isfinite(errs), errs, 1e30)
    srt = np.sort(e, axis=1)
    tol = ERR_TOL["atol"] + ERR_TOL["rtol"] * srt[:, 0]
    clear = srt[:, 1] - srt[:, 0] > tol
    np.testing.assert_array_equal(got.type_idx[clear], ref.type_idx[clear])
    picked = np.take_along_axis(e, got.type_idx[:, None].astype(np.int64), axis=1)[:, 0]
    assert (picked - srt[:, 0] <= tol).all()
    same = got.type_idx == ref.type_idx
    np.testing.assert_allclose(got.params[same], ref.params[same], **MOM_TOL)
    np.testing.assert_allclose(got.error[same], ref.error[same], **ERR_TOL)


@pytest.mark.parametrize("method", ["baseline", "grouping"])
def test_answers_follow_the_reference_server(reference_errors, method, tmp_path):
    """The same queries through both packages' servers under the parity
    rules; their caches in one directory never serve each other: the
    reference's server computes what the port's stored."""
    spec = make_spec(method, execution=ExecSpec(cache_dir=str(tmp_path / "cache")))
    rspec = rapi.PipelineSpec.from_json(spec.to_json())
    queries = [q for q, *_ in QUERIES] + [RegionQuery(1)]
    with server(spec) as srv:
        port = [srv.query(q) for q in queries]
        assert srv.stats().slices_stored == 2
    with rserve.PDFServer(rspec) as rsrv:
        ref = [rsrv.query(getattr(rserve, type(q).__name__)(*dataclasses.astuple(q)))
               for q in queries]
        assert rsrv.stats().windows_from_disk == 0
    for (q, s, lo, hi), got, want in zip(QUERIES + [(None, 1, 0, 10 * PPL)], port, ref):
        _assert_parity(got, want, reference_errors[s][lo:hi])
        assert got.spec_hash == spec.content_hash() != want.spec_hash
    with server(spec) as warm:
        again = [warm.query(q) for q in queries]
        assert warm.stats().launches == 0 and not warm.session._executors
    for a, b in zip(port, again):
        assert a.windows_from_disk == 0 and b.windows_computed == 0
        for name in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
