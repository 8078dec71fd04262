"""``repro_torch.api.ResultCache`` and its session wiring, on the CPU: the
cases of tests/test_result_cache.py against the port. Hits are bitwise
equal to computed slices and skip compute; result-defining changes (and
changed file manifests) miss, staging-only changes hit; the LRU cap, lock
and crash hygiene, and chunk-fingerprint adoption behave as the
reference's. The entry format is the reference's: each package reads the
other's entries bitwise, while their spec hashes keep a shared
``cache_dir`` from ever serving one package's result to the other."""

import dataclasses
import os
import threading
import time
import warnings

import numpy as np
import pytest
pytest.importorskip("torch")

import repro.api as rapi
from repro.api import ResultCache as RResultCache
from repro_torch.api import (
    ComputeSpec,
    ExecSpec,
    MethodSpec,
    PDFSession,
    PipelineSpec,
    ResultCache,
    SourceSpec,
    build_source,
)
from repro_torch.core.executor import RESULT_FIELDS, SliceResult
from repro_torch.data.file_source import export_cube
from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultRule

SMALL_SOURCE = SourceSpec(num_slices=6, lines_per_slice=9, points_per_line=12,
                          observations=200)


def session(spec, **kw):
    return PDFSession(spec, device="cpu", **kw)


def spec_with_cache(cache_dir, source=SMALL_SOURCE, **method_kw):
    method_kw.setdefault("name", "grouping")
    return PipelineSpec(
        source=source,
        method=MethodSpec(**method_kw),
        compute=ComputeSpec(window_lines=3, num_bins=20),
        execution=ExecSpec(slices=(1, 2), cache_dir=str(cache_dir)),
    )


def with_exec(spec, **kw):
    return dataclasses.replace(spec, execution=dataclasses.replace(spec.execution, **kw))


def assert_bitwise_equal(a, b):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.avg_error == b.avg_error
    assert a.spec_hash == b.spec_hash


# -- session integration ----------------------------------------------------------


def test_second_run_is_served_bitwise_identical(tmp_path):
    spec = spec_with_cache(tmp_path / "cache")
    s1 = session(spec)
    first = s1.run_all()
    rep1 = s1.report()
    assert rep1.cache_hits == 0 and rep1.cache_misses == 2
    assert not any(r.cached for r in first.values())

    s2 = session(spec)
    second = s2.run_all()
    rep2 = s2.report()
    assert rep2.cache_hits == 2 and rep2.cache_misses == 0
    for s in (1, 2):
        assert second[s].cached and second[s].stats == []
        assert_bitwise_equal(first[s], second[s])
    # no executor was ever built: the cache-served session did zero compute
    assert not s2._executors and rep2.windows == 0


@pytest.mark.parametrize("changed,hits", [
    (dict(group_tol=1e-3), 0),  # result-defining: misses
    (None, 2),  # staging only: hits
], ids=["result_defining_misses", "exec_only_hits"])
def test_what_the_hash_covers_decides_hits(tmp_path, changed, hits):
    cache = tmp_path / "cache"
    session(spec_with_cache(cache)).run_all()
    if changed is None:
        spec = with_exec(spec_with_cache(cache), prefetch=False, async_persist=False, shards=2)
    else:
        spec = spec_with_cache(cache, **changed)
    s = session(spec)
    results = s.run_all()
    assert s.report().cache_hits == hits and s.report().cache_misses == 2 - hits
    assert all(r.cached for r in results.values()) == (hits == 2)


def test_changed_file_manifest_misses(tmp_path):
    cache = tmp_path / "cache"
    file_a = export_cube(SMALL_SOURCE, tmp_path / "cube_a", lines_per_chunk=4)
    file_b = export_cube(dataclasses.replace(SMALL_SOURCE, seed=5), tmp_path / "cube_b",
                         lines_per_chunk=4)
    session(spec_with_cache(cache, source=file_a)).run_all()
    hit = session(spec_with_cache(cache, source=file_a))
    hit.run_all()
    assert hit.report().cache_hits == 2
    # same knobs, different bytes on disk: the manifest sha keys the cache
    miss = session(spec_with_cache(cache, source=file_b))
    miss.run_all()
    assert miss.report().cache_hits == 0 and miss.report().cache_misses == 2


def test_error_bound_recomputed_on_hits(tmp_path):
    spec = spec_with_cache(tmp_path / "cache", error_bound=10.0)
    first = session(spec).run_all()
    second = session(spec).run_all()
    for s in (1, 2):
        assert first[s].error_bound_satisfied is True
        assert second[s].cached and second[s].error_bound_satisfied is True


def test_cache_with_external_source_warns(tmp_path):
    sim = build_source(SMALL_SOURCE)
    spec = PipelineSpec(source=SourceSpec(kind="external"), compute=ComputeSpec(window_lines=3),
                        execution=ExecSpec(cache_dir=str(tmp_path / "cache")))
    with pytest.warns(UserWarning, match="external data source"):
        session(spec, data_source=sim)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a described source must not warn
        session(spec_with_cache(tmp_path / "c2"))


def test_misfiled_entry_is_a_miss(tmp_path):
    spec = spec_with_cache(tmp_path / "cache")
    session(spec).run_all()
    cache = ResultCache(tmp_path / "cache")
    good = cache.lookup(spec.content_hash(), 1)
    assert good is not None and good.cached
    wrong = tmp_path / "cache" / ("0" * 16)
    wrong.mkdir()
    cache.path(spec.content_hash(), 1).rename(wrong / "slice1.npz")
    assert cache.lookup("0" * 16, 1) is None


def test_cache_hit_still_persists_out_dir(tmp_path):
    """--cache-dir + --out-dir: a hit skips the executor but writes the
    window .npz files + watermark a computed run writes, bitwise, and the
    directory is a valid resume target."""
    spec = spec_with_cache(tmp_path / "cache")
    computed_out, cached_out = tmp_path / "computed", tmp_path / "cached"
    session(with_exec(spec, out_dir=str(computed_out))).run_all()
    hit_spec = with_exec(spec, out_dir=str(cached_out))
    s = session(hit_spec)
    s.run_all()
    assert s.report().cache_hits == 2
    names = sorted(p.name for p in computed_out.iterdir())
    assert sorted(p.name for p in cached_out.iterdir()) == names and names
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(computed_out / name), np.load(cached_out / name)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")
        else:
            assert (computed_out / name).read_text() == (cached_out / name).read_text()
    res = session(with_exec(hit_spec, cache_dir=None)).run_all(resume=True)
    assert all(len(r.stats) == 0 for r in res.values())


def test_cache_hit_respects_resume_mismatch_check(tmp_path):
    out = tmp_path / "out"
    other = with_exec(spec_with_cache(tmp_path / "other_cache", group_tol=1e-3),
                      out_dir=str(out))
    session(other).run_all()  # out_dir now belongs to the other spec
    spec = spec_with_cache(tmp_path / "cache")
    session(spec).run_all()  # populate the cache
    with pytest.raises(ValueError, match="resume mismatch"):
        session(with_exec(spec, out_dir=str(out), resume=True)).run_all()


def test_corrupt_cache_entry_is_a_miss_and_recomputed(tmp_path):
    spec = spec_with_cache(tmp_path / "cache")
    first = session(spec).run_all()
    ResultCache(tmp_path / "cache").path(spec.content_hash(), 1).write_bytes(b"not a zip")
    s = session(spec)
    with pytest.warns(UserWarning, match="unreadable cache entry"):
        results = s.run_all()
    assert (s.report().cache_hits, s.report().cache_misses) == (1, 1)
    assert not results[1].cached
    assert_bitwise_equal(first[1], results[1])
    s2 = session(spec)
    s2.run_all()
    assert s2.report().cache_hits == 2


def test_sampling_results_cache_cleanly(tmp_path):
    spec = spec_with_cache(tmp_path / "cache", name="sampling", sample_frac=0.5, sample_seed=3)
    first = session(spec).run_all()
    s2 = session(spec)
    second = s2.run_all()
    assert s2.report().cache_hits == 2 and s2._tree is None  # no tree trained
    for s in (1, 2):
        assert_bitwise_equal(first[s], second[s])
        assert (second[s].type_idx == -1).any()


def test_session_wires_cache_max_bytes(tmp_path):
    spec = spec_with_cache(tmp_path / "cache")
    staged = with_exec(spec, cache_max_bytes=12345)
    assert session(staged).cache.max_bytes == 12345
    assert session(spec).cache.max_bytes is None
    assert staged.content_hash() == spec.content_hash()


@pytest.mark.parametrize("warm", [True, False], ids=["warm_cache", "cold_cache"])
def test_fault_plan_cache_errors_degrade(tmp_path, warm):
    """``execution.fault_plan``'s ``cache_error`` rules reach the cache's
    ``on_cache`` hook once per operation and slice: a failed lookup is a
    warned miss (the slice recomputes), a failed store a warned skip; the
    results stay bitwise. A cold cache has no entry to look up, so only
    the store of slice 1 fails."""
    cache = tmp_path / "cache"
    clean = session(spec_with_cache(tmp_path / "clean")).run_all()
    if warm:
        session(spec_with_cache(cache)).run_all()
    plan = tmp_path / "plan.json"
    plan.write_text(FaultPlan(rules=(FaultRule("cache_error", slice_i=1, times=1),)).to_json())
    spec = with_exec(spec_with_cache(cache), fault_plan=str(plan))
    s = session(spec)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = s.run_all()
    msgs = [str(w.message) for w in caught]
    assert any("cache store failed" in m for m in msgs)
    assert any("unreadable cache entry" in m for m in msgs) == warm
    assert s.injector.events == {"cache_error": 2 if warm else 1}
    for i in (1, 2):
        assert_bitwise_equal(clean[i], got[i])
    assert (s.report().cache_hits, s.report().cache_misses) == ((1, 1) if warm else (0, 2))
    # the failed store left the warm entry in place, and no cold one
    assert (ResultCache(cache).lookup(spec.content_hash(), 1) is None) == (not warm)


# -- across the packages ---------------------------------------------------------


def test_entries_read_bitwise_across_packages(tmp_path):
    """One format: the reference's ResultCache reads a port entry and the
    port's a reference entry, bitwise, each under its own hash; a shared
    cache_dir holds both specs' entries apart."""
    cache = tmp_path / "cache"
    spec = spec_with_cache(cache)
    port = session(spec).run_all()
    rspec = rapi.PipelineSpec.from_json(spec.to_json())
    ref = rapi.PDFSession(rspec).run_all()
    assert spec.content_hash() != rspec.content_hash()
    r_cache, t_cache = RResultCache(cache), ResultCache(cache)
    for s in (1, 2):
        got = r_cache.lookup(spec.content_hash(), s)
        assert got.cached and got.spec_hash == spec.content_hash()
        for f in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(port[s], f), err_msg=f)
        assert got.avg_error == port[s].avg_error
        back = t_cache.lookup(rspec.content_hash(), s)
        for f in RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(back, f), getattr(ref[s], f), err_msg=f)
    assert sorted(p.name for p in cache.iterdir()) == sorted(
        [spec.content_hash(), rspec.content_hash()])
    again = session(spec)
    again.run_all()
    assert again.report().cache_hits == 2  # its own entries, never the reference's


# -- LRU size cap / shared-dir hygiene --------------------------------------------


def fabricated(slice_i, spec_hash="lruhash", p=256):
    """A deterministic SliceResult per slice index, so concurrent readers
    can verify bitwise."""
    rng = np.random.default_rng(1000 + slice_i)
    return SliceResult(
        type_idx=rng.integers(0, 4, p).astype(np.int32),
        params=rng.random((p, 3), dtype=np.float32),
        error=rng.random(p, dtype=np.float32),
        mean=rng.random(p, dtype=np.float32),
        std=rng.random(p, dtype=np.float32),
        skew=rng.random(p, dtype=np.float32),
        kurt=rng.random(p, dtype=np.float32),
        avg_error=float(slice_i), stats=[], slice_i=slice_i, spec_hash=spec_hash,
    )


def entry_size(tmp_path):
    probe = ResultCache(tmp_path / "probe")
    probe.store(fabricated(0))
    return probe.size_bytes()


def set_mtime(cache, slice_i, when, spec_hash="lruhash"):
    os.utime(cache.path(spec_hash, slice_i), (when, when))


@pytest.mark.parametrize("touch_old", [False, True], ids=["oldest_evicted", "touch_refreshes"])
def test_lru_cap_evicts_least_recently_used(tmp_path, touch_old):
    one = entry_size(tmp_path)
    cache = ResultCache(tmp_path / "cache", max_bytes=2 * one + one // 2)
    now = time.time()
    for i in (0, 1):
        cache.store(fabricated(i))
        set_mtime(cache, i, now - 100 + i)  # 0 is oldest-used
    if touch_old:
        assert cache.lookup("lruhash", 0) is not None  # 0 becomes most recent
    cache.store(fabricated(2))
    gone = 1 if touch_old else 0
    assert cache.lookup("lruhash", gone) is None
    assert cache.lookup("lruhash", 1 - gone) is not None
    assert cache.lookup("lruhash", 2) is not None
    assert cache.evictions == 1 and cache.size_bytes() <= cache.max_bytes


def test_store_never_evicts_its_own_entry(tmp_path):
    one = entry_size(tmp_path)
    cache = ResultCache(tmp_path / "cache", max_bytes=max(1, one // 2))
    cache.store(fabricated(7))
    assert cache.lookup("lruhash", 7) is not None
    cache.store(fabricated(8))
    assert cache.lookup("lruhash", 7) is None
    assert cache.lookup("lruhash", 8) is not None


def test_stale_tmps_reaped_at_open_fresh_kept(tmp_path):
    d = tmp_path / "cache" / "somehash"
    d.mkdir(parents=True)
    stale, fresh = d / "dead-writer.tmp", d / "live-writer.tmp"
    stale.write_bytes(b"x")
    fresh.write_bytes(b"y")
    old = time.time() - 7200
    os.utime(stale, (old, old))
    ResultCache(tmp_path / "cache")
    assert not stale.exists() and fresh.exists()


def test_store_without_provenance_is_refused(tmp_path):
    with pytest.raises(ValueError, match="spec_hash and slice_i"):
        ResultCache(tmp_path).store(dataclasses.replace(fabricated(0), spec_hash=None))
    with pytest.raises(ValueError, match="max_bytes"):
        ResultCache(tmp_path, max_bytes=0)


def test_corrupt_entry_is_warned_miss_for_concurrent_readers(tmp_path):
    cache = ResultCache(tmp_path / "cache")
    cache.store(fabricated(3))
    cache.path("lruhash", 3).write_bytes(b"garbage, not a zip")
    results, errors = [], []

    def reader():
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                results.append(cache.lookup("lruhash", 3))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors and results == [None] * 4
    with pytest.warns(UserWarning, match="unreadable cache entry"):
        assert cache.lookup("lruhash", 3) is None


def test_concurrent_store_lookup_under_eviction_pressure(tmp_path):
    """Two writer threads + two readers over one capped dir: no crashes,
    and every successful hit is bitwise-equal to that slice's content."""
    one = entry_size(tmp_path)
    cache = ResultCache(tmp_path / "cache", max_bytes=3 * one + one // 2)
    expected = {i: fabricated(i) for i in range(8)}
    errors, hits = [], [0]
    writers_done = threading.Event()

    def writer(offset):
        try:
            for _ in range(6):
                for i in range(offset, 8, 2):
                    cache.store(expected[i])
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                round_ = 0
                while round_ < 40 or not writers_done.is_set():
                    got = cache.lookup("lruhash", round_ % 8)
                    if got is not None:
                        hits[0] += 1
                        assert_bitwise_equal(expected[got.slice_i], got)
                    round_ += 1
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    writers = [threading.Thread(target=writer, args=(o,)) for o in (0, 1)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in writers + readers:
        t.start()
    for t in writers:
        t.join(timeout=120)
    writers_done.set()
    for t in readers:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in writers + readers)
    assert not errors, errors[0]
    assert hits[0] > 0
    cache.store(expected[0])  # one quiesced store re-trims exactly
    assert cache.size_bytes() <= cache.max_bytes and cache.evictions > 0


# -- chunk-dependency fingerprints / adoption -------------------------------------


DEPS = ("sha-a", "sha-b", "sha-c")


def test_store_records_deps_and_deps_roundtrip(tmp_path):
    cache = ResultCache(tmp_path / "cache")
    cache.store(fabricated(0), deps=DEPS)
    cache.store(fabricated(1))
    assert cache.deps("lruhash", 0) == DEPS
    assert cache.deps("lruhash", 1) is None and cache.deps("lruhash", 9) is None
    assert_bitwise_equal(fabricated(0), cache.lookup("lruhash", 0))


def test_adopt_rekeys_matching_fingerprint_bitwise(tmp_path):
    cache = ResultCache(tmp_path / "cache")
    cache.store(fabricated(2, spec_hash="oldhash"), deps=DEPS)
    assert cache.adopt("oldhash", "newhash", 2, DEPS) and cache.adoptions == 1
    got = cache.lookup("newhash", 2)
    assert got.spec_hash == "newhash"
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(fabricated(2), f), getattr(got, f), err_msg=f)
    assert cache.deps("newhash", 2) == DEPS
    assert cache.lookup("oldhash", 2) is not None
    assert cache.adopt("oldhash", "newhash", 2, DEPS) and cache.adoptions == 1


def test_adopt_refuses_unsound_rekeys(tmp_path):
    cache = ResultCache(tmp_path / "cache")
    cache.store(fabricated(3, spec_hash="oldhash"), deps=DEPS)
    cache.store(fabricated(4, spec_hash="oldhash"))
    assert not cache.adopt("oldhash", "newhash", 3, ("sha-a", "sha-CHANGED"))
    assert not cache.adopt("oldhash", "newhash", 4, DEPS)
    assert not cache.adopt("oldhash", "newhash", 3, ())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not cache.adopt("ghosthash", "newhash", 3, DEPS)
    assert cache.adoptions == 0 and cache.lookup("newhash", 3) is None


def test_file_session_stores_chunk_fingerprints(tmp_path):
    """A session over a file cube stores each slice with the sha256s of
    the chunks it reads — what adoption across an append compares."""
    from repro_torch.data.file_source import read_manifest, slice_chunk_shas

    cube = export_cube(SMALL_SOURCE, tmp_path / "cube", lines_per_chunk=4)
    spec = spec_with_cache(tmp_path / "cache", source=cube)
    s = session(spec)
    s.run_all()
    m = read_manifest(cube.path)
    for i in (1, 2):
        assert s.cache.deps(spec.content_hash(), i) == slice_chunk_shas(m, i)


# -- cross-process eviction coordination (two handles, one dir) -------------------


def test_foreign_sweep_lock_skips_eviction_pass(tmp_path):
    one = entry_size(tmp_path)
    a = ResultCache(tmp_path / "cache", max_bytes=2 * one + one // 2)
    b = ResultCache(tmp_path / "cache", max_bytes=2 * one + one // 2)
    now = time.time()
    for i in (0, 1):
        a.store(fabricated(i))
        set_mtime(a, i, now - 100 + i)
    sweep = tmp_path / "cache" / ".sweep.lock"
    sweep.write_text(str(os.getpid()))
    a.store(fabricated(2))
    assert a.lock_misses == 1 and a.evictions == 0
    assert a.lookup("lruhash", 0) is not None
    sweep.unlink()
    a.store(fabricated(3))
    assert a.evictions > 0 and a.size_bytes() <= a.max_bytes
    assert b.lookup("lruhash", 3) is not None


def test_eviction_skips_entry_dir_locked_by_concurrent_store(tmp_path):
    one = entry_size(tmp_path)
    cache = ResultCache(tmp_path / "cache", max_bytes=one + one // 2)
    now = time.time()
    cache.store(fabricated(0, spec_hash="hash_a"))
    os.utime(cache.path("hash_a", 0), (now - 100, now - 100))
    lock = tmp_path / "cache" / "hash_a" / ".lock"
    lock.write_text(str(os.getpid()))
    cache.store(fabricated(1, spec_hash="hash_b"))
    assert cache.lookup("hash_a", 0) is not None and cache.lock_misses >= 1
    lock.unlink()
    cache.store(fabricated(2, spec_hash="hash_c"))
    assert cache.lookup("hash_a", 0) is None and cache.size_bytes() <= cache.max_bytes


def test_stale_sweep_lock_is_broken(tmp_path):
    one = entry_size(tmp_path)
    cache = ResultCache(tmp_path / "cache", max_bytes=one + one // 2)
    cache.store(fabricated(0))
    sweep = tmp_path / "cache" / ".sweep.lock"
    sweep.write_text("12345")
    old = time.time() - 3600
    os.utime(sweep, (old, old))
    cache.store(fabricated(1))
    assert cache.evictions > 0 and cache.size_bytes() <= cache.max_bytes


def test_fault_injector_hook_is_the_cache_hook(tmp_path):
    """``ResultCache(injector=...)`` calls ``on_cache`` on every lookup and
    store; the injected ``InjectedFault`` is an OSError, handled there as a
    warned skip or miss. One fault a target: the retry succeeds."""
    inj = FaultInjector(FaultPlan(rules=(FaultRule("cache_error", slice_i=5, times=1),)))
    cache = ResultCache(tmp_path / "cache", injector=inj)
    with pytest.warns(UserWarning, match="cache store failed"):
        cache.store(fabricated(5))
    assert not cache.path("lruhash", 5).exists()
    cache.store(fabricated(5))
    with pytest.warns(UserWarning, match="unreadable cache entry"):
        assert cache.lookup("lruhash", 5) is None
    assert_bitwise_equal(fabricated(5), cache.lookup("lruhash", 5))
    cache.store(fabricated(6))
    assert cache.lookup("lruhash", 6) is not None  # not a target of the rule
    assert inj.events == {"cache_error": 2}
