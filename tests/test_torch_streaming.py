"""Port vs reference: streaming (``repro_torch.streaming``).

The merge math holds the reference's properties for both the host (numpy)
pair and the torch pair: the merge identity, the from-scratch budget,
associativity and permutation, degenerate partitions, the
``suffstats_from_moments`` round trip and exact count merges (property
tests of the same: tests/test_torch_streaming_properties.py). The host pair
is bitwise the reference's. Sidecars written by the port equal the
reference's bitwise for the same window; an append by the port writes the
reference's chunk files and manifest ``content_sha256``; ``merge_slice``
matches the reference's merge (counts exact, moments rtol = atol = 2e-3,
Eq.-5 errors rtol 1e-4 / atol 5e-4, ``type_idx`` outside a tie between the
best two types) and a strict port recompute within ``MERGE_ULP_BUDGET``.
The reference's session-level cases then run on the port, on the CPU.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

import repro.api as rapi
from repro.core import distributions as rd
from repro.streaming import append as r_append
from repro.streaming import moments as rm
from repro.streaming import stats as r_stats
from repro_torch import api as tapi
from repro_torch.core import distributions as td
from repro_torch.core import pdf_error as tpe
from repro_torch.core import regions
from repro_torch.core.executor import RESULT_FIELDS
from repro_torch.data import file_source as t_fs
from repro_torch.streaming import moments as tm
from repro_torch.streaming import stats as t_stats
from repro_torch.streaming import (
    MERGE_ULP_BUDGET,
    append_realizations,
    incremental,
)

MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)
SIM = tapi.SourceSpec(num_slices=3, lines_per_slice=4, points_per_line=6, observations=48)
MOMENT_FIELDS = ("mean", "var", "skew", "kurt", "vmin", "vmax")


def _np_stats(s):
    """A SuffStats of tensors as numpy (float64 kept)."""
    return tm.SuffStats(float(s.n), *(np.asarray(torch.as_tensor(f)) for f in s[1:]))


# The two merge pairs: (merge_suffstats, merge_counts), each returning numpy.
PAIRS = {
    "numpy": (tm.merge_suffstats, tm.merge_counts),
    "torch": (lambda a, b: _np_stats(tm.merge_suffstats_torch(a, b)),
              lambda a, b: tm.merge_counts_torch(a, b).numpy()),
}
pair_ids = pytest.mark.parametrize("pair", sorted(PAIRS))


def rand_parts(shape=(7,), counts=(12, 5, 9), seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(3.0, scale, shape + (k,)).astype(np.float32) for k in counts]


def assert_within_budget(a, b, names=("mean", "var", "skew", "kurt")):
    ma, mb = tm.moments_from_suffstats(a), tm.moments_from_suffstats(b)
    for name in names:
        va, vb = np.asarray(getattr(ma, name)), np.asarray(getattr(mb, name))
        # ulp distance degenerates across zero: an absolute floor of one
        # float32 epsilon, as the reference's property tests allow
        ok = (tm.ulp_diff(va, vb) <= MERGE_ULP_BUDGET) | (np.abs(va - vb) <= 2.0**-23)
        assert ok.all(), f"{name}: {tm.ulp_diff(va, vb).max()} ulps"


# -- the merge math --------------------------------------------------------------


def test_host_pair_is_bitwise_the_reference():
    """The numpy code is the reference's: same inputs, same bits."""
    parts = rand_parts(seed=4)
    t_s = [tm.suffstats_from_values(p) for p in parts]
    r_s = [rm.suffstats_from_values(p) for p in parts]
    for a, b in zip(t_s, r_s):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, fb)
    t_m = tm.merge_suffstats(tm.merge_suffstats(t_s[0], t_s[1]), t_s[2])
    r_m = rm.merge_suffstats(rm.merge_suffstats(r_s[0], r_s[1]), r_s[2])
    for fa, fb in zip(t_m, r_m):
        np.testing.assert_array_equal(fa, fb)
    for fa, fb in zip(tm.moments_from_suffstats(t_m), rm.moments_from_suffstats(r_m)):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
    m = rd.moments_from_values(parts[0])
    for fa, fb in zip(tm.suffstats_from_moments(m, 12), rm.suffstats_from_moments(m, 12)):
        np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(tm.ulp_diff(parts[0], parts[0] + 1e-3),
                                  rm.ulp_diff(parts[0], parts[0] + 1e-3))
    assert tm.MERGE_ULP_BUDGET == rm.MERGE_ULP_BUDGET


@pair_ids
def test_empty_is_merge_identity(pair):
    merge, _ = PAIRS[pair]
    (a,) = rand_parts(counts=(8,))
    s = tm.suffstats_from_values(a)
    for merged in (merge(tm.empty_suffstats(s.mean.shape), s),
                   merge(s, tm.empty_suffstats(s.mean.shape))):
        assert merged.n == s.n
        for f_m, f_s in zip(merged[1:], s[1:]):
            np.testing.assert_array_equal(f_m, f_s)


@pair_ids
def test_merge_matches_from_scratch_within_budget(pair):
    merge, _ = PAIRS[pair]
    parts = rand_parts()
    merged = tm.suffstats_from_values(parts[0])
    for p in parts[1:]:
        merged = merge(merged, tm.suffstats_from_values(p))
    direct = tm.suffstats_from_values(np.concatenate(parts, axis=-1))
    assert merged.n == direct.n
    np.testing.assert_array_equal(merged.vmin, direct.vmin)  # min/max exact
    np.testing.assert_array_equal(merged.vmax, direct.vmax)
    assert_within_budget(merged, direct)


@pair_ids
def test_merge_associativity_and_permutation(pair):
    merge, _ = PAIRS[pair]
    a, b, c = (tm.suffstats_from_values(p) for p in rand_parts(seed=3))
    left = merge(merge(a, b), c)
    for other in (merge(a, merge(b, c)), merge(c, merge(b, a))):
        assert other.n == left.n
        assert_within_budget(left, other)


@pair_ids
def test_degenerate_constant_partition_merges_finite(pair):
    merge, _ = PAIRS[pair]
    merged = merge(tm.suffstats_from_values(np.full((4, 10), 2.5, np.float32)),
                   tm.suffstats_from_values(np.full((4, 6), 2.5, np.float32)))
    m = tm.moments_from_suffstats(merged)
    for f in m:
        assert np.isfinite(np.asarray(f)).all()
    np.testing.assert_allclose(np.asarray(m.mean), 2.5)
    np.testing.assert_allclose(np.asarray(m.var), 0.0)


@pytest.mark.parametrize("impl", ["reference", "port"])
def test_suffstats_from_moments_roundtrip(impl):
    """Moments of either package (jnp or torch, CPU) invert and finalize
    back within the budget."""
    (a,) = rand_parts(counts=(40,), seed=7)
    if impl == "reference":
        m = rd.moments_from_values(a)
    else:
        m = td.Moments(*(f.numpy() for f in td.moments_from_values(torch.from_numpy(a))))
    back = tm.moments_from_suffstats(tm.suffstats_from_moments(m, a.shape[-1]))
    for name in MOMENT_FIELDS:
        d = tm.ulp_diff(getattr(back, name), np.asarray(getattr(m, name))).max()
        assert d <= MERGE_ULP_BUDGET, f"{name}: {d} ulps"


@pair_ids
def test_histogram_merge_is_exact_integer_addition(pair):
    _, merge = PAIRS[pair]
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1000, (6, 16)).astype(np.float32)
    b = rng.integers(0, 1000, (6, 16)).astype(np.float32)
    np.testing.assert_array_equal(merge(a, b), a + b)
    np.testing.assert_array_equal(merge(a, b), np.asarray(rm.merge_counts_jnp(a, b)))
    if pair == "numpy":
        with pytest.raises(ValueError, match="integral"):
            merge(a + 0.5, b)


def test_torch_pair_keeps_device_and_dtype():
    a, b = (tm.suffstats_from_values(p) for p in rand_parts(counts=(9, 4), seed=2))
    ta = tm.SuffStats(a.n, *(torch.from_numpy(f).float() for f in a[1:]))
    tb = tm.SuffStats(b.n, *(torch.from_numpy(f).float() for f in b[1:]))
    merged = tm.merge_suffstats_torch(ta, tb)
    assert all(f.dtype == torch.float32 and f.device.type == "cpu" for f in merged[1:])
    assert merged.n == 13.0
    want = tm.merge_suffstats(a, b)
    for f_t, f_w in zip(merged[1:], want[1:]):
        np.testing.assert_allclose(f_t.numpy(), f_w, rtol=1e-5, atol=1e-5)
    counts = tm.merge_counts_torch(torch.ones(3, 4), torch.ones(3, 4))
    assert counts.dtype == torch.float32 and float(counts.sum()) == 24.0


def test_split_histogram_bitwise_equals_one_pass():
    """Eq.-5 counts over FIXED edges: binning partitions separately (K4's
    plain version, the sidecar path) and adding is bitwise-equal to binning
    the concatenation."""
    rng = np.random.default_rng(11)
    parts = [rng.uniform(0.0, 10.0, (5, k)).astype(np.float32) for k in (30, 17, 4)]
    allv = np.concatenate(parts, axis=-1)
    vmin, vmax = torch.from_numpy(allv.min(axis=1)), torch.from_numpy(allv.max(axis=1))

    def counts(v):
        return t_stats.window_counts(torch.from_numpy(np.ascontiguousarray(v)), vmin, vmax, 16)

    summed = counts(parts[0])
    for p in parts[1:]:
        summed = tm.merge_counts(summed, counts(p))
    np.testing.assert_array_equal(summed, counts(allv))


def test_fit_backends_carry_merge_callables():
    from repro_torch.core.fitting import get_fit_backend

    ref = get_fit_backend("reference")
    assert ref.merge_stats is tm.merge_suffstats and ref.merge_hist is tm.merge_counts
    for name in ("kernels", "fused"):
        b = get_fit_backend(name)
        assert b.merge_stats is tm.merge_suffstats_torch
        assert b.merge_hist is tm.merge_counts_torch


# -- sidecars, appends, merges: the port against the reference -----------------


def make_cube(tmp_path, name="cube"):
    return t_fs.export_cube(SIM, tmp_path / name, lines_per_chunk=2)


def make_spec(file_src, tmp_path, tag="", fit_backend="fused", **stream_kw):
    stream_kw.setdefault("persist_stats", True)
    return tapi.PipelineSpec(
        source=file_src,
        compute=tapi.ComputeSpec(window_lines=2, num_bins=16, fit_backend=fit_backend),
        execution=tapi.ExecSpec(cache_dir=str(tmp_path / f"cache{tag}"),
                                out_dir=str(tmp_path / f"out{tag}")),
        stream=tapi.StreamSpec(**stream_kw),
    )


def ref_spec(spec, tag=None, tmp_path=None):
    """The reference package's spec of the same JSON (its own directories
    when ``tag`` is given)."""
    r = rapi.PipelineSpec.from_json(spec.to_json())
    if tag is not None:
        r = dataclasses.replace(r, execution=dataclasses.replace(
            r.execution, cache_dir=str(tmp_path / f"cache{tag}"),
            out_dir=str(tmp_path / f"out{tag}")))
    return r


def in_range_append(cube_path, slice_i, k=5):
    """Per-point data strictly inside each point's [vmin, vmax] (the
    midpoint, tiled k deep): an append that cannot move the Eq.-5 edges."""
    src = t_fs.FileCubeSource(cube_path)
    g = src.geometry
    vals = src.load_window(regions.Window(slice_i, 0, g.lines_per_slice))
    mid = (vals.min(axis=1) + vals.max(axis=1)) / 2.0
    block = np.repeat(mid[:, None], k, axis=1).astype(np.float32)
    return block.reshape(g.lines_per_slice, g.points_per_line, k)


def assert_fields_equal(a, b):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.avg_error == b.avg_error


def assert_sidecars_equal(a, b):
    assert a is not None and b is not None
    assert (a["num_bins"], a["line_start"], a["line_end"]) == \
        (b["num_bins"], b["line_start"], b["line_end"])
    np.testing.assert_array_equal(a["freq"], b["freq"])
    assert a["freq"].dtype == b["freq"].dtype == np.int64
    assert a["stats"].n == b["stats"].n
    for fa, fb in zip(a["stats"][1:], b["stats"][1:]):
        assert fa.dtype == fb.dtype == np.float64
        np.testing.assert_array_equal(fa, fb)


def _windows(spec, slice_i):
    g = regions.CubeGeometry(SIM.num_slices, SIM.lines_per_slice, SIM.points_per_line)
    return list(regions.iter_windows(g, slice_i, spec.compute.window_lines))


@pytest.mark.parametrize("rows", [1, 511, 600, 3001])
def test_row_block_statistics_are_bitwise_one_call(rows):
    """The recorder's threaded row blocks give the reference's one-call
    statistics bit for bit, whatever the split."""
    from concurrent.futures import ThreadPoolExecutor

    v = np.random.default_rng(rows).normal(3.0, 2.0, (rows, 257)).astype(np.float32)
    want = rm.suffstats_from_values(v)
    with ThreadPoolExecutor(3) as pool:
        got = t_stats.host_suffstats(v, pool)
    assert got.n == want.n
    for fa, fb in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(fa, fb)


@pytest.mark.parametrize("fit_backend", ["reference", "kernels", "fused"])
def test_sidecars_bitwise_equal_reference(tmp_path, fit_backend):
    """The same spec run by both packages with ``persist_stats``: every
    window's sidecar (float64 statistics, int64 counts) is bitwise the
    reference's, and each package's ``load_stats`` reads the other's."""
    spec = make_spec(make_cube(tmp_path), tmp_path, fit_backend=fit_backend)
    session = tapi.PDFSession(spec, device="cpu")
    session.run_all()
    rapi.PDFSession(ref_spec(spec, "_ref", tmp_path)).run_all()
    rec = session.executor(0).stats_recorder
    assert rec.windows_recorded == 6 and rec.seconds > 0
    out, rout = spec.execution.out_dir, str(tmp_path / "out_ref")
    for s in range(SIM.num_slices):
        for w in _windows(spec, s):
            mine = t_stats.load_stats(out, s, w.line_start, spec_hash=session.spec_hash)
            assert_sidecars_equal(mine, r_stats.load_stats(rout, s, w.line_start))
            assert_sidecars_equal(mine, r_stats.load_stats(out, s, w.line_start))
            assert_sidecars_equal(mine, t_stats.load_stats(rout, s, w.line_start))
    # a sidecar under another spec hash is refused
    assert t_stats.load_stats(out, 0, 0, spec_hash="0" * 16) is None


def test_recorder_skips_sampled_windows(tmp_path):
    """The random sampler's windows describe a draw: no sidecar, as in the
    reference."""
    spec = make_spec(make_cube(tmp_path), tmp_path)
    tree = tapi.PDFSession(dataclasses.replace(
        spec, method=tapi.MethodSpec(name="ml")), device="cpu").tree
    sspec = dataclasses.replace(spec, method=tapi.MethodSpec(name="sampling", sample_frac=0.5))
    session = tapi.PDFSession(sspec, tree=tree, device="cpu")
    session.run_all([0])
    assert session.executor(0).stats_recorder.windows_recorded == 0
    assert not list((tmp_path / "out").glob("slice0_stats_*.npz"))


def test_append_bitwise_equal_reference(tmp_path):
    """The same appends (two versions, two slices) by each package on two
    copies of one cube: identical chunk files, manifests and
    ``content_sha256``."""
    base = make_cube(tmp_path).path
    copies = {}
    for name in ("port", "ref"):
        copies[name] = tmp_path / name
        shutil.copytree(base, copies[name])
    rng = np.random.default_rng(3)
    appends = [{1: rng.normal(size=(4, 6, 3)).astype(np.float32)},
               {0: rng.normal(size=(24, 2)).astype(np.float32),
                2: rng.normal(size=(4, 6, 1)).astype(np.float32)}]
    for data in appends:
        assert append_realizations(copies["port"], data) == \
            r_append.append_realizations(copies["ref"], data)
    files = sorted(p.name for p in copies["port"].iterdir())
    assert files == sorted(p.name for p in copies["ref"].iterdir())
    assert sum(f.endswith(".npy") and ".v0000" in f for f in files) == 2 + 2 + 2  # deltas
    for f in files:
        assert (copies["port"] / f).read_bytes() == (copies["ref"] / f).read_bytes(), f
    m = t_fs.read_manifest(copies["port"])
    assert m["version"] == 3
    assert m["content_sha256"] == t_fs.read_manifest(copies["ref"])["content_sha256"] \
        == t_fs.manifest_sha(copies["port"])
    with pytest.raises(ValueError, match="empty"):
        append_realizations(copies["port"], {})
    with pytest.raises(ValueError, match="shape"):
        append_realizations(copies["port"], {0: np.zeros((2, 2, 3), np.float32)})
    assert t_fs.manifest_version(copies["port"]) == 3  # failed appends commit nothing


def _all_type_errors(types, num_bins, mean, std, skew, kurt, vmin, vmax, freq):
    """Every candidate's Eq.-5 error from moments and counts (the refit's
    chain on the CPU): the margin rule's input."""
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    mom = td.Moments(t(mean), t(np.square(std)), t(skew), t(kurt), t(vmin), t(vmax))
    params = td.fit_all(types, mom)
    masses = tpe.cdf_masses(types, params, tpe.interval_edges(mom.vmin, mom.vmax, num_bins))
    return tpe.pdf_error_from_freq(t(freq), masses).numpy()


def assert_margin_rule(got, want, errs):
    """``type_idx`` equal wherever ``want``'s best-to-second error gap
    exceeds the error tolerance (elsewhere the two types tie)."""
    srt = np.sort(np.where(np.isfinite(errs), errs, 1e30), axis=-1)
    decided = srt[:, 1] - srt[:, 0] > ERR_TOL["atol"] + ERR_TOL["rtol"] * np.abs(srt[:, 0])
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(got.type_idx[decided], want.type_idx[decided])


def _slice_sidecars(out_dir, spec, slice_i):
    sc = [t_stats.load_stats(out_dir, slice_i, w.line_start) for w in _windows(spec, slice_i)]
    return np.concatenate([c["freq"] for c in sc]), sc


def test_merge_slice_matches_reference(tmp_path):
    """One cube and one append, merged by each package from its own run's
    sidecars: counts exact, moments and errors at the parity tolerances,
    ``type_idx`` by the margin rule; and both merges within
    MERGE_ULP_BUDGET of a strict port recompute, counts bitwise."""
    file_src = make_cube(tmp_path)
    cube = file_src.path
    spec = make_spec(file_src, tmp_path)
    rspec = ref_spec(spec, "_ref", tmp_path)
    tapi.PDFSession(spec, device="cpu").run_all()
    rapi.PDFSession(rspec).run_all()
    append_realizations(cube, {1: in_range_append(cube, 1)})

    port = tapi.PDFSession(spec, device="cpu")
    got = port.run_all([1])[1]
    ref = rapi.PDFSession(rspec).run_all([1])[1]
    assert port.report().slices_merged == 1 and not port._executors
    freq, sc = _slice_sidecars(spec.execution.out_dir, spec, 1)
    rfreq, _ = _slice_sidecars(rspec.execution.out_dir, spec, 1)
    np.testing.assert_array_equal(freq, rfreq)
    for name in ("mean", "std", "skew", "kurt"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), **MOM_TOL,
                                   err_msg=name)
    same = got.type_idx == ref.type_idx
    np.testing.assert_allclose(got.error[same], ref.error[same], **ERR_TOL)
    np.testing.assert_allclose(got.params[same], ref.params[same], **MOM_TOL)
    vmin = np.concatenate([c["stats"].vmin for c in sc])
    vmax = np.concatenate([c["stats"].vmax for c in sc])
    types = tuple(spec.compute.types)
    errs = _all_type_errors(types, 16, ref.mean, ref.std, ref.skew, ref.kurt, vmin, vmax, freq)
    assert_margin_rule(got, ref, errs)

    strict_spec = make_spec(file_src, tmp_path, tag="_strict", update_mode="strict")
    strict = tapi.PDFSession(strict_spec, device="cpu").run_all([1])[1]
    sfreq, _ = _slice_sidecars(strict_spec.execution.out_dir, spec, 1)
    np.testing.assert_array_equal(freq, sfreq)
    for merged in (got, ref):
        for name in ("mean", "std", "skew", "kurt"):
            d = tm.ulp_diff(getattr(merged, name), getattr(strict, name)).max()
            assert d <= MERGE_ULP_BUDGET, f"{name}: {d} ulps"


def test_merge_window_refuses_what_the_reference_refuses(tmp_path):
    """Another bin count, nothing appended, or edges moved: None."""
    file_src = make_cube(tmp_path)
    spec = make_spec(file_src, tmp_path)
    tapi.PDFSession(spec, device="cpu").run_all([0])
    out = spec.execution.out_dir
    w = _windows(spec, 0)[0]
    old = t_stats.load_stats(out, 0, 0)
    src = t_fs.FileCubeSource(file_src.path)
    assert incremental.merge_window(spec, src, w, old, "cpu") is None  # nothing new
    append_realizations(file_src.path, {0: in_range_append(file_src.path, 0)})
    src = t_fs.FileCubeSource(file_src.path)
    assert incremental.merge_window(spec, src, w, old, "cpu") is not None
    assert incremental.merge_window(spec, src, w, {**old, "num_bins": 8}, "cpu") is None
    narrow = old["stats"]._replace(vmax=old["stats"].vmin + 1e-6)
    assert incremental.merge_window(spec, src, w, {**old, "stats": narrow}, "cpu") is None


# -- the reference's session-level cases, on the port -----------------------------


def test_incremental_run_recomputes_only_changed_slices(tmp_path):
    """Merge mode: after an append to one slice, a second run adopts every
    untouched slice (served bitwise from the cache), merges the appended
    slice from its sidecars and never builds an executor. Merged counts
    are bitwise a from-scratch run's, moments within MERGE_ULP_BUDGET; the
    watermark records the tolerance; the merge never enters the cache."""
    file_src = make_cube(tmp_path)
    cube = file_src.path
    spec = make_spec(file_src, tmp_path)
    s1 = tapi.PDFSession(spec, device="cpu")
    first = s1.run_all()
    old_hash = s1.spec_hash
    assert s1.report().cache_misses == 3 and s1.report().cache_adopted == 0

    append_realizations(cube, {1: in_range_append(cube, 1)})
    s2 = tapi.PDFSession(spec, device="cpu")
    assert s2.spec_hash != old_hash
    second = s2.run_all()
    rep2 = s2.report()
    assert (rep2.cache_adopted, rep2.cache_hits, rep2.slices_merged, rep2.cache_misses) == \
        (2, 2, 1, 1)
    assert not s2._executors and rep2.windows == 0
    for s in (0, 2):
        assert second[s].cached
        assert_fields_equal(first[s], second[s])

    fresh = tapi.PDFSession(make_spec(file_src, tmp_path, tag="_fresh"), device="cpu")
    full = fresh.run_all()
    merged, ref = second[1], full[1]
    for name in ("mean", "std", "skew", "kurt"):
        d = tm.ulp_diff(getattr(merged, name), getattr(ref, name)).max()
        assert d <= MERGE_ULP_BUDGET, f"{name}: {d} ulps"
    for w in _windows(spec, 1):
        a = t_stats.load_stats(spec.execution.out_dir, 1, w.line_start)
        b = t_stats.load_stats(fresh.spec.execution.out_dir, 1, w.line_start)
        np.testing.assert_array_equal(a["freq"], b["freq"])
        assert a["stats"].n == b["stats"].n == SIM.observations + 5
    mark = json.loads((tmp_path / "out" / "slice1_watermark.json").read_text())
    assert mark["spec_hash"] == s2.spec_hash
    assert mark["merge_ulp_budget"] == MERGE_ULP_BUDGET
    assert mark["merged_from"] == old_hash
    assert not tapi.ResultCache(spec.execution.cache_dir).path(s2.spec_hash, 1).exists()


def test_merge_survives_watermark_restamped_by_cache_hit(tmp_path):
    """Slice 2 adopted at v2 gets its watermark re-stamped by the cache-hit
    persist while its sidecars keep the v1 stamp; an append to slice 2 at v3
    still merges (the sidecar is accepted under the manifest lineage)."""
    file_src = make_cube(tmp_path)
    cube = file_src.path
    spec = make_spec(file_src, tmp_path)
    tapi.PDFSession(spec, device="cpu").run_all()
    append_realizations(cube, {1: in_range_append(cube, 1)})
    tapi.PDFSession(spec, device="cpu").run_all()
    append_realizations(cube, {2: in_range_append(cube, 2)})
    s3 = tapi.PDFSession(spec, device="cpu")
    third = s3.run_all([2])
    rep = s3.report()
    assert rep.slices_merged == 1 and rep.windows == 0 and not s3._executors
    ref = tapi.PDFSession(make_spec(file_src, tmp_path, tag="_fresh"),
                          device="cpu").run_all([2])[2]
    for name in ("mean", "std", "skew", "kurt"):
        d = tm.ulp_diff(getattr(third[2], name), getattr(ref, name)).max()
        assert d <= MERGE_ULP_BUDGET, f"{name}: {d} ulps"


def test_strict_mode_recompute_is_bitwise(tmp_path):
    file_src = make_cube(tmp_path)
    cube = file_src.path
    spec = make_spec(file_src, tmp_path, update_mode="strict")
    tapi.PDFSession(spec, device="cpu").run_all()
    append_realizations(cube, {1: in_range_append(cube, 1)})
    s2 = tapi.PDFSession(spec, device="cpu")
    second = s2.run_all()
    rep2 = s2.report()
    assert rep2.cache_adopted == 2 and rep2.slices_merged == 0 and rep2.windows == 2
    full = tapi.PDFSession(make_spec(file_src, tmp_path, tag="_fresh", update_mode="strict"),
                           device="cpu").run_all()
    assert_fields_equal(second[1], full[1])
    assert second[1].spec_hash == full[1].spec_hash
    assert tapi.ResultCache(spec.execution.cache_dir).path(s2.spec_hash, 1).exists()


def test_out_of_range_append_falls_back_to_full_recompute(tmp_path):
    file_src = make_cube(tmp_path)
    cube = file_src.path
    spec = make_spec(file_src, tmp_path)
    tapi.PDFSession(spec, device="cpu").run_all()
    wild = np.random.default_rng(9).normal(100.0, 50.0, (SIM.lines_per_slice,
                                                          SIM.points_per_line, 5))
    append_realizations(cube, {1: wild.astype(np.float32)})
    s2 = tapi.PDFSession(spec, device="cpu")
    second = s2.run_all()
    rep2 = s2.report()
    assert rep2.cache_adopted == 2 and rep2.slices_merged == 0 and rep2.windows == 2
    fresh = tapi.PDFSession(make_spec(file_src, tmp_path, tag="_fresh"), device="cpu")
    assert_fields_equal(second[1], fresh.run_all()[1])


def test_incremental_disabled_skips_adoption(tmp_path):
    file_src = make_cube(tmp_path)
    cube = file_src.path
    spec = make_spec(file_src, tmp_path, incremental=False, update_mode="strict")
    tapi.PDFSession(spec, device="cpu").run_all()
    append_realizations(cube, {1: in_range_append(cube, 1)})
    s2 = tapi.PDFSession(spec, device="cpu")
    s2.run_all()
    rep = s2.report()
    assert rep.cache_adopted == 0 and rep.cache_misses == 3


def test_refresh_source_follows_appends(tmp_path):
    file_src = make_cube(tmp_path)
    cube = file_src.path
    spec = make_spec(file_src, tmp_path)
    s = tapi.PDFSession(spec, device="cpu")
    h1 = s.spec_hash
    s.run_all()
    append_realizations(cube, {0: in_range_append(cube, 0)})
    h2 = s.refresh_source()
    assert h2 != h1 and s.spec_hash == h2
    assert s._file_source().version == 2
    assert not s._executors
    res = s.run_all()
    rep = s.report()
    assert rep.cache_adopted == 2 and rep.slices_merged == 1
    assert res[0].spec_hash == h2
