"""Port vs reference: whole slices through ``PDFComputer``.

A small seismic cube (4 slices of 12 lines x 30 points, 200 observations,
window_lines=5, so every slice ends in a ragged 2-line window) goes through
``repro.core.pipeline.PDFComputer`` and the port's, on the CPU: baseline for
4 and 10 candidate types, grouping and reuse (host Select, the reference's
default fused backend) for 4, against each of the port's backends. Within
the port, bitwise: prefetch on and off, device and host Select, faithful
and fused mode; persist + resume re-runs nothing."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import distributions as rd
from repro.core import pipeline as rp
from repro.core import regions as r_regions
from repro.data import simulation as r_sim
from repro.kernels import fitpdf as rfp
from repro_torch.core import executor as tex
from repro_torch.core import pipeline as tp
from repro_torch.core import regions as t_regions
from repro_torch.data import simulation as t_sim

DIMS, OBS, WINDOW_LINES = (4, 12, 30), 200, 5
SLICES = (0, 1, 2, 3)  # one per seismic layer type
MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)
FIELDS = ("type_idx", "params", "error", "mean", "std", "skew", "kurt")
LARGE_BINS = 1000  # more than 767, the most the card's K2 took before ROADMAP fault F1 was fixed


def _ref_source():
    return r_sim.SeismicSimulation(r_sim.SimulationConfig(
        geometry=r_regions.CubeGeometry(*DIMS), num_simulations=OBS))


def _port_source():
    return t_sim.SeismicSimulation(t_sim.SimulationConfig(
        geometry=t_regions.CubeGeometry(*DIMS), num_simulations=OBS))


def _port(types=rd.TYPES_4, fit_backend="fused", num_bins=64, method="baseline",
          select_backend="host", mode="fused", **kw):
    cfg = tp.PDFConfig(types=types, num_bins=num_bins, window_lines=WINDOW_LINES,
                       fit_backend=fit_backend, method=method,
                       select_backend=select_backend, mode=mode)
    return tp.PDFComputer(cfg, _port_source(), device="cpu", **kw)


def _bitwise(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.avg_error == b.avg_error


@pytest.fixture(scope="module")
def reference_results():
    """The reference's results per candidate set, plus its per-type errors
    (for the tie rule), computed once."""
    out = {}
    src = _ref_source()
    for types in (rd.TYPES_4, rd.TYPES_10):
        cfg = rp.PDFConfig(types=types, window_lines=WINDOW_LINES)
        res = rp.PDFComputer(cfg, src).run(SLICES)
        errs = {}
        for s in SLICES:
            v = jnp.asarray(np.concatenate([
                src.load_window(w) for w in r_regions.iter_windows(src.geometry, s, WINDOW_LINES)]))
            m = rfp.moments(v, 64)
            errs[s] = np.asarray(rfp.fit_errors(v, m, rd.fit_all(types, m), types, 64))
        out[len(types)] = (res, errs)
    return out


@pytest.fixture(scope="module")
def grouped_reference():
    """The reference's grouping and reuse runs (host Select, 4 types)."""
    src = _ref_source()
    return {m: rp.PDFComputer(rp.PDFConfig(window_lines=WINDOW_LINES, method=m), src).run(SLICES)
            for m in ("grouping", "reuse")}


def _assert_slices_match(ref, ref_errs, got, slices=SLICES):
    for s in slices:
        r, t = ref[s], got[s]
        for name in ("mean", "std", "skew", "kurt"):
            np.testing.assert_allclose(getattr(t, name), getattr(r, name), **MOM_TOL, err_msg=name)
        # type_idx: equal wherever the reference's best and second-best
        # errors are further apart than the error tolerance; elsewhere (on
        # the normal layer, student_t at nu = 50 ties with normal) the
        # port's pick must be within the tolerance of the best.
        errs = np.where(np.isfinite(ref_errs[s]), ref_errs[s], 1e30)
        srt = np.sort(errs, axis=1)
        tol = ERR_TOL["atol"] + ERR_TOL["rtol"] * srt[:, 0]
        clear = srt[:, 1] - srt[:, 0] > tol
        np.testing.assert_array_equal(t.type_idx[clear], r.type_idx[clear])
        picked = np.take_along_axis(errs, t.type_idx[:, None].astype(np.int64), axis=1)[:, 0]
        assert (picked - srt[:, 0] <= tol).all()
        same = t.type_idx == r.type_idx
        np.testing.assert_allclose(t.params[same], r.params[same], **MOM_TOL)
        np.testing.assert_allclose(t.error[same], r.error[same], **ERR_TOL)
        assert abs(t.avg_error - r.avg_error) <= 5e-4
        assert t.type_idx.dtype == np.int32 and t.params.dtype == np.float32
        assert [tuple(w.window) for w in t.stats] == [tuple(w.window) for w in r.stats]
        assert t.slice_i == s and t.error_bound_satisfied is None


@pytest.mark.parametrize("fit_backend", ["fused", "reference"])
@pytest.mark.parametrize("types", [rd.TYPES_4, rd.TYPES_10], ids=["4types", "10types"])
def test_slices_match_reference(reference_results, fit_backend, types):
    ref, ref_errs = reference_results[len(types)]
    _assert_slices_match(ref, ref_errs, _port(types, fit_backend).run(SLICES))


@pytest.fixture(scope="module")
def large_bins_reference():
    """The reference's slice 0 at num_bins=1000 (4 types), past what one
    block of the card's K2 holds at once, and its per-type errors."""
    src = _ref_source()
    res = rp.PDFComputer(rp.PDFConfig(num_bins=LARGE_BINS, window_lines=WINDOW_LINES), src).run([0])
    v = jnp.asarray(np.concatenate([
        src.load_window(w) for w in r_regions.iter_windows(src.geometry, 0, WINDOW_LINES)]))
    m = rfp.moments(v, LARGE_BINS)
    return res, {0: np.asarray(rfp.fit_errors(v, m, rd.fit_all(rd.TYPES_4, m), rd.TYPES_4, LARGE_BINS))}


@pytest.mark.parametrize("fit_backend", ["fused", "kernels", "reference"])
def test_slice_large_bins_matches_reference(large_bins_reference, fit_backend):
    """One slice at num_bins=1000 against the reference, under the same
    parity rules."""
    ref, ref_errs = large_bins_reference
    _assert_slices_match(ref, ref_errs, _port(fit_backend=fit_backend, num_bins=LARGE_BINS).run([0]),
                         slices=(0,))


@pytest.mark.parametrize("fit_backend", ["kernels", "fused", "reference"])
@pytest.mark.parametrize("method", ["grouping", "reuse"])
def test_grouped_slices_match_reference(reference_results, grouped_reference, method,
                                        fit_backend):
    """Grouping and reuse against the reference's host Select: the parity
    rules per point, and per window the same number of fitted
    representatives and cache hits (rows of one generator cell are
    identical, so both packages find the same groups)."""
    ref = grouped_reference[method]
    got = _port(fit_backend=fit_backend, method=method).run(SLICES)
    _assert_slices_match(ref, reference_results[4][1], got)
    for s in SLICES:
        assert [(w.num_fitted, w.cache_hits) for w in got[s].stats] == \
            [(w.num_fitted, w.cache_hits) for w in ref[s].stats]
        assert sum(w.num_fitted for w in got[s].stats) < len(got[s].type_idx)
    if method == "reuse":
        assert sum(w.cache_hits for s in SLICES for w in got[s].stats) > 0


@pytest.mark.parametrize("fit_backend", ["kernels", "fused", "reference"])
@pytest.mark.parametrize("method", ["grouping", "reuse"])
def test_device_select_bitwise_matches_host(method, fit_backend):
    host = _port(fit_backend=fit_backend, method=method).run(SLICES)
    device = _port(fit_backend=fit_backend, method=method, select_backend="device").run(SLICES)
    for s in SLICES:
        _bitwise(host[s], device[s])
        assert [(w.num_fitted, w.cache_hits) for w in host[s].stats] == \
            [(w.num_fitted, w.cache_hits) for w in device[s].stats]


@pytest.mark.parametrize("method", ["baseline", "grouping"])
def test_faithful_matches_fused_on_kernels(method):
    """Faithful mode (K4 once per type on a fresh unit-scaled copy) gives
    fused mode's results bit for bit."""
    a = _port(rd.TYPES_10, "kernels", num_bins=20, method=method, mode="faithful").run_slice(1)
    b = _port(rd.TYPES_10, "kernels", num_bins=20, method=method).run_slice(1)
    _bitwise(a, b)


@pytest.mark.parametrize("fit_backend", ["kernels", "fused"])
def test_reuse_prefetch_on_off_bitwise(fit_backend):
    """The reuse cache fills in window order on the compute thread, so
    prefetch does not change what it holds or returns."""
    a = _port(fit_backend=fit_backend, method="reuse", select_backend="device",
              exec_config=tp.ExecutorConfig(prefetch=False, async_persist=False))
    b = _port(fit_backend=fit_backend, method="reuse", select_backend="device",
              exec_config=tp.ExecutorConfig(prefetch=True, prefetch_depth=3))
    ra, rb = a.run(SLICES), b.run(SLICES)
    for s in SLICES:
        _bitwise(ra[s], rb[s])
        assert [w.cache_hits for w in ra[s].stats] == [w.cache_hits for w in rb[s].stats]
    assert (a.cache.size, a.cache.hits, a.cache.lookups) == \
        (b.cache.size, b.cache.hits, b.cache.lookups)


def test_reuse_cache_spans_slices():
    """The cache lives on the executor: a second run of the same slice on
    one PDFComputer hits on every representative and fits nothing."""
    comp = _port(method="reuse")
    first = comp.run_slice(2)
    size = comp.cache.size
    assert size == sum(w.num_fitted for w in first.stats)
    again = comp.run_slice(2)
    assert [w.num_fitted for w in again.stats] == [0] * len(again.stats)
    assert [w.cache_hits for w in again.stats] == \
        [w.num_fitted + w.cache_hits for w in first.stats]
    assert comp.cache.size == size
    _bitwise(first, again)


def test_seismic_slices_find_their_layer_type():
    res = _port(rd.TYPES_4).run(SLICES)
    src = _port_source()
    for s in SLICES:
        assert np.mean(res[s].type_idx == src.true_type_index(s)) > 0.9


@pytest.mark.parametrize("fit_backend", ["fused", "reference"])
def test_prefetch_on_off_bitwise(fit_backend):
    a = _port(rd.TYPES_10, fit_backend,
              exec_config=tp.ExecutorConfig(prefetch=False, async_persist=False)).run_slice(2)
    b = _port(rd.TYPES_10, fit_backend,
              exec_config=tp.ExecutorConfig(prefetch=True, prefetch_depth=3)).run_slice(2)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.avg_error == b.avg_error


def test_persist_and_resume(tmp_path):
    comp = _port(out_dir=tmp_path)
    first = comp.run_slice(1)
    assert len(first.stats) == 3  # lines 0-5, 5-10, 10-12
    mark = json.loads((tmp_path / "slice1_watermark.json").read_text())
    assert mark == {"next_line": 12, "complete": True, "spec_hash": comp.spec.content_hash()}
    resumed = _port(out_dir=tmp_path).run_slice(1, resume=True)
    assert resumed.stats == [] and comp.last_report.units == 3
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(resumed, f), getattr(first, f), err_msg=f)

    # A crash after the first window: resume re-runs exactly the other two.
    (tmp_path / "slice1_watermark.json").write_text(json.dumps({"next_line": 5}))
    for f in tmp_path.glob("slice1_window_0000[5-9].npz"):
        f.unlink()
    (tmp_path / "slice1_window_00010.npz").unlink()
    partial = _port(out_dir=tmp_path, exec_config=tp.ExecutorConfig(async_persist=False))
    again = partial.run_slice(1, resume=True)
    assert [w.window.line_start for w in again.stats] == [5, 10]
    assert partial.last_report.units == 2
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(again, f), getattr(first, f), err_msg=f)
    assert partial.executor.watermark(1) == 12


def test_persisted_files_match_reference_format(tmp_path):
    rp.PDFComputer(rp.PDFConfig(window_lines=WINDOW_LINES), _ref_source(),
                   out_dir=tmp_path / "ref").run_slice(3)
    _port(out_dir=tmp_path / "port").run_slice(3)
    ref_files = sorted(p.name for p in (tmp_path / "ref").iterdir())
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == ref_files
    for name in port_files:
        if name.endswith(".npz"):
            r, t = np.load(tmp_path / "ref" / name), np.load(tmp_path / "port" / name)
            # Both stamp their spec hash; the port's never equals the reference's.
            assert set(r.files) == set(t.files)
            assert str(t["spec_hash"]) != str(r["spec_hash"])
            for k in t.files:
                assert t[k].dtype == r[k].dtype and t[k].shape == r[k].shape, k
        else:
            r = json.loads((tmp_path / "ref" / name).read_text())
            t = json.loads((tmp_path / "port" / name).read_text())
            assert t.pop("spec_hash") != r.pop("spec_hash")
            assert t == r


def test_report_and_error_bound():
    cfg = tp.PDFConfig(window_lines=WINDOW_LINES, error_bound=10.0)
    comp = tp.PDFComputer(cfg, _port_source(), device="cpu")
    res = comp.run_slice(0)
    assert res.error_bound_satisfied is True
    rep = comp.last_report
    assert rep.units == 3 and rep.wall_seconds > 0 and rep.persist_seconds == 0.0
    assert 0.0 <= rep.load_hidden_fraction <= 1.0
    assert res.total_compute_seconds > 0 and res.total_load_seconds > 0
    assert np.isclose(res.avg_error, float(res.error.mean()))


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.PDFComputer(tp.PDFConfig(), _port_source())


@pytest.mark.parametrize("kw", [
    dict(method="grouping_ml"),
    dict(method="ml"),
    dict(method="sampling"),
    dict(method="reuse_ml", select_backend="device"),
    dict(method="sampling", sampler="kmeans", fit_backend="kernels"),
])
def test_tree_methods_require_a_tree(kw):
    """The ML and sampling methods refuse to start without a decision tree,
    with the reference's error."""
    cfg = tp.PDFConfig(**kw)  # valid configuration, as in the reference
    with pytest.raises(ValueError, match=f"method {kw['method']!r} requires a decision tree"):
        tp.PDFComputer(cfg, _port_source(), device="cpu")
    with pytest.raises(ValueError, match="requires a decision tree"):
        rp.PDFComputer(rp.PDFConfig(**kw), _ref_source())


def test_config_fields_and_defaults_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(rp.PDFConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tp.PDFConfig)}
    assert got == ref
    assert tex.METHODS == rp.METHODS and tex.SELECT_BACKENDS == rp.SELECT_BACKENDS
    ec_ref = {f.name: f.default for f in dataclasses.fields(rp.ExecutorConfig)}
    ec = {f.name: f.default for f in dataclasses.fields(tp.ExecutorConfig)}
    assert ec == ec_ref
    # The result types' fields, the result cache's ``cached`` included.
    from repro.core import executor as rex

    for port_cls, ref_cls in ((tex.SliceResult, rex.SliceResult),
                              (tex.ExecutorReport, rex.ExecutorReport)):
        assert [f.name for f in dataclasses.fields(port_cls)] == \
            [f.name for f in dataclasses.fields(ref_cls)]
        assert [f.default for f in dataclasses.fields(port_cls)] == \
            [f.default for f in dataclasses.fields(ref_cls)]
    assert tex.WindowStats._fields == rex.WindowStats._fields
    assert tex.WindowResult._fields == rex.WindowResult._fields
    assert tex.RESULT_FIELDS == rex.RESULT_FIELDS
    for bad in (dict(num_bins=1), dict(window_lines=0), dict(method="x"),
                dict(error_bound=0.0), dict(fit_backend="x"), dict(rep_bucket=0)):
        with pytest.raises(ValueError):
            tp.PDFConfig(**bad)
    for bad in (dict(prefetch_depth=0), dict(max_retries=-1), dict(retry_backoff_s=-1.0),
                dict(straggler_grace_s=-1.0)):
        with pytest.raises(ValueError):
            tp.ExecutorConfig(**bad)
        with pytest.raises(ValueError):
            rp.ExecutorConfig(**bad)
