"""The batched window path: ``run_window_batch`` and ``run_window``.

Within the port, bitwise: every method on every backend (host Select, and
device Select for the grouped methods) gives each window of a batch the
bits ``run_window`` gives it, for a batch of one slice and for a shuffled
batch spanning slices; ``run_window`` gives the run loop's bits. The
grouped methods pack whole windows into one fit launch a shape class, as
the packing predicts. Against the reference: ``repro``'s
``run_window_batch`` on the same windows under the ROADMAP's parity rules
(baseline and grouping with host Select; the reference's device keys fail
under jax 0.9.0, ROADMAP queue 3). A small seismic cube (4 slices of 12
lines x 30 points, 200 observations, windows of 5 lines) on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")

from repro.core import distributions as rd
from repro.core import executor as rex
from repro.core import regions as r_regions
from repro.data import simulation as r_sim
from repro.kernels import fitpdf as rfp
from repro_torch.core import executor as tex
from repro_torch.core import fitting
from repro_torch.core import grouping as tg
from repro_torch.core import regions as t_regions
from repro_torch.core.pipeline import train_type_tree
from repro_torch.data import simulation as t_sim

DIMS, OBS, WINDOW_LINES = (4, 12, 30), 200, 5
MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)
TREE_METHODS = ("ml", "grouping_ml", "reuse_ml", "sampling")


def _sim():
    return t_sim.SeismicSimulation(t_sim.SimulationConfig(
        geometry=t_regions.CubeGeometry(*DIMS), num_simulations=OBS))


def _windows(slices):
    geom = t_regions.CubeGeometry(*DIMS)
    return [w for s in slices for w in t_regions.iter_windows(geom, s, WINDOW_LINES)]


# one slice in line order, and a shuffled batch over three slices
BATCHES = {"slice1": _windows([1]),
           "mixed": [_windows([0, 2, 3])[i] for i in
                     np.random.default_rng(0).permutation(9)]}


@pytest.fixture(scope="module")
def tree():
    return train_type_tree(_sim(), window_lines=WINDOW_LINES, device="cpu")


def _executor(method, fit_backend="fused", select_backend="host", tree=None, **kw):
    cfg = tex.PDFConfig(window_lines=WINDOW_LINES, method=method, fit_backend=fit_backend,
                        select_backend=select_backend, **kw)
    return tex.StagedExecutor(cfg, _sim(), "cpu", tree=tree if method in TREE_METHODS else None)


def _bitwise(got, want, what=""):
    assert tuple(got.window) == tuple(want.window)
    for f in tex.RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{what}{f}")


@pytest.mark.parametrize("batch", sorted(BATCHES))
@pytest.mark.parametrize("fit_backend", ["fused", "kernels", "reference"])
@pytest.mark.parametrize("method", tex.METHODS)
def test_batch_bitwise_equals_run_window(tree, method, fit_backend, batch):
    windows = BATCHES[batch]
    got = _executor(method, fit_backend, tree=tree).run_window_batch(windows)
    # a fresh executor: the reuse methods' cache fills in the same order
    one = _executor(method, fit_backend, tree=tree)
    assert len(got) == len(windows)
    for w, r in zip(windows, got):
        _bitwise(r, one.run_window(w), f"{tuple(w)}/")
        assert r.type_idx.dtype == np.int32 and r.params.dtype == np.float32


@pytest.mark.parametrize("method", ["grouping", "reuse", "grouping_ml", "reuse_ml"])
@pytest.mark.parametrize("fit_backend", ["fused", "kernels"])
def test_device_select_batch_bitwise(tree, method, fit_backend):
    """Device Select runs each window through ``run_window``; its bits equal
    host Select's batch."""
    windows = BATCHES["mixed"]
    got = _executor(method, fit_backend, "device", tree=tree).run_window_batch(windows)
    want = _executor(method, fit_backend, tree=tree).run_window_batch(windows)
    for a, b in zip(got, want):
        _bitwise(a, b)


@pytest.mark.parametrize("method", ["baseline", "grouping", "ml", "grouping_ml", "sampling"])
def test_run_window_equals_run_loop(tree, method):
    """``run_window`` is the run loop's computation: a slice's windows equal
    ``run_slice``'s results at their rows."""
    ex = _executor(method, tree=tree)
    res = ex.run_slice(2)
    ppl = DIMS[2]
    for w in _windows([2]):
        r = ex.run_window(w)
        lo, hi = w.line_start * ppl, w.line_end * ppl
        for f in tex.RESULT_FIELDS:
            np.testing.assert_array_equal(getattr(r, f), getattr(res, f)[lo:hi], err_msg=f)
        assert r.arrays().keys() == set(tex.RESULT_FIELDS)


def _packing(ex, windows):
    """The launches the packing predicts: per shape class, windows filled
    greedily in batch order."""
    sizes = []
    for w in windows:
        v = ex.stager.ready(ex.stager.stage(ex.data.load_window(w)))
        g = tg.group_host(ex._quantized_keys(ex._backend.moments(v))).num_groups
        sizes.append((tg.padded_size(g, ex.config.rep_bucket), g))
    count = 0
    for size in sorted({s for s, _ in sizes}):
        fill = None
        for s, g in sizes:
            if s != size:
                continue
            if fill is None or fill + g > size:
                count, fill = count + 1, 0
            fill += g
    return count


@pytest.mark.parametrize("rep_bucket", [256, 16, 4])
@pytest.mark.parametrize("fit_backend", ["fused", "kernels"])
def test_grouping_packs_windows_into_shared_launches(monkeypatch, fit_backend, rep_bucket):
    """Grouping's representatives go to one fit launch a packing group (on
    the fused backend through K2's ``row_indices`` route), as many as the
    packing predicts; the batch's bits still equal ``run_window``'s."""
    calls = []
    real = fitting.fit_all_rows

    def counted(backend, values, moments, rows, *a, **kw):
        calls.append((values.shape[0], rows.shape[0]))
        return real(backend, values, moments, rows, *a, **kw)

    windows = _windows([0, 1, 2, 3])
    ex = _executor("grouping", fit_backend, rep_bucket=rep_bucket)
    want = _packing(ex, windows)
    monkeypatch.setattr(fitting, "fit_all_rows", counted)
    got = ex.run_window_batch(windows)
    assert len(calls) == want
    # every launch reads its rows out of the whole batch (4 slices' rows)
    assert all(p == DIMS[0] * DIMS[1] * DIMS[2] for p, _ in calls)
    if rep_bucket == 256:
        assert want == 1  # every window's groups fit one 256-row launch
    else:
        assert want > 1
    one = _executor("grouping", fit_backend, rep_bucket=rep_bucket)
    for w, r in zip(windows, got):
        _bitwise(r, one.run_window(w))


def test_batch_refuses_duplicates_and_takes_empty():
    ex = _executor("baseline")
    assert ex.run_window_batch([]) == []
    w = _windows([0])[0]
    with pytest.raises(ValueError, match="distinct"):
        ex.run_window_batch([w, w])


@pytest.mark.parametrize("method", ["baseline", "grouping"])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_batch_matches_reference(method, batch):
    """The port's batch against ``repro``'s ``run_window_batch`` on the same
    windows: moments 2e-3; type_idx equal wherever the reference's best and
    second-best Eq.-5 errors differ by more than the error tolerance, the
    port's pick within it elsewhere; params and error where types agree."""
    windows = BATCHES[batch]
    src = r_sim.SeismicSimulation(r_sim.SimulationConfig(
        geometry=r_regions.CubeGeometry(*DIMS), num_simulations=OBS))
    ref = rex.StagedExecutor(rex.PDFConfig(window_lines=WINDOW_LINES, method=method),
                             src).run_window_batch([r_regions.Window(*w) for w in windows])
    got = _executor(method).run_window_batch(windows)
    for w, r, t in zip(windows, ref, got):
        assert tuple(r.window) == tuple(t.window)
        v = jnp.asarray(src.load_window(r.window))
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
