"""Port vs reference: sampling (§5.4, Algorithm 5).

The samplers, ``predict_types``, ``slice_features_from_moments`` and
``type_percentage_distance`` are numpy with ``default_rng`` in both
packages (the port's classification runs its own ``predict``), so they
match bitwise on the same inputs. ``method='sampling'`` on the small cube
of ``tests/test_torch_ml.py``: the random sampler picks the reference's
points and its types follow the tree-margin rule; the k-means sampler, fed
the reference's moments, picks the reference's points; within the port,
prefetch on and off are bitwise equal.
"""

import numpy as np
import pytest

from repro.core import distributions as rd
from repro.core import executor as rex
from repro.core import ml_predict as rmlp
from repro.core import pipeline as rp
from repro.core import sampling as rsmp
from repro_torch.core import pipeline as tp
from repro_torch.core import regions as t_regions
from repro_torch.core import sampling as tsmp

from test_torch_ml import (
    MOM_TOL, SLICES, WINDOW_LINES, _carry, _port_source, _ref_source, assert_margin_rule)


def _population(seed=0):
    """Two (mu, sigma) clusters, their skew/kurt, and a tree on (mu, sigma)
    and one on the scale-invariant features."""
    rng = np.random.default_rng(seed)
    mean = np.concatenate([rng.normal(0, 0.1, 600), rng.normal(5, 0.1, 400)]).astype(np.float32)
    std = np.concatenate([rng.normal(1, 0.02, 600), rng.normal(3, 0.02, 400)]).astype(np.float32)
    skew = rng.normal(0, 1, 1000).astype(np.float32)
    kurt = rng.normal(0, 2, 1000).astype(np.float32)
    mean[::7] = mean[0]  # exact duplicates for the grouping-first path
    std[::7] = std[0]
    labels = np.concatenate([np.zeros(600, np.int32), np.ones(400, np.int32)])
    labels[skew > 1.5] = 2
    tree2 = rmlp.train_tree(np.stack([mean, std], 1), labels, 4, depth=2, max_bins=16)
    tree3 = rmlp.train_tree(rex.tree_features_np(mean, std, skew, kurt), labels, 4, depth=4,
                            max_bins=32)
    return mean, std, skew, kurt, tree2, tree3


@pytest.mark.parametrize("num_points,rate,seed", [
    (1000, 0.1, 1), (6275, 0.1, 7), (25, 0.1, 3), (251, 0.01, 0), (10, 1.0, 2), (3, 0.05, 9)])
def test_sample_indices_random_bitwise(num_points, rate, seed):
    want = rsmp.sample_indices_random(num_points, rate, seed=seed)
    got = tsmp.sample_indices_random(num_points, rate, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("scratch", [1 << 22, 64, 7])
def test_assign_chunked_bitwise(scratch):
    rng = np.random.default_rng(scratch)
    feats = rng.normal(size=(300, 2))
    centers = feats[rng.choice(300, 17, replace=False)]
    for got, want in zip(tsmp._assign_chunked(feats, centers, scratch),
                         rsmp._assign_chunked(feats, centers, scratch)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate,iters,seed", [(0.02, 5, 0), (0.1, 10, 3), (0.5, 1, 1)])
def test_sample_indices_kmeans_bitwise(rate, iters, seed):
    mean, std, *_ = _population()
    feats = np.stack([mean, std], 1)
    np.testing.assert_array_equal(tsmp.sample_indices_kmeans(feats, rate, iters, seed),
                                  rsmp.sample_indices_kmeans(feats, rate, iters, seed))


@pytest.mark.parametrize("group_first", [True, False])
@pytest.mark.parametrize("features", ["mean_std", "scale_invariant", "no_kurt"])
def test_predict_types_bitwise(group_first, features):
    mean, std, skew, kurt, tree2, tree3 = _population()
    tree = tree2 if features == "mean_std" else tree3
    kw = dict(group_first=group_first, group_tol=1e-3)
    if features != "mean_std":
        kw["skew"] = skew
        kw["kurt"] = kurt if features == "scale_invariant" else None
    want = rsmp.predict_types(mean, std, tree, **kw)
    got = tsmp.predict_types(mean, std, _carry(tree), **kw)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.shape == (len(mean),)


@pytest.mark.parametrize("group_first", [True, False])
def test_slice_features_and_distance_bitwise(group_first):
    mean, std, skew, kurt, _, tree = _population()
    idx = rsmp.sample_indices_random(len(mean), 0.1, seed=5)
    want = rsmp.slice_features_from_moments(mean[idx], std[idx], tree, rd.TYPES_4,
                                            group_first=group_first, skew=skew[idx],
                                            kurt=kurt[idx])
    got = tsmp.slice_features_from_moments(mean[idx], std[idx], _carry(tree), rd.TYPES_4,
                                           group_first=group_first, skew=skew[idx],
                                           kurt=kurt[idx])
    assert (got.avg_mean, got.avg_std, got.num_sampled) == \
        (want.avg_mean, want.avg_std, want.num_sampled)
    np.testing.assert_array_equal(got.type_percentage, want.type_percentage)
    full = rsmp.slice_features_from_moments(mean, std, tree, rd.TYPES_4, skew=skew, kurt=kurt)
    assert tsmp.type_percentage_distance(got.type_percentage, full.type_percentage) == \
        rsmp.type_percentage_distance(want.type_percentage, full.type_percentage)


# -- method='sampling' through PDFComputer ----------------------------------------


@pytest.fixture(scope="module")
def cube_tree():
    return rp.train_type_tree(_ref_source(), window_lines=WINDOW_LINES)


def _ref_run(tree, sampler, frac=0.1):
    cfg = rp.PDFConfig(window_lines=WINDOW_LINES, method="sampling", sampler=sampler,
                       sample_frac=frac)
    return rp.PDFComputer(cfg, _ref_source(), tree=tree).run(SLICES)


def _port(tree, sampler, fit_backend="fused", frac=0.1, **kw):
    cfg = tp.PDFConfig(window_lines=WINDOW_LINES, method="sampling", sampler=sampler,
                       sample_frac=frac, fit_backend=fit_backend)
    return tp.PDFComputer(cfg, _port_source(), tree=_carry(tree), device="cpu", **kw)


def _assert_sampled_layout(res, frac, ppl):
    """Unsampled points: type -1, zero params, error and moments; each
    window classifies max(1, round(frac * P_w)) points."""
    off = res.type_idx < 0
    assert (res.type_idx[off] == -1).all()
    assert not res.params[off].any() and not res.error.any()
    for w in res.stats:
        p = (w.window.line_end - w.window.line_start) * ppl
        assert w.num_fitted == max(1, round(frac * p)) and w.cache_hits == 0
    assert int((~off).sum()) == sum(w.num_fitted for w in res.stats)
    return off


@pytest.mark.parametrize("fit_backend", ["fused", "kernels", "reference"])
def test_random_sampling_matches_reference(cube_tree, fit_backend):
    ref = _ref_run(cube_tree, "random")
    got = _port(cube_tree, "random", fit_backend).run(SLICES)
    ppl = _port_source().geometry.points_per_line
    for s in SLICES:
        off = _assert_sampled_layout(got[s], 0.1, ppl)
        np.testing.assert_array_equal(off, ref[s].type_idx < 0)  # the same points
        for name in ("mean", "std", "skew", "kurt"):
            assert not getattr(got[s], name)[off].any()  # moments only where sampled
        assert_margin_rule(cube_tree, ref[s], got[s])
        assert [w.num_fitted for w in got[s].stats] == [w.num_fitted for w in ref[s].stats]
        want_f, got_f = ref[s].features(rd.TYPES_4), got[s].features(rd.TYPES_4)
        assert got_f.num_sampled == want_f.num_sampled
        np.testing.assert_allclose(got_f.avg_mean, want_f.avg_mean, **MOM_TOL)


def test_kmeans_fed_reference_moments_picks_reference_points(cube_tree):
    """The port's k-means sampler with the executor's per-window seed, fed
    each window's (mean, std) from the reference run, picks the reference's
    points; the port's own k-means run classifies one point a cluster."""
    ref = _ref_run(cube_tree, "kmeans")
    comp = _port(cube_tree, "kmeans")
    cfg, ex = comp.config, comp.executor
    src = _port_source()
    ppl = src.geometry.points_per_line
    for s in SLICES:
        r = ref[s]
        for w in t_regions.iter_windows(src.geometry, s, WINDOW_LINES):
            lo, hi = w.line_start * ppl, w.line_end * ppl
            idx = tsmp.sample_indices_kmeans(np.stack([r.mean[lo:hi], r.std[lo:hi]], axis=-1),
                                             cfg.sample_frac, iters=cfg.kmeans_iters,
                                             seed=ex._sample_seed(w))
            np.testing.assert_array_equal(np.flatnonzero(r.type_idx[lo:hi] >= 0), idx)
    got = comp.run(SLICES)
    for s in SLICES:
        off = got[s].type_idx < 0
        assert not got[s].params[off].any() and not got[s].error.any()
        assert sum(w.num_fitted for w in got[s].stats) == int((~off).sum())
        assert all(1 <= w.num_fitted <= max(1, round(0.1 * w.num_points)) for w in got[s].stats)


@pytest.mark.parametrize("sampler", ["random", "kmeans"])
def test_sampling_prefetch_on_off_bitwise(cube_tree, sampler):
    a = _port(cube_tree, sampler, exec_config=tp.ExecutorConfig(prefetch=False,
                                                                 async_persist=False))
    b = _port(cube_tree, sampler, exec_config=tp.ExecutorConfig(prefetch=True, prefetch_depth=3))
    ra, rb = a.run(SLICES), b.run(SLICES)
    for s in SLICES:
        for f in ("type_idx", "params", "error", "mean", "std", "skew", "kurt"):
            np.testing.assert_array_equal(getattr(ra[s], f), getattr(rb[s], f), err_msg=f)
        assert [w.num_fitted for w in ra[s].stats] == [w.num_fitted for w in rb[s].stats]


def test_sampling_order_free_and_resumable(cube_tree, tmp_path):
    """The draw is seeded from (sample_seed, slice, line): one slice alone,
    after a crash and resume, equals the same slice inside a 4-slice run."""
    whole = _port(cube_tree, "random").run(SLICES)[2]
    first = _port(cube_tree, "random", out_dir=tmp_path).run_slice(2)
    (tmp_path / "slice2_window_00010.npz").unlink()
    (tmp_path / "slice2_watermark.json").write_text('{"next_line": 10}')
    again = _port(cube_tree, "random", out_dir=tmp_path).run_slice(2, resume=True)
    assert [w.window.line_start for w in again.stats] == [10]
    for f in ("type_idx", "mean", "std", "skew", "kurt"):
        np.testing.assert_array_equal(getattr(first, f), getattr(whole, f), err_msg=f)
        np.testing.assert_array_equal(getattr(again, f), getattr(whole, f), err_msg=f)
    ex = _port(cube_tree, "random").executor
    w2, w3 = t_regions.Window(2, 0, WINDOW_LINES), t_regions.Window(3, 0, WINDOW_LINES)
    assert ex._sample_seed(w2) != ex._sample_seed(w3)  # the seed mixes in the slice
    assert not np.array_equal(ex._draw_sample(150, w2), ex._draw_sample(150, w3))
