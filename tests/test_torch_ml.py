"""Port vs reference: ML prediction (§5.3) — the tree, Algorithm 4 and the
``ml``, ``grouping_ml`` and ``reuse_ml`` methods.

The tree's code (descent, CART training, grid search, features) matches
``repro.core.ml_predict`` bitwise on the same inputs. The fitting functions
match ``repro.core.fitting`` under the parity rules. Whole slices of the
small cube of ``tests/test_torch_pipeline.py`` go through both packages'
``PDFComputer`` with one tree, trained by the reference and carried over
with ``interop.tree_from_numpy``, under the tree-margin rule below; within
the port, host and device Select, prefetch on and off, and persist + resume
are bitwise equal.

Tree-margin rule. The two packages' moments differ within ``MOM_TOL``, so
their features are not bitwise equal and a point whose feature lies at a
split threshold may take the other branch. A point is *decided* when, at
every node of the reference's descent path, its feature lies further from
the threshold than the feature's tolerance (``ml_predict.feature_tolerance``:
cv = std / |mean| carries the relative errors of both, skew and kurt
``MOM_TOL`` itself; ``ml_predict.reachable_leaves``). Decided
points must have the same type, params within ``MOM_TOL`` and errors within
``ERR_TOL``; every point's type must be the label of a leaf it can reach
with its features moved within their tolerances.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import distributions as rd
from repro.core import executor as rex
from repro.core import fitting as rfit
from repro.core import ml_predict as rmlp
from repro.core import pipeline as rp
from repro.core import regions as r_regions
from repro.data import simulation as r_sim
from repro.kernels import fitpdf as rfp
from repro_torch import interop
from repro_torch.core import distributions as td
from repro_torch.core import executor as tex
from repro_torch.core import fitting as tfit
from repro_torch.core import ml_predict as tmlp
from repro_torch.core import pipeline as tp
from repro_torch.core import regions as t_regions
from repro_torch.data import simulation as t_sim

DIMS, OBS, WINDOW_LINES = (4, 12, 30), 200, 5
SLICES = (0, 1, 2, 3)
MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)
FIELDS = ("type_idx", "params", "error", "mean", "std", "skew", "kurt")
ML_METHODS = ("ml", "grouping_ml", "reuse_ml")
# Share of the cube's points that must be decided under the margin rule.
# Every point of a cube slice has the same cv (the generator scales one
# draw per layer), and the CART thresholds are quantiles of those cvs: the
# tree trained on the cube splits at slice 1's cv and 5.4e-4 from slice
# 3's, within their cv tolerance (2.4e-3, 1.2e-3), so slices 0 and 2 are
# decided and slices 1 and 3 are not.
MIN_DECIDED = 0.5
# The port's train_type_tree, scored on the reference's training data, may
# misclassify at most this share more than the reference's own tree. Its
# thresholds are quantiles of the port's features, so one can sit on a
# slice's common cv, an ulp from the reference's: on this cube that sends
# 40 of the 1,440 training points (2.8 %) the other way.
TREE_ERROR_MARGIN = 0.05


def _ref_source():
    return r_sim.SeismicSimulation(r_sim.SimulationConfig(
        geometry=r_regions.CubeGeometry(*DIMS), num_simulations=OBS))


def _port_source():
    return t_sim.SeismicSimulation(t_sim.SimulationConfig(
        geometry=t_regions.CubeGeometry(*DIMS), num_simulations=OBS))


def _carry(tree: rmlp.DecisionTree) -> tmlp.DecisionTree:
    return interop.tree_from_numpy(tree.depth, tree.feature, tree.threshold, tree.leaf_label)


def _ref_predict(tree, x):
    return np.asarray(rmlp.predict(tree.as_device(), jnp.asarray(x)))


def _port_predict(tree, x):
    return tmlp.predict(tree.as_device("cpu"), torch.from_numpy(x)).numpy()


def _bitwise(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.avg_error == b.avg_error


def assert_margin_rule(tree, ref, got):
    """The tree-margin rule for one slice (reference ``ref``, port ``got``)
    over the classified points (all of them but sampling's unsampled ones,
    ``type_idx == -1`` on both sides): decided points have the reference's
    type; every point's type is the label of a leaf it may reach; where the
    types agree, params and errors agree. Returns the number of decided
    points."""
    for name in ("mean", "std", "skew", "kurt"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), **MOM_TOL, err_msg=name)
    cls = ref.type_idx >= 0
    np.testing.assert_array_equal(got.type_idx >= 0, cls)
    feats = rex.tree_features_np(ref.mean, ref.std, ref.skew, ref.kurt)[cls]
    tol = tmlp.feature_tolerance(ref.mean[cls], ref.std[cls], ref.skew[cls], ref.kurt[cls],
                                 **MOM_TOL)
    reach = tmlp.reachable_leaves(tree, feats, tol)
    ok = reach.sum(1) == 1
    got_t, ref_t = got.type_idx[cls], ref.type_idx[cls]
    np.testing.assert_array_equal(got_t[ok], ref_t[ok])
    assert (reach & (tree.leaf_label[None, :] == got_t[:, None])).any(1).all()
    same = got.type_idx == ref.type_idx
    np.testing.assert_allclose(got.params[same], ref.params[same], **MOM_TOL)
    np.testing.assert_allclose(got.error[same], ref.error[same], **ERR_TOL)
    assert got.type_idx.dtype == np.int32 and got.params.dtype == np.float32
    return int(ok.sum())


# -- the tree ------------------------------------------------------------------


def _labelled(n, num_feat, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, num_feat)).astype(np.float32)
    y = ((x[:, 0] > 0).astype(np.int32) + 2 * (x[:, 1] > 0.3).astype(np.int32)
         + (x[:, -1] > 1.2).astype(np.int32)) % 4
    y[x[:, 0] > 0.8] = 0  # a pure region: deep trees get early leaves there
    return x, y


def _probe_features(tree: rmlp.DecisionTree, n, num_feat, seed):
    """Random features plus rows that sit exactly at each finite threshold
    (on its feature), rows with NaN and inf features."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, num_feat)).astype(np.float32)
    finite = np.flatnonzero(np.isfinite(tree.threshold))
    at = x[: len(finite)].copy()
    at[np.arange(len(finite)), tree.feature[finite]] = tree.threshold[finite]
    odd = x[:6].copy()
    odd[0, 0] = odd[1, -1] = np.nan
    odd[2] = np.nan
    odd[3, 0], odd[4, 0], odd[5, -1] = np.inf, -np.inf, np.inf
    return np.concatenate([x, at, odd])


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6])
def test_predict_matches_reference_bitwise(depth):
    """The descent on the same features and the same tree (early leaves with
    inf thresholds included): at thresholds, NaN and inf features too."""
    x, y = _labelled(500, 3, seed=depth)
    tree = rmlp.train_tree(x, y, 4, depth=depth, max_bins=16)
    if depth >= 4:
        assert np.isinf(tree.threshold).any()  # an early leaf
    probe = _probe_features(tree, 300, 3, seed=10 + depth)
    want = _ref_predict(tree, probe)
    got = _port_predict(_carry(tree), probe)
    np.testing.assert_array_equal(got, want)
    # batched leading shape, as the reference broadcasts
    batched = torch.from_numpy(probe[:300].reshape(100, 3, 3))
    got2 = tmlp.predict(_carry(tree).as_device("cpu"), batched)
    np.testing.assert_array_equal(got2.numpy().reshape(-1), want[:300])


@pytest.mark.parametrize("depth,max_bins,num_feat,seed", [
    (1, 64, 2, 0), (3, 16, 2, 1), (4, 32, 3, 2), (6, 8, 3, 3)])
def test_train_tree_matches_reference_bitwise(depth, max_bins, num_feat, seed):
    x, y = _labelled(400, num_feat, seed)
    want = rmlp.train_tree(x, y, 4, depth=depth, max_bins=max_bins)
    got = tmlp.train_tree(x, y, 4, depth=depth, max_bins=max_bins)
    assert got.depth == want.depth
    for f in ("feature", "threshold", "leaf_label"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype
    assert tmlp.model_error(got, x, y) == rmlp.model_error(want, x, y)
    # model_error predicts in float32 whatever the features' dtype
    assert tmlp.model_error(got, x.astype(np.float64), y) == \
        rmlp.model_error(want, x.astype(np.float64), y)


def test_single_class_tree_matches_reference():
    x = np.random.default_rng(0).normal(size=(50, 2)).astype(np.float32)
    y = np.full(50, 2, np.int32)
    want, got = rmlp.train_tree(x, y, 4, depth=3), tmlp.train_tree(x, y, 4, depth=3)
    for f in ("feature", "threshold", "leaf_label"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert tmlp.model_error(got, x, y) == 0.0


def test_tune_hyperparameters_matches_reference():
    x, y = _labelled(300, 3, seed=5)
    kw = dict(depths=(1, 2, 3), bins=(8, 16), seed=4)
    assert tmlp.tune_hyperparameters(x, y, 4, **kw) == rmlp.tune_hyperparameters(x, y, 4, **kw)


def test_tree_features_match_reference_bitwise():
    """Device and host features on the same moments (the reference's, of a
    cube window, with a zero mean and a constant row planted)."""
    src = _ref_source()
    v = src.load_window(r_regions.Window(1, 0, WINDOW_LINES))
    v[3] = 0.0  # mean 0: cv's 1e-12 floor
    v[4] = 7.0  # var 0
    m = rfp.moments(jnp.asarray(v), 64)
    fields = [np.asarray(f) for f in m]
    want = np.asarray(rex.tree_features(m))
    got = tex.tree_features(interop.moments_from_numpy(fields, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (len(v), 3)
    std = np.sqrt(np.maximum(fields[1], 0))
    np.testing.assert_array_equal(tex.tree_features_np(fields[0], std, fields[2], fields[3]),
                                  rex.tree_features_np(fields[0], std, fields[2], fields[3]))
    assert tex.TREE_FEATURES == rex.TREE_FEATURES


def test_tree_from_numpy_predicts_as_reference():
    x, y = _labelled(300, 3, seed=7)
    tree = rmlp.train_tree(x, y, 4, depth=4, max_bins=32)
    carried = interop.tree_from_numpy(tree.depth, tree.feature.tolist(), tree.threshold,
                                      tree.leaf_label)
    assert carried.feature.dtype == np.int32 and carried.threshold.dtype == np.float32
    feat, thr, leaf = carried.as_device("cpu")
    assert (feat.dtype, thr.dtype, leaf.dtype) == (torch.int64, torch.float32, torch.int64)
    probe = _probe_features(tree, 200, 3, seed=8)
    np.testing.assert_array_equal(_port_predict(carried, probe), _ref_predict(tree, probe))
    with pytest.raises(ValueError, match="depth"):
        interop.tree_from_numpy(3, tree.feature, tree.threshold, tree.leaf_label)
    with pytest.raises(ValueError, match="depth"):
        interop.tree_from_numpy(0, [], [], [0])


def test_reachable_leaves_and_feature_tolerance():
    """A depth-2 tree (x0 <= 0 | x1 <= 1 on the left, an early leaf on the
    right): far from the thresholds a point reaches one leaf, within its
    tolerance of one both of that node's subtrees."""
    tree = tmlp.DecisionTree(2, np.array([0, 1, 0], np.int32),
                             np.array([0.0, 1.0, np.inf], np.float32),
                             np.array([0, 1, 2, 2], np.int32))
    feats = np.array([[-1.0, 0.0], [-1.0, 1.05], [0.05, 5.0], [-0.05, 1.0], [np.nan, 0.0]])
    reach = tmlp.reachable_leaves(tree, feats, np.full((5, 2), 0.1))
    np.testing.assert_array_equal(reach, [[1, 0, 0, 0], [1, 1, 0, 0], [0, 1, 1, 0],
                                          [1, 1, 1, 0], [0, 0, 0, 1]])  # NaN goes right
    np.testing.assert_array_equal(_port_predict(tree, feats.astype(np.float32)), [0, 1, 2, 0, 2])
    tol = tmlp.feature_tolerance(np.array([100.0, 0.0]), np.array([30.0, 1.0]),
                                 np.array([0.5, 0.0]), np.array([-1.0, 0.0]), rtol=1e-3, atol=1e-2)
    r_s, r_m = 1e-3 + 1e-2 / 30, 1e-3 + 1e-2 / 100
    np.testing.assert_allclose(tol[0], [0.3 * (r_s + r_m) / (1 - r_m), 1e-2 + 5e-4, 1e-2 + 1e-3])
    assert np.isinf(tol[1, 0])  # a zero mean: cv may move anywhere


# -- Algorithm 4 -----------------------------------------------------------------


@pytest.fixture(scope="module")
def window_inputs():
    """A cube window (two slices' first lines), the reference's moments and
    a tree-independent predicted type per row."""
    src = _ref_source()
    v = np.concatenate([src.load_window(r_regions.Window(s, 0, 2)) for s in SLICES])
    m = rfp.moments(jnp.asarray(v), 64)
    return v, [np.asarray(f) for f in m]


def test_select_predicted_matches_reference():
    rng = np.random.default_rng(0)
    params = rng.normal(size=(40, 10, 3)).astype(np.float32)
    errs = rng.uniform(size=(40, 10)).astype(np.float32)
    errs[3, :] = np.inf
    errs[4, :] = np.nan
    errs[5, 2] = -np.inf
    pred = rng.integers(0, 10, 40).astype(np.int32)
    pred[3:6] = 2
    want = rfit.select_predicted(jnp.asarray(params), jnp.asarray(errs), jnp.asarray(pred))
    got = tfit.select_predicted(torch.from_numpy(params), torch.from_numpy(errs),
                                torch.from_numpy(pred).long())
    for f in ("type_idx", "params", "error"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert got.type_idx.dtype == torch.int32
    assert (got.error[3:6] == 1e30).all()  # non-finite errors, as the reference has them


@pytest.mark.parametrize("types", [td.TYPES_4, td.TYPES_10], ids=["4types", "10types"])
@pytest.mark.parametrize("num_bins", [20, 64])
def test_compute_pdf_with_predicted_type_matches_reference(window_inputs, types, num_bins):
    v, fields = window_inputs
    pred = np.random.default_rng(num_bins).integers(0, len(types), len(v)).astype(np.int32)
    want = rfit.compute_pdf_with_predicted_type(
        jnp.asarray(v), rd.Moments(*map(jnp.asarray, fields)), jnp.asarray(pred), types, num_bins)
    got = tfit.compute_pdf_with_predicted_type(
        torch.from_numpy(v), interop.moments_from_numpy(fields, "cpu"), torch.from_numpy(pred),
        types, num_bins)
    np.testing.assert_array_equal(got.type_idx.numpy(), pred)
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), **MOM_TOL)
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error), **ERR_TOL)


@pytest.mark.parametrize("backend", ["reference", "kernels", "fused"])
@pytest.mark.parametrize("types,num_bins", [(td.TYPES_4, 64), (td.TYPES_10, 20)],
                         ids=["4types", "10types"])
def test_fit_predicted_matches_reference(window_inputs, backend, types, num_bins):
    """Each backend's Algorithm 4 against the reference's backend of the
    same name on the same values, moments and predicted types."""
    v, fields = window_inputs
    pred = np.random.default_rng(len(types)).integers(0, len(types), len(v)).astype(np.int32)
    want = rfit.get_fit_backend(backend, num_bins).fit_predicted(
        jnp.asarray(v), rd.Moments(*map(jnp.asarray, fields)), jnp.asarray(pred), types, num_bins)
    tb = tfit.get_fit_backend(backend, num_bins)
    got = tb.fit_predicted(torch.from_numpy(v), interop.moments_from_numpy(fields, "cpu"),
                           torch.from_numpy(pred).long(), types, num_bins)
    np.testing.assert_array_equal(got.type_idx.numpy(), np.asarray(want.type_idx))
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), **MOM_TOL)
    np.testing.assert_allclose(got.error.numpy(), np.asarray(want.error), **ERR_TOL)
    # Algorithm 4's error is Algorithm 3's where the latter picks that type.
    allt = tb.fit_all(torch.from_numpy(v), interop.moments_from_numpy(fields, "cpu"), types,
                      num_bins)
    same = allt.type_idx.numpy() == pred
    assert same.any()
    np.testing.assert_array_equal(got.error.numpy()[same], allt.error.numpy()[same])


# -- whole slices ----------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_tree():
    """The reference's train_type_tree on the cube, and its training data."""
    src = _ref_source()
    tree = rp.train_type_tree(src, window_lines=WINDOW_LINES)
    feats, labels = [], []
    for s in SLICES:
        res = rp.PDFComputer(rp.PDFConfig(window_lines=WINDOW_LINES), src).run_slice(s)
        feats.append(rex.tree_features_np(res.mean, res.std, res.skew, res.kurt))
        labels.append(res.type_idx)
    return tree, np.concatenate(feats), np.concatenate(labels)


@pytest.fixture(scope="module")
def ml_reference(ref_tree):
    """The reference's three ML methods over the cube (host Select, its
    default fused backend)."""
    src = _ref_source()
    return {m: rp.PDFComputer(rp.PDFConfig(window_lines=WINDOW_LINES, method=m), src,
                              tree=ref_tree[0]).run(SLICES)
            for m in ML_METHODS}


def _port(method, tree, fit_backend="fused", select_backend="host", **kw):
    cfg = tp.PDFConfig(window_lines=WINDOW_LINES, method=method, fit_backend=fit_backend,
                       select_backend=select_backend)
    return tp.PDFComputer(cfg, _port_source(), tree=tree, device="cpu", **kw)


@pytest.mark.parametrize("fit_backend", ["fused", "kernels", "reference"])
@pytest.mark.parametrize("method", ML_METHODS)
def test_ml_slices_match_reference(ref_tree, ml_reference, method, fit_backend):
    tree = ref_tree[0]
    got = _port(method, _carry(tree), fit_backend).run(SLICES)
    ref = ml_reference[method]
    n_decided = 0
    for s in SLICES:
        n_decided += assert_margin_rule(tree, ref[s], got[s])
        assert [(w.num_fitted, w.cache_hits) for w in got[s].stats] == \
            [(w.num_fitted, w.cache_hits) for w in ref[s].stats]
        assert abs(got[s].avg_error - ref[s].avg_error) <= ERR_TOL["atol"]
        assert [tuple(w.window) for w in got[s].stats] == [tuple(w.window) for w in ref[s].stats]
    assert n_decided >= MIN_DECIDED * sum(len(got[s].type_idx) for s in SLICES)
    if method == "reuse_ml":
        assert sum(w.cache_hits for s in SLICES for w in got[s].stats) > 0
    if method == "grouping_ml":
        grouping = tp.PDFComputer(tp.PDFConfig(window_lines=WINDOW_LINES, method="grouping",
                                               fit_backend=fit_backend),
                                  _port_source(), device="cpu").run(SLICES)
        for s in SLICES:
            assert [w.num_fitted for w in got[s].stats] == [w.num_fitted for w in grouping[s].stats]


@pytest.mark.parametrize("fit_backend", ["fused", "kernels", "reference"])
@pytest.mark.parametrize("method", ["grouping_ml", "reuse_ml"])
def test_ml_device_select_bitwise_matches_host(ref_tree, method, fit_backend):
    tree = _carry(ref_tree[0])
    host = _port(method, tree, fit_backend).run(SLICES)
    device = _port(method, tree, fit_backend, select_backend="device").run(SLICES)
    for s in SLICES:
        _bitwise(host[s], device[s])
        assert [(w.num_fitted, w.cache_hits) for w in host[s].stats] == \
            [(w.num_fitted, w.cache_hits) for w in device[s].stats]


@pytest.mark.parametrize("method", ML_METHODS)
def test_ml_prefetch_on_off_bitwise(ref_tree, method):
    tree = _carry(ref_tree[0])
    a = _port(method, tree, exec_config=tp.ExecutorConfig(prefetch=False, async_persist=False))
    b = _port(method, tree, exec_config=tp.ExecutorConfig(prefetch=True, prefetch_depth=3))
    ra, rb = a.run(SLICES), b.run(SLICES)
    for s in SLICES:
        _bitwise(ra[s], rb[s])
        assert [w.cache_hits for w in ra[s].stats] == [w.cache_hits for w in rb[s].stats]


def test_ml_persist_and_resume(ref_tree, tmp_path):
    tree = _carry(ref_tree[0])
    first = _port("grouping_ml", tree, out_dir=tmp_path).run_slice(2)
    (tmp_path / "slice2_watermark.json").write_text(json.dumps({"next_line": 5}))
    for f in sorted(tmp_path.glob("slice2_window_*.npz"))[1:]:
        f.unlink()
    comp = _port("grouping_ml", tree, out_dir=tmp_path,
                 exec_config=tp.ExecutorConfig(async_persist=False))
    again = comp.run_slice(2, resume=True)
    assert [w.window.line_start for w in again.stats] == [5, 10]
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(again, f), getattr(first, f), err_msg=f)
    assert comp.executor.watermark(2) == 12


def test_train_type_tree_close_to_reference(ref_tree):
    """The port's train_type_tree (its own baseline on the CPU, its own
    trainer) scored on the reference's features and labels: within
    TREE_ERROR_MARGIN of the reference tree's model error there."""
    tree, x, y = ref_tree
    port_tree = tp.train_type_tree(_port_source(), window_lines=WINDOW_LINES, device="cpu")
    assert port_tree.depth == 4 and port_tree.leaf_label.shape == (16,)
    ref_err = rmlp.model_error(tree, x, y)
    assert tmlp.model_error(port_tree, x, y) <= ref_err + TREE_ERROR_MARGIN
    # The same trainer on the same data gives the same tree.
    same = tmlp.train_tree(x, y, 4, depth=4, max_bins=32)
    for f in ("feature", "threshold", "leaf_label"):
        np.testing.assert_array_equal(getattr(same, f), getattr(tree, f))


def test_slice_features_match_reference(ref_tree, ml_reference):
    """``SliceResult.features`` aggregates as the reference's on the same
    arrays (here the reference's own ml result)."""
    r = ml_reference["ml"][1]
    port = tex.SliceResult(r.type_idx, r.params, r.error, r.mean, r.std, r.skew, r.kurt,
                           r.avg_error)
    want, got = r.features(td.TYPES_4), port.features(td.TYPES_4)
    assert (got.avg_mean, got.avg_std, got.num_sampled) == \
        (want.avg_mean, want.avg_std, want.num_sampled)
    np.testing.assert_array_equal(got.type_percentage, want.type_percentage)
