"""Port vs reference: the fused fit kernels' plain versions (what the port
runs on the CPU) against ``repro.kernels.fitpdf`` (Pallas in interpret
mode), and the wrappers' input checks. The CUDA kernels themselves are held
against these plain versions on the card in test_torch_kernels_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as rd
from repro.core import fitting as rfit
from repro.data.simulation import SeismicSimulation
from repro.core.regions import Window
from repro.kernels import fitpdf as rfp
from repro_torch import interop
from repro_torch.core import distributions as td
from repro_torch.core import fitting as tfit
from repro_torch.core import pdf_error as tpe
from repro_torch.kernels import fitpdf as tfp
from repro_torch.kernels.fitpdf import kernel as tk

# tests/test_fitpdf_kernel.py's shapes: P and n not multiples of any block.
SHAPES = [(1, 64), (7, 100), (37, 513), (64, 1000), (129, 2048), (5, 1)]
MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)


def _window(shape, seed=0, spread=10.0):
    rng = np.random.default_rng(seed)
    return rng.normal(3000.0, spread, shape).astype(np.float32)


def _seed(*key):
    return hash(key) % 2**31  # tuples of ints hash the same in every process


# Past the bins a block's shared memory holds on the card (K2 takes them in
# chunks there): small P and n, so the reference's interpret-mode one-hots
# stay small.
LARGE_BINS_SHAPES = [(7, 100), (37, 513), (5, 1)]
# The large-L errors are held on windows with a 20 % spread. At
# ``_window``'s 0.3 % the lognormal fit's sigma is ~3e-3, where one ulp of
# log(x) between the packages' log implementations moves a CDF value by up
# to 1.2e-4 (ROADMAP queue 3, not a port fault): over 1,000 bins of a
# (37, 513) window that adds up to 8.3e-4 between the packages, and each is
# 3e-3 from float64 there. At a 5-10 % spread the gamma fit's k falls at
# 100-400, where JAX's float32 gammainc is off (ROADMAP queue 3; the port
# is held to float64 there, test_fit_errors_mid_k_gamma_against_float64).
# At 20 % every type agrees within a tenth of ERR_TOL at L = 1,000 and 4,000.
LARGE_BINS_SPREAD = 600.0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("num_bins", [20, 64])
def test_moments_and_edges_match_reference(shape, num_bins):
    _check_moments_and_edges(shape, num_bins)


@pytest.mark.parametrize("shape", LARGE_BINS_SHAPES)
@pytest.mark.parametrize("num_bins", [1000, 4000])
def test_moments_and_edges_match_reference_large_bins(shape, num_bins):
    _check_moments_and_edges(shape, num_bins)


def _check_moments_and_edges(shape, num_bins):
    v = _window(shape, seed=_seed(shape))
    m_ref, e_ref = rfp.moments_and_edges(jnp.asarray(v), num_bins)
    m_got, e_got = tfp.moments_and_edges(torch.from_numpy(v), num_bins)
    for name, got, want in zip(rd.Moments._fields, m_got, m_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOM_TOL, err_msg=name)
    np.testing.assert_allclose(e_got.numpy(), np.asarray(e_ref), rtol=1e-6, atol=1e-3)
    assert e_got.shape == (shape[0], num_bins + 1)
    m_only = tfp.moments(torch.from_numpy(v), num_bins)
    for a, b in zip(m_only, m_got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("types", [rd.TYPES_4, rd.TYPES_10], ids=["4types", "10types"])
@pytest.mark.parametrize("num_bins", [20, 64])
def test_fit_errors_match_reference(shape, types, num_bins):
    """Plain K2 == the reference kernel on identical moments and params."""
    _check_fit_errors(shape, types, num_bins)


@pytest.mark.parametrize("shape", LARGE_BINS_SHAPES)
@pytest.mark.parametrize("types", [rd.TYPES_4, rd.TYPES_10], ids=["4types", "10types"])
@pytest.mark.parametrize("num_bins", [1000, 4000])
def test_fit_errors_match_reference_large_bins(shape, types, num_bins):
    """Plain K2 == the reference kernel at L past what one block of the
    card's K2 holds at once (windows with a 20 % spread: LARGE_BINS_SPREAD)."""
    _check_fit_errors(shape, types, num_bins, LARGE_BINS_SPREAD)


def _check_fit_errors(shape, types, num_bins, spread=10.0):
    v = _window(shape, seed=_seed(shape, len(types)), spread=spread)
    m = rd.moments_from_values(jnp.asarray(v))
    params = rd.fit_all(types, m)
    want = np.asarray(rfp.fit_errors(jnp.asarray(v), m, params, types, num_bins))
    mt = interop.moments_from_numpy([np.asarray(f) for f in m], "cpu")
    pt = torch.tensor(np.asarray(params))
    got = tfp.fit_errors(torch.from_numpy(v), mt, pt, types, num_bins).numpy()
    assert got.shape == want.shape == (shape[0], len(types))
    np.testing.assert_allclose(got, want, **ERR_TOL, equal_nan=True)
    ref = tfp.fit_errors_ref(torch.from_numpy(v), mt, pt, types, num_bins).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("types,num_bins", [(rd.TYPES_4, 64), (rd.TYPES_10, 20)],
                         ids=["4types_L64", "10types_L20"])
def test_set1_window_matches_reference(types, num_bins):
    """One Set1 seismic window (slice 201, lines 0-25: 6,275 x 1,000, a
    lognormal layer) through both packages' fused path."""
    v = SeismicSimulation().load_window(Window(201, 0, 25))
    assert v.shape == (6275, 1000)
    m_ref, _ = rfp.moments_and_edges(jnp.asarray(v), num_bins)
    mt, _ = tfp.moments_and_edges(torch.from_numpy(v), num_bins)
    for name, got, want in zip(rd.Moments._fields, mt, m_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOM_TOL, err_msg=name)
    params = rd.fit_all(types, m_ref)
    want = np.asarray(rfp.fit_errors(jnp.asarray(v), m_ref, params, types, num_bins))
    mt_ref = interop.moments_from_numpy([np.asarray(f) for f in m_ref], "cpu")
    got = tfp.fit_errors(torch.from_numpy(v), mt_ref, torch.tensor(np.asarray(params)),
                         types, num_bins).numpy()
    np.testing.assert_allclose(got, want, **ERR_TOL, equal_nan=True)
    # Selection on the port's own moments and params agrees with the reference.
    r_sel = rfit.select_best(params, jnp.asarray(want))
    t_params = td.fit_all(types, mt)
    t_sel = tfit.select_best(t_params, tfp.fit_errors(torch.from_numpy(v), mt, t_params,
                                                      types, num_bins))
    np.testing.assert_array_equal(t_sel.type_idx.numpy(), np.asarray(r_sel.type_idx))


def test_fit_errors_mid_k_gamma_against_float64():
    """Rows whose gamma fit lands at 100 < k <= 1e4, where the reference's
    float32 gammainc is off by up to ~3e-4 per CDF value (summed over the
    masses, more): the port's errors are held against its own float64
    evaluation instead."""
    v = np.random.default_rng(9).normal(3000.0, 100.0, (16, 800)).astype(np.float32)
    vt = torch.from_numpy(v)
    m = td.moments_from_values(vt)
    params = td.fit_all(td.TYPES_10, m)
    k = params[:, td.TYPES_10.index("gamma"), 0]
    assert bool(((k > 100) & (k <= 1e4)).all())
    got = tfp.fit_errors(vt, m, params, td.TYPES_10, 64)
    m64 = td.Moments(*(f.double() for f in m))
    want = tk.fit_error_counts_plain(
        vt.double(), m64.vmin, m64.vmax,
        tpe.interval_edges(m64.vmin, m64.vmax, 64), params.double().reshape(16, -1),
        td.TYPES_10, 64)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **ERR_TOL)


def test_degenerate_constant_window():
    """vmin == vmax: the same NaN pattern as the reference (uniform's empty
    support), and the selection is finite and identical."""
    v = np.full((5, 100), 7.0, np.float32)
    m = rd.moments_from_values(jnp.asarray(v))
    params = rd.fit_all(rd.TYPES_10, m)
    want = np.asarray(rfp.fit_errors(jnp.asarray(v), m, params, rd.TYPES_10, 16))
    mt = interop.moments_from_numpy([np.asarray(f) for f in m], "cpu")
    pt = torch.tensor(np.asarray(params))
    got = tfp.fit_errors(torch.from_numpy(v), mt, pt, rd.TYPES_10, 16).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-5, equal_nan=True)
    a = rfit.select_best(params, jnp.asarray(want))
    b = tfit.select_best(pt, torch.from_numpy(got))
    np.testing.assert_array_equal(b.type_idx.numpy(), np.asarray(a.type_idx))
    assert np.isfinite(b.error.numpy()).all()
    stats, edges = tk.moments_edges_stats(torch.from_numpy(v), 16)
    assert (stats[:, 4] == stats[:, 5]).all() and torch.isfinite(edges).all()


def test_select_best_first_minimum_and_nonfinite():
    errs = np.array([[0.2, 0.1, 0.1], [np.nan, np.inf, 0.3], [0.5, 0.5, 0.5]], np.float32)
    params = np.arange(27, dtype=np.float32).reshape(3, 3, 3)
    a = rfit.select_best(jnp.asarray(params), jnp.asarray(errs))
    b = tfit.select_best(torch.from_numpy(params), torch.from_numpy(errs))
    np.testing.assert_array_equal(b.type_idx.numpy(), np.asarray(a.type_idx))
    np.testing.assert_array_equal(b.params.numpy(), np.asarray(a.params))
    np.testing.assert_array_equal(b.error.numpy(), np.asarray(a.error))
    assert b.type_idx.dtype == torch.int32


def assert_types_match(got_t, got_err, want_t, want_errs):
    """type_idx equal wherever the reference's best and second-best Eq.-5
    errors are more than the error tolerance apart; where they are not (a
    tie), the port's pick must be within the tolerance of the best."""
    errs = np.where(np.isfinite(want_errs), want_errs, 1e30)
    srt = np.sort(errs, axis=-1)
    best, gap = srt[:, 0], srt[:, 1] - srt[:, 0]
    clear = gap > ERR_TOL["atol"] + ERR_TOL["rtol"] * best
    np.testing.assert_array_equal(got_t[clear], want_t[clear])
    picked = np.take_along_axis(errs, got_t[:, None].astype(np.int64), axis=-1)[:, 0]
    assert (np.abs(picked - best) <= ERR_TOL["atol"] + ERR_TOL["rtol"] * best).all()
    np.testing.assert_allclose(got_err, best, **ERR_TOL)


@pytest.mark.parametrize("mode", ["fused", "faithful"])
@pytest.mark.parametrize("backend", ["reference", "kernels", "fused"])
def test_fit_backends_match_reference(mode, backend):
    v = _window((23, 300), seed=5)
    rb = rfit.get_fit_backend(backend, 20)
    tb = tfit.get_fit_backend(backend, 20)
    m_ref = rb.moments(jnp.asarray(v))
    mt = tb.moments(torch.from_numpy(v))
    for name, got, want in zip(rd.Moments._fields, mt, m_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOM_TOL, err_msg=name)
    r = rb.fit_all(jnp.asarray(v), m_ref, rd.TYPES_10, 20, mode)
    t = tb.fit_all(torch.from_numpy(v),
                   interop.moments_from_numpy([np.asarray(f) for f in m_ref], "cpu"),
                   rd.TYPES_10, 20, mode)
    want_errs = np.asarray(rfp.fit_errors_ref(
        jnp.asarray(v), m_ref, rd.fit_all(rd.TYPES_10, m_ref), rd.TYPES_10, 20))
    assert_types_match(t.type_idx.numpy(), t.error.numpy(), np.asarray(r.type_idx), want_errs)
    same = t.type_idx.numpy() == np.asarray(r.type_idx)
    np.testing.assert_allclose(t.params.numpy()[same], np.asarray(r.params)[same], rtol=1e-5)


def test_backend_registry():
    assert tfit.FIT_BACKENDS == rfit.FIT_BACKENDS
    for name in ("reference", "kernels", "fused"):
        assert tfit.get_fit_backend(name, 16).name == name
    from repro_torch.kernels import hist, moments

    kernels = tfit.get_fit_backend("kernels", 16)
    assert kernels.moments is moments.moments and kernels.histogram is hist.histogram
    with pytest.raises(ValueError):
        tfit.get_fit_backend("nope", 16)
    with pytest.raises(ValueError):
        tfit.compute_pdf_and_error(torch.zeros(2, 4), td.moments_from_values(torch.ones(2, 4)),
                                   td.TYPES_4, 8, mode="nope")


def _k2_args(p=6, n=40, types=td.TYPES_4, num_bins=8):
    v = torch.from_numpy(_window((p, n), seed=1))
    m = td.moments_from_values(v)
    params = td.fit_all(types, m).reshape(p, -1).contiguous()
    edges = tpe.interval_edges(m.vmin, m.vmax, num_bins)
    return [v, m.vmin, m.vmax, edges, params, types, num_bins]


@pytest.mark.parametrize("change,exc", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    (lambda a: a.__setitem__(0, a[0][:, :, None]), ValueError),
    (lambda a: a.__setitem__(1, a[1][:3]), ValueError),
    (lambda a: a.__setitem__(3, a[3][:, :-1]), ValueError),
    (lambda a: a.__setitem__(4, a[4].t().contiguous().t()), ValueError),
    (lambda a: a.__setitem__(4, a[4].half()), TypeError),
    (lambda a: a.__setitem__(5, ("normal", "pareto", "uniform", "cauchy")), ValueError),
    (lambda a: a.__setitem__(5, ()), ValueError),
    (lambda a: a.__setitem__(0, torch.zeros((6, 0))), ValueError),
], ids=["values_f64", "values_3d", "vmin_shape", "edges_shape", "params_strided",
        "params_f16", "unknown_type", "no_types", "no_observations"])
def test_fit_error_counts_rejects_bad_inputs(change, exc):
    args = _k2_args()
    tk.fit_error_counts(*args)  # the unchanged call is accepted
    change(args)
    with pytest.raises(exc):
        tk.fit_error_counts(*args)


def test_moments_edges_stats_rejects_bad_inputs():
    v = torch.from_numpy(_window((4, 10)))
    stats, edges = tk.moments_edges_stats(v, 8)
    assert stats.shape == (4, tk.NUM_STATS) and edges.shape == (4, 9)
    assert (stats[:, 6:] == 0).all()
    with pytest.raises(TypeError):
        tk.moments_edges_stats(v.double(), 8)
    with pytest.raises(ValueError):
        tk.moments_edges_stats(v[0], 8)
    with pytest.raises(ValueError):
        tk.moments_edges_stats(v, 0)


def test_cpu_path_never_launches():
    k1, k2 = tk.moments_edges_stats.launches, tk.fit_error_counts.launches
    tk.fit_error_counts(*_k2_args())
    tk.moments_edges_stats(torch.from_numpy(_window((4, 10))), 8)
    assert (tk.moments_edges_stats.launches, tk.fit_error_counts.launches) == (k1, k2)
