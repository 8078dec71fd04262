"""Port vs reference: distributions (fitters, CDFs, special functions) and
the Eq.-5 pieces of pdf_error.

Inputs are made with numpy from a seed and handed to both packages; the
port's Moments are the reference's, carried over with ``interop``, so each
fitter and CDF is compared on identical inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from jax.scipy import special as jsp

from repro.core import distributions as rd
from repro.core import pdf_error as rpe
from repro_torch import interop
from repro_torch.core import distributions as td
from repro_torch.core import pdf_error as tpe

N_OBS = 500
BISECTION_STEP = (50.0 - 0.2) / 2**20  # fit_weibull's final bracket width


def _values(seed=0, reps=3):
    """Rows from every family the fitters meet, incl. the seismic layers'
    (normal, lognormal, exponential, uniform) and narrow normals whose gamma
    fit has k ~ 1e5 (Wilson-Hilferty) or k ~ 900 (exact branch, k > 100)."""
    rng = np.random.default_rng(seed)
    n = N_OBS
    rows = []
    for _ in range(reps):
        rows += [
            rng.normal(3000, 900, n), np.exp(rng.normal(8, 0.5, n)), rng.exponential(3000, n),
            rng.uniform(1500, 4500, n), rng.gamma(2.0, 1000, n), rng.normal(3000, 10, n),
            3000 + 300 * rng.standard_t(6, n), rng.geometric(0.2, n) - 1.0,
            3000 * rng.weibull(1.5, n), rng.normal(3000, 100, n), rng.normal(0.0, 1.0, n),
        ]
    return np.asarray(rows, np.float32)


def _moments(v):
    mj = rd.moments_from_values(jnp.asarray(v))
    return mj, interop.moments_from_numpy([np.asarray(f) for f in mj], "cpu")


def test_moments_from_values_matches_reference():
    v = _values()
    mj = rd.moments_from_values(jnp.asarray(v))
    mt = td.moments_from_values(torch.from_numpy(v))
    for name, a, b in zip(rd.Moments._fields, mj, mt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-3, atol=2e-3, err_msg=name)
    np.testing.assert_array_equal(mt.vmin.numpy(), np.asarray(mj.vmin))
    np.testing.assert_array_equal(mt.vmax.numpy(), np.asarray(mj.vmax))
    np.testing.assert_allclose(mt.std.numpy(), np.asarray(mj.std), rtol=1e-6)


@pytest.mark.parametrize("name", rd.TYPES_10)
def test_fitter_matches_reference(name):
    mj, mt = _moments(_values(seed=1))
    want = np.asarray(rd._FITTERS[name](mj))
    got = td._FITTERS[name](mt).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name != "weibull":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        return
    # Weibull's k is a 20-step bisection on float32 lgamma; two lgamma
    # implementations can take a different branch once CV^2(k) is within
    # their rounding of the target. At k <= 10 that happens only in the last
    # steps (the bracket resolution); at k ~ 38 float32 CV^2 itself resolves
    # k only to ~5e-4 relative (measured 4.5e-4 between the two packages).
    k = want[:, 0]
    small = k <= 10
    np.testing.assert_allclose(got[small, 0], k[small], rtol=1e-4, atol=2 * BISECTION_STEP)
    np.testing.assert_allclose(got[~small, 0], k[~small], rtol=1e-3)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4)


def test_fit_all_stacks_types():
    mj, mt = _moments(_values(seed=2, reps=1))
    got = td.fit_all(td.TYPES_10, mt)
    assert got.shape == (len(mt.mean), 10, 3)
    for i, name in enumerate(td.TYPES_10):
        torch.testing.assert_close(got[:, i], td._FITTERS[name](mt), rtol=0, atol=0)
    assert td.TYPES_4 == rd.TYPES_4 and td.TYPES_10 == rd.TYPES_10


def _cdf_inputs(seed=3, num_bins=64):
    """Reference params of every type, at the Eq.-5 edges, shifted far below
    the support, and at 0."""
    mj, _ = _moments(_values(seed=seed))
    params = np.array(rd.fit_all(rd.TYPES_10, mj))
    edges = np.array(rpe.interval_edges(mj.vmin, mj.vmax, num_bins))
    x = np.concatenate([edges, edges - 5000.0, np.zeros((len(edges), 1), np.float32)], axis=1)
    return params, x


def _both_cdfs(name, params, x, i):
    want = np.asarray(rd.cdf(name, jnp.asarray(params[:, i, None, :]), jnp.asarray(x)))
    got = td.cdf(name, torch.from_numpy(params[:, i, None, :]), torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("name", [t for t in rd.TYPES_10 if t not in ("gamma", "lognormal")])
def test_cdf_matches_reference(name):
    params, x = _cdf_inputs()
    got, want = _both_cdfs(name, params, x, rd.TYPES_10.index(name))
    assert got.dtype == np.float32
    # student_t: the reference's float32 betainc is off by up to ~1.2e-5
    # (the port's runs in float64); the others agree to a few ulps.
    atol = 2e-5 if name == "student_t" else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=True)


def test_cdf_lognormal_matches_reference():
    params, x = _cdf_inputs()
    i = rd.TYPES_10.index("lognormal")
    got, want = _both_cdfs("lognormal", params, x, i)
    # One float32 ulp of log(x) near log(3000) ~ 8 is ~1e-6; the CDF moves
    # by that over sigma, so rows fitted with a tiny sigma (~3e-3, the narrow
    # normals) differ by up to ~1.2e-4 (measured) between two log
    # implementations. Everywhere else the difference is ~1e-6.
    sigma = params[:, i, 1:2]
    atol = np.maximum(1e-5, 1e-6 / sigma)
    assert (np.abs(got - want) <= atol).all()


@pytest.mark.parametrize("regime", ["k<=100", "100<k<=1e4", "k>1e4"])
def test_cdf_gamma(regime):
    """The reference's float32 gammainc is inaccurate at large shape (vs
    float64: 2e-6 at k=11, 1.8e-5 at k=120, 2e-4 at k=2,000, 4.6e-3 at
    k=9,999; here up to 3.6e-5 at k <= 100 and 2.9e-4 at k ~ 900), while
    torch's agrees with float64 at every k. So above k = 100 the port is held
    against float64 instead of the reference; above k = 1e4 both switch to
    the same Wilson-Hilferty formula."""
    params, x = _cdf_inputs()
    i = rd.TYPES_10.index("gamma")
    k = params[:, i, 0]
    sel = {"k<=100": k <= 100, "100<k<=1e4": (k > 100) & (k <= 1e4), "k>1e4": k > 1e4}[regime]
    assert sel.any()
    got, want = _both_cdfs("gamma", params[sel], x[sel], i)
    if regime == "100<k<=1e4":
        f64 = td.cdf("gamma", torch.from_numpy(params[sel, i, None, :]).double(),
                     torch.from_numpy(x[sel]).double()).numpy()
        np.testing.assert_allclose(got, f64, rtol=0, atol=2e-6)
        assert np.abs(want - f64).max() > 1e-5  # the reference's deviation is real
    else:
        # k > 1e4: an ulp of the cube root, scaled by sqrt(9k) ~ 1e3, moves
        # the normal argument; measured up to 1.2e-6.
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-5 if regime == "k<=100" else 5e-6)


def test_betainc_matches_reference_and_float64():
    rng = np.random.default_rng(4)
    a = rng.uniform(2.25, 25.0, 4000).astype(np.float32)  # nu/2 of the t fitter
    x = rng.uniform(0.0, 1.0, 4000).astype(np.float32)
    x[:6] = [0.0, 1.0, 1e-30, 0.5, 0.999, 1e-6]
    b = np.full_like(a, 0.5)
    got = td.betainc(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(x)).numpy()
    want = np.asarray(jsp.betainc(jnp.asarray(a), jnp.asarray(b), jnp.asarray(x)))
    # The reference's float32 continued fraction is off by up to ~1.2e-5
    # (measured); the port's float64 one is held tighter below.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert got[0] == 0.0 and got[1] == 1.0
    scipy_special = pytest.importorskip("scipy.special")
    f64 = td.betainc(torch.from_numpy(a).double(), torch.from_numpy(b).double(),
                     torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(f64, scipy_special.betainc(a.astype(np.float64), 0.5,
                                                          x.astype(np.float64)),
                               rtol=0, atol=1e-12)
    assert np.isnan(td.betainc(torch.tensor([np.nan]), torch.tensor([0.5]),
                               torch.tensor([0.5])).numpy()).all()


def test_cbrt_matches_reference():
    x = np.random.default_rng(5).uniform(-1e3, 1e3, 1000).astype(np.float32)
    x[:3] = [0.0, 1.0, -8.0]
    got = td.cbrt(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.cbrt(jnp.asarray(x))), rtol=4e-7, atol=0)


@pytest.mark.parametrize("num_bins", [20, 64])
def test_interval_edges_bitwise(num_bins):
    mj, mt = _moments(_values(seed=6))
    want = np.asarray(rpe.interval_edges(mj.vmin, mj.vmax, num_bins))
    got = tpe.interval_edges(mt.vmin, mt.vmax, num_bins).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_bins", [20, 64])
def test_histograms_exactly_equal(num_bins):
    v = _values(seed=7)
    mj, mt = _moments(v)
    want = np.asarray(rpe.histogram(jnp.asarray(v), mj.vmin, mj.vmax, num_bins))
    vt = torch.from_numpy(v)
    np.testing.assert_array_equal(tpe.histogram_scatter(vt, mt.vmin, mt.vmax, num_bins).numpy(), want)
    np.testing.assert_array_equal(tpe.histogram(vt, mt.vmin, mt.vmax, num_bins).numpy(), want)
    assert want.sum(axis=1).tolist() == [N_OBS] * len(v)


def test_pdf_error_chain_matches_reference():
    v = _values(seed=8)
    mj, mt = _moments(v)
    types = rd.TYPES_4
    pj = rd.fit_all(types, mj)
    pt = torch.tensor(np.asarray(pj))
    masses_j = np.asarray(rpe.cdf_masses(types, pj, rpe.interval_edges(mj.vmin, mj.vmax, 64)))
    masses_t = tpe.cdf_masses(types, pt, tpe.interval_edges(mt.vmin, mt.vmax, 64)).numpy()
    # The lognormal masses inherit the log-ulp amplification of tiny-sigma rows.
    np.testing.assert_allclose(masses_t, masses_j, rtol=0, atol=3e-4)
    want = np.asarray(rpe.pdf_error(jnp.asarray(v), pj, types, 64, moments=mj))
    got = tpe.pdf_error(torch.from_numpy(v), pt, types, 64, moments=mt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-4)
    got_nomom = tpe.pdf_error(torch.from_numpy(v), pt, types, 64).numpy()
    np.testing.assert_array_equal(got_nomom, got)
    errs = torch.from_numpy(got[:, 0])
    valid = torch.arange(len(errs)) % 2 == 0
    np.testing.assert_allclose(
        float(tpe.slice_average_error(errs)), float(rpe.slice_average_error(jnp.asarray(got[:, 0]))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(tpe.slice_average_error(errs, valid)),
        float(rpe.slice_average_error(jnp.asarray(got[:, 0]), jnp.asarray(valid.numpy()))),
        rtol=1e-6)


def test_interop_config_round_trip():
    from repro.core.executor import PDFConfig as RConfig
    from repro_torch.core.executor import PDFConfig as TConfig

    for ref in (RConfig(), RConfig(types=rd.TYPES_10, num_bins=20, fit_backend="reference",
                                   window_lines=5, error_bound=0.5)):
        got = interop.pdf_config_from_dict(dataclasses.asdict(ref))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert interop.pdf_config_from_dict(dataclasses.asdict(RConfig())) == TConfig()
    with pytest.raises(ValueError, match="use_kernels"):
        interop.pdf_config_from_dict({**dataclasses.asdict(RConfig()), "use_kernels": True})
    with pytest.raises(ValueError):
        interop.moments_from_numpy([np.zeros(3)] * 5, "cpu")
