"""Port vs reference: the ``kernels`` backend's moments (K3) and histogram
(K4) wrappers, on the CPU through their plain versions, against
``repro.kernels.moments`` and ``repro.kernels.hist`` (Pallas in interpret
mode), and K2's ``row_indices`` prologue against K2 on the gathered rows.
The CUDA kernels are held against these plain versions on the card in
test_torch_kernels_cuda.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import distributions as rd
from repro.kernels import hist as rh
from repro.kernels import moments as rm
from repro_torch.core import distributions as td
from repro_torch.core import pdf_error as tpe
from repro_torch.kernels import fitpdf as tfp
from repro_torch.kernels import hist as th
from repro_torch.kernels import moments as tm
from repro_torch.kernels.fitpdf import kernel as tk

SHAPES = [(1, 64), (7, 100), (8, 512), (16, 1000), (3, 513), (32, 2048), (5, 1)]  # test_kernels.py:12
MOM_TOL = dict(rtol=2e-3, atol=2e-3)  # the port's K1 test (test_torch_fitpdf.py)


def _window(shape):
    rng = np.random.default_rng(hash(shape) % 2**31)  # tuples of ints hash alike everywhere
    return (3000 + 10 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_moments_match_reference(shape):
    v = _window(shape)
    want = rm.moments(jnp.asarray(v))
    got = tm.moments(torch.from_numpy(v))
    for name, g, w in zip(rd.Moments._fields, got, want):
        assert g.shape == (shape[0],) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MOM_TOL, err_msg=name)
    # K3's plain stats are K1's: one formula, so the fused and kernels
    # backends compute the same moments bit for bit.
    k1_stats, _ = tk.moments_edges_stats_plain(torch.from_numpy(v), 64)
    assert torch.equal(tm.moments_stats(torch.from_numpy(v)), k1_stats)


def test_moments_batched_shape():
    v = _window((2, 3, 50))
    got = tm.moments(torch.from_numpy(v))
    flat = tm.moments(torch.from_numpy(v.reshape(6, 50)))
    for g, f in zip(got, flat):
        assert g.shape == (2, 3)
        assert torch.equal(g.reshape(6), f)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("num_bins", [8, 20, 64])
def test_histogram_matches_reference(shape, num_bins):
    """Counts equal the reference kernel's exactly."""
    _check_histogram(shape, num_bins)


@pytest.mark.parametrize("shape", [(7, 100), (3, 513), (5, 1)])
@pytest.mark.parametrize("num_bins", [1000, 4000])
def test_histogram_matches_reference_large_bins(shape, num_bins):
    """Counts equal the reference kernel's exactly at L past what one block
    of the card's K4 holds at once (small P and n: the reference's
    interpret-mode one-hot is (8, 512, L))."""
    _check_histogram(shape, num_bins)


def _check_histogram(shape, num_bins):
    v = _window(shape)
    vmin, vmax = v.min(1), v.max(1)
    want = np.asarray(rh.histogram(jnp.asarray(v), jnp.asarray(vmin), jnp.asarray(vmax), num_bins))
    got = th.histogram(torch.from_numpy(v), torch.from_numpy(vmin), torch.from_numpy(vmax),
                       num_bins)
    assert got.dtype == torch.float32 and got.shape == (shape[0], num_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().sum(1), shape[1])


def test_histogram_constant_rows_and_batch():
    v = np.full((3, 4, 37), 7.0, np.float32)
    lo = hi = torch.full((3, 4), 7.0)
    got = th.histogram(torch.from_numpy(v), lo, hi, 16)
    want = np.asarray(rh.histogram(jnp.asarray(v), jnp.asarray(lo.numpy()),
                                   jnp.asarray(hi.numpy()), 16))
    assert got.shape == (3, 4, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[..., 0] == 37).all() and (got[..., 1:] == 0).all()


@pytest.mark.parametrize("types,num_bins", [(rd.TYPES_4, 64), (rd.TYPES_10, 20)],
                         ids=["4types_L64", "10types_L20"])
def test_fit_errors_row_indices_equal_gathered(types, num_bins):
    """K2's prologue: the full window plus per-representative moments and
    params give, bit for bit, what the gathered rows give."""
    v = torch.from_numpy(_window((40, 300)))
    v[1::4] = v[0]  # duplicate rows
    m = td.moments_from_values(v)
    for idx in (torch.tensor([0, 2, 3, 5, 39, 17]), torch.tensor([7, 7, 0, 39, 7])):
        sub = td.Moments(*(f[idx] for f in m))
        params = td.fit_all(types, sub)
        got = tfp.fit_errors(v, sub, params, types, num_bins, row_indices=idx)
        want = tfp.fit_errors(v[idx], sub, params, types, num_bins)
        assert got.shape == (len(idx), len(types))
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("change,exc", [
    (lambda a: a.update(row_indices=a["row_indices"].int()), TypeError),
    (lambda a: a.update(row_indices=a["row_indices"][:, None]), ValueError),
    (lambda a: a.update(row_indices=a["row_indices"][:2]), ValueError),
    (lambda a: a.update(row_indices=a["row_indices"] + 10), IndexError),
], ids=["int32", "2d", "length", "out_of_range"])
def test_fit_error_counts_rejects_bad_row_indices(change, exc):
    v = torch.from_numpy(_window((6, 40)))
    idx = torch.tensor([5, 0, 3])
    m = td.moments_from_values(v[idx])
    params = td.fit_all(td.TYPES_4, m).reshape(3, -1).contiguous()
    kw = dict(row_indices=idx)
    args = (m.vmin, m.vmax, tpe.interval_edges(m.vmin, m.vmax, 8), params, td.TYPES_4, 8)
    tk.fit_error_counts(v, *args, **kw)  # the unchanged call is accepted
    change(kw)
    with pytest.raises(exc):
        tk.fit_error_counts(v, *args, **kw)


def test_fit_error_counts_unchecked_indices():
    """Device Select's call (``_fit_error_counts_in_range``: indices in
    range by construction, no range check) gives the checked call's
    errors, and an index outside the window gives a row of NaN, as the
    kernel does; the public wrapper still raises on a negative index and
    on one past the window."""
    v = torch.from_numpy(_window((6, 40)))
    m = td.moments_from_values(v)
    idx = torch.tensor([5, 0, 3, 3])
    sub = td.Moments(*(f[idx] for f in m))
    params = td.fit_all(td.TYPES_4, sub).reshape(4, -1).contiguous()
    args = (sub.vmin, sub.vmax, tpe.interval_edges(sub.vmin, sub.vmax, 8), params, td.TYPES_4, 8)
    want = tk.fit_error_counts(v, *args, row_indices=idx)
    got = tk._fit_error_counts_in_range(v, *args, idx)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for bad in (torch.tensor([5, -1, 3, 3]), torch.tensor([5, 0, 6, 3])):
        with pytest.raises(IndexError):
            tk.fit_error_counts(v, *args, row_indices=bad)
        got = tk._fit_error_counts_in_range(v, *args, bad)
        inside = (bad >= 0) & (bad < 6)
        assert torch.isnan(got[~inside]).all()
        np.testing.assert_array_equal(got[inside].numpy(), want[inside].numpy())


def test_new_wrappers_reject_bad_inputs():
    v = torch.from_numpy(_window((4, 10)))
    lo, hi = v.amin(1), v.amax(1)
    with pytest.raises(TypeError):
        tm.moments_stats(v.double())
    with pytest.raises(ValueError):
        tm.moments_stats(v[0])
    with pytest.raises(TypeError):
        th.hist_counts(v.double(), lo, hi, 8)
    with pytest.raises(ValueError):
        th.hist_counts(v, lo[:3], hi, 8)
    with pytest.raises(TypeError):
        th.hist_counts(v, lo.double(), hi, 8)
    with pytest.raises(ValueError):
        th.hist_counts(v, lo, hi, 0)


def test_cpu_path_never_launches():
    before = (tm.moments_stats.launches, th.hist_counts.launches,
              tk.fit_error_counts.row_index_launches)
    v = torch.from_numpy(_window((4, 10)))
    tm.moments_stats(v)
    th.hist_counts(v, v.amin(1), v.amax(1), 8)
    m = td.moments_from_values(v)
    tfp.fit_errors(v, m, td.fit_all(td.TYPES_4, m), td.TYPES_4, 8, row_indices=torch.arange(4))
    assert (tm.moments_stats.launches, th.hist_counts.launches,
            tk.fit_error_counts.row_index_launches) == before
