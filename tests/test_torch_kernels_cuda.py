"""The CUDA kernels of repro_torch against their plain PyTorch versions.

These need a CUDA device and ``nvcc`` (the kernels compile on first use),
so they carry the ``cuda`` marker and skip elsewhere. This file imports no
JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import distributions as td
from repro_torch.core import pdf_error as tpe
from repro_torch.core import grouping as tg
from repro_torch.kernels.band_attn import kernel as tbk
from repro_torch.kernels.band_attn import banded_attention, banded_attention_ref
from repro_torch.kernels.band_attn.ref import row_errors
from repro_torch.kernels.fitpdf import kernel as tk
from repro_torch.kernels.hist import kernel as thk
from repro_torch.kernels.moments import kernel as tmk

pytestmark = pytest.mark.cuda

SHAPES = [(1, 64), (7, 100), (37, 513), (64, 1000), (129, 2048), (5, 1), (6275, 1000)]

# K1 against its plain version, per stat (the same as chip_smoke.py's
# K1_TOL): only the order of each row's sums differs, so mean and var are
# held well below a biased variance's 1/n, and vmin/vmax are exact.
K1_TOL = [(1e-5, 0.0), (1e-4, 0.0), (1e-4, 1e-4), (1e-4, 5e-4), (0.0, 0.0), (0.0, 0.0)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _close(got, want, rtol, atol):
    got, want = got.cpu().double(), want.cpu().double()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, equal_nan=True)


def _window(shape, seed):
    return np.random.default_rng(seed).normal(3000.0, 10.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("num_bins", [20, 64])
def test_moments_edges_stats_kernel(dev, shape, num_bins):
    x = torch.from_numpy(_window(shape, seed=shape[0])).to(dev)
    before = tk.moments_edges_stats.launches
    stats, edges = tk.moments_edges_stats(x, num_bins)
    again = tk.moments_edges_stats(x, num_bins)
    p_stats, p_edges = tk.moments_edges_stats_plain(x, num_bins)
    torch.cuda.synchronize()
    assert tk.moments_edges_stats.launches == before + 2
    assert torch.equal(stats, again[0]) and torch.equal(edges, again[1])
    for i, (rtol, atol) in enumerate(K1_TOL):
        _close(stats[:, i], p_stats[:, i], rtol=rtol, atol=atol)
    _close(edges, p_edges, rtol=1e-6, atol=1e-3)
    n = shape[1]
    if n > 1:  # a biased variance (n/(n-1) dropped) must not pass
        with pytest.raises(AssertionError):
            _close(stats[:, 1] * ((n - 1) / n), p_stats[:, 1], *K1_TOL[1])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("types", [td.TYPES_4, td.TYPES_10], ids=["4types", "10types"])
@pytest.mark.parametrize("num_bins", [20, 64])
def test_fit_error_counts_kernel(dev, shape, types, num_bins):
    x = torch.from_numpy(_window(shape, seed=shape[1])).to(dev)
    m = td.moments_from_values(x)
    params = td.fit_all(types, m).reshape(shape[0], -1).contiguous()
    edges = tpe.interval_edges(m.vmin, m.vmax, num_bins)
    args = (x, m.vmin, m.vmax, edges, params, types, num_bins)
    before = tk.fit_error_counts.launches
    got = tk.fit_error_counts(*args)
    again = tk.fit_error_counts(*args)
    want = tk.fit_error_counts_plain(*args)
    torch.cuda.synchronize()
    assert tk.fit_error_counts.launches == before + 2
    assert torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(again, nan=-1.0))
    _close(got, want, rtol=1e-4, atol=5e-4)


def test_degenerate_window_nan_pattern(dev):
    x = torch.full((5, 100), 7.0, device=dev)
    m = td.moments_from_values(x)
    params = td.fit_all(td.TYPES_10, m).reshape(5, -1).contiguous()
    edges = tpe.interval_edges(m.vmin, m.vmax, 16)
    args = (x, m.vmin, m.vmax, edges, params, td.TYPES_10, 16)
    got, want = tk.fit_error_counts(*args), tk.fit_error_counts_plain(*args)
    assert bool(torch.isnan(want).any())
    _close(got, want, rtol=0, atol=1e-5)


def test_kernel_rejects_mixed_devices(dev):
    x = torch.from_numpy(_window((4, 10), seed=0)).to(dev)
    m = td.moments_from_values(x)
    params = td.fit_all(td.TYPES_4, m).reshape(4, -1).contiguous()
    edges = tpe.interval_edges(m.vmin, m.vmax, 8)
    with pytest.raises(ValueError):
        tk.fit_error_counts(x, m.vmin.cpu(), m.vmax, edges, params, td.TYPES_4, 8)
    with pytest.raises(ValueError):
        tk.moments_edges_stats(x.t(), 8)  # not contiguous
    with pytest.raises(RuntimeError):  # a chunk of bins that is not a multiple of 32
        tk._fit_error_counts_in_range(x, m.vmin, m.vmax, tpe.interval_edges(m.vmin, m.vmax, 4000),
                                      params, td.TYPES_4, 4000, None, chunk=100)


def _with_constant_row(arr):
    arr = arr.copy()
    arr[0] = 7.0  # vmin == vmax: every count in bin 0, the NaN rows of uniform
    return arr


@pytest.mark.parametrize("shape", SHAPES)
def test_moments_stats_kernel(dev, shape):
    """K3 within K1_TOL of its plain version, and bitwise equal to K1's
    stats: one kernel template, the edges compiled out."""
    x = torch.from_numpy(_with_constant_row(_window(shape, seed=shape[0] + 1))).to(dev)
    before = tmk.moments_stats.launches
    stats = tmk.moments_stats(x)
    again = tmk.moments_stats(x)
    k1_stats, _ = tk.moments_edges_stats(x, 64)
    want = tmk.moments_stats_plain(x)
    torch.cuda.synchronize()
    assert tmk.moments_stats.launches == before + 2
    assert stats.shape == (shape[0], tmk.NUM_STATS)
    assert torch.equal(stats, again)
    assert torch.equal(stats, k1_stats)
    for i, (rtol, atol) in enumerate(K1_TOL):
        _close(stats[:, i], want[:, i], rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("num_bins", [8, 20, 64])
def test_hist_counts_kernel(dev, shape, num_bins):
    """K4's counts equal the scatter histogram's exactly, rows sum to n, a
    constant row counts everything in bin 0."""
    x = torch.from_numpy(_with_constant_row(_window(shape, seed=shape[1] + 2))).to(dev)
    vmin, vmax = x.amin(1), x.amax(1)
    before = thk.hist_counts.launches
    got = thk.hist_counts(x, vmin, vmax, num_bins)
    want = thk.hist_counts_plain(x, vmin, vmax, num_bins)
    torch.cuda.synchronize()
    assert thk.hist_counts.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got.sum(1), torch.full((shape[0],), float(shape[1]), device=dev))
    assert got[0, 0] == shape[1]


@pytest.mark.parametrize("backend", ["fused", "kernels"])
@pytest.mark.parametrize("types,num_bins", [(td.TYPES_4, 64), (td.TYPES_10, 20)],
                         ids=["4types", "10types"])
def test_fit_predicted_launches_its_kernel(dev, backend, types, num_bins):
    """Algorithm 4 on the card: ``fused`` launches K2 once (all T types),
    ``kernels`` K4 once, whatever T; the fit equals the plain backend's
    (K4's counts are exact; K2's errors within the error tolerance)."""
    from repro_torch.core import fitting as tf

    x = torch.from_numpy(_window((257, 1000), seed=5)).to(dev)
    m = td.moments_from_values(x)
    pred = torch.from_numpy(np.random.default_rng(3).integers(0, len(types), 257)).to(dev)
    before = (tk.fit_error_counts.launches, thk.hist_counts.launches)
    got = tf.get_fit_backend(backend, num_bins).fit_predicted(x, m, pred, types, num_bins)
    torch.cuda.synchronize()
    k2, k4 = tk.fit_error_counts.launches - before[0], thk.hist_counts.launches - before[1]
    assert (k2, k4) == ((1, 0) if backend == "fused" else (0, 1))
    want = tf.get_fit_backend("reference", num_bins).fit_predicted(x, m, pred, types, num_bins)
    assert torch.equal(got.type_idx, want.type_idx) and torch.equal(got.params, want.params)
    if backend == "kernels":
        assert torch.equal(got.error, want.error)
    else:
        _close(got.error, want.error, rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("types", [td.TYPES_4, td.TYPES_10], ids=["4types", "10types"])
def test_fit_error_counts_row_indices(dev, shape, types):
    """K2 with a representative list (lowest row of each key group, then a
    list with repeats) is bitwise equal to K2 on the gathered rows, and
    within the error tolerance of the plain version."""
    arr = _with_constant_row(_window(shape, seed=shape[0] + 3))
    arr[1::3] = arr[0]  # duplicate rows, so the groups have several members
    x = torch.from_numpy(arr).to(dev)
    m = td.moments_from_values(x)
    groups = tg.group_device(tg.quantize_keys(m.mean, m.var))
    reps, _ = tg.compact_representatives(groups.rep_for_point, groups.is_rep)
    repeats = torch.from_numpy(
        np.random.default_rng(shape[0]).integers(0, shape[0], 2 * shape[0] + 1)).to(dev)
    for idx in (reps, repeats):
        sub = td.Moments(*(f[idx] for f in m))
        params = td.fit_all(types, sub).reshape(len(idx), -1).contiguous()
        edges = tpe.interval_edges(sub.vmin, sub.vmax, 20)
        args = (sub.vmin, sub.vmax, edges, params, types, 20)
        before = (tk.fit_error_counts.launches, tk.fit_error_counts.row_index_launches)
        got = tk.fit_error_counts(x, *args, row_indices=idx)
        gathered = tk.fit_error_counts(x[idx].contiguous(), *args)
        want = tk.fit_error_counts_plain(x[idx], *args)
        torch.cuda.synchronize()
        assert (tk.fit_error_counts.launches, tk.fit_error_counts.row_index_launches) == \
            (before[0] + 2, before[1] + 1)
        assert got.shape == (len(idx), len(types))
        assert torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(gathered, nan=-1.0))
        _close(got, want, rtol=1e-4, atol=5e-4)


def test_new_kernels_reject_bad_inputs(dev):
    x = torch.from_numpy(_window((6, 40), seed=0)).to(dev)
    vmin, vmax = x.amin(1), x.amax(1)
    with pytest.raises(TypeError):
        tmk.moments_stats(x.double())
    with pytest.raises(ValueError):
        tmk.moments_stats(x.t())  # not contiguous
    with pytest.raises(ValueError):
        thk.hist_counts(x, vmin.cpu(), vmax, 8)
    with pytest.raises(RuntimeError):  # a chunk of bins that is not a multiple of 32
        thk._hist_counts(x, vmin, vmax, 4000, chunk=100)
    m = td.moments_from_values(x)
    params = td.fit_all(td.TYPES_4, m).reshape(6, -1).contiguous()
    edges = tpe.interval_edges(m.vmin, m.vmax, 8)
    args = (m.vmin, m.vmax, edges, params, td.TYPES_4, 8)
    with pytest.raises(IndexError):
        tk.fit_error_counts(x, *args, row_indices=torch.arange(1, 7, device=dev))
    with pytest.raises(TypeError):
        tk.fit_error_counts(x, *args, row_indices=torch.arange(6, device=dev, dtype=torch.int32))


def _k2_args(x, m, types, num_bins, idx=None):
    sub = m if idx is None else td.Moments(*(f[idx] for f in m))
    params = td.fit_all(types, sub).reshape(len(sub.vmin), -1).contiguous()
    edges = tpe.interval_edges(sub.vmin, sub.vmax, num_bins).contiguous()
    return sub.vmin.contiguous(), sub.vmax.contiguous(), edges, params, types, num_bins


@pytest.mark.parametrize("types,num_bins", [(td.TYPES_4, 64), (td.TYPES_10, 20)],
                         ids=["4types_L64", "10types_L20"])
def test_row_bitwise_alone_in_window_and_through_indices(dev, types, num_bins):
    """A row's K2 errors and K4 counts are the same bits alone, inside the
    full Set1-shaped window (6,275 x 1,000) and through ``row_indices``
    with G = 1, 818 and 6,275: nothing of a row's result depends on the
    grid or on the rows that share its launch."""
    p, n = 6275, 1000
    x = torch.from_numpy(_window((p, n), seed=11)).to(dev)
    m = td.moments_from_values(x)
    full = tk.fit_error_counts(x, *_k2_args(x, m, types, num_bins))
    counts = thk.hist_counts(x, m.vmin, m.vmax, num_bins)
    rng = np.random.default_rng(12)
    for r in (0, 817, 4093, p - 1):
        alone = x[r:r + 1].contiguous()
        m1 = td.Moments(*(f[r:r + 1] for f in m))
        assert torch.equal(tk.fit_error_counts(alone, *_k2_args(alone, m1, types, num_bins)), full[r:r + 1])
        assert torch.equal(thk.hist_counts(alone, m1.vmin, m1.vmax, num_bins), counts[r:r + 1])
        others = rng.choice(np.delete(np.arange(p), r), 817, replace=False)
        for idx in ([r], np.insert(others, 409, r), rng.permutation(p)):
            idx = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(dev)
            got = tk.fit_error_counts(x, *_k2_args(x, m, types, num_bins, idx), row_indices=idx)
            assert torch.equal(got[idx == r], full[r:r + 1])


def test_misaligned_rows_bitwise(dev):
    """Rows that do not start on a 16-byte boundary (a window at an offset
    of one float, n = 1,000) take the scalar head and tail: the same bits
    as the aligned copy."""
    p, n = 300, 1000
    base = torch.zeros(p * n + 1, device=dev)
    x = base[1:].view(p, n)
    x.copy_(torch.from_numpy(_window((p, n), seed=13)).to(dev))
    aligned = x.clone()
    m = td.moments_from_values(aligned)
    args = _k2_args(aligned, m, td.TYPES_4, 64)
    assert torch.equal(tk.fit_error_counts(x, *args), tk.fit_error_counts(aligned, *args))
    assert torch.equal(thk.hist_counts(x, m.vmin, m.vmax, 64), thk.hist_counts(aligned, m.vmin, m.vmax, 64))


def _moments_window(shape, seed):
    """A window with a constant row (degenerate: var 0, NaN skew and kurt
    in neither version), a row that starts with NaN and one with a NaN
    inside (NaN stats), a row with +-inf (NaN sums, infinite min and max)."""
    arr = _with_constant_row(_window(shape, seed))
    p, n = shape
    if p > 3:
        arr[1, 0] = np.nan
        arr[2, n // 2] = np.nan
        arr[3, n - 1] = np.inf
        arr[3, 0] = -np.inf
    return arr


@pytest.mark.parametrize("n", [1, 3, 5, 999, 1000, 1001, 2048, 2049, 4097])
def test_moments_kernels_any_n(dev, n):
    """K1 (L = 64) and K3 at any n, below and above one round of 16-byte
    loads (2,048 values), n not a multiple of 4: within K1_TOL of the plain
    version with its NaN pattern (degenerate and NaN rows), repeat launches
    bitwise, K3 bitwise equal to K1's stats, and a planted biased variance
    rejected."""
    x = torch.from_numpy(_moments_window((37, n), seed=n)).to(dev)
    before = (tk.moments_edges_stats.launches, tmk.moments_stats.launches)
    stats, edges = tk.moments_edges_stats(x, 64)
    again, edges2 = tk.moments_edges_stats(x, 64)
    k3, k3_again = tmk.moments_stats(x), tmk.moments_stats(x)
    want, want_edges = tk.moments_edges_stats_plain(x, 64)
    torch.cuda.synchronize()
    assert (tk.moments_edges_stats.launches, tmk.moments_stats.launches) == (before[0] + 2, before[1] + 2)
    nan0 = lambda t: torch.nan_to_num(t, nan=-1.0)  # noqa: E731
    assert torch.equal(nan0(stats), nan0(again)) and torch.equal(nan0(edges), nan0(edges2))
    assert torch.equal(nan0(k3), nan0(k3_again)) and torch.equal(nan0(k3), nan0(stats))
    for i, (rtol, atol) in enumerate(K1_TOL):
        _close(stats[:, i], want[:, i], rtol=rtol, atol=atol)
    _close(edges, want_edges, rtol=1e-6, atol=1e-3)
    if n > 1:  # a biased variance (n/(n-1) dropped) must not pass
        with pytest.raises(AssertionError):
            _close(stats[4:, 1] * ((n - 1) / n), want[4:, 1], *K1_TOL[1])


def test_moments_row_bitwise_anywhere(dev):
    """One row of 1,001 values placed at rows of every alignment of a
    window (1,001 is 1 mod 4, so row r starts r floats past a 16-byte
    boundary, mod 4), in windows that start 0-3 floats past one, and alone:
    the same K1 and K3 stats, bit for bit."""
    p, n = 64, 1001
    arr = _window((p, n), seed=18)
    row = arr[5].copy()
    places = [0, 1, 2, 3, 17, 42, p - 1]
    arr[places] = row
    want = tmk.moments_stats(torch.from_numpy(row[None]).to(dev))
    for off in range(4):
        base = torch.zeros(p * n + off, device=dev)
        x = base[off:].view(p, n)
        x.copy_(torch.from_numpy(arr).to(dev))
        k1, _ = tk.moments_edges_stats(x, 64)
        k3 = tmk.moments_stats(x)
        for r in places:
            assert torch.equal(k3[r:r + 1], want), (off, r)
            assert torch.equal(k1[r:r + 1], want), (off, r)


def test_moments_no_spills(dev):
    """K1's and K3's kernels keep their sums in registers (no local memory)."""
    for attrs in (tk.moments_edges_attributes(), tmk.moments_attributes()):
        assert attrs["local_bytes"] == 0, attrs
        assert 0 < attrs["registers"] <= 255, attrs


@pytest.mark.parametrize("num_bins", [8, 64, 767])
def test_worst_case_conflict_row(dev, num_bins):
    """Every value of a row but its two ends in one bin: every atomic of
    the histogram hits one counter. Counts stay exact, errors within the
    tolerance of the plain version."""
    arr = _window((8, 1000), seed=14)
    arr[0] = 5.0
    arr[0, 0], arr[0, -1] = 0.0, 10.0
    arr[1] = arr[0][::-1]
    x = torch.from_numpy(arr).to(dev)
    m = td.moments_from_values(x)
    got = thk.hist_counts(x, m.vmin, m.vmax, num_bins)
    assert torch.equal(got, thk.hist_counts_plain(x, m.vmin, m.vmax, num_bins))
    assert got[0, num_bins // 2] == 998
    for types in (td.TYPES_4, td.TYPES_10):
        args = (x, *_k2_args(x, m, types, num_bins))
        _close(tk.fit_error_counts(*args), tk.fit_error_counts_plain(*args), rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("types", [td.TYPES_4, td.TYPES_10], ids=["4types", "10types"])
def test_fit_error_and_hist_no_spills(dev, types):
    """K2's two instantiations (with and without the float64 special
    functions) and K4 keep everything in registers (no local memory), and
    their shared memory at the largest L each took before fits the 48 KB
    a block gets without opting in."""
    for attrs in (tk.fit_error_attributes(types, 767), thk.hist_attributes(1536)):
        assert attrs["local_bytes"] == 0, attrs
        assert 0 < attrs["registers"] <= 255 and attrs["smem_bytes"] <= 48 * 1024, attrs


def _optin_chunk(num_bins):
    """The chunk of bins a block of K4 (an int counter a bin) counts at once
    on this card: all of them while they fit the shared memory a block can
    opt in to, else the largest multiple of 32 that fits."""
    words = torch.cuda.get_device_properties(0).shared_memory_per_block_optin // 4
    return num_bins if num_bins <= words else words // 32 * 32


@pytest.mark.parametrize("num_bins", [768, 1537, 2457, 4000, 11622, 58113])
def test_any_bin_count(dev, num_bins):
    """K2 (4 and 10 types, and through ``row_indices``) within the error
    tolerance of its plain version and K4's counts exactly equal to the
    scatter histogram at L past every limit of the designs before: 48 KB
    of shared memory (K2 above 2,456 bins, K4 above 12,288), the card's
    opt-in limit (K2 above 11,621 on an H100, K4 above 58,112). K4 holds
    all the bins while they fit the opt-in limit, then goes in chunks; K2
    holds at most ``_fit_error_chunk`` bins (a multiple of 32) a launch.
    Each wrapper counts one launch a chunk."""
    x = torch.from_numpy(_with_constant_row(_window((6, 400), seed=16))).to(dev)
    m = td.moments_from_values(x)
    before = thk.hist_counts.launches
    counts = thk.hist_counts(x, m.vmin, m.vmax, num_bins)
    assert thk.hist_counts.launches - before == -(-num_bins // _optin_chunk(num_bins))
    assert torch.equal(counts, thk.hist_counts_plain(x, m.vmin, m.vmax, num_bins))
    attrs = thk.hist_attributes(num_bins)
    assert attrs["chunk"] == _optin_chunk(num_bins) and attrs["local_bytes"] == 0, attrs
    most = tk._fit_error_chunk(0)
    assert most % 32 == 0 and most >= 32
    chunks = -(-num_bins // most)
    idx = torch.tensor([5, 0, 3, 3, 1], device=dev)
    for types in (td.TYPES_4, td.TYPES_10):
        args = (x, *_k2_args(x, m, types, num_bins))
        before = tk.fit_error_counts.launches
        _close(tk.fit_error_counts(*args), tk.fit_error_counts_plain(*args), rtol=1e-4, atol=5e-4)
        assert tk.fit_error_counts.launches - before == chunks
        sub = _k2_args(x, m, types, num_bins, idx)
        before = (tk.fit_error_counts.launches, tk.fit_error_counts.row_index_launches)
        got = tk.fit_error_counts(x, *sub, row_indices=idx)
        assert (tk.fit_error_counts.launches - before[0],
                tk.fit_error_counts.row_index_launches - before[1]) == (chunks, chunks)
        _close(got, tk.fit_error_counts_plain(x[idx], *sub), rtol=1e-4, atol=5e-4)
        attrs = tk.fit_error_attributes(types, num_bins)
        assert attrs["chunk"] == min(num_bins, most), attrs
        assert attrs["local_bytes"] == 0 and attrs["smem_bytes"] <= 48 * 1024, attrs


@pytest.mark.parametrize("types", [td.TYPES_4, td.TYPES_10], ids=["4types", "10types"])
@pytest.mark.parametrize("num_bins,chunks", [(64, (32,)), (767, (32, 96, 736)),
                                             (4000, (32, 1024, 2432))])
def test_chunked_route_bitwise(dev, types, num_bins, chunks):
    """K2's errors are the same bits whether a block counts its L bins in
    one launch (at L = 4,000, 80 KB of shared memory: opted in) or in
    chunks of any multiple of 32, its own route included (a lane adds the
    same bins in the same order), also through ``row_indices``; K4's
    counts too. Each wrapper counts one launch a chunk."""
    x = torch.from_numpy(_with_constant_row(_window((40, 1001), seed=17))).to(dev)
    m = td.moments_from_values(x)
    idx = torch.tensor([39, 0, 7, 7, 20], device=dev)
    args, sub = _k2_args(x, m, types, num_bins), _k2_args(x, m, types, num_bins, idx)
    one = tk._fit_error_counts_in_range(x, *args, None, chunk=num_bins)
    one_rows = tk._fit_error_counts_in_range(x, *sub, idx, chunk=num_bins)
    counts = thk._hist_counts(x, m.vmin, m.vmax, num_bins, chunk=num_bins)
    nan0 = lambda t: torch.nan_to_num(t, nan=-1.0)  # noqa: E731
    for c in (*chunks, 0):
        launches = -(-num_bins // (c or tk._fit_error_chunk(0)))
        before = (tk.fit_error_counts.launches, tk.fit_error_counts.row_index_launches)
        got = tk._fit_error_counts_in_range(x, *args, None, chunk=c)
        assert torch.equal(nan0(got), nan0(one)), c
        got = tk._fit_error_counts_in_range(x, *sub, idx, chunk=c)
        assert torch.equal(nan0(got), nan0(one_rows)), c
        assert (tk.fit_error_counts.launches - before[0],
                tk.fit_error_counts.row_index_launches - before[1]) == (2 * launches, launches), c
        before = thk.hist_counts.launches
        assert torch.equal(thk._hist_counts(x, m.vmin, m.vmax, num_bins, chunk=c), counts), c
        assert thk.hist_counts.launches - before == -(-num_bins // (c or _optin_chunk(num_bins))), c


def test_device_select_indices_need_no_sync(dev):
    """K2 through ``row_indices`` from ``compact_representatives``, as the
    executor's device Select calls it, issues no host synchronisation; the
    public wrapper's range check does, and an index outside the window
    still raises there, and gives NaN rows, never a read, without it."""
    x = torch.from_numpy(_window((6275, 1000), seed=15)).to(dev)
    m = td.moments_from_values(x)
    groups = tg.group_device(tg.quantize_keys(m.mean, m.var))
    idx, _ = tg.compact_representatives(groups.rep_for_point, groups.is_rep)
    args = _k2_args(x, m, td.TYPES_4, 64, idx)
    want = tk.fit_error_counts(x, *args, row_indices=idx)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tk._fit_error_counts_in_range(x, *args, idx)
        with pytest.raises(RuntimeError):  # the range check synchronises
            tk.fit_error_counts(x, *args, row_indices=idx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)
    bad = idx.clone()
    bad[0], bad[-1] = -1, len(x)
    with pytest.raises(IndexError):
        tk.fit_error_counts(x, *args, row_indices=bad)
    got = tk._fit_error_counts_in_range(x, *args, bad)
    assert torch.isnan(got[[0, -1]]).all()
    assert torch.equal(got[1:-1], want[1:-1])


# K5 against its plain version. (B, S, H, KV, hd, W): GQA, MHA, ragged
# tails, G = 3, S < W, S = 1, and hd 256 / 136 / 40; then S not a multiple
# of 64 with S > W at G = 1 (hd 8), G = 3 (hd 136 and 256: one warpgroup a
# block) and G = 4 (two blocks a kv head). hd 8, 40 and 136 are not
# multiples of 16: the bf16 kernel pads them in shared memory.
BAND_CASES = [
    (2, 64, 4, 2, 16, 16),
    (1, 48, 8, 8, 32, 16),
    (2, 50, 4, 2, 16, 16),
    (1, 128, 6, 2, 64, 32),
    (1, 8, 2, 1, 8, 16),
    (1, 1, 2, 1, 8, 4),
    (2, 700, 4, 2, 256, 1024),
    (1, 2500, 4, 2, 256, 1024),
    (2, 300, 4, 4, 40, 100),
    (1, 129, 2, 1, 136, 64),
    (2, 333, 4, 4, 8, 100),
    (1, 1000, 6, 2, 136, 256),
    (1, 517, 3, 1, 256, 128),
    (1, 200, 8, 2, 64, 64),
]
# float32: the repo's attention tolerance, per entry. bf16: the kernel
# rounds the softmax weights to bf16 for P V (as the reference's oracle
# does), so the gate is per row (chip_smoke.py's K5_TOL): the worst
# ``row_errors`` against the float32 truth at most this factor times that
# of the plain version with the oracle's rounding.
BAND_TOL = {torch.float32: dict(rtol=0.0, atol=2e-5), torch.bfloat16: 2.0}


def _row_gate(got, q, k, v, w):
    """(got's worst row, the bf16 gate's limit) against the float32 truth."""
    truth = banded_attention_ref(q.float(), k.float(), v.float(), w)
    oracle = banded_attention_ref(q, k, v, w, round_weights=True)
    limit = BAND_TOL[torch.bfloat16] * float(row_errors(oracle, truth).max())
    return float(row_errors(got, truth).max()), limit, truth


def _band_inputs(case, dtype, dev):
    b, s, h, kv, hd, _ = case
    rng = np.random.default_rng(s * 1000 + hd)
    return tuple(torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32)).to(dev).to(dtype)
                 for shape, std in (((b, s, h, hd), 0.5), ((b, s, kv, hd), 0.5), ((b, s, kv, hd), 1.0)))


@pytest.mark.parametrize("case", BAND_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_banded_attention_kernel(dev, case, dtype):
    q, k, v = _band_inputs(case, dtype, dev)
    w = case[-1]
    before = tbk.banded_attention_kernel.launches
    got = banded_attention(q, k, v, w)
    again = tbk.banded_attention_kernel(q, k, v, w)
    torch.cuda.synchronize()
    assert tbk.banded_attention_kernel.launches == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)
    if dtype == torch.float32:
        want = banded_attention_ref(q, k, v, w)
        torch.testing.assert_close(got.float(), want.float(), **BAND_TOL[dtype])
        if case[1] > w:  # a window off by one must not pass
            with pytest.raises(AssertionError):
                torch.testing.assert_close(got.float(), banded_attention_ref(q, k, v, w - 1).float(),
                                           **BAND_TOL[dtype])
        return
    worst, limit, truth = _row_gate(got, q, k, v, w)
    assert worst <= limit, (worst, limit)
    if case[1] > w:  # a window off by one must not pass
        assert float(row_errors(banded_attention_ref(q, k, v, w - 1), truth).max()) > limit


@pytest.mark.parametrize("widths", [(256, 16, 8), (256, 3, 1), (136, 6, 2), (8, 2, 1)])
def test_banded_attention_tc_no_spills(dev, widths):
    """The bf16 kernel's instantiation keeps its float32 accumulators in
    registers (no local memory) and fits a block's shared memory."""
    attrs = tbk.tc_attributes(*widths)
    assert attrs["local_bytes"] == 0, attrs
    assert 0 < attrs["registers"] <= 255 and attrs["smem_bytes"] <= 232448, attrs


def test_banded_attention_kernel_rejects(dev):
    """A CUDA tensor the kernel does not take raises; nothing falls back."""
    q, k, v = _band_inputs((1, 64, 4, 2, 16, 16), torch.bfloat16, dev)
    before = tbk.banded_attention_kernel.launches
    with pytest.raises(TypeError):
        banded_attention(q.half(), k.half(), v.half(), 16)
    with pytest.raises(TypeError):
        banded_attention(q.double(), k.double(), v.double(), 16)
    for hd in (12, 264):
        shapes = [(1, 64, 4, hd), (1, 64, 2, hd), (1, 64, 2, hd)]
        with pytest.raises(ValueError):
            banded_attention(*(torch.zeros(sh, dtype=torch.bfloat16, device=dev) for sh in shapes), 16)
    with pytest.raises(ValueError):
        tbk.banded_attention_kernel(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 16)
    base = torch.zeros(q.numel() + 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):  # 2 bytes off a 16-byte boundary
        tbk.banded_attention_kernel(base[1:1 + q.numel()].view(q.shape), k, v, 16)
    with pytest.raises(ValueError):
        banded_attention(q, k.cpu(), v, 16)
    assert tbk.banded_attention_kernel.launches == before


# -- the load stage's pinned staging and the batched window path ----------------


def _cube(lines=12, ppl=30, obs=200):
    from repro_torch.core.regions import CubeGeometry
    from repro_torch.data.simulation import SeismicSimulation, SimulationConfig

    return SeismicSimulation(SimulationConfig(geometry=CubeGeometry(3, lines, ppl),
                                              num_simulations=obs))


def test_pinned_stager_bitwise_from_many_threads(dev):
    """Windows staged through the pinned pool from 6 threads at once, more
    than the pool holds, each bitwise equal to the pageable copy; every
    stage is one copy, and no buffer is rewritten before its copy ends."""
    import concurrent.futures as cf

    from repro_torch.data.loader import WindowStager

    st = WindowStager(dev, pool_size=3)
    rng = np.random.default_rng(0)
    raws = [rng.normal(3000.0, 10.0, (int(rng.integers(1, 700)), 257)).astype(np.float32)
            for _ in range(48)]

    def one(raw):
        staged = st.stage(raw)
        assert staged.ready is not None
        return st.ready(staged)

    with cf.ThreadPoolExecutor(6) as pool:
        got = list(pool.map(one, raws))
    torch.cuda.synchronize()
    for raw, g in zip(raws, got):
        assert g.device == dev and g.dtype == torch.float32
        assert torch.equal(g.cpu(), torch.from_numpy(raw))
    assert st.copies == len(raws) and len(st._slots) <= 3
    both = st.ready(st.stage(raws[0], raws[1].astype(np.float64)))  # cast on the host copy
    assert torch.equal(both.cpu(), torch.from_numpy(np.concatenate(raws[:2])))


@pytest.mark.parametrize("exec_kw", [dict(prefetch=False, async_persist=False),
                                     dict(prefetch_depth=1), dict(prefetch_depth=3)])
def test_staged_slices_bitwise_on_card(dev, exec_kw):
    """Slices through the pinned stager on the card, prefetch off, at depth
    1 and 3, bitwise equal; the same with a straggling load raced by a
    speculative one (its loser's buffer and tensor dropped)."""
    from repro_torch.core import executor as tex
    from repro_torch.core.regions import build_plan
    from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultRule

    sim = _cube()
    cfg = tex.PDFConfig(window_lines=3, method="grouping")
    plan = build_plan(sim.geometry, [0, 1, 2], 3)
    want = tex.StagedExecutor(cfg, sim, dev, exec_config=tex.ExecutorConfig(
        prefetch=False, async_persist=False)).run(plan)
    inj = FaultInjector(FaultPlan(rules=(
        FaultRule("latency", slice_i=2, line_start=6, seconds=1.5),
        FaultRule("read_error", slice_i=1, times=1))))
    for source, kw in ((sim, dict(speculate=False)),
                       (inj.wrap_source(sim), dict(speculate=True, straggler_grace_s=0.3,
                                                   retry_backoff_s=0.001))):
        ex = tex.StagedExecutor(cfg, source, dev, exec_config=tex.ExecutorConfig(**exec_kw, **kw))
        got = ex.run(plan)
        for s in (0, 1, 2):
            for f in tex.RESULT_FIELDS:
                assert np.array_equal(getattr(got[s], f), getattr(want[s], f)), (s, f)
        assert ex.stager.copies >= 12
    assert inj.events["latency"] == 1 and ex.last_report.speculation_wins >= 1


@pytest.mark.parametrize("method,fit_backend", [("baseline", "fused"), ("grouping", "fused"),
                                                ("grouping", "kernels")])
def test_window_batch_bitwise_on_card(dev, method, fit_backend):
    """``run_window_batch`` on the card: one copy for the batch, bitwise
    equal to ``run_window`` per window; grouping on fused reads its packed
    representatives through K2's ``row_indices`` route, one launch a
    packing group."""
    from repro_torch.core import executor as tex
    from repro_torch.core.regions import iter_windows

    sim = _cube()
    cfg = tex.PDFConfig(window_lines=5, method=method, fit_backend=fit_backend)
    windows = [w for s in (2, 0, 1) for w in iter_windows(sim.geometry, s, 5)]
    ex = tex.StagedExecutor(cfg, sim, dev)
    copies, rows = ex.stager.copies, tk.fit_error_counts.row_index_launches
    got = ex.run_window_batch(windows)
    torch.cuda.synchronize()
    assert ex.stager.copies == copies + 1
    if method == "grouping" and fit_backend == "fused":
        assert tk.fit_error_counts.row_index_launches == rows + 1  # one 256-row class
    one = tex.StagedExecutor(cfg, sim, dev)
    for w, r in zip(windows, got):
        want = one.run_window(w)
        for f in tex.RESULT_FIELDS:
            assert np.array_equal(getattr(r, f), getattr(want, f)), (tuple(w), f)
