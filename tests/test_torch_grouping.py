"""Port vs reference: the grouping keys, host and device dedup, the
representative padding and the reuse cache (``repro_torch.core.grouping``
and ``reuse`` against ``repro.core.grouping`` and ``reuse``).

The reference's device keys need ``jax.experimental.enable_x64``, which the
installed JAX lacks, so the port's device keys and partition are held
against the reference's host Select path (``quantize_keys_host``,
``group_host``), bitwise."""

import numpy as np
import pytest
import torch

from repro.core import grouping as rg
from repro.core import reuse as rr
from repro_torch.core import grouping as tg
from repro_torch.core import reuse as tr

# tests/test_select_backends.py:20-21: seismic-scale and extreme means,
# negative means, and non-default tolerances.
MAGS = [1e-3, 1.0, 3e3, 1e6, 1e9, -3e3, -1e9]
TOLS = [1e-6, 3.7e-5, 1e-2]


def _features(mag, tol):
    """(mean, var) float32 as tests/test_select_backends.py:33-39 makes
    them: degenerate variances and real duplicate groups."""
    rng = np.random.default_rng(int(abs(mag)) % 997 + int(tol * 1e7) % 97)
    mean = rng.normal(mag, abs(mag) * 0.1 + 1e-3, 300).astype(np.float32)
    var = np.abs(rng.normal(100, 30, 300)).astype(np.float32)
    var[::3] = 0.0
    reps = rng.integers(0, 300, size=200)
    return np.concatenate([mean, mean[reps]]), np.concatenate([var, var[reps]])


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("tol", TOLS)
def test_quantize_keys_host_bitwise(mag, tol):
    mean, var = _features(mag, tol)
    want = rg.quantize_keys_host(mean, var, tol)
    np.testing.assert_array_equal(tg.quantize_keys_host(mean, var, tol), want)
    out, tmp = np.empty((len(mean), 2), np.int64), np.empty((len(mean),))
    assert tg.quantize_keys_host(mean, var, tol, out=out, tmp=tmp) is out
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("tol", TOLS)
def test_quantize_keys_torch_bitwise(mag, tol):
    """The device keys (torch, float64, round half to even) equal the
    reference's host keys bit for bit."""
    mean, var = _features(mag, tol)
    got = tg.quantize_keys(torch.from_numpy(mean), torch.from_numpy(var), tol)
    assert got.dtype == torch.int64 and got.shape == (len(mean), 2)
    np.testing.assert_array_equal(got.numpy(), rg.quantize_keys_host(mean, var, tol))


def test_quantize_keys_widen_before_divide():
    """Means one float32 ulp apart at 3e3 are 244 quanta of 1e-6 apart: the
    keys must keep them apart (a float32 divide would not), and halves round
    to even as np.rint does."""
    mean = np.array([3000.0, np.nextafter(np.float32(3000.0), np.float32(4e3))], np.float32)
    var = np.ones(2, np.float32)
    got = tg.quantize_keys(torch.from_numpy(mean), torch.from_numpy(var)).numpy()
    np.testing.assert_array_equal(got, rg.quantize_keys_host(mean, var))
    assert got[1, 0] - got[0, 0] == 244
    f32 = torch.round(torch.from_numpy(mean) / 1e-6)  # the trap: stays float32
    assert f32.dtype == torch.float32 and f32[1] - f32[0] != 244
    halves = np.array([0.5, 1.5, 2.5, -0.5], np.float32)
    keys = tg.quantize_keys(torch.from_numpy(halves), torch.zeros(4), 1.0).numpy()
    np.testing.assert_array_equal(keys[:, 0], np.rint(halves.astype(np.float64)))


def test_quantize_features_and_int64_split():
    mean, var = _features(3e3, 1e-6)
    std = np.sqrt(var)
    np.testing.assert_array_equal(tg.quantize_features_host(mean, std),
                                  rg.quantize_features_host(mean, std))
    keys = rg.quantize_keys_host(mean, var)
    hi_lo = np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=-1).reshape(len(keys), 4)
    hi_lo = hi_lo.astype(np.uint32).view(np.int32)
    np.testing.assert_array_equal(tg.keys_to_int64(hi_lo), rg.keys_to_int64(hi_lo))
    np.testing.assert_array_equal(tg.keys_to_int64(hi_lo), keys)


@pytest.mark.parametrize("mag", [1.0, 3e3, -1e9])
@pytest.mark.parametrize("tol", [1e-6, 1e-2])
def test_group_host_matches_reference(mag, tol):
    keys = rg.quantize_keys_host(*_features(mag, tol), tol)
    got, want = tg.group_host(keys), rg.group_host(keys)
    assert got.num_groups == want.num_groups < len(keys)
    np.testing.assert_array_equal(got.rep_indices, want.rep_indices)
    np.testing.assert_array_equal(got.inverse, want.inverse)


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("tol", [1e-6, 1e-2])
def test_group_device_matches_np_unique(mag, tol):
    """The device partition: every point's representative is the lowest row
    of its key group (np.unique's return_index), the compaction lists the
    representatives in row order, and the slot map scatters them back."""
    mean, var = _features(mag, tol)
    host = rg.group_host(rg.quantize_keys_host(mean, var, tol))
    keys = tg.quantize_keys(torch.from_numpy(mean), torch.from_numpy(var), tol)
    groups = tg.group_device(keys)
    assert groups.num_groups == host.num_groups
    want_rep = host.rep_indices[host.inverse]
    np.testing.assert_array_equal(groups.rep_for_point.numpy(), want_rep)
    np.testing.assert_array_equal(groups.is_rep.numpy(), want_rep == np.arange(len(mean)))
    gather_idx, point_slot = tg.compact_representatives(groups.rep_for_point, groups.is_rep)
    np.testing.assert_array_equal(gather_idx.numpy(), np.sort(host.rep_indices))
    np.testing.assert_array_equal(gather_idx[point_slot].numpy(), want_rep)
    rep_vals = torch.arange(len(gather_idx)) * 10
    np.testing.assert_array_equal(tg.scatter_group_results(rep_vals, point_slot).numpy(),
                                  rep_vals.numpy()[point_slot.numpy()])


def test_group_device_lowest_row_not_first_in_sort():
    """Equal keys, reps chosen by row: rows 3 and 1 share a key that sorts
    first, rows 0 and 2 another."""
    keys = torch.tensor([[5, 0], [1, 0], [5, 0], [1, 0]])
    groups = tg.group_device(keys)
    assert groups.num_groups == 2
    np.testing.assert_array_equal(groups.rep_for_point.numpy(), [0, 1, 0, 1])
    gather_idx, point_slot = tg.compact_representatives(groups.rep_for_point, groups.is_rep)
    np.testing.assert_array_equal(gather_idx.numpy(), [0, 1])
    np.testing.assert_array_equal(point_slot.numpy(), [0, 1, 0, 1])


@pytest.mark.parametrize("g,bucket", [(0, 256), (1, 256), (256, 256), (257, 256),
                                      (818, 256), (1500, 100), (7, 3)])
def test_padding_matches_reference(g, bucket):
    assert tg.padded_size(g, bucket) == rg.padded_size(g, bucket)
    reps = np.arange(3, 3 + 2 * g, 2, dtype=np.int64)
    np.testing.assert_array_equal(tg.pad_representatives(reps, bucket),
                                  rg.pad_representatives(reps, bucket))


def test_reuse_cache_matches_reference():
    """The same lookups and inserts give the same hits, results and counters."""
    rng = np.random.default_rng(3)
    caches = (rr.ReuseCache(), tr.ReuseCache())
    for _ in range(5):
        keys = rng.integers(0, 40, size=(25, 2))
        results = rng.normal(size=(25, 5))
        out = [c.lookup_window(keys) for c in caches]
        np.testing.assert_array_equal(out[0][0], out[1][0])
        np.testing.assert_array_equal(out[0][1], out[1][1])
        for c in caches:
            c.insert_window(keys[~out[0][0]], results[~out[0][0]])
    a, b = caches
    assert (a.lookups, a.hits, a.size, a.hit_rate) == (b.lookups, b.hits, b.size, b.hit_rate)
    assert b.hits > 0 and b.search_seconds > 0
    full = tr.ReuseCache(max_entries=1)
    full.insert_window(np.array([[1, 2], [3, 4]]), np.zeros((2, 5)))
    assert full.size == 2  # the bound is checked once per window, as the reference does
    full.insert_window(np.array([[5, 6]]), np.zeros((1, 5)))
    assert full.size == 2
