"""Property tests of the port's streaming merge math, for the host (numpy)
and the torch merge pair: the reference's tests/test_streaming_properties.py
on both. Comparisons are same-precision, and the tolerance is the pinned
``MERGE_ULP_BUDGET``; derandomization comes from conftest.py's profiles."""

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="property tests need the optional 'test' extra")
from hypothesis import given, settings, strategies as st  # noqa: E402

torch = pytest.importorskip("torch")

from repro_torch.streaming import moments as tm  # noqa: E402

MOMENT_FIELDS = ("mean", "var", "skew", "kurt", "vmin", "vmax")

# The two merge pairs: (merge_suffstats, merge_counts), each returning numpy.
PAIRS = {
    "numpy": (tm.merge_suffstats, tm.merge_counts),
    "torch": (lambda a, b: tm.SuffStats(float(a.n) + float(b.n), *(
        np.asarray(f) for f in tm.merge_suffstats_torch(a, b)[1:])),
              lambda a, b: tm.merge_counts_torch(torch.from_numpy(a),
                                                 torch.from_numpy(b)).numpy()),
}
pair_ids = pytest.mark.parametrize("pair", sorted(PAIRS))


def assert_within_budget(a, b):
    """Every finalized moment within MERGE_ULP_BUDGET float32 ulps, or
    within one float32 epsilon (ulp distance degenerates across zero)."""
    ma, mb = tm.moments_from_suffstats(a), tm.moments_from_suffstats(b)
    for name in MOMENT_FIELDS:
        va, vb = np.asarray(getattr(ma, name)), np.asarray(getattr(mb, name))
        ok = (tm.ulp_diff(va, vb) <= tm.MERGE_ULP_BUDGET) | (np.abs(va - vb) <= 2.0**-23)
        assert ok.all(), f"{name}: {tm.ulp_diff(va, vb).max()} ulps over budget"

values = st.floats(-100.0, 100.0, allow_nan=False, width=32)


def partition(min_size=1, max_size=24):
    return st.lists(values, min_size=min_size, max_size=max_size)


def to_arr(part):
    return np.asarray(part, np.float32).reshape(1, -1)


@pair_ids
@settings(max_examples=60)
@given(p1=partition(), p2=partition(), p3=partition())
def test_property_merge_is_associative(pair, p1, p2, p3):
    merge, _ = PAIRS[pair]
    a, b, c = (tm.suffstats_from_values(to_arr(p)) for p in (p1, p2, p3))
    left, right = merge(merge(a, b), c), merge(a, merge(b, c))
    assert left.n == right.n
    np.testing.assert_array_equal(left.vmin, right.vmin)
    np.testing.assert_array_equal(left.vmax, right.vmax)
    assert_within_budget(left, right)


@pair_ids
@settings(max_examples=60)
@given(parts=st.lists(partition(), min_size=2, max_size=5), rnd=st.randoms())
def test_property_merge_is_permutation_invariant(pair, parts, rnd):
    merge, _ = PAIRS[pair]
    stats = [tm.suffstats_from_values(to_arr(p)) for p in parts]
    inorder = stats[0]
    for s in stats[1:]:
        inorder = merge(inorder, s)
    shuffled = list(stats)
    rnd.shuffle(shuffled)
    other = shuffled[0]
    for s in shuffled[1:]:
        other = merge(other, s)
    assert inorder.n == other.n
    assert_within_budget(inorder, other)


@pair_ids
@settings(max_examples=60)
@given(parts=st.lists(partition(), min_size=1, max_size=4))
def test_property_merge_tree_matches_from_scratch(pair, parts):
    merge, _ = PAIRS[pair]
    merged = tm.suffstats_from_values(to_arr(parts[0]))
    for p in parts[1:]:
        merged = merge(merged, tm.suffstats_from_values(to_arr(p)))
    direct = tm.suffstats_from_values(np.concatenate([to_arr(p) for p in parts], axis=-1))
    assert merged.n == direct.n
    np.testing.assert_array_equal(merged.vmin, direct.vmin)
    np.testing.assert_array_equal(merged.vmax, direct.vmax)
    assert_within_budget(merged, direct)


@pair_ids
@settings(max_examples=40)
@given(c=values, p1=partition(min_size=2), p2=partition(min_size=2))
def test_property_degenerate_constant_partitions_stay_finite(pair, c, p1, p2):
    merge, _ = PAIRS[pair]
    merged = merge(tm.suffstats_from_values(np.full((1, len(p1)), np.float32(c))),
                   tm.suffstats_from_values(np.full((1, len(p2)), np.float32(c))))
    m = tm.moments_from_suffstats(merged)
    for f in m:
        assert np.isfinite(np.asarray(f)).all()
    np.testing.assert_array_equal(np.asarray(m.vmin), np.float32(c))
    np.testing.assert_array_equal(np.asarray(m.vmax), np.float32(c))


@pair_ids
@settings(max_examples=60)
@given(num_bins=st.integers(1, 16), data=st.data())
def test_property_histogram_merge_exact_and_order_free(pair, num_bins, data):
    _, merge = PAIRS[pair]
    count_arr = st.lists(st.integers(0, 2**23), min_size=num_bins, max_size=num_bins)
    parts = [np.asarray(data.draw(count_arr), np.int64) for _ in range(3)]
    fwd = merge(merge(parts[0], parts[1]), parts[2])
    rev = merge(parts[2], merge(parts[1], parts[0]))
    np.testing.assert_array_equal(fwd, sum(parts))
    np.testing.assert_array_equal(rev, sum(parts))
