"""Merge-able sufficient statistics: parallel Welford/Chan moment merges.

Port of ``repro.streaming.moments``. The Random Sample Partition view of
the cube treats every chunk as a self-contained partition of the
observations; an *append* adds a new partition of realizations to a window
the pipeline has already fitted. The Eq.-2 moments and the Eq.-5 histogram
are both decomposable over that partition structure:

* moments — a window's (mean, var, skew, kurt, min, max) finalize from the
  sufficient statistics ``(n, mean, S2, S3, S4, vmin, vmax)`` where
  ``Sk = sum((x - mean)**k)``; two partitions' statistics merge exactly with
  the Chan/Golub/LeVeque + Pébay update formulas — no re-read of the old
  observations;
* histogram — Eq.-5 bin counts over FIXED edges are integers, and integer
  addition is exact: merged counts are bitwise-equal to a full recompute
  whenever the merged (vmin, vmax) still equal the edges the old counts
  were binned with (otherwise the merge falls back to a full recompute of
  that window — streaming/incremental.py).

The numpy code (float64 accumulation) is the reference's, line for line, so
its results are bitwise the reference's. ``merge_suffstats_torch`` /
``merge_counts_torch`` take the place of the reference's jnp pair: the same
formulas on tensors, on the tensors' own device and dtype. The fit-backend
registry (core/fitting.py) carries the host pair for ``reference`` and the
torch pair for ``kernels``/``fused``.

Merged moments are NOT bitwise-equal to a from-scratch recompute — float
rounding differs along the merge tree — but they are provably close:
``MERGE_ULP_BUDGET`` pins the float32 ulp tolerance the property tests and
the merge-mode watermark both use. The budget is a declared constant, never
recomputed from an observed run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.distributions import Moments

# Matches distributions._EPS / pdf_error._EPS: the finalization guards must
# be the same as moments_from_values' or a merged refit would diverge from
# the full recompute for reasons other than merge rounding.
_EPS = 1e-12

# The pinned tolerance (float32 ulps, per moment field) between merged and
# from-scratch moments, the reference's: same-precision merge associativity
# and permutation are exact to a few ulps, while a float64 merge against
# the float32 single-pass pipeline recompute differs by the pipeline's own
# cancellation noise in skew/kurt; 2048 bounds both and stays a ~2e-4
# relative bound.
MERGE_ULP_BUDGET = 2048


class SuffStats(NamedTuple):
    """Merge-able per-point statistics of one observation partition.

    ``n`` is the partition's observation count (scalar — every point of a
    window sees the same number of realizations); the array fields share
    one leading shape (the window's points). ``s2``/``s3``/``s4`` are the
    *central sums* ``sum((x - mean)**k)``. An empty partition is ``n=0``
    with zero sums and ``vmin=+inf``/``vmax=-inf`` (the min/max
    identities), which the merge formulas absorb without branching."""

    n: float
    mean: np.ndarray
    s2: np.ndarray
    s3: np.ndarray
    s4: np.ndarray
    vmin: np.ndarray
    vmax: np.ndarray


def empty_suffstats(shape, dtype=np.float64) -> SuffStats:
    """The merge identity: ``merge(empty, s) == s`` field-for-field."""
    z = np.zeros(shape, dtype)
    return SuffStats(0.0, z.copy(), z.copy(), z.copy(), z.copy(),
                     np.full(shape, np.inf, dtype),
                     np.full(shape, -np.inf, dtype))


def suffstats_from_values(values, axis: int = -1) -> SuffStats:
    """Direct (host, float64) statistics of one partition's raw values —
    the from-scratch side of every merge, and what the append path computes
    over the new realizations it reads."""
    v = np.asarray(values, np.float64)
    n = v.shape[axis]
    mean = v.mean(axis=axis)
    c = v - np.expand_dims(mean, axis)
    return SuffStats(
        float(n), mean,
        (c**2).sum(axis=axis), (c**3).sum(axis=axis), (c**4).sum(axis=axis),
        v.min(axis=axis), v.max(axis=axis))


def suffstats_from_moments(m: Moments, n: int) -> SuffStats:
    """Invert ``moments_from_values``' finalization (modulo float rounding:
    the same ``_EPS`` guards are un-applied) — persisted window moments as
    merge-able statistics without touching the raw observations again.
    Takes numpy arrays or CPU tensors."""
    n = float(n)
    var = np.asarray(m.var, np.float64)
    m2 = var * max(n - 1.0, 1.0) / n
    sig = np.sqrt(np.maximum(m2, _EPS))
    m3 = np.asarray(m.skew, np.float64) * sig**3
    m4 = (np.asarray(m.kurt, np.float64) + 3.0) * np.maximum(m2, _EPS) ** 2
    return SuffStats(
        n, np.asarray(m.mean, np.float64),
        n * m2, n * m3, n * m4,
        np.asarray(m.vmin, np.float64), np.asarray(m.vmax, np.float64))


def moments_from_suffstats(s: SuffStats, dtype=np.float32) -> Moments:
    """Finalize merged statistics with the *same* formulas (and ``_EPS``
    guards) as ``distributions.moments_from_values``, so a merged window
    differs from a full recompute only by merge-tree rounding — the
    difference MERGE_ULP_BUDGET bounds. numpy in, numpy out."""
    n = max(float(s.n), 1.0)
    m2 = np.asarray(s.s2, np.float64) / n
    var = np.asarray(s.s2, np.float64) / max(float(s.n) - 1.0, 1.0)
    sig = np.sqrt(np.maximum(m2, _EPS))
    skew = (np.asarray(s.s3, np.float64) / n) / sig**3
    kurt = (np.asarray(s.s4, np.float64) / n) / np.maximum(m2, _EPS) ** 2 - 3.0
    return Moments(*(np.asarray(f, dtype) for f in
                     (s.mean, var, skew, kurt, s.vmin, s.vmax)))


def _merge(a: SuffStats, b: SuffStats, xp) -> SuffStats:
    """Chan/Golub/LeVeque (S2) + Pébay (S3, S4) pairwise update, array
    module ``xp`` ∈ {numpy, torch}. Branch-free: an ``n=0`` side
    contributes nothing because every cross term carries an ``na*nb`` or
    ``Sk`` factor of zero, and ``n`` is clamped in denominators only."""
    na, nb = float(a.n), float(b.n)
    n = na + nb
    nn = n if n > 0 else 1.0  # counts are host scalars in both paths
    delta = b.mean - a.mean
    mean = a.mean + delta * (nb / nn)
    s2 = a.s2 + b.s2 + delta**2 * (na * nb / nn)
    s3 = (a.s3 + b.s3
          + delta**3 * (na * nb * (na - nb) / nn**2)
          + 3.0 * delta * (na * b.s2 - nb * a.s2) / nn)
    s4 = (a.s4 + b.s4
          + delta**4 * (na * nb * (na * na - na * nb + nb * nb) / nn**3)
          + 6.0 * delta**2 * (na * na * b.s2 + nb * nb * a.s2) / nn**2
          + 4.0 * delta * (na * b.s3 - nb * a.s3) / nn)
    return SuffStats(n, mean, s2, s3, s4,
                     xp.minimum(a.vmin, b.vmin), xp.maximum(a.vmax, b.vmax))


def merge_suffstats(a: SuffStats, b: SuffStats) -> SuffStats:
    """Host (numpy, float64) merge — the ``reference`` backend's path and
    the one streaming/incremental.py uses for persisted sidecar stats."""
    if a.n == 0:
        return b
    if b.n == 0:
        return a
    return _merge(a, b, np)


def merge_suffstats_torch(a: SuffStats, b: SuffStats) -> SuffStats:
    """Tensor merge with identical formulas — the ``kernels`` and ``fused``
    backends' path (the reference's ``merge_suffstats_jnp``). Works on the
    tensors' own device and dtype (numpy fields become CPU tensors); the
    host path remains the accuracy reference."""
    return _merge(SuffStats(a.n, *map(torch.as_tensor, a[1:])),
                  SuffStats(b.n, *map(torch.as_tensor, b[1:])), torch)


# -- exact integer histogram merges --------------------------------------------


def merge_counts(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Bitwise-exact Eq.-5 histogram merge over FIXED edges: counts are
    integers, so addition in int64 is exact and the result is bitwise-equal
    to histogramming the concatenated observations (same edges). Raises if
    either input is not integral — a count array that drifted off the
    integers is corrupt, not mergeable."""
    ia = np.asarray(np.rint(a), np.int64)
    ib = np.asarray(np.rint(b), np.int64)
    if not (np.array_equal(ia, np.asarray(a)) and
            np.array_equal(ib, np.asarray(b))):
        raise ValueError("histogram merge requires integral bin counts")
    return (ia + ib).astype(np.asarray(a).dtype)


def merge_counts_torch(a, b) -> torch.Tensor:
    """Tensor histogram merge (the reference's ``merge_counts_jnp``):
    float32 integer adds are exact below 2**24 counts per bin — far above
    any window's observation count — so plain addition preserves the
    bitwise-equality contract."""
    return torch.as_tensor(a) + torch.as_tensor(b)


# -- ulp distance (the budget's measuring stick) -------------------------------


def ulp_diff(a, b) -> np.ndarray:
    """Element-wise distance in float32 ulps between two arrays: the
    monotone integer reinterpretation of IEEE-754 makes |key(a) - key(b)|
    exactly the number of representable floats between them."""
    fa = np.asarray(a, np.float32)
    fb = np.asarray(b, np.float32)

    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, (1 << 31) - i, i)

    return np.abs(key(fa) - key(fb))
