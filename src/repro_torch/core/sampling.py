"""Sampling (§5.4, Algorithm 5): fast slice features from a fraction of points.

Port of ``repro.core.sampling``. Estimates a slice's features — average
mean, average std, distribution-type percentages — by sampling points,
computing their moments, optionally grouping, and classifying types with
the decision tree (no Eq.-5 fitting at all).

Both samplers of the paper: random (the recommended one) and k-means (Lloyd
with a fixed iteration count on (mu, sigma); the point closest to each
centroid becomes a "double sampled" point). Both are numpy with
``default_rng``, copied from the reference, so they draw the same indices;
the classification runs the port's ``predict`` on the host, as the
reference classifies on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import grouping as grp
from repro_torch.core import ml_predict as mlp


class SliceFeatures(NamedTuple):
    avg_mean: float
    avg_std: float
    type_percentage: np.ndarray  # (T,) fractions summing to ~1
    num_sampled: int


def sample_indices_random(
    num_points: int, rate: float, seed: int = 0
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = max(1, int(round(num_points * rate)))
    return np.sort(rng.choice(num_points, size=k, replace=False))


def _assign_chunked(
    features: np.ndarray, centers: np.ndarray, scratch_floats: int = 1 << 22
) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-centroid assignment without materializing the (P, k) distance
    matrix: points go in chunks sized so the scratch, the (chunk, k,
    n_features) broadcast temporary included, stays at ~``scratch_floats``
    floats whatever P is. Returns the assignment and each point's squared
    distance to its own centroid."""
    p, k = len(features), len(centers)
    chunk = max(1, scratch_floats // max(k * features.shape[-1], 1))
    assign = np.empty(p, dtype=np.int64)
    d2_own = np.empty(p, dtype=np.float64)
    for lo in range(0, p, chunk):
        block = features[lo : lo + chunk]
        d2 = ((block[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        a = d2.argmin(axis=1)
        assign[lo : lo + chunk] = a
        d2_own[lo : lo + chunk] = d2[np.arange(len(block)), a]
    return assign, d2_own


def sample_indices_kmeans(
    features: np.ndarray, rate: float, iters: int = 10, seed: int = 0
) -> np.ndarray:
    """k-means 'double sampling': k = rate * P clusters on (mu, sigma); the
    member closest to each centroid is selected. Fixed Lloyd iterations."""
    rng = np.random.default_rng(seed)
    p = len(features)
    k = max(1, int(round(p * rate)))
    centers = features[rng.choice(p, size=k, replace=False)].astype(np.float64)
    for _ in range(iters):
        assign, _ = _assign_chunked(features, centers)
        sums = np.zeros_like(centers)
        np.add.at(sums, assign, features)
        counts = np.bincount(assign, minlength=k)
        occupied = counts > 0
        centers[occupied] = sums[occupied] / counts[occupied, None]
    assign, d2_own = _assign_chunked(features, centers)
    # closest member per occupied cluster: a stable sort by (cluster,
    # distance) puts each cluster's argmin first in its run (ties keep the
    # original order, as argmin does).
    order = np.lexsort((d2_own, assign))
    first = np.ones(len(order), dtype=bool)
    first[1:] = assign[order[1:]] != assign[order[:-1]]
    return np.sort(np.unique(order[first].astype(np.int64)))


def _predict_host(tree: mlp.DecisionTree, feats: np.ndarray) -> np.ndarray:
    """The tree's classes for host float32 features, as int32."""
    pred = mlp.predict(tree.as_device("cpu"), torch.from_numpy(np.ascontiguousarray(feats)))
    return pred.numpy().astype(np.int32)


def predict_types(
    mean: np.ndarray,
    std: np.ndarray,
    tree: mlp.DecisionTree,
    group_first: bool = True,
    group_tol: float = grp.DEFAULT_TOL,
    skew: np.ndarray | None = None,
    kurt: np.ndarray | None = None,
) -> np.ndarray:
    """Algorithm 5 lines 15-24: (optionally) group, then tree-classify;
    returns the per-point type prediction (grouped predictions expanded back
    through the inverse map, so the output is always (P,)).

    ``skew``/``kurt`` extend the features when the tree was trained on the
    scale-invariant set (``ml_predict.TREE_FEATURES``); without them the
    features are the paper's (mean, std)."""
    if skew is not None:
        feats = mlp.tree_features_np(mean, std, skew,
                                     kurt if kurt is not None else np.zeros_like(skew))
    else:
        feats = np.stack([mean, std], axis=-1).astype(np.float32)
    if group_first:
        keys = grp.quantize_features_host(mean, std, group_tol)
        groups = grp.group_host(keys)
        return _predict_host(tree, feats[groups.rep_indices])[groups.inverse]
    return _predict_host(tree, feats)


def slice_features_from_moments(
    mean: np.ndarray,
    std: np.ndarray,
    tree: mlp.DecisionTree,
    types: Sequence[str],
    group_first: bool = True,
    group_tol: float = grp.DEFAULT_TOL,
    skew: np.ndarray | None = None,
    kurt: np.ndarray | None = None,
) -> SliceFeatures:
    """Algorithm 5 lines 15-26: classify (``predict_types``) and aggregate.
    The type percentages are over points (grouped predictions expanded), the
    paper's per-point definition."""
    pred = predict_types(mean, std, tree, group_first=group_first,
                         group_tol=group_tol, skew=skew, kurt=kurt)
    pct = np.bincount(pred, minlength=len(types)).astype(np.float64) / len(pred)
    return SliceFeatures(float(mean.mean()), float(std.mean()), pct, len(mean))


def type_percentage_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Fig. 17's Euclidean distance between type-percentage vectors."""
    return float(np.sqrt(((a - b) ** 2).sum()))
