"""ML prediction (§5.3): decision-tree classification of distribution types.

Port of ``repro.core.ml_predict``. The paper trains a decision tree on
previously generated output data and uses it to skip Algorithm 3's
try-all-types loop. Here:

* ``train_tree``, ``model_error`` and ``tune_hyperparameters`` — host
  numpy copies of the reference's CART/Gini trainer over ``max_bins``
  quantile candidate splits and its §5.3.1 grid search: the same trees
  from the same data, bit for bit.
* ``DecisionTree`` — a complete binary tree in array form (feature and
  threshold per internal node, label per leaf; early leaves expanded
  downward), so ``predict`` is a fixed ``depth``-step descent in torch on
  the features' device.
* ``tree_features`` / ``tree_features_np`` — the tree's inputs: the
  scale-invariant moments (cv = sigma / |mu|, skew, excess kurtosis) as
  float32, on the device and on the host.
* ``feature_tolerance`` / ``reachable_leaves`` — which leaves a point can
  reach when its moments move within a tolerance: the tree-margin rule
  that holds predicted types of two moment formulas to each other.

The tree is the pipeline's "weights": ``interop.tree_from_numpy`` carries
one the reference trained into the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.distributions import Moments

# Tree features: scale-invariant moments, so a tree transfers across slices
# whose value scales differ.
TREE_FEATURES = ("cv", "skew", "kurt")


def tree_features(moments: Moments) -> torch.Tensor:
    """(P,) moments -> (P, 3) float32 features on their device, bitwise
    equal to ``tree_features_np`` on the same moments. The standard
    deviation is rounded once from float64 (exactly the correctly rounded
    float32 root): PyTorch's float32 ``sqrt`` on the CPU is off by an ulp
    now and then, numpy's and CUDA's are not."""
    std = torch.sqrt(torch.clamp(moments.var, min=0.0).double()).float()
    cv = std / torch.clamp(moments.mean.abs(), min=1e-12)
    return torch.stack([cv, moments.skew, moments.kurt], dim=-1)


def tree_features_np(mean, std, skew, kurt) -> np.ndarray:
    """Host ``tree_features`` from per-point arrays -> (P, 3) float32."""
    cv = std / np.maximum(np.abs(mean), 1e-12)
    return np.stack([cv, skew, kurt], axis=-1).astype(np.float32)


@dataclass(frozen=True)
class DecisionTree:
    """Complete binary tree of given depth in array form.

    feature[i], threshold[i] for internal nodes i in [0, 2^depth - 1);
    leaf_label[j] for leaves j in [0, 2^depth). Descent: go left iff
    x[feature] <= threshold.
    """

    depth: int
    feature: np.ndarray  # (2^depth - 1,) int32
    threshold: np.ndarray  # (2^depth - 1,) float32
    leaf_label: np.ndarray  # (2^depth,) int32

    def as_device(self, device: torch.device | str):
        """(feature int64, threshold float32, leaf_label int64) on ``device``."""
        return (
            torch.as_tensor(self.feature, dtype=torch.int64, device=device),
            torch.as_tensor(self.threshold, dtype=torch.float32, device=device),
            torch.as_tensor(self.leaf_label, dtype=torch.int64, device=device),
        )


def predict(tree_arrays, features: torch.Tensor) -> torch.Tensor:
    """features (..., F) float32 -> (...,) int64 predicted class, on the
    features' device. Fixed-depth descent: go left iff ``x <= t``, so a NaN
    feature goes right and an ``inf`` threshold (an early leaf) sends every
    other value left."""
    feat, thr, leaf = tree_arrays
    depth = int(np.log2(leaf.shape[0]) + 0.5)
    node = torch.zeros(features.shape[:-1], dtype=torch.int64, device=features.device)
    for _ in range(depth):
        x = torch.take_along_dim(features, feat[node][..., None], dim=-1)[..., 0]
        node = torch.where(x <= thr[node], 2 * node + 1, 2 * node + 2)
    return leaf[node - (leaf.shape[0] - 1)]


def feature_tolerance(mean, std, skew, kurt, rtol: float, atol: float) -> np.ndarray:
    """(P, 3) how far each point's (cv, skew, kurt) may move when mean,
    std, skew and kurt may each move by ``atol + rtol * |x|`` (two moment
    formulas, or two packages, agree that far). cv = std / |mean| carries
    both relative errors: with r_s = rtol + atol / std and r_m = rtol +
    atol / |mean|, cv moves by at most cv (r_s + r_m) / (1 - r_m)."""
    mean, std = np.abs(np.asarray(mean, np.float64)), np.asarray(std, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        r_s, r_m = rtol + atol / std, rtol + atol / mean
        cv = std / np.maximum(mean, 1e-12)
        tol_cv = np.where(r_m < 1, cv * (r_s + r_m) / (1 - r_m), np.inf)
    return np.stack([tol_cv, atol + rtol * np.abs(skew), atol + rtol * np.abs(kurt)], axis=-1)


def reachable_leaves(tree: DecisionTree, features: np.ndarray, tol: np.ndarray) -> np.ndarray:
    """(P, 2^depth) bool: the leaves each point may reach when each of its
    features may move by ``tol`` (P, F): both children of a node whose
    threshold lies within the tolerance of the point's feature. A point
    that reaches one leaf has a type no such move can change."""
    n_internal = 2**tree.depth - 1
    reach = np.zeros((len(features), 2 * n_internal + 1), dtype=bool)
    reach[:, 0] = True
    for node in range(n_internal):
        f, t = tree.feature[node], tree.threshold[node]
        x = np.asarray(features[:, f], np.float64)
        with np.errstate(invalid="ignore"):
            near = np.abs(x - t) <= tol[:, f]
        left = x <= t
        reach[:, 2 * node + 1] |= reach[:, node] & (left | near)
        reach[:, 2 * node + 2] |= reach[:, node] & (~left | near)
    return reach[:, n_internal:]


def _gini_split(labels: np.ndarray, num_classes: int, left_mask: np.ndarray) -> float:
    def gini(sub):
        if len(sub) == 0:
            return 0.0
        counts = np.bincount(sub, minlength=num_classes).astype(np.float64)
        p = counts / len(sub)
        return 1.0 - np.sum(p * p)

    n = len(labels)
    nl = left_mask.sum()
    return (nl / n) * gini(labels[left_mask]) + ((n - nl) / n) * gini(labels[~left_mask])


def train_tree(
    features: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    depth: int = 4,
    max_bins: int = 32,
) -> DecisionTree:
    """Greedy CART with Gini impurity over maxBins quantile candidate splits."""
    features = np.asarray(features, dtype=np.float32)
    labels = np.asarray(labels, dtype=np.int32)
    n, num_feat = features.shape

    n_internal = 2**depth - 1
    feat_arr = np.zeros((n_internal,), dtype=np.int32)
    thr_arr = np.full((n_internal,), np.inf, dtype=np.float32)  # inf => always left
    leaf_arr = np.zeros((2**depth,), dtype=np.int32)

    def majority(idx):
        if len(idx) == 0:
            return 0
        return int(np.bincount(labels[idx], minlength=num_classes).argmax())

    # node -> sample indices, built level by level.
    assignments = {0: np.arange(n)}
    for node in range(n_internal):
        idx = assignments.pop(node, np.empty((0,), dtype=np.int64))
        left_child, right_child = 2 * node + 1, 2 * node + 2
        best = None
        if len(idx) > 1 and len(np.unique(labels[idx])) > 1:
            sub_x, sub_y = features[idx], labels[idx]
            for f in range(num_feat):
                col = sub_x[:, f]
                qs = np.unique(
                    np.quantile(col, np.linspace(0, 1, min(max_bins, len(col)) + 1)[1:-1])
                )
                for t in qs:
                    lm = col <= t
                    if lm.all() or not lm.any():
                        continue
                    g = _gini_split(sub_y, num_classes, lm)
                    if best is None or g < best[0]:
                        best = (g, f, t, lm)
        if best is None:
            # Early leaf: expand downward (always-left path carries the label).
            feat_arr[node] = 0
            thr_arr[node] = np.inf
            assignments[left_child] = idx
            assignments[right_child] = np.empty((0,), dtype=np.int64)
        else:
            _, f, t, lm = best
            feat_arr[node] = f
            thr_arr[node] = t
            assignments[left_child] = idx[lm]
            assignments[right_child] = idx[~lm]

    # Leaves: majority label; empty leaves inherit from sibling/parent path.
    first_leaf = n_internal
    global_major = majority(np.arange(n))
    for j in range(2**depth):
        idx = assignments.get(first_leaf + j, np.empty((0,), dtype=np.int64))
        leaf_arr[j] = majority(idx) if len(idx) else global_major

    # Fix empty leaves under early-leaf chains: propagate the left sibling.
    for j in range(2**depth):
        node_idx = first_leaf + j
        if len(assignments.get(node_idx, ())) == 0 and j % 2 == 1:
            leaf_arr[j] = leaf_arr[j - 1]

    return DecisionTree(depth, feat_arr, thr_arr, leaf_arr)


def model_error(tree: DecisionTree, features: np.ndarray, labels: np.ndarray) -> float:
    """Wrong-prediction rate (the paper's 'model error'), predicted on the
    host in float32 as the reference predicts it."""
    x = torch.from_numpy(np.asarray(features, dtype=np.float32))
    pred = predict(tree.as_device("cpu"), x).numpy()
    return float(np.mean(pred != labels))


def tune_hyperparameters(
    features: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    depths: Sequence[int] = (2, 3, 4, 5, 6),
    bins: Sequence[int] = (8, 16, 32, 64),
    val_fraction: float = 0.3,
    seed: int = 0,
) -> tuple[int, int, float]:
    """§5.3.1: pick the smallest (depth, maxBins) past which validation error
    stops decreasing. Returns (depth, max_bins, best_val_error)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(labels))
    n_val = int(len(labels) * val_fraction)
    va, tr = perm[:n_val], perm[n_val:]

    best = (depths[0], bins[0], 1.0)
    for d in depths:
        for b in bins:
            tree = train_tree(features[tr], labels[tr], num_classes, d, b)
            err = model_error(tree, features[va], labels[va])
            # Strict improvement keeps the minimal hyper-parameters (paper:
            # "choose the minimum values from which the error does not
            # decrease when they increase").
            if err < best[2] - 1e-9:
                best = (d, b, err)
    return best
