"""Data grouping (§5.2): points sharing (quantized) mean/std fit once.

Port of ``repro.core.grouping``. Two layers:

* host Select — numpy copies of the reference's ``quantize_keys_host``,
  ``group_host``, ``padded_size`` and ``pad_representatives``: np.unique over
  a window's (P, 2) int64 keys, then the fit runs on one representative per
  group.
* device Select — the same keys and partition in torch on the window's
  device (``quantize_keys``, ``group_device``, ``compact_representatives``).
  CUDA has native float64 and int64, so the reference's x64-lanes machinery
  (hi/lo int32 key pairs) has no counterpart here: the keys are int64.

Key semantics are the reference's: ``rint(x / tol)`` in float64, with the
standard deviation taken as ``sqrt(max(var, 0))`` in float64. Every path
widens to float64 *before* the divide: a Python-float ``tol`` is a weak
scalar to both numpy (NEP 50) and torch, so ``mean_f32 / tol`` would divide
in float32 and alias means of ~3e3 at tol = 1e-6 onto float32's 2^24
integer grid.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_TOL = 1e-6


def quantize_keys_host(
    mean: np.ndarray,
    var: np.ndarray,
    tol: float = DEFAULT_TOL,
    out: np.ndarray | None = None,
    tmp: np.ndarray | None = None,
) -> np.ndarray:
    """Host Select-path quantization: (P,) mean/var -> (P, 2) int64 keys.
    ``out``/``tmp`` let callers reuse buffers (one allocation per window
    size on the executor's hot path)."""
    mean = np.asarray(mean)
    var = np.asarray(var)
    p = mean.shape[0]
    if out is None:
        out = np.empty((p, 2), dtype=np.int64)
    if tmp is None:
        tmp = np.empty((p,), dtype=np.float64)
    tmp[:] = mean  # exact f32 -> f64 widening, before the divide
    np.divide(tmp, tol, out=tmp)
    np.rint(tmp, out=tmp)
    out[:, 0] = tmp
    tmp[:] = var
    np.maximum(tmp, 0.0, out=tmp)
    np.sqrt(tmp, out=tmp)
    np.divide(tmp, tol, out=tmp)
    np.rint(tmp, out=tmp)
    out[:, 1] = tmp
    return out


def quantize_features_host(
    mean: np.ndarray, std: np.ndarray, tol: float = DEFAULT_TOL
) -> np.ndarray:
    """(P,) mean/std -> (P, 2) int64 keys, for callers that already hold the
    standard deviation (the sampling path). Widens to f64 before the divide."""
    mean = np.asarray(mean)
    std = np.asarray(std)
    out = np.empty((mean.shape[0], 2), dtype=np.int64)
    out[:, 0] = np.rint(mean.astype(np.float64) / tol)
    out[:, 1] = np.rint(std.astype(np.float64) / tol)
    return out


def keys_to_int64(keys: np.ndarray) -> np.ndarray:
    """(..., 2k) hi/lo int32 keys -> (..., k) int64 keys: the exact inverse
    of the reference's device key split, so keys from the reference's
    device Select compare with the port's."""
    k = np.asarray(keys)
    hi = k[..., 0::2].astype(np.int64)
    lo = k[..., 1::2].astype(np.int64) & 0xFFFFFFFF
    return (hi << 32) | lo


class HostGroups(NamedTuple):
    rep_indices: np.ndarray  # (G,) the lowest row index of each group
    inverse: np.ndarray  # (P,) group id of every point
    num_groups: int


def group_host(keys: np.ndarray) -> HostGroups:
    """Window-level dedup on the host. keys: (P, C) int. Groups come in the
    lexicographic order of their keys."""
    keys = np.asarray(keys)
    _, rep_indices, inverse = np.unique(
        keys, axis=0, return_index=True, return_inverse=True
    )
    return HostGroups(rep_indices.astype(np.int64), inverse.reshape(-1).astype(np.int64),
                      len(rep_indices))


def padded_size(num: int, bucket: int = 256) -> int:
    """Smallest ``bucket * 2^k`` >= num."""
    padded = bucket
    while padded < num:
        padded *= 2
    return padded


def pad_representatives(rep_indices: np.ndarray, bucket: int = 256) -> np.ndarray:
    """Pad the representative list to ``bucket * 2^k`` rows (padded slots
    repeat rep 0; their results are discarded). The reference pads to bound
    its jit cache; the port keeps the padding so the host Select path fits
    the same batches as the reference's."""
    g = len(rep_indices)
    out = np.full((padded_size(g, bucket),), rep_indices[0] if g else 0, dtype=np.int64)
    out[:g] = rep_indices
    return out


# -- device Select ------------------------------------------------------------


def quantize_keys(mean: torch.Tensor, var: torch.Tensor, tol: float = DEFAULT_TOL) -> torch.Tensor:
    """(P,) mean/var -> (P, 2) int64 keys on their device, bitwise equal to
    ``quantize_keys_host``: widened to float64 first, ``torch.round`` (half
    to even, as ``np.rint``; torch has no ``rint``), the std as the float64
    sqrt of the clamped variance."""
    mu = torch.round(mean.double() / tol)
    sig = torch.round(var.double().clamp_min(0.0).sqrt() / tol)
    return torch.stack([mu, sig], dim=-1).long()


class DeviceGroups(NamedTuple):
    """Every point's representative (the lowest row index holding its key)
    and the group counts, which the host needs for its bookkeeping.
    ``num_groups`` counts the groups of the whole table; after
    ``group_device_global`` the points are one shard's and
    ``num_groups_local`` counts the representatives among them (its
    ``is_rep.sum()``); on one device the two are equal."""

    rep_for_point: torch.Tensor  # (P,) int64
    is_rep: torch.Tensor  # (P,) bool
    num_groups: int
    num_groups_local: int


def group_device(keys: torch.Tensor) -> DeviceGroups:
    """Dedup of (P, C) integer keys on their device. ``torch.unique(dim=0)``
    sorts the keys as ``np.unique`` does; the representative of a group is
    its lowest row index (``np.unique``'s ``return_index``), found with an
    integer ``amin`` scatter, which is exact in any order. Rows with equal
    keys may differ in skew and kurtosis, so this choice is part of the
    result."""
    p = keys.shape[0]
    uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
    g = uniq.shape[0]
    idx = torch.arange(p, dtype=torch.int64, device=keys.device)
    first = torch.full((g,), p, dtype=torch.int64, device=keys.device)
    first.scatter_reduce_(0, inverse, idx, reduce="amin")
    rep_for_point = first[inverse]
    return DeviceGroups(rep_for_point, rep_for_point == idx, g, g)


def group_device_global(keys: torch.Tensor, group=None) -> DeviceGroups:
    """Global grouping across the ranks of ``group`` (default: the world):
    the paper's cross-node shuffle.

    Gathers every rank's (P_local, C) keys in rank order (the collective the
    roofline's collective term prices), dedups the gathered table with
    ``group_device``, and returns this rank's slice of it: each local
    point's *global* representative (a row index of the gathered table),
    its ``is_rep``, ``num_groups`` over the whole table and
    ``num_groups_local`` = this slice's ``is_rep.sum()``. Every rank holds
    the same number of points (a ``ShardedStager`` pads to that) and must
    call it. The reference gathers over each mesh axis in turn; a group
    over those axes in the same row-major order gathers the same table."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    p_local = keys.shape[0]
    parts = [torch.empty_like(keys) for _ in range(n)]
    dist.all_gather(parts, keys.contiguous(), group=group)
    groups = group_device(torch.cat(parts))
    start = dist.get_rank(group) * p_local
    local_rep = groups.rep_for_point[start:start + p_local]
    local_is_rep = groups.is_rep[start:start + p_local]
    num_local = local_is_rep.sum()  # a 0-d tensor on meta, where nothing is counted
    return DeviceGroups(local_rep, local_is_rep, groups.num_groups,
                        num_local if num_local.is_meta else int(num_local))


def compact_representatives(
    rep_for_point: torch.Tensor, is_rep: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """A device partition -> ``(gather_idx (G,), point_slot (P,))``:
    ``gather_idx`` lists the representatives' row indices in ascending
    order and ``point_slot`` maps every point to its representative's slot.
    Exactly G rows: PyTorch runs eagerly, so there is no static batch size
    to pad to."""
    gather_idx = torch.nonzero(is_rep).reshape(-1)
    rep_rank = torch.cumsum(is_rep.to(torch.int64), dim=0) - 1
    return gather_idx, rep_rank[rep_for_point]


def scatter_group_results(rep_results: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """Representative results (G, ...) + inverse (P,) -> per-point (P, ...)."""
    return rep_results[inverse]
