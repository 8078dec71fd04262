"""Incremental recompute across appends: merge-mode window updates.

Port of ``repro.streaming.incremental``. Two update modes
(``StreamSpec.update_mode``) govern what happens to a slice whose chunks
changed in an append:

* ``"strict"`` — the session recomputes affected slices in full through the
  normal executor: bitwise-identical to a from-scratch run on the appended
  cube, by construction. This module is not involved.
* ``"merge"`` (the default) — each affected window re-fits from *merged*
  sufficient statistics: the persisted sidecar (streaming/stats.py) carries
  the old partition's stats and Eq.-5 counts, the append's new realizations
  are read alone (O(new data)), and the Chan/Pébay merge plus an exact
  integer histogram merge reconstruct the appended window without re-reading
  its history. Merged histograms are bitwise-equal to a full recompute;
  merged moments are within ``MERGE_ULP_BUDGET`` float32 ulps of it — the
  updated watermark records that tolerance (``merge_ulp_budget``), which is
  exactly why merge-mode results never enter the ``ResultCache`` (the cache
  serves only bitwise-reproducible entries).

On the device: the new partition's counts over the OLD edges are K4
(``kernels/hist/kernel.py::hist_counts``), one launch a window, and the
refit from statistics (``refit_from_stats``: ``fit_all``, the edges, the CDF
masses, the Eq.-5 error from the counts and the argmin) is plain PyTorch on
the session's device — the reference computes it in jnp outside any Pallas
kernel, and K2 takes values, not counts. A merge launches no K1 and no K2.

The merge is refused — per slice, falling back to a full recompute — when
its preconditions do not hold: no out_dir or no complete prior run, a
missing/foreign/mis-windowed sidecar, a bin-count mismatch, no new
observations, or new values outside a point's old ``[vmin, vmax]`` (the
Eq.-5 edges move, so old counts are not reusable).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import distributions as dists
from repro_torch.core import fitting
from repro_torch.core import pdf_error as pe
from repro_torch.core import regions
from repro_torch.core.executor import _FIELDS, PersistStage, SliceResult
from repro_torch.streaming import stats as sstats
from repro_torch.streaming.moments import (
    MERGE_ULP_BUDGET,
    SuffStats,
    merge_counts,
    merge_suffstats,
    moments_from_suffstats,
    suffstats_from_values,
)


@dataclass
class MergedWindow:
    window: regions.Window
    arrays: dict  # _FIELDS name -> (P,) / (P, 3) numpy
    stats: SuffStats
    freq: np.ndarray  # int64 (P, L)


def refit_from_stats(types, num_bins: int, moments: dists.Moments,
                     freq: np.ndarray, device: torch.device | str):
    """Algorithm 3 (fit every candidate, select by Eq.-5 error) driven from
    statistics alone — no raw values — on ``device``. The fused-mode chain
    with the histogram of the values replaced by the merged counts;
    everything downstream is the same code. Returns numpy
    ``(type_idx, params, error)``."""
    mom = dists.Moments(*(torch.as_tensor(np.asarray(f, np.float32), device=device)
                          for f in moments))
    params_all = dists.fit_all(types, mom)
    edges = pe.interval_edges(mom.vmin, mom.vmax, num_bins)
    masses = pe.cdf_masses(types, params_all, edges)
    errs = pe.pdf_error_from_freq(
        torch.as_tensor(np.asarray(freq, np.float32), device=device), masses)
    res = fitting.select_best(params_all, errs)
    return (res.type_idx.cpu().numpy(), res.params.cpu().numpy(),
            res.error.cpu().numpy())


def merge_window(spec, source, w: regions.Window, old: dict,
                 device: torch.device | str) -> MergedWindow | None:
    """Merge one window forward over an append, or None when a merge
    precondition fails (see module docstring). ``old`` is the window's
    sidecar dict from ``stats.load_stats``."""
    num_bins = spec.compute.num_bins
    if old["num_bins"] != num_bins:
        return None
    n_old = int(old["stats"].n)
    n_now = source.slice_observations(w.slice_i)
    if n_now <= n_old:
        return None  # nothing appended since the sidecar was recorded
    new_vals = source.load_window_obs(w, n_old, n_now)  # (P, k) float32
    new_stats = suffstats_from_values(new_vals)
    merged = merge_suffstats(old["stats"], new_stats)
    if not (np.array_equal(merged.vmin, old["stats"].vmin)
            and np.array_equal(merged.vmax, old["stats"].vmax)):
        return None  # edges moved: old Eq.-5 counts are not reusable
    # Exact histogram merge: bin the new partition over the OLD edges (K4,
    # float32 bins) and add integers — bitwise-equal to a one-pass histogram
    # of the full window, since counts are order-free integer sums (< 2**24).
    vals = torch.from_numpy(np.ascontiguousarray(new_vals, np.float32)).to(device)
    vmin32 = torch.from_numpy(np.asarray(old["stats"].vmin, np.float32)).to(device)
    vmax32 = torch.from_numpy(np.asarray(old["stats"].vmax, np.float32)).to(device)
    new_freq = sstats.window_counts(vals, vmin32, vmax32, num_bins)
    freq = merge_counts(old["freq"], new_freq)
    mom = moments_from_suffstats(merged, np.float32)
    type_idx, params, error = refit_from_stats(
        tuple(spec.compute.types), num_bins, mom, freq, device)
    arrays = {
        "type_idx": type_idx.astype(np.int32),
        "params": params,
        "error": error,
        "mean": np.asarray(mom.mean, np.float32),
        "std": np.sqrt(np.maximum(np.asarray(mom.var, np.float32), 0)),
        "skew": np.asarray(mom.skew, np.float32),
        "kurt": np.asarray(mom.kurt, np.float32),
    }
    return MergedWindow(w, arrays, merged, freq)


def merge_slice(spec, source, slice_i: int, new_hash: str,
                lineage: tuple[str, ...] = (),
                device: torch.device | str = "cuda") -> SliceResult | None:
    """Merge every window of one appended slice forward on ``device``,
    atomically from the caller's point of view: windows/sidecars/watermark
    are rewritten only after ALL windows merged (any failure returns None
    with the out_dir untouched, and the caller falls back to a full
    recompute). None too in strict mode, without an out_dir, or for a
    source that is not a file cube (no ``load_window_obs``).

    The out_dir must hold the previous run's windows + stats sidecars; the
    watermark's recorded spec hash identifies that run, and sidecars are
    validated against it OR against ``lineage`` — the spec's hashes at
    archived manifest versions (a cache-hit persist re-stamps the watermark
    without rewriting the sidecars, and the merge reads everything past the
    sidecar's own ``n``, so an ancestor's stamp is sound merge input). The
    updated watermark carries ``new_hash`` plus the merge tolerance:
    ``{"merge_ulp_budget": MERGE_ULP_BUDGET, "merged_from": <old hash>}``."""
    out_dir = spec.execution.out_dir
    if (spec.stream.update_mode != "merge" or out_dir is None
            or not hasattr(source, "load_window_obs")):
        return None
    geom = source.geometry
    persist = PersistStage(out_dir, async_writes=False, spec_hash=new_hash)
    info = persist.watermark_info(slice_i)
    old_hash = info.get("spec_hash")
    if not old_hash or int(info.get("next_line", 0)) < geom.lines_per_slice:
        return None  # no complete prior run to merge forward
    merged: list[MergedWindow] = []
    for w in regions.iter_windows(geom, slice_i, spec.compute.window_lines):
        old = sstats.load_stats(out_dir, slice_i, w.line_start,
                                spec_hash=(old_hash, *lineage))
        if old is None or (old["line_start"], old["line_end"]) != \
                (w.line_start, w.line_end):
            return None  # sidecar missing/foreign/mis-windowed
        mw = merge_window(spec, source, w, old, device)
        if mw is None:
            return None
        merged.append(mw)
    # Commit: window .npz + sidecars first, tolerance-stamped watermark last
    # (the same durable-then-advance order the persist stage uses).
    for mw in merged:
        persist.submit(slice_i, mw.window, mw.arrays)
        sstats.write_stats(out_dir, slice_i, mw.window.line_start,
                           mw.window.line_end, mw.stats, mw.freq,
                           spec.compute.num_bins, new_hash)
    persist.close()
    persist.raise_if_failed()
    mark = Path(out_dir) / f"slice{slice_i}_watermark.json"
    mark.write_text(json.dumps({
        "next_line": geom.lines_per_slice,
        "spec_hash": new_hash,
        "merge_ulp_budget": MERGE_ULP_BUDGET,
        "merged_from": old_hash,
    }))
    outs = {name: np.concatenate([mw.arrays[name] for mw in merged])
            for name in _FIELDS}
    return SliceResult(
        *(outs[name] for name in _FIELDS),
        avg_error=float(outs["error"].mean()),
        stats=[], slice_i=slice_i, spec_hash=new_hash,
    )
