"""Streaming ingestion: append-able cubes, merge-able statistics,
chunk-granular incremental recompute (DESIGN.md §16) — port of
``repro.streaming``.

The subsystem spans four layers:

* data — ``append_realizations`` extends an exported cube with a versioned
  manifest delta; ``FileCubeSource`` opens any version and
  ``file_source.chunk_diff`` reports what an append touched;
* core — ``moments`` carries the Chan/Pébay sufficient-statistic merges and
  exact histogram merges, wired through the ``fit_backend`` registry (the
  host pair for ``reference``, the torch pair for ``kernels``/``fused``);
  ``stats.StatsRecorder`` persists per-window statistics sidecars, their
  counts from K4;
* api — ``PDFSession`` adopts cached slices whose chunk fingerprints are
  unchanged (``ResultCache.adopt``) and routes appended slices through
  ``incremental.merge_slice`` (or a strict full recompute);
* serve/launch — ``PDFServer.invalidate`` and ``run_pdf --watch`` pick up
  appends without a restart.
"""

from repro_torch.streaming.append import append_realizations
from repro_torch.streaming.incremental import merge_slice, refit_from_stats
from repro_torch.streaming.moments import (
    MERGE_ULP_BUDGET,
    SuffStats,
    empty_suffstats,
    merge_counts,
    merge_counts_torch,
    merge_suffstats,
    merge_suffstats_torch,
    moments_from_suffstats,
    suffstats_from_moments,
    suffstats_from_values,
    ulp_diff,
)
from repro_torch.streaming.stats import StatsRecorder, load_stats

__all__ = [
    "MERGE_ULP_BUDGET",
    "StatsRecorder",
    "SuffStats",
    "append_realizations",
    "empty_suffstats",
    "load_stats",
    "merge_counts",
    "merge_counts_torch",
    "merge_slice",
    "merge_suffstats",
    "merge_suffstats_torch",
    "moments_from_suffstats",
    "refit_from_stats",
    "suffstats_from_moments",
    "suffstats_from_values",
    "ulp_diff",
]
