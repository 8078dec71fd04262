"""Per-window sufficient-statistic sidecars: the merge path's persistence.

Port of ``repro.streaming.stats``. ``StatsRecorder`` is the
``StagedExecutor(stats_recorder=...)`` hook: for every full (non-sampled)
window it records the staged values' statistics after the moments and
before the fit, and writes one sidecar next to the window's persisted
``.npz``:

    out_dir/slice{N}_stats_{line:05d}.npz
        spec_hash, line_start, line_end, n, num_bins,
        mean, s2, s3, s4, vmin, vmax      # float64 SuffStats per point
        freq                              # int64 Eq.-5 counts per point

The keys, dtypes and values are the reference's, so a sidecar written by
either package loads in the other. The counts are K4
(``kernels/hist/kernel.py::hist_counts``) over the window's (vmin, vmax)
edges: on a CUDA tensor the kernel, on a CPU tensor its plain version
(``pdf_error.histogram_scatter``) — exact integers either way, so
``merge_counts`` stays bitwise. The statistics are the reference's float64
host code (``suffstats_from_values``) on the window's float32 values, NOT
inverted from the finalized float32 moments, so the old side of a later
merge carries no finalization round-trip error; same code, same bytes, so
the port's sidecars equal the reference's bitwise. The recorder runs that
code on blocks of rows in a few threads (numpy releases the GIL): every
statistic is a reduction along a row, so a block's rows get the bits the
whole window's would.

Writes are tmp + atomic rename: a crashed write leaves no half-sidecar, and
a missing/stale sidecar only costs the merge path a full-recompute fallback
for that window — never correctness.
"""

from __future__ import annotations

import os
import tempfile
import time
import zipfile
from concurrent import futures
from pathlib import Path

import numpy as np
import torch

from repro_torch.streaming.moments import SuffStats, suffstats_from_values

_STAT_FIELDS = ("mean", "s2", "s3", "s4", "vmin", "vmax")


def stats_path(out_dir: str | Path, slice_i: int, line_start: int) -> Path:
    return Path(out_dir) / f"slice{slice_i}_stats_{line_start:05d}.npz"


def window_counts(values: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor,
                  num_bins: int) -> np.ndarray:
    """Eq.-5 counts of (P, n) float32 ``values`` over (vmin, vmax) as int64
    on the host: K4 on the values' device (its plain version on the CPU)."""
    from repro_torch.kernels.hist.kernel import hist_counts

    counts = hist_counts(values, vmin.to(torch.float32).contiguous(),
                         vmax.to(torch.float32).contiguous(), num_bins)
    return np.rint(counts.cpu().numpy()).astype(np.int64)


# The recorder's row blocks: at most 8 (one a thread), none under 256 rows.
_BLOCKS = 8
_MIN_BLOCK_ROWS = 256


def host_suffstats(host: np.ndarray, pool: futures.Executor | None = None) -> SuffStats:
    """``suffstats_from_values`` of a (P, n) window, row blocks mapped over
    ``pool`` when one is given: bitwise the one-call result."""
    if pool is None or len(host) < 2 * _MIN_BLOCK_ROWS:
        return suffstats_from_values(host)
    step = max(_MIN_BLOCK_ROWS, -(-len(host) // _BLOCKS))
    parts = list(pool.map(suffstats_from_values,
                          [host[i:i + step] for i in range(0, len(host), step)]))
    return SuffStats(parts[0].n, *(np.concatenate([getattr(p, f) for p in parts])
                                   for f in SuffStats._fields[1:]))


class StatsRecorder:
    """Callable hook ``(window, values, moments, host=None) -> None``
    writing one sidecar per window. ``values`` is the staged (P, n) float32
    tensor, ready on the caller's stream; ``host``, when given, is the same
    window as the numpy array the loader staged it from (the statistics are
    computed there, sparing a device-to-host copy of the window), else the
    values are copied to the host. Runs on the executor's compute thread;
    ``seconds`` totals its time, ``windows_recorded`` its windows."""

    def __init__(self, out_dir: str | Path, num_bins: int,
                 spec_hash: str | None = None):
        self.out_dir = Path(out_dir)
        self.num_bins = int(num_bins)
        self.spec_hash = spec_hash
        self.windows_recorded = 0
        self.seconds = 0.0

    def __call__(self, w, values: torch.Tensor, moments,
                 host: np.ndarray | None = None) -> None:
        t0 = time.perf_counter()
        freq = window_counts(values, moments.vmin, moments.vmax, self.num_bins)
        if host is None:
            host = values.cpu().numpy()
        with futures.ThreadPoolExecutor(min(_BLOCKS, os.cpu_count() or 1)) as pool:
            s = host_suffstats(np.asarray(host, np.float32), pool)
        write_stats(self.out_dir, w.slice_i, w.line_start, w.line_end,
                    s, freq, self.num_bins, self.spec_hash)
        self.windows_recorded += 1
        self.seconds += time.perf_counter() - t0


def write_stats(out_dir: str | Path, slice_i: int, line_start: int,
                line_end: int, s: SuffStats, freq: np.ndarray,
                num_bins: int, spec_hash: str | None) -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    f = stats_path(out, slice_i, line_start)
    fd, tmp = tempfile.mkstemp(dir=out, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez(
                fh,
                spec_hash=spec_hash or "",
                line_start=line_start, line_end=line_end,
                n=float(s.n), num_bins=num_bins, freq=freq,
                **{name: np.asarray(getattr(s, name), np.float64)
                   for name in _STAT_FIELDS},
            )
        os.replace(tmp, f)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_stats(out_dir: str | Path, slice_i: int, line_start: int,
               spec_hash=None) -> dict | None:
    """One window's sidecar as ``{"stats": SuffStats, "freq": int64 array,
    "num_bins": int, "line_start"/"line_end": int}`` — or None when the
    sidecar is missing, unreadable, or (when ``spec_hash`` is given) was
    written under a different spec. ``spec_hash`` may be one hash or a
    collection of acceptable hashes (the spec's manifest-version lineage —
    see ``incremental.merge_slice``). None always means "fall back to a
    full recompute of this window"."""
    f = stats_path(out_dir, slice_i, line_start)
    accept = ({spec_hash} if isinstance(spec_hash, str)
              else set(spec_hash or ()))
    try:
        with np.load(f) as z:
            if accept and str(z["spec_hash"]) not in accept | {""}:
                return None
            return {
                "stats": SuffStats(float(z["n"]),
                                   *(z[name] for name in _STAT_FIELDS)),
                "freq": np.asarray(z["freq"], np.int64),
                "num_bins": int(z["num_bins"]),
                "line_start": int(z["line_start"]),
                "line_end": int(z["line_end"]),
            }
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None
