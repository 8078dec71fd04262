"""Staged PDF executor: load / compute / persist as decoupled stages.

Port of ``repro.core.executor`` for the baseline method:

  load stage     ``WindowPrefetcher`` (data/loader.py) loads window *k+1* from
                 the data source and copies it to the device while the device
                 is still fitting window *k*.
  compute stage  the main thread: moments, then Algorithm 3 over the window
                 on the device — identical operations, in identical order,
                 with prefetch on or off, so results are bitwise equal.
  persist stage  a single writer thread appends per-window ``.npz`` files and
                 the watermark off the critical path, in submission order;
                 ``close()`` flushes before the executor returns or re-raises.

The ``.npz`` and watermark format is the reference's. Not ported yet: the
other methods (grouping, reuse, ML, sampling; ROADMAP queue 1 items 6-8),
device Select (item 6), and retry, speculation and quarantine (item 12) —
a load error propagates to the caller.
"""

from __future__ import annotations

import functools
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import distributions as dists
from repro_torch.core import fitting
from repro_torch.core import regions
from repro_torch.data.loader import WindowPrefetcher

METHODS = (
    "baseline", "grouping", "reuse", "ml", "grouping_ml", "reuse_ml", "sampling",
)
SAMPLERS = ("random", "kmeans")
SELECT_BACKENDS = ("host", "device")

# repro.core.grouping.DEFAULT_TOL: the (mu, sigma) quantum of the grouping
# methods, carried so a reference PDFConfig converts field for field.
DEFAULT_TOL = 1e-6

# Where each method that this executor does not run yet is to come from.
_NOT_PORTED = {
    "grouping": "ROADMAP queue 1 item 6 (grouping and reuse)",
    "reuse": "ROADMAP queue 1 item 6 (grouping and reuse)",
    "ml": "ROADMAP queue 1 item 7 (ML prediction)",
    "grouping_ml": "ROADMAP queue 1 items 6-7 (grouping, ML prediction)",
    "reuse_ml": "ROADMAP queue 1 items 6-7 (reuse, ML prediction)",
    "sampling": "ROADMAP queue 1 item 8 (sampling)",
}


@dataclass(frozen=True)
class PDFConfig:
    types: tuple[str, ...] = dists.TYPES_4
    num_bins: int = 64
    window_lines: int = 25
    method: str = "baseline"
    mode: str = "fused"  # 'faithful' reproduces the paper's per-type pass cost
    group_tol: float = DEFAULT_TOL
    rep_bucket: int = 256  # padding bucket for representative batches
    error_bound: float | None = None  # the paper's bounded-error constraint
    # Device-work implementation (fitting.FIT_BACKENDS): 'reference' (plain
    # torch chain), 'kernels' (not ported), 'fused' (the two CUDA kernels of
    # kernels/fitpdf — the default hot path).
    fit_backend: str = "fused"
    select_backend: str = "host"
    # method='sampling' (§5.4) knobs, carried for the reference's field set.
    sample_frac: float = 0.1
    sampler: str = "random"
    kmeans_iters: int = 10
    sample_seed: int = 0

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {self.method!r}")
        if self.num_bins < 2:
            raise ValueError(f"num_bins must be >= 2, got {self.num_bins}")
        if self.window_lines < 1:
            raise ValueError(f"window_lines must be >= 1, got {self.window_lines}")
        if self.error_bound is not None and not self.error_bound > 0:
            raise ValueError(
                f"error_bound must be > 0 (or None), got {self.error_bound}")
        if not 0 < self.sample_frac <= 1:
            raise ValueError(f"sample_frac must be in (0, 1], got {self.sample_frac}")
        if self.sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, got {self.sampler!r}")
        if self.kmeans_iters < 1:
            raise ValueError(f"kmeans_iters must be >= 1, got {self.kmeans_iters}")
        if self.fit_backend not in fitting.FIT_BACKENDS:
            raise ValueError(
                f"fit_backend must be one of {fitting.FIT_BACKENDS}, "
                f"got {self.fit_backend!r}"
            )
        if self.select_backend not in SELECT_BACKENDS:
            raise ValueError(
                f"select_backend must be one of {SELECT_BACKENDS}, "
                f"got {self.select_backend!r}"
            )
        if self.rep_bucket < 1:
            raise ValueError(f"rep_bucket must be >= 1, got {self.rep_bucket}")


@dataclass(frozen=True)
class ExecutorConfig:
    """Staging knobs; ``prefetch=False, async_persist=False`` is the strictly
    serial loop. None of them changes a per-point result."""

    prefetch: bool = True
    prefetch_depth: int = 2  # how many windows the load stage may run ahead
    async_persist: bool = True

    def __post_init__(self):
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")


class WindowStats(NamedTuple):
    window: regions.Window
    num_points: int
    num_fitted: int  # points actually sent through ComputePDF&Error
    load_seconds: float
    compute_seconds: float
    cache_hits: int
    wait_seconds: float = 0.0  # compute stage blocked waiting for this window


@dataclass
class SliceResult:
    type_idx: np.ndarray  # (P,) int32
    params: np.ndarray  # (P, 3)
    error: np.ndarray  # (P,)
    mean: np.ndarray  # (P,)
    std: np.ndarray  # (P,)
    skew: np.ndarray  # (P,)  (normalized 3rd moment — paper footnote 1)
    kurt: np.ndarray  # (P,)  (excess kurtosis)
    avg_error: float  # Eq. 6
    stats: list[WindowStats] = field(default_factory=list)
    error_bound_satisfied: bool | None = None
    slice_i: int | None = None
    spec_hash: str | None = None  # provenance; None until the API is ported

    @property
    def total_load_seconds(self) -> float:
        return sum(s.load_seconds for s in self.stats)

    @property
    def total_compute_seconds(self) -> float:
        return sum(s.compute_seconds for s in self.stats)

    @property
    def total_wait_seconds(self) -> float:
        return sum(s.wait_seconds for s in self.stats)


@dataclass(frozen=True)
class ExecutorReport:
    """Per-stage totals for one ``run``. ``wait_seconds`` is the time the
    compute stage spent blocked on the load stage; serially it equals
    ``load_seconds`` by construction."""

    wall_seconds: float
    units: int
    load_seconds: float
    wait_seconds: float
    compute_seconds: float
    persist_seconds: float

    @property
    def load_hidden_seconds(self) -> float:
        return max(0.0, self.load_seconds - self.wait_seconds)

    @property
    def load_hidden_fraction(self) -> float:
        return self.load_hidden_seconds / self.load_seconds if self.load_seconds > 0 else 0.0


@functools.lru_cache(maxsize=64)
def _fit_fns(types: tuple, num_bins: int, mode: str, fit_backend: str):
    """The compute stage's two device functions for one configuration."""
    backend = fitting.get_fit_backend(fit_backend, num_bins)

    def moments_f(values):
        return backend.moments(values)

    def fit_all_f(values, moments):
        r = backend.fit_all(values, moments, types, num_bins, mode)
        return r.type_idx, r.params, r.error

    return moments_f, fit_all_f


class _StagedWindow(NamedTuple):
    """Load-stage output: device-resident values, ready for the moments
    kernel (which runs on the compute stage, like every device op)."""

    unit: regions.WorkUnit
    values: torch.Tensor
    load_seconds: float


# The per-point result arrays of a SliceResult, in persisted order.
RESULT_FIELDS = ("type_idx", "params", "error", "mean", "std", "skew", "kurt")
_FIELDS = RESULT_FIELDS


class PersistStage:
    """Writes per-window ``.npz`` + watermark, optionally off-thread.

    One writer thread drains a FIFO queue, so windows of a slice persist in
    submission order and the watermark (``next_line``) only advances after
    its window file is written — the serial path's restart contract.
    The executor closes (and so flushes) the stage before returning *and*
    before propagating any compute-stage exception, so a crash loses at
    most the in-flight window.
    """

    def __init__(self, out_dir: str | Path | None, async_writes: bool = True,
                 total_lines: int | None = None):
        self.out_dir = Path(out_dir) if out_dir else None
        # Lines per slice: lets the watermark carry the ``complete`` stamp.
        self.total_lines = total_lines
        self.seconds = 0.0
        self.writes = 0
        self._error: BaseException | None = None
        self._async = bool(async_writes and self.out_dir is not None)
        if self._async:
            self._q: queue.Queue = queue.Queue()
            self._thread = threading.Thread(
                target=self._loop, name="window-persist", daemon=True
            )
            self._thread.start()

    def submit(self, slice_i: int, w: regions.Window, arrays: dict[str, np.ndarray]):
        """``arrays`` maps _FIELDS names to the window's result views; the
        views stay valid because windows are disjoint and the output buffers
        outlive the stage."""
        if self.out_dir is None:
            return
        if self._async:
            self._q.put((slice_i, w, arrays))
        else:
            self._write(slice_i, w, arrays)

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._error is None:
                    self._write(*item)
            except BaseException as e:  # parked — raise_if_failed re-raises on the main thread
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, slice_i: int, w: regions.Window, arrays: dict[str, np.ndarray]):
        t0 = time.perf_counter()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        np.savez(
            self.out_dir / f"slice{slice_i}_window_{w.line_start:05d}.npz",
            line_start=w.line_start, line_end=w.line_end, **arrays,
        )
        mark: dict = {"next_line": int(w.line_end)}
        if self.total_lines is not None:
            mark["complete"] = int(w.line_end) >= self.total_lines
        (self.out_dir / f"slice{slice_i}_watermark.json").write_text(json.dumps(mark))
        self.seconds += time.perf_counter() - t0
        self.writes += 1

    def raise_if_failed(self):
        if self._error is not None:
            raise RuntimeError("persist stage failed") from self._error

    def close(self):
        """Flush pending writes and stop the writer; never raises (call
        ``raise_if_failed`` on the success path)."""
        if self._async and self._thread.is_alive():
            self._q.put(None)
            self._q.join()
            self._thread.join(timeout=5.0)

    def watermark(self, slice_i: int) -> int:
        if self.out_dir is None:
            return 0
        f = self.out_dir / f"slice{slice_i}_watermark.json"
        if not f.exists():
            return 0
        return int(json.loads(f.read_text())["next_line"])

    def restore_windows(self, slice_i: int, upto_line: int, ppl: int,
                        outs: dict[str, np.ndarray]):
        for f in sorted(self.out_dir.glob(f"slice{slice_i}_window_*.npz")):
            z = np.load(f)
            if int(z["line_end"]) <= upto_line:
                lo, hi = int(z["line_start"]) * ppl, int(z["line_end"]) * ppl
                for name in _FIELDS:
                    outs[name][lo:hi] = z[name]


class StagedExecutor:
    """Drives Algorithms 1-2 over a Plan of (slice, window) work units on
    ``device``.

    ``data_source`` must expose ``geometry: regions.CubeGeometry`` and
    ``load_window(window) -> np.ndarray (num_points, n_obs) float32``.
    """

    def __init__(
        self,
        config: PDFConfig,
        data_source,
        device: torch.device | str,
        out_dir: str | Path | None = None,
        exec_config: ExecutorConfig | None = None,
        spec_hash: str | None = None,
    ):
        if config.method != "baseline":
            raise NotImplementedError(
                f"method {config.method!r} is not ported yet: "
                f"{_NOT_PORTED[config.method]}")
        if config.select_backend != "host":
            raise NotImplementedError(
                "select_backend='device' is not ported yet: ROADMAP queue 1 "
                "item 6 (grouping and reuse, device Select)")
        self.config = config
        self.data = data_source
        self.device = torch.device(device)
        self.out_dir = Path(out_dir) if out_dir else None
        self.exec_config = exec_config or ExecutorConfig()
        self.spec_hash = spec_hash
        self._moments, self._fit_all = _fit_fns(
            tuple(config.types), config.num_bins, config.mode, config.fit_backend
        )
        self.last_report: ExecutorReport | None = None

    # -- load stage -----------------------------------------------------------

    def _load_unit(self, unit: regions.WorkUnit) -> _StagedWindow:
        """Load + stage one window on the device (host work only — device
        kernels stay on the compute stage); runs on the prefetch thread when
        prefetch is enabled."""
        t0 = time.perf_counter()
        raw = self.data.load_window(unit.window)  # (P, n_obs)
        values = torch.from_numpy(np.ascontiguousarray(raw, dtype=np.float32)).to(self.device)
        return _StagedWindow(unit, values, time.perf_counter() - t0)

    # -- compute stage ---------------------------------------------------------

    def _fit(self, values: torch.Tensor, moments: dists.Moments):
        """Fit every row of ``values``; returns np arrays (type, params, err)."""
        t, p, e = self._fit_all(values, moments)
        return t.cpu().numpy(), p.cpu().numpy(), e.cpu().numpy()

    def _compute_window(self, item: _StagedWindow):
        """The compute-stage body for one staged window: moments, Algorithm 3,
        and the copy of the results to the host (which waits for the device,
        so ``compute_seconds`` covers the window's device work)."""
        t0 = time.perf_counter()
        moments = self._moments(item.values)
        t, p, e = self._fit(item.values, moments)
        mom_np = (moments.mean.cpu().numpy(),
                  np.sqrt(np.maximum(moments.var.cpu().numpy(), 0)),
                  moments.skew.cpu().numpy(), moments.kurt.cpu().numpy())
        return t, p, e, mom_np, time.perf_counter() - t0

    # -- run loop --------------------------------------------------------------

    def run(
        self,
        plan: regions.Plan,
        resume: bool = False,
        on_window: Callable[[WindowStats], None] | None = None,
    ) -> dict[int, SliceResult]:
        """Execute every unit of ``plan``; returns one SliceResult per slice.

        Pass the *full* plan even when resuming — completed windows are
        filtered against each slice's watermark here and their results
        restored from the persisted ``.npz`` files.
        """
        geom = self.data.geometry
        ppl = geom.points_per_line
        total = geom.points_per_slice
        requested = plan.slices

        persist = PersistStage(
            self.out_dir,
            async_writes=self.exec_config.async_persist,
            total_lines=geom.lines_per_slice,
        )
        outs = {
            s: {
                "type_idx": np.zeros((total,), dtype=np.int32),
                "params": np.zeros((total, 3), dtype=np.float32),
                "error": np.zeros((total,), dtype=np.float32),
                "mean": np.zeros((total,), dtype=np.float32),
                "std": np.zeros((total,), dtype=np.float32),
                "skew": np.zeros((total,), dtype=np.float32),
                "kurt": np.zeros((total,), dtype=np.float32),
            }
            for s in requested
        }
        stats: dict[int, list[WindowStats]] = {s: [] for s in requested}

        units = list(plan.units)
        if resume and self.out_dir is not None:
            marks = {s: persist.watermark(s) for s in requested}
            for s, mark in marks.items():
                if mark > 0:
                    persist.restore_windows(s, mark, ppl, outs[s])
            units = [u for u in units if u.window.line_start >= marks[u.window.slice_i]]

        load_total = wait_total = compute_total = 0.0
        wall0 = time.perf_counter()
        prefetcher = None
        if self.exec_config.prefetch and units:
            prefetcher = WindowPrefetcher(
                units, self._load_unit, depth=self.exec_config.prefetch_depth
            )
            stream = iter(prefetcher)
        else:
            stream = (self._load_unit(u) for u in units)

        try:
            while True:
                w0 = time.perf_counter()
                item = next(stream, None)
                if item is None:
                    break
                # wait_s: the only load-stage time the device was blocked on
                # (serially the whole load runs inline, so wait == load).
                wait_s = time.perf_counter() - w0
                t, p, e, mom_np, comp_s = self._compute_window(item)

                w = item.unit.window
                o = outs[w.slice_i]
                lo, hi = w.line_start * ppl, w.line_end * ppl
                o["type_idx"][lo:hi], o["params"][lo:hi], o["error"][lo:hi] = t, p, e
                for name, col in zip(("mean", "std", "skew", "kurt"), mom_np):
                    o[name][lo:hi] = col

                ws = WindowStats(w, hi - lo, hi - lo, item.load_seconds, comp_s, 0, wait_s)
                stats[w.slice_i].append(ws)
                load_total += item.load_seconds
                wait_total += wait_s
                compute_total += comp_s

                persist.submit(w.slice_i, w, {name: o[name][lo:hi] for name in _FIELDS})
                if on_window:
                    on_window(ws)
        finally:
            if prefetcher is not None:
                prefetcher.close()
            persist.close()  # flushes: the watermark is durable before any re-raise

        persist.raise_if_failed()
        self.last_report = ExecutorReport(
            wall_seconds=time.perf_counter() - wall0,
            units=sum(len(v) for v in stats.values()),
            load_seconds=load_total,
            wait_seconds=wait_total,
            compute_seconds=compute_total,
            persist_seconds=persist.seconds,
        )

        results: dict[int, SliceResult] = {}
        for s in requested:
            o = outs[s]
            avg_err = float(o["error"].mean())
            r = SliceResult(o["type_idx"], o["params"], o["error"], o["mean"],
                            o["std"], o["skew"], o["kurt"], avg_err, stats[s],
                            slice_i=s, spec_hash=self.spec_hash)
            if self.config.error_bound is not None:
                r.error_bound_satisfied = avg_err <= self.config.error_bound
            results[s] = r
        return results

    def run_slice(
        self,
        slice_i: int,
        resume: bool = False,
        on_window: Callable[[WindowStats], None] | None = None,
    ) -> SliceResult:
        plan = regions.build_plan(self.data.geometry, [slice_i], self.config.window_lines)
        return self.run(plan, resume=resume, on_window=on_window)[slice_i]

    def watermark(self, slice_i: int) -> int:
        return PersistStage(self.out_dir, async_writes=False).watermark(slice_i)
