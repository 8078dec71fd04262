"""Staged PDF executor: load / compute / persist as decoupled stages.

Port of ``repro.core.executor`` for every method of ``METHODS``, with host
or device Select:

  load stage     ``WindowPrefetcher`` (data/loader.py) loads window *k+1* from
                 the data source and stages it on the device while the device
                 is still fitting window *k*: on a CUDA device through a pinned
                 host buffer and a ``non_blocking`` copy on a copy stream
                 (``WindowStager``), whose event the compute stream waits on
                 before the moments kernel.
  compute stage  the main thread: moments, then the Select step (§5.1-5.2:
                 grouping dedups the window on (mu, sigma) keys and fits one
                 representative per group; reuse also looks each group up
                 in a cache that spans windows and slices), then Algorithm 3
                 on the device, or for the ML methods (§5.3) Algorithm 4:
                 the decision tree predicts each row's type on the device
                 and only that type's fit is kept. Sampling (§5.4) fits
                 nothing: it classifies a drawn fraction of the window with
                 the tree. Identical operations, in identical order, with
                 prefetch on or off, so results are bitwise equal.
  persist stage  a single writer thread appends per-window ``.npz`` files and
                 the watermark off the critical path, in submission order;
                 ``close()`` flushes before the executor returns or re-raises.

Per-stage heartbeats feed one ``runtime.monitor.StepMonitor`` per stage.
Fault tolerance is the reference's (DESIGN.md §14): a transiently failing
load or compute is retried with backoff (a fresh load each attempt), a
straggling load is raced by a speculative second load (first success wins),
and a unit that exhausts its retries is quarantined (``type_idx = -1``, zero
params and moments, a failed-unit manifest beside the watermark) or, with
``degraded_mode=False``, aborts the run. Loads are deterministic and fits
row-pure, so a retried, speculated or re-dealt unit yields the bits of its
first attempt. ``FaultInjector`` (runtime/faults.py) exercises all of it.

``run_window_batch`` computes many windows, possibly of several slices,
with shared launches: one host-to-device copy for the batch, and for the
grouping methods with host Select the representatives of whole windows
packed into one fit launch a shape class (on the fused backend K2 reads
them through its ``row_indices`` prologue). Each window gets the bits
``run_window`` gives it.

Select runs on the host (np.unique over int64 keys) or on the device
(``select_backend='device'``: ``torch.unique`` over the same keys, and on
the fused backend K2 reads the representatives through its ``row_indices``
prologue); the two are bitwise equal.

With a ``stats_recorder`` (``streaming.stats.StatsRecorder``) the compute
stage hands each full window's values and moments to it after the moments
and before the fit (never a sampled window; never in ``run_window_batch``):
the merge path's sufficient-statistic sidecars.

The ``.npz``, watermark and failed-unit manifest formats are the
reference's.
"""

from __future__ import annotations

import hashlib
import json
import queue
import threading
import time
from concurrent import futures
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import distributions as dists
from repro_torch.core import fitting
from repro_torch.core import grouping as grp
from repro_torch.core import ml_predict as mlp
from repro_torch.core import regions
from repro_torch.core import sampling as smp
from repro_torch.core.grouping import DEFAULT_TOL
from repro_torch.core.ml_predict import TREE_FEATURES, tree_features, tree_features_np  # noqa: F401
from repro_torch.core.reuse import ReuseCache
from repro_torch.data.loader import (PrefetchError, ShardedStager, StagedValues, WindowPrefetcher,
                                     WindowStager)
from repro_torch.runtime.faults import ShardLostError, is_transient
from repro_torch.runtime.monitor import StepMonitor, StragglerPolicy

METHODS = (
    "baseline", "grouping", "reuse", "ml", "grouping_ml", "reuse_ml", "sampling",
)
SAMPLERS = ("random", "kmeans")
SELECT_BACKENDS = ("host", "device")


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
    # torch chain), 'kernels' (the chain on the K3 moments and K4 histogram
    # kernels), 'fused' (the two CUDA kernels of kernels/fitpdf — the default
    # hot path).
    fit_backend: str = "fused"
    select_backend: str = "host"
    # method='sampling' (§5.4): the fraction of a window's points classified,
    # the sampler that draws them, and the Lloyd iterations of 'kmeans'. The
    # draw is seeded from (sample_seed, slice, line), so results do not
    # depend on the order windows run in.
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
    """Staging + fault-tolerance knobs; ``prefetch=False,
    async_persist=False`` is the strictly serial loop.

    None of these change per-point results — the bitwise-equivalence
    contract: a retried, speculated, or re-dealt work unit recomputes the
    exact bytes the first attempt would have produced (loads are
    deterministic, fits are row-pure), which is what makes
    first-result-wins and re-dealing safe (DESIGN.md §14)."""

    prefetch: bool = True
    prefetch_depth: int = 2  # how many windows the load stage may run ahead
    async_persist: bool = True
    # Work-unit retry: how many *re*-attempts a transiently failing unit
    # gets (max_retries + 1 attempts in all) before it is quarantined
    # (degraded_mode=True) or the run aborts (False). Backoff is
    # exponential (retry_backoff_s * 2^attempt) with a deterministic
    # per-(unit, attempt) jitter.
    max_retries: int = 2
    retry_backoff_s: float = 0.05
    # Straggler speculation: when a window load exceeds
    # max(threshold x trailing-median, straggler_grace_s), re-dispatch an
    # identical load and take whichever finishes first.
    speculate: bool = True
    straggler_grace_s: float = 1.0
    # Degraded completion: quarantine units that exhaust their retries
    # (type_idx = -1, failed-unit manifest next to the watermark) instead
    # of aborting the run.
    degraded_mode: bool = True

    def __post_init__(self):
        if self.prefetch_depth < 1:
            raise ValueError(f"prefetch_depth must be >= 1, got {self.prefetch_depth}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {self.retry_backoff_s}")
        if self.straggler_grace_s < 0:
            raise ValueError(
                f"straggler_grace_s must be >= 0, got {self.straggler_grace_s}")


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
    # Provenance: content hash of the PipelineSpec that produced this result
    # (api/spec.py); also stamped into persisted .npz files and watermarks.
    spec_hash: str | None = None
    # True when this result was served from a spec-hash-keyed ResultCache
    # (api/cache.py) instead of being computed; cached results are bitwise
    # identical to computed ones but carry no window stats.
    cached: bool = False
    # Fault-tolerance bookkeeping (DESIGN.md §14): transient re-attempts,
    # speculative re-dispatches, and the quarantined windows of a degraded
    # run — each a dict with unit_id/line_start/line_end/attempts/error,
    # mirrored in the slice's failed-unit manifest on disk. A quarantined
    # window's points carry type_idx = -1 and zero params/moments.
    retries: int = 0
    speculations: int = 0
    quarantined: tuple = ()

    @property
    def degraded(self) -> bool:
        """True when any work unit was quarantined — the result is complete
        for every other window but not the slice's answer."""
        return len(self.quarantined) > 0

    @property
    def total_load_seconds(self) -> float:
        return sum(s.load_seconds for s in self.stats)

    @property
    def total_compute_seconds(self) -> float:
        return sum(s.compute_seconds for s in self.stats)

    @property
    def total_wait_seconds(self) -> float:
        return sum(s.wait_seconds for s in self.stats)

    def features(self, types) -> smp.SliceFeatures:
        """§5.4 slice features from this result: average mean/std and type
        percentages over the classified points — all of them for the fitting
        methods, the sampled subset for ``method='sampling'`` (unsampled
        points carry ``type_idx == -1``)."""
        m = self.type_idx >= 0
        n = int(m.sum())
        pct = (np.bincount(self.type_idx[m], minlength=len(types))
               .astype(np.float64) / max(n, 1))
        return smp.SliceFeatures(
            float(self.mean[m].mean()) if n else 0.0,
            float(self.std[m].mean()) if n else 0.0,
            pct, n,
        )


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
    # Fault-tolerance totals across the run's slices (DESIGN.md §14).
    retries: int = 0
    speculations: int = 0
    speculation_wins: int = 0
    quarantined: int = 0

    @property
    def load_hidden_seconds(self) -> float:
        return max(0.0, self.load_seconds - self.wait_seconds)

    @property
    def load_hidden_fraction(self) -> float:
        return self.load_hidden_seconds / self.load_seconds if self.load_seconds > 0 else 0.0


class _StagedWindow(NamedTuple):
    """Load-stage output: the window staged on the device (its copy maybe
    still in flight; ``WindowStager.ready`` before use), for the moments
    kernel, which runs on the compute stage like every device op."""

    unit: regions.WorkUnit
    staged: StagedValues
    load_seconds: float
    # The loader's numpy window, kept only for a stats recorder: the
    # sidecar's float64 statistics read these bytes instead of copying the
    # staged window back from the device.
    host: np.ndarray | None = None


class _FailedUnit(NamedTuple):
    """Load/compute-stage output for a unit that exhausted its retries in
    degraded mode: flows down the same stream as ``_StagedWindow`` (raising
    from the prefetch thread would kill the whole stream) and is quarantined
    by the run loop instead of computed."""

    unit: regions.WorkUnit
    error: str
    attempts: int


class _ComputedWindow(NamedTuple):
    """One computed window: everything the run loop scatters/persists."""

    window: regions.Window
    type_idx: np.ndarray
    params: np.ndarray
    error: np.ndarray
    mom_np: tuple
    sample_idx: np.ndarray | None
    fitted: int
    cache_hits: int
    compute_seconds: float
    load_seconds: float


def _errstr(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"


# The per-point result arrays of a SliceResult, in persisted order.
RESULT_FIELDS = ("type_idx", "params", "error", "mean", "std", "skew", "kurt")
_FIELDS = RESULT_FIELDS


class WindowResult(NamedTuple):
    """Per-point results of ONE window (``run_window``,
    ``run_window_batch``). Field order after ``window`` matches
    ``RESULT_FIELDS``."""

    window: regions.Window
    type_idx: np.ndarray  # (P,) int32
    params: np.ndarray  # (P, 3) float32
    error: np.ndarray  # (P,)
    mean: np.ndarray  # (P,)
    std: np.ndarray  # (P,)
    skew: np.ndarray  # (P,)
    kurt: np.ndarray  # (P,)

    def arrays(self) -> dict[str, np.ndarray]:
        return {name: getattr(self, name) for name in _FIELDS}


class PersistStage:
    """Writes per-window ``.npz`` + watermark, optionally off-thread.

    One writer thread drains a FIFO queue, so windows of a slice persist in
    submission order and the watermark (``next_line``) is only advanced
    after its window file is durable — exactly the serial path's restart
    contract. ``flush()`` blocks until everything submitted is written;
    the executor flushes before returning *and* before propagating any
    compute-stage exception, so a crash loses at most the in-flight window.
    """

    def __init__(self, out_dir: str | Path | None, async_writes: bool = True,
                 monitor: StepMonitor | None = None,
                 spec_hash: str | None = None,
                 injector=None,
                 total_lines: int | None = None):
        self.out_dir = Path(out_dir) if out_dir else None
        self.monitor = monitor
        self.spec_hash = spec_hash  # stamped into every .npz + watermark
        # Lines per slice, when the caller knows it: lets the watermark
        # carry an explicit ``complete`` stamp (the cluster redeal scan's
        # recovery line) instead of readers re-deriving it from geometry.
        self.total_lines = total_lines
        self.injector = injector  # faults.FaultInjector (on_persist hook)
        self.seconds = 0.0
        self.writes = 0
        self.retries = 0  # transient write failures absorbed in _write
        self._error: BaseException | None = None
        self._async = bool(async_writes and self.out_dir is not None)
        if self._async:
            self._q: queue.Queue = queue.Queue()
            self._thread = threading.Thread(
                target=self._loop, name="window-persist", daemon=True
            )
            self._thread.start()

    # -- submission -----------------------------------------------------------

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
            except BaseException as e:  # repro: allow[ERR]: parked — flush()/raise_if_failed re-raise on the main thread
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, slice_i: int, w: regions.Window, arrays: dict[str, np.ndarray]):
        uid = f"persist:s{slice_i}/l{w.line_start:05d}"
        t0 = time.perf_counter()
        if self.monitor is not None:
            self.monitor.start(uid, now=t0)
        try:
            # Transient write failures (an NFS hiccup mid-savez, or the
            # injector's persist_error) get two quiet re-attempts — a
            # partially-written .npz is simply overwritten, and the
            # watermark only advances after a successful write.
            for attempt in range(3):
                try:
                    if self.injector is not None:
                        self.injector.on_persist(slice_i, w.line_start)
                    self._write_once(slice_i, w, arrays)
                    break
                except OSError:
                    if attempt == 2:
                        raise
                    self.retries += 1
                    time.sleep(0.01 * (attempt + 1))
        except BaseException:
            if self.monitor is not None:
                self.monitor.abandon(uid)
            raise
        t1 = time.perf_counter()
        if self.monitor is not None:
            self.monitor.finish(uid, now=t1)
        self.seconds += t1 - t0
        self.writes += 1

    def _write_once(self, slice_i: int, w: regions.Window,
                    arrays: dict[str, np.ndarray]):
        self.out_dir.mkdir(parents=True, exist_ok=True)
        extra = {"spec_hash": self.spec_hash} if self.spec_hash else {}
        np.savez(
            self.out_dir / f"slice{slice_i}_window_{w.line_start:05d}.npz",
            line_start=w.line_start, line_end=w.line_end, **extra, **arrays,
        )
        mark: dict = {"next_line": int(w.line_end), **extra}
        if self.total_lines is not None:
            mark["complete"] = int(w.line_end) >= self.total_lines
        (self.out_dir / f"slice{slice_i}_watermark.json").write_text(
            json.dumps(mark)
        )

    # -- lifecycle ------------------------------------------------------------

    def flush(self):
        if self._async:
            self._q.join()

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

    # -- watermark / restore (resume) -----------------------------------------

    def watermark_info(self, slice_i: int) -> dict:
        if self.out_dir is None:
            return {"next_line": 0}
        f = self.out_dir / f"slice{slice_i}_watermark.json"
        if not f.exists():
            return {"next_line": 0}
        return json.loads(f.read_text())

    def run_window_sharded(self, w: regions.Window, sharded: ShardedStager) -> WindowResult:
        """One window with its points split over the ranks of ``sharded``'s
        mesh: each rank loads the window, stages its block of the rows
        onto its own device, runs moments and the fit on them (K1 and K2
        on the fused backend), copies its results to the host, and the
        ranks' rows are gathered back into the whole window's result. The
        fit is row by row, so it is the one-rank ``run_window``'s result
        bit for bit. For the methods that fit every row (``baseline``,
        ``ml``); every rank of the mesh must call it."""
        if self.config.method not in ("baseline", "ml"):
            raise ValueError(f"run_window_sharded fits every row; method {self.config.method!r} "
                             "groups, reuses or samples over the whole window")
        staged, p = sharded.stage(self.data.load_window(w))
        values = self.stager.ready(staged)
        moments = self._backend.moments(values)
        t, params, e = self._fit(values, moments)
        return WindowResult(w, *sharded.gather([t, params, e, *self._moments_np(moments)], p))

    def watermark(self, slice_i: int) -> int:
        return int(self.watermark_info(slice_i)["next_line"])

    def check_resume_hash(self, slice_i: int, info: dict):
        """Resume-mismatch detection: a watermark written under a different
        spec hash describes a *different computation* (other tolerance,
        candidate set, source seed...) — silently mixing its windows into
        this run would corrupt the output, so refuse."""
        stored = info.get("spec_hash")
        if stored and self.spec_hash and stored != self.spec_hash:
            raise ValueError(
                f"resume mismatch for slice {slice_i}: watermark in "
                f"{self.out_dir} was written by spec {stored}, this run is "
                f"spec {self.spec_hash} — point --out-dir elsewhere or "
                "re-run without resume")

    def restore_windows(self, slice_i: int, upto_line: int, ppl: int,
                        outs: dict[str, np.ndarray]):
        for f in sorted(self.out_dir.glob(f"slice{slice_i}_window_*.npz")):
            z = np.load(f)
            if int(z["line_end"]) <= upto_line:
                lo, hi = int(z["line_start"]) * ppl, int(z["line_end"]) * ppl
                for name in _FIELDS:
                    outs[name][lo:hi] = z[name]

    # -- degraded mode: the failed-unit manifest -------------------------------

    def failed_manifest_path(self, slice_i: int) -> Path:
        return self.out_dir / f"slice{slice_i}_failed_units.json"

    def write_failed_manifest(self, slice_i: int, entries: list[dict]):
        """Record a degraded slice's quarantined units next to its watermark
        — the completion contract of degraded mode (DESIGN.md §14): the run
        *finished*, and this file says exactly which windows it finished
        without. An empty entry list deletes the manifest (the slice was
        repaired, e.g. by a resume that re-ran the quarantined units)."""
        if self.out_dir is None:
            return
        f = self.failed_manifest_path(slice_i)
        if not entries:
            f.unlink(missing_ok=True)
            return
        self.out_dir.mkdir(parents=True, exist_ok=True)
        f.write_text(json.dumps(
            {"spec_hash": self.spec_hash, "slice": slice_i, "failed": entries},
            indent=1,
        ))

    def failed_lines(self, slice_i: int) -> set[int]:
        """line_start of every quarantined unit recorded for the slice —
        resume re-runs these even below the watermark (their .npz was never
        written, so the watermark alone cannot see the hole)."""
        if self.out_dir is None:
            return set()
        f = self.failed_manifest_path(slice_i)
        if not f.exists():
            return set()
        return {int(e["line_start"])
                for e in json.loads(f.read_text()).get("failed", ())}


class StagedExecutor:
    """Drives Algorithms 1-2 over a Plan of (slice, window) work units on
    ``device``.

    ``data_source`` must expose ``geometry: regions.CubeGeometry`` and
    ``load_window(window) -> np.ndarray (num_points, n_obs) float32``.
    The reuse cache lives on the executor, so windows — and consecutive
    slices and ``run_slice`` calls — share it. The ML and sampling methods
    need ``tree``; its arrays move to ``device`` once, here. ``injector``
    (a ``runtime.faults.FaultInjector``) gets the persist stage's hook; its
    read faults come through the source it wraps (``wrap_source``).
    """

    def __init__(
        self,
        config: PDFConfig,
        data_source,
        device: torch.device | str,
        tree: mlp.DecisionTree | None = None,
        out_dir: str | Path | None = None,
        exec_config: ExecutorConfig | None = None,
        spec_hash: str | None = None,
        injector=None,
        stats_recorder=None,
    ):
        if ("ml" in config.method or config.method == "sampling") and tree is None:
            raise ValueError(f"method {config.method!r} requires a decision tree")
        self.config = config
        self.data = data_source
        self.device = torch.device(device)
        self.tree = tree
        self._tree_arrays = tree.as_device(self.device) if tree is not None else None
        self.out_dir = Path(out_dir) if out_dir else None
        self.exec_config = exec_config or ExecutorConfig()
        self.spec_hash = spec_hash
        self.injector = injector  # faults.FaultInjector (persist-path hook)
        # streaming.stats.StatsRecorder (or any callable taking (window,
        # values, moments, host=...)): sees each full window's staged values
        # and moments before the fit, so merge-able sufficient statistics
        # persist without a second read.
        self.stats_recorder = stats_recorder
        self._backend = fitting.get_fit_backend(config.fit_backend, config.num_bins)
        self.cache = ReuseCache()
        self._key_buf: np.ndarray | None = None  # cached (P, 2) quantize buffer
        self._key_tmp: np.ndarray | None = None
        # Pinned buffers enough for the prefetch thread's queue, the window
        # in compute and the speculation pool's 4 workers; a stage that finds
        # none free waits for one's copy to end.
        self.stager = WindowStager(self.device, self.exec_config.prefetch_depth + 2 + 4)
        # One StepMonitor per stage. The load monitor's grace floor is
        # configurable so speculation can be exercised without second-long
        # stalls; under speculation it sees one start/finish per *attempt*
        # (failed attempts are abandoned, so they never enter the median).
        self.monitors = {
            "load": StepMonitor(StragglerPolicy(
                grace_seconds=self.exec_config.straggler_grace_s)),
            "compute": StepMonitor(),
            "persist": StepMonitor(),
        }
        self.last_report: ExecutorReport | None = None
        # Per-run fault bookkeeping: {slice -> counter dict}, reset by run();
        # the lock covers prefetch-thread vs compute-thread increments.
        self._fault_lock = threading.Lock()
        self._fault_counts: dict[int, dict[str, int]] = {}
        self._spec_pool: futures.ThreadPoolExecutor | None = None

    # -- load stage -----------------------------------------------------------

    def _load_unit(self, unit: regions.WorkUnit, uid: str | None = None) -> _StagedWindow:
        """Load + stage one window (host work and the copy's dispatch only —
        device kernels stay on the compute stage); runs on the prefetch
        thread when prefetch is enabled, or on speculation-pool threads
        under re-dispatch. ``uid`` distinguishes attempts of the same unit in
        the load monitor; failed attempts are abandoned (no duration
        recorded) so an injected stall cannot poison the straggler median.
        ``load_seconds`` is the host load plus the staging dispatch, as the
        reference's."""
        mon = self.monitors["load"]
        uid = uid or unit.unit_id
        t0 = time.perf_counter()
        mon.start(uid, now=t0)
        try:
            raw = self.data.load_window(unit.window)  # (P, n_obs)
            staged = self.stager.stage(raw)
        except BaseException:
            mon.abandon(uid)
            raise
        t1 = time.perf_counter()
        mon.finish(uid, now=t1)
        return _StagedWindow(unit, staged, t1 - t0,
                             raw if self.stats_recorder is not None else None)

    # -- fault tolerance: retry, speculation, quarantine (DESIGN.md §14) -------

    def _note_fault(self, slice_i: int, key: str, n: int = 1):
        with self._fault_lock:
            c = self._fault_counts.setdefault(
                slice_i, {"retries": 0, "speculations": 0, "speculation_wins": 0})
            c[key] += n

    def _backoff(self, unit: regions.WorkUnit, attempt: int) -> float:
        """Exponential backoff with *deterministic* jitter hashed from
        (unit, attempt), as the reference's: a re-run backs off identically,
        and jitter in [0.5x, 1.5x) still de-correlates units that failed
        together."""
        h = hashlib.sha256(f"{unit.unit_id}:{attempt}".encode()).digest()
        jitter = 0.5 + h[0] / 256.0
        return self.exec_config.retry_backoff_s * (2 ** attempt) * jitter

    def _pool(self) -> futures.ThreadPoolExecutor:
        # 4 workers: a straggling loser may still occupy one while the next
        # unit's primary + speculative pair runs — 2 would deadlock behind it.
        if self._spec_pool is None:
            self._spec_pool = futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="load-spec")
        return self._spec_pool

    def _load_speculative(self, unit: regions.WorkUnit, uid: str) -> _StagedWindow:
        """One load attempt with straggler speculation: if the primary load
        exceeds max(threshold x trailing-median, grace), dispatch a
        bitwise-identical second load and take whichever succeeds first
        (loads are deterministic and fits row-pure, so the winner cannot
        change the result's bytes). The loser runs to its end in the pool;
        its pinned buffer is free again once its copy has completed, and its
        device tensor, never used off the copy stream, is dropped. Below
        ``min_samples`` completed loads there is no median and the attempt
        runs inline."""
        mon = self.monitors["load"]
        med = mon.median()
        if med is None:
            return self._load_unit(unit, uid=uid)
        pol = mon.policy
        limit = max(pol.threshold * med, pol.grace_seconds)
        pool = self._pool()
        primary = pool.submit(self._load_unit, unit, uid)
        done, _ = futures.wait([primary], timeout=limit)
        if primary in done:
            return primary.result()  # raises the load's own error if it failed

        self._note_fault(unit.window.slice_i, "speculations")
        if uid not in mon.flagged:
            mon.flagged.append(uid)
        spec = pool.submit(self._load_unit, unit, f"{uid}#spec")
        pending = {primary, spec}
        while pending:
            done, pending = futures.wait(pending, return_when=futures.FIRST_COMPLETED)
            for f in done:
                if f.exception() is None:
                    if f is spec:
                        self._note_fault(unit.window.slice_i, "speculation_wins")
                    return f.result()
        raise primary.exception()  # both attempts failed

    def _load_guarded(self, unit: regions.WorkUnit):
        """The load stage's retry wrapper (the prefetcher's stage function):
        transient failures back off and re-attempt up to ``max_retries``
        times; exhaustion returns a ``_FailedUnit`` — raising here would
        kill the whole prefetch stream. The run loop turns it into
        quarantine (degraded mode) or a per-unit error. Fatal errors —
        ``ShardLostError``, device errors — always raise."""
        ec = self.exec_config
        last: BaseException | None = None
        for attempt in range(ec.max_retries + 1):
            uid = unit.unit_id if attempt == 0 else f"{unit.unit_id}#r{attempt}"
            try:
                if ec.speculate:
                    return self._load_speculative(unit, uid)
                return self._load_unit(unit, uid=uid)
            except Exception as e:  # noqa: BLE001 — classified below
                if not is_transient(e):
                    raise
                last = e
                if attempt < ec.max_retries:
                    self._note_fault(unit.window.slice_i, "retries")
                    time.sleep(self._backoff(unit, attempt))
        return _FailedUnit(unit, _errstr(last), ec.max_retries + 1)

    # -- compute stage ---------------------------------------------------------

    def _fit(self, values: torch.Tensor, moments: dists.Moments):
        """Fit every row of ``values``: Algorithm 4 on the tree's predicted
        types for the ML methods, else Algorithm 3; returns np arrays
        (type, params, err)."""
        r = self._fit_device(values, moments)
        return r.type_idx.cpu().numpy(), r.params.cpu().numpy(), r.error.cpu().numpy()

    def _fit_device(self, values: torch.Tensor, moments: dists.Moments) -> fitting.FitResult:
        cfg = self.config
        if "ml" in cfg.method:
            pred = mlp.predict(self._tree_arrays, tree_features(moments))
            return self._backend.fit_predicted(values, moments, pred, tuple(cfg.types),
                                               cfg.num_bins)
        return self._backend.fit_all(values, moments, tuple(cfg.types), cfg.num_bins, cfg.mode)

    def _quantized_keys(self, moments: dists.Moments) -> np.ndarray:
        """Host Select's (mu, sigma) keys (``grp.quantize_keys_host``) in a
        cached (P, 2) buffer, one allocation per window size."""
        mean = moments.mean.cpu().numpy()
        var = moments.var.cpu().numpy()
        p = mean.shape[0]
        if self._key_buf is None or self._key_buf.shape[0] != p:
            self._key_buf = np.empty((p, 2), dtype=np.int64)
            self._key_tmp = np.empty((p,), dtype=np.float64)
        return grp.quantize_keys_host(
            mean, var, self.config.group_tol, out=self._key_buf, tmp=self._key_tmp)

    def _select_and_fit(self, values: torch.Tensor, moments: dists.Moments,
                        window: regions.Window, num_points: int,
                        sample_idx: np.ndarray | None):
        """The Select step (§5.1-5.2): per-point (type, params, error) plus
        ``(num_fitted, cache_hits)``. Baseline and ml fit every row; the
        grouping and reuse methods dedup on 'host' (np.unique) or 'device'
        (``torch.unique``), with bitwise equal results; sampling classifies
        (``_sample_classify``: ``num_points`` is the window's, ``values`` the
        random sampler's ``sample_idx`` rows)."""
        method = self.config.method
        if method == "sampling":
            return self._sample_classify(moments, window, num_points, sample_idx)
        if method in ("baseline", "ml"):
            t, p, e = self._fit(values, moments)
            return t, p, e, values.shape[0], 0
        if self.config.select_backend == "device":
            return self._select_device(values, moments)
        keys = self._quantized_keys(moments)
        groups = grp.group_host(keys)
        rep_t, rep_p, rep_e, fitted, cache_hits = self._fit_representatives(
            values, moments, keys[groups.rep_indices], groups.rep_indices)
        inv = groups.inverse
        return rep_t[inv], rep_p[inv], rep_e[inv], fitted, cache_hits

    def _fit_representatives(self, values: torch.Tensor, moments: dists.Moments,
                             rep_keys: np.ndarray, rep_rows: np.ndarray):
        """Fit one row per group — the Select core of both backends.

        ``rep_keys`` (G, 2) int64 is each group's cache identity, ``rep_rows``
        (G,) the representatives' window rows. The reuse method looks them
        up in the cache first; the misses are fitted as one batch padded to
        ``rep_bucket * 2^k`` rows, as the reference pads them, and inserted.
        Returns per-group ``(rep_t, rep_p, rep_e, fitted, cache_hits)``."""
        reuse = self.config.method.startswith("reuse")
        g = len(rep_rows)
        if reuse:
            hit, cached = self.cache.lookup_window(rep_keys)
            cache_hits = int(hit.sum())
        else:
            hit, cached, cache_hits = np.zeros((g,), dtype=bool), np.zeros((g, 5)), 0
        todo = rep_rows[~hit]

        rep_t = np.zeros((g,), dtype=np.int32)
        rep_p = np.zeros((g, 3), dtype=np.float32)
        rep_e = np.zeros((g,), dtype=np.float32)
        rep_t[hit] = cached[hit, 0].astype(np.int32)
        rep_p[hit] = cached[hit, 1:4]
        rep_e[hit] = cached[hit, 4]

        if len(todo):
            padded = grp.pad_representatives(todo, self.config.rep_bucket)
            idx = torch.from_numpy(padded).to(values.device)
            t, p, e = self._fit(*fitting.gather_rows(values, moments, idx))
            t, p, e = t[: len(todo)], p[: len(todo)], e[: len(todo)]
            rep_t[~hit], rep_p[~hit], rep_e[~hit] = t, p, e
            if reuse:
                self.cache.insert_window(
                    rep_keys[~hit],
                    np.concatenate([t[:, None], p, e[:, None]], axis=-1).astype(np.float64))
        return rep_t, rep_p, rep_e, len(todo), cache_hits

    def _select_device(self, values: torch.Tensor, moments: dists.Moments):
        """Device Select: the keys, the dedup and the compaction stay on the
        window's device; only the group count comes to the host. Grouping
        then fits the G representatives and scatters per point on the
        device (on the fused backend K2 reads them through ``row_indices``;
        grouping_ml gathers them, predicts their types and runs Algorithm 4
        on them). Reuse keeps the host cache: the (G, 2) representative keys
        and rows and the (P,) slot map come down, and the misses go through
        the same padded fit as on the host path, so results and cache
        contents equal the host path's."""
        cfg = self.config
        keys = grp.quantize_keys(moments.mean, moments.var, cfg.group_tol)
        groups = grp.group_device(keys)
        gather_idx, point_slot = grp.compact_representatives(groups.rep_for_point, groups.is_rep)
        if cfg.method.startswith("grouping"):
            if cfg.method == "grouping_ml":
                r = self._fit_device(*fitting.gather_rows(values, moments, gather_idx))
            else:
                r = fitting.fit_all_rows(self._backend, values, moments, gather_idx,
                                         tuple(cfg.types), cfg.num_bins, cfg.mode)
            out = (grp.scatter_group_results(f, point_slot).cpu().numpy() for f in r)
            return (*out, groups.num_groups, 0)
        rep_t, rep_p, rep_e, fitted, cache_hits = self._fit_representatives(
            values, moments, keys[gather_idx].cpu().numpy(), gather_idx.cpu().numpy())
        inv = point_slot.cpu().numpy()
        return rep_t[inv], rep_p[inv], rep_e[inv], fitted, cache_hits

    def _sample_seed(self, w: regions.Window) -> int:
        """Per-window draw seed from (sample_seed, slice, line): results do
        not depend on window execution order and survive resume."""
        return (self.config.sample_seed * 1_000_003 + w.slice_i * 100_003
                + w.line_start)

    def _draw_sample(self, num_points: int, w: regions.Window) -> np.ndarray:
        """The random sampler's index draw: it needs only the window's point
        count, so the window is subset before the moments pass."""
        return smp.sample_indices_random(num_points, self.config.sample_frac,
                                         seed=self._sample_seed(w))

    def _sample_classify(self, moments: dists.Moments, w: regions.Window,
                         num_points: int, idx: np.ndarray | None):
        """method='sampling' (§5.4, Algorithm 5): classify the sampled
        points' types with the tree on the host (grouping first) and fit
        nothing. Unsampled points get ``type_idx = -1`` and zero
        params/error; ``num_fitted`` reports the classified count.

        ``idx`` is the random sampler's draw (``moments`` then cover only
        those rows). For k-means ``idx`` is None: double sampling clusters
        every point's (mu, sigma), so it needs the whole window's moments."""
        cfg = self.config
        mean = moments.mean.cpu().numpy()
        std = np.sqrt(np.maximum(moments.var.cpu().numpy(), 0.0))
        skew, kurt = moments.skew.cpu().numpy(), moments.kurt.cpu().numpy()
        if idx is None:
            idx = smp.sample_indices_kmeans(
                np.stack([mean, std], axis=-1), cfg.sample_frac,
                iters=cfg.kmeans_iters, seed=self._sample_seed(w))
            mean, std, skew, kurt = mean[idx], std[idx], skew[idx], kurt[idx]
        pred = smp.predict_types(mean, std, self.tree, group_tol=cfg.group_tol,
                                 skew=skew, kurt=kurt)
        t = np.full((num_points,), -1, dtype=np.int32)
        t[idx] = pred
        params = np.zeros((num_points, 3), dtype=np.float32)
        err = np.zeros((num_points,), dtype=np.float32)
        return t, params, err, len(idx), 0

    def _moments_of(self, values: torch.Tensor, w: regions.Window):
        """The random sampler's subset (drawn from the window's point count,
        so the device work falls with the rate) and the moments of the rows
        fitted: ``(values, moments, sample_idx)``."""
        sample_idx = None
        if self.config.method == "sampling" and self.config.sampler == "random":
            sample_idx = self._draw_sample(values.shape[0], w)
            values = values[torch.from_numpy(sample_idx).to(values.device)]
        return values, self._backend.moments(values), sample_idx

    @staticmethod
    def _moments_np(moments: dists.Moments) -> tuple:
        return (moments.mean.cpu().numpy(),
                np.sqrt(np.maximum(moments.var.cpu().numpy(), 0)),
                moments.skew.cpu().numpy(), moments.kurt.cpu().numpy())

    def _compute_window(self, item: _StagedWindow, attempt: int = 0) -> _ComputedWindow:
        """The compute-stage body for one staged window: wait for its copy,
        moments, Select and Algorithm 3 or 4 (or sampling's classification),
        and the copy of the results to the host (which waits for the device,
        so ``compute_seconds`` covers the window's device work). The run
        loop writes the random sampler's moments at ``sample_idx`` only."""
        cmon = self.monitors["compute"]
        unit = item.unit
        uid = unit.unit_id if attempt == 0 else f"{unit.unit_id}#c{attempt}"
        t0 = time.perf_counter()
        cmon.start(uid, now=t0)
        try:
            values = self.stager.ready(item.staged)
            num_points = values.shape[0]
            values, moments, sample_idx = self._moments_of(values, unit.window)
            if self.stats_recorder is not None and sample_idx is None:
                # Read on the compute stream, where ``ready`` made the staged
                # tensor safe. Sampled windows are skipped: their stats
                # describe a draw, not the window, and cannot merge with
                # append data.
                self.stats_recorder(unit.window, values, moments, host=item.host)
            t, p, e, fitted, hits = self._select_and_fit(values, moments, unit.window,
                                                         num_points, sample_idx)
            mom_np = self._moments_np(moments)
        except BaseException:
            cmon.abandon(uid)
            raise
        t1 = time.perf_counter()
        cmon.finish(uid, now=t1)
        return _ComputedWindow(unit.window, t, p, e, mom_np, sample_idx, fitted, hits,
                               t1 - t0, item.load_seconds)

    def _compute_with_retry(self, item: _StagedWindow):
        """Compute one staged window, retrying transient failures with a
        *fresh load* each time, as the reference does (its fits consume the
        staged buffer). Returns a ``_ComputedWindow``, or a ``_FailedUnit``
        after exhaustion (quarantined in degraded mode, else an error)."""
        ec = self.exec_config
        unit = item.unit
        last: BaseException | None = None
        for attempt in range(ec.max_retries + 1):
            try:
                if item is None:
                    item = self._load_unit(unit, uid=f"{unit.unit_id}#c{attempt}")
                return self._compute_window(item, attempt)
            except Exception as e:  # noqa: BLE001 — classified below
                if not is_transient(e):
                    raise
                last = e
                item = None  # reload next attempt
                if attempt < ec.max_retries:
                    self._note_fault(unit.window.slice_i, "retries")
                    time.sleep(self._backoff(unit, attempt))
        return _FailedUnit(unit, _errstr(last), ec.max_retries + 1)

    def _quarantine(self, failed: _FailedUnit, outs: dict, ppl: int,
                    quarantined: dict[int, list[dict]]):
        """Degraded mode's terminal state for a unit: its points carry
        ``type_idx = -1`` and zero params/moments, nothing is persisted for
        the window (the manifest records the hole), and the run continues."""
        w = failed.unit.window
        o = outs[w.slice_i]
        lo, hi = w.line_start * ppl, w.line_end * ppl
        o["type_idx"][lo:hi] = -1
        for name in ("params", "error", "mean", "std", "skew", "kurt"):
            o[name][lo:hi] = 0
        quarantined[w.slice_i].append({
            "unit_id": failed.unit.unit_id,
            "line_start": int(w.line_start),
            "line_end": int(w.line_end),
            "attempts": int(failed.attempts),
            "error": failed.error,
        })

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
        restored from the persisted ``.npz`` files; windows a degraded run
        quarantined are run again.
        """
        geom = self.data.geometry
        ppl = geom.points_per_line
        total = geom.points_per_slice
        requested = plan.slices

        persist = PersistStage(
            self.out_dir,
            async_writes=self.exec_config.async_persist,
            monitor=self.monitors["persist"],
            spec_hash=self.spec_hash,
            injector=self.injector,
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
            infos = {s: persist.watermark_info(s) for s in requested}
            for s, info in infos.items():
                persist.check_resume_hash(s, info)
            marks = {s: int(info["next_line"]) for s, info in infos.items()}
            # Units a degraded run quarantined sit below the watermark with
            # no .npz; the failed-unit manifest re-includes them.
            failed_prev = {s: persist.failed_lines(s) for s in requested}
            for s, mark in marks.items():
                if mark > 0:
                    persist.restore_windows(s, mark, ppl, outs[s])
            units = [
                u for u in units
                if u.window.line_start >= marks[u.window.slice_i]
                or u.window.line_start in failed_prev[u.window.slice_i]
            ]

        with self._fault_lock:
            self._fault_counts = {}
        quarantined: dict[int, list[dict]] = {s: [] for s in requested}
        load_total = wait_total = compute_total = 0.0
        wall0 = time.perf_counter()
        prefetcher = None
        if self.exec_config.prefetch and units:
            prefetcher = WindowPrefetcher(
                units, self._load_guarded, depth=self.exec_config.prefetch_depth
            )
            stream = iter(prefetcher)
        else:
            stream = (self._load_guarded(u) for u in units)

        try:
            while True:
                w0 = time.perf_counter()
                try:
                    item = next(stream, None)
                except PrefetchError as pe:
                    # Shard death surfaces as itself: the scheduler's
                    # re-deal catches ShardLostError, not the prefetch
                    # wrapper it crossed the thread boundary in.
                    if isinstance(pe.__cause__, ShardLostError):
                        raise pe.__cause__
                    raise
                if item is None:
                    break
                # wait_s: the only load-stage time the device was blocked on
                # (serially the whole load runs inline, so wait == load).
                wait_s = time.perf_counter() - w0

                if not isinstance(item, _FailedUnit):
                    item = self._compute_with_retry(item)
                if isinstance(item, _FailedUnit):
                    if not self.exec_config.degraded_mode:
                        raise RuntimeError(
                            f"work unit {item.unit.unit_id} failed after "
                            f"{item.attempts} attempts: {item.error}")
                    self._quarantine(item, outs, ppl, quarantined)
                    continue

                w = item.window
                o = outs[w.slice_i]
                lo, hi = w.line_start * ppl, w.line_end * ppl
                o["type_idx"][lo:hi] = item.type_idx
                o["params"][lo:hi] = item.params
                o["error"][lo:hi] = item.error
                for name, col in zip(("mean", "std", "skew", "kurt"), item.mom_np):
                    if item.sample_idx is None:
                        o[name][lo:hi] = col
                    else:  # the random sampler's rows; the others stay zero
                        o[name][lo:hi][item.sample_idx] = col

                ws = WindowStats(w, hi - lo, item.fitted, item.load_seconds,
                                 item.compute_seconds, item.cache_hits, wait_s)
                stats[w.slice_i].append(ws)
                load_total += item.load_seconds
                wait_total += wait_s
                compute_total += item.compute_seconds

                persist.submit(w.slice_i, w, {name: o[name][lo:hi] for name in _FIELDS})
                if on_window:
                    on_window(ws)
        finally:
            if prefetcher is not None:
                prefetcher.close()
            persist.close()  # flushes: the watermark is durable before any re-raise
            if self._spec_pool is not None:
                self._spec_pool.shutdown(wait=False, cancel_futures=True)
                self._spec_pool = None

        persist.raise_if_failed()
        if self.out_dir is not None:
            for s in requested:
                persist.write_failed_manifest(s, quarantined[s])
        counts = self._fault_counts
        self.last_report = ExecutorReport(
            wall_seconds=time.perf_counter() - wall0,
            units=sum(len(v) for v in stats.values()),
            load_seconds=load_total,
            wait_seconds=wait_total,
            compute_seconds=compute_total,
            persist_seconds=persist.seconds,
            retries=sum(c["retries"] for c in counts.values()),
            speculations=sum(c["speculations"] for c in counts.values()),
            speculation_wins=sum(c["speculation_wins"] for c in counts.values()),
            quarantined=sum(len(v) for v in quarantined.values()),
        )

        results: dict[int, SliceResult] = {}
        for s in requested:
            o = outs[s]
            avg_err = float(o["error"].mean())
            c = counts.get(s, {})
            r = SliceResult(o["type_idx"], o["params"], o["error"], o["mean"],
                            o["std"], o["skew"], o["kurt"], avg_err, stats[s],
                            slice_i=s, spec_hash=self.spec_hash,
                            retries=c.get("retries", 0),
                            speculations=c.get("speculations", 0),
                            quarantined=tuple(quarantined[s]))
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

    # -- externally batched windows ----------------------------------------------

    def run_window_batch(self, windows: list[regions.Window]) -> list[WindowResult]:
        """Compute many windows with shared launches — the entry point for
        externally batched work (the serving layer's coalesced tick; the
        ``windows`` must be distinct, in any order, possibly spanning
        slices). Each window's per-point results are **bitwise equal** to
        ``run_window``'s:

        * one host-to-device copy stages the whole batch (one pinned
          buffer, sliced back into window views);
        * moments run per window at the window's own shape; on the card
          their launches queue without a host sync between them;
        * baseline and ml fit each window in its own launch;
        * the grouping methods (host Select) choose each window's
          representatives exactly as ``run_window`` does, then pack whole
          windows of one fit-shape class (``grp.padded_size(groups,
          rep_bucket)``) into one fit launch of that size: on the fused
          backend K2 reads them from the batch through its ``row_indices``
          prologue, elsewhere they are gathered. Every fit is row-pure, so
          a row's bits do not depend on its neighbours or the padding.

        ``sampling``, the ``reuse`` variants (cache hits depend on the order
        of insertions) and device Select (its gather, fit and scatter stay
        per window) run each window through ``run_window``, as the
        reference does."""
        if not windows:
            return []
        if len({(w.slice_i, w.line_start) for w in windows}) != len(windows):
            raise ValueError("run_window_batch windows must be distinct")
        method = self.config.method
        if (method == "sampling" or method.startswith("reuse")
                or self.config.select_backend == "device"):
            return [self.run_window(w) for w in windows]

        lmon = self.monitors["load"]
        raws = []
        for w in windows:
            uid = f"batch:s{w.slice_i}/l{w.line_start:05d}"
            lmon.start(uid, now=time.perf_counter())
            raws.append(self.data.load_window(w))
            lmon.finish(uid, now=time.perf_counter())
        cat = self.stager.ready(self.stager.stage(*raws))
        offsets = np.cumsum([0] + [r.shape[0] for r in raws])
        staged = [cat[a:b] for a, b in zip(offsets[:-1], offsets[1:])]

        cmon = self.monitors["compute"]
        uid = f"batch:s{windows[0].slice_i}/l{windows[0].line_start:05d}x{len(windows)}"
        cmon.start(uid, now=time.perf_counter())
        moments = [self._backend.moments(v) for v in staged]
        if method in ("baseline", "ml"):
            fits = [self._fit_device(v, m) for v, m in zip(staged, moments)]
            per = [tuple(f.cpu().numpy() for f in r) for r in fits]
        else:
            per = self._select_and_fit_packed(cat, offsets, moments)
        out = [WindowResult(w, t, p, e, *self._moments_np(m))
               for w, m, (t, p, e) in zip(windows, moments, per)]
        cmon.finish(uid, now=time.perf_counter())
        return out

    def _select_and_fit_packed(self, cat: torch.Tensor, offsets: np.ndarray, moments: list):
        """Grouped Select over a window batch: quantize + dedup per window on
        the host (the grouping scope is the window, as Algorithm 3 defines
        it), then pack whole windows of the same fit-shape class into shared
        fit launches of exactly that size over ``cat``, the batch's rows.
        Returns per-window per-point ``(t, p, e)`` in window order."""
        cfg = self.config
        infos = [grp.group_host(self._quantized_keys(m)) for m in moments]

        # pack: greedy fill within each shape class, preserving window order
        classes: dict[int, list[int]] = {}
        for i, g in enumerate(infos):
            classes.setdefault(grp.padded_size(g.num_groups, cfg.rep_bucket), []).append(i)
        launches: list[tuple[int, list[int]]] = []
        for size, idxs in sorted(classes.items()):
            cur: list[int] = []
            cur_n = 0
            for i in idxs:
                n = infos[i].num_groups
                if cur and cur_n + n > size:
                    launches.append((size, cur))
                    cur, cur_n = [], 0
                cur.append(i)
                cur_n += n
            if cur:
                launches.append((size, cur))

        cat_mom = dists.Moments(*(torch.cat(f) for f in zip(*moments)))
        results: list = [None] * len(moments)
        for size, idxs in launches:
            # padding slots repeat the first representative: discarded by
            # the inverse maps, and row-pure fits make their content moot
            idx = np.full((size,), int(infos[idxs[0]].rep_indices[0]) + int(offsets[idxs[0]]),
                          dtype=np.int64)
            pos = 0
            for i in idxs:
                n = infos[i].num_groups
                idx[pos:pos + n] = infos[i].rep_indices + offsets[i]
                pos += n
            rows = torch.from_numpy(idx).to(cat.device)
            if "ml" in cfg.method:
                r = self._fit_device(*fitting.gather_rows(cat, cat_mom, rows))
            else:
                r = fitting.fit_all_rows(self._backend, cat, cat_mom, rows, tuple(cfg.types),
                                         cfg.num_bins, cfg.mode)
            t, p, e = (f.cpu().numpy() for f in r)
            pos = 0
            for i in idxs:
                g = infos[i]
                n = g.num_groups
                inv = g.inverse
                results[i] = (t[pos:pos + n][inv], p[pos:pos + n][inv], e[pos:pos + n][inv])
                pos += n
        return results

    def run_window(self, w: regions.Window) -> WindowResult:
        """ONE window through exactly the run loop's computation (load →
        moments → Select & fit), without persist: the per-window fallback
        of ``run_window_batch`` and the serving layer's naive
        one-launch-per-query baseline."""
        item = self._load_unit(regions.WorkUnit(w, 0))
        values = self.stager.ready(item.staged)
        total_points = values.shape[0]
        cmon = self.monitors["compute"]
        uid = f"one:s{w.slice_i}/l{w.line_start:05d}"
        cmon.start(uid, now=time.perf_counter())
        values, moments, sample_idx = self._moments_of(values, w)
        t, p, e, _fitted, _hits = self._select_and_fit(values, moments, w, total_points,
                                                       sample_idx)
        mom_np = self._moments_np(moments)
        cmon.finish(uid, now=time.perf_counter())
        if sample_idx is None:
            mean, std, skew, kurt = mom_np
        else:
            # like the run loop: unsampled rows stay zero (type_idx -1)
            mean, std, skew, kurt = (np.zeros((total_points,), dtype=np.float32)
                                     for _ in range(4))
            for dst, col in zip((mean, std, skew, kurt), mom_np):
                dst[sample_idx] = col
        return WindowResult(w, t, p, e, mean, std, skew, kurt)

    def run_window_sharded(self, w: regions.Window, sharded: ShardedStager) -> WindowResult:
        """One window with its points split over the ranks of ``sharded``'s
        mesh: each rank loads the window, stages its block of the rows
        onto its own device, runs moments and the fit on them (K1 and K2
        on the fused backend), copies its results to the host, and the
        ranks' rows are gathered back into the whole window's result. The
        fit is row by row, so it is the one-rank ``run_window``'s result
        bit for bit. For the methods that fit every row (``baseline``,
        ``ml``); every rank of the mesh must call it."""
        if self.config.method not in ("baseline", "ml"):
            raise ValueError(f"run_window_sharded fits every row; method {self.config.method!r} "
                             "groups, reuses or samples over the whole window")
        staged, p = sharded.stage(self.data.load_window(w))
        values = self.stager.ready(staged)
        moments = self._backend.moments(values)
        t, params, e = self._fit(values, moments)
        return WindowResult(w, *sharded.gather([t, params, e, *self._moments_np(moments)], p))

    def watermark(self, slice_i: int) -> int:
        return PersistStage(self.out_dir, async_writes=False).watermark(slice_i)
