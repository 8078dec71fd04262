"""Staged PDF executor: load / compute / persist as decoupled stages.

Port of ``repro.core.executor`` for every method of ``METHODS``, with host
or device Select:

  load stage     ``WindowPrefetcher`` (data/loader.py) loads window *k+1* from
                 the data source and copies it to the device while the device
                 is still fitting window *k*.
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

Select runs on the host (np.unique over int64 keys) or on the device
(``select_backend='device'``: ``torch.unique`` over the same keys, and on
the fused backend K2 reads the representatives through its ``row_indices``
prologue); the two are bitwise equal.

The ``.npz`` and watermark format is the reference's. Not ported yet:
retry, speculation and quarantine (ROADMAP queue 1 item 12) — a load error
propagates to the caller.
"""

from __future__ import annotations

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
from repro_torch.core import grouping as grp
from repro_torch.core import ml_predict as mlp
from repro_torch.core import regions
from repro_torch.core import sampling as smp
from repro_torch.core.grouping import DEFAULT_TOL
from repro_torch.core.ml_predict import TREE_FEATURES, tree_features, tree_features_np  # noqa: F401
from repro_torch.core.reuse import ReuseCache
from repro_torch.data.loader import WindowPrefetcher

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

    @property
    def load_hidden_seconds(self) -> float:
        return max(0.0, self.load_seconds - self.wait_seconds)

    @property
    def load_hidden_fraction(self) -> float:
        return self.load_hidden_seconds / self.load_seconds if self.load_seconds > 0 else 0.0


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
            except BaseException as e:  # repro: allow[ERR]: parked — raise_if_failed re-raises on the main thread
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
    The reuse cache lives on the executor, so windows — and consecutive
    slices and ``run_slice`` calls — share it. The ML and sampling methods
    need ``tree``; its arrays move to ``device`` once, here.
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
        self._backend = fitting.get_fit_backend(config.fit_backend, config.num_bins)
        self.cache = ReuseCache()
        self._key_buf: np.ndarray | None = None  # cached (P, 2) quantize buffer
        self._key_tmp: np.ndarray | None = None
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

    def _compute_window(self, item: _StagedWindow):
        """The compute-stage body for one staged window: moments, Select and
        Algorithm 3 or 4 (or sampling's classification), and the copy of the
        results to the host (which waits for the device, so
        ``compute_seconds`` covers the window's device work). The random
        sampler subsets the window on the device before the moments pass,
        so the device work falls with the rate; the run loop writes its
        moments at ``sample_idx`` only."""
        t0 = time.perf_counter()
        values = item.values
        num_points = values.shape[0]
        sample_idx = None
        if self.config.method == "sampling" and self.config.sampler == "random":
            sample_idx = self._draw_sample(num_points, item.unit.window)
            values = values[torch.from_numpy(sample_idx).to(values.device)]
        moments = self._backend.moments(values)
        t, p, e, fitted, hits = self._select_and_fit(values, moments, item.unit.window,
                                                     num_points, sample_idx)
        mom_np = (moments.mean.cpu().numpy(),
                  np.sqrt(np.maximum(moments.var.cpu().numpy(), 0)),
                  moments.skew.cpu().numpy(), moments.kurt.cpu().numpy())
        return t, p, e, mom_np, sample_idx, fitted, hits, time.perf_counter() - t0

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
                t, p, e, mom_np, sample_idx, fitted, hits, comp_s = self._compute_window(item)

                w = item.unit.window
                o = outs[w.slice_i]
                lo, hi = w.line_start * ppl, w.line_end * ppl
                o["type_idx"][lo:hi], o["params"][lo:hi], o["error"][lo:hi] = t, p, e
                for name, col in zip(("mean", "std", "skew", "kurt"), mom_np):
                    if sample_idx is None:
                        o[name][lo:hi] = col
                    else:  # the random sampler's rows; the others stay zero
                        o[name][lo:hi][sample_idx] = col

                ws = WindowStats(w, hi - lo, fitted, item.load_seconds, comp_s, hits, wait_s)
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
