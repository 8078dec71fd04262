"""``PDFSession``: execute a ``PipelineSpec`` — the one run surface.

A session owns everything a run needs (the data source, the decision tree
when the method wants one, one ``StagedExecutor`` per shard) and exposes a
*streaming* entry point: ``run(slices)`` is a generator yielding one
``SliceResult`` as each slice completes, so callers can persist / print /
aggregate incrementally at paper scale instead of holding every slice's
arrays until the end. ``run_all`` drains it into the familiar
``{slice: result}`` map; ``report()`` aggregates the per-stage executor
reports plus the spec's provenance hash (and, when ``ExecSpec.cache_dir``
routes the session through a ``ResultCache``, the per-slice hit/miss
counts — cache hits stream stored results bitwise-identical without
building an executor at all).

Slices are dealt round-robin over ``spec.execution.shards`` (the paper's
per-node whole-slice assignment, runtime/scheduler.assign_slices); each
shard's executor is cached on the session, so its reuse cache spans all the
slices that shard processes — exactly the semantics of the
``PDFComputer`` facade, which produces bitwise-identical results and
stamps the same spec hash (tests/test_torch_api.py).

Port of ``repro.api.session``. A session runs on ``cuda`` unless the
caller passes ``device=`` (``"cpu"`` for the kernels' plain versions); with
no device given and no CUDA device present it raises. What the port does
not have yet raises ``NotImplementedError`` at construction instead of
running something else: multi-process placement and
``execution.compile_cache_dir`` (ROADMAP item 15), and
``stream.persist_stats`` with an ``out_dir`` (item 13). The merge-mode
incremental update (item 13) raises where the reference would merge.
"""

from __future__ import annotations

import warnings
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.api.cache import ResultCache
from repro_torch.api.spec import PipelineSpec, build_source
from repro_torch.core import ml_predict as mlp
from repro_torch.core import regions
from repro_torch.core.executor import ExecutorReport, SliceResult, StagedExecutor
from repro_torch.core.pipeline import resolve_device
from repro_torch.kernels import _build
from repro_torch.runtime import elastic
from repro_torch.runtime.faults import FaultInjector, FaultPlan, ShardLostError
from repro_torch.runtime.scheduler import assign_slices


@dataclass(frozen=True)
class SessionReport:
    """Per-stage totals over every executor run the session has done, plus
    the spec provenance hash (the same hash stamped into persisted
    watermarks and BENCH rows)."""

    spec_hash: str
    slices_done: int
    windows: int
    wall_seconds: float
    load_seconds: float
    wait_seconds: float
    compute_seconds: float
    persist_seconds: float
    # ResultCache traffic (ExecSpec.cache_dir): slices served without any
    # compute vs slices computed (and stored). Both stay 0 with no cache.
    cache_hits: int = 0
    cache_misses: int = 0
    # Streaming (DESIGN.md §16): entries re-keyed across an append because
    # their chunk fingerprints were unchanged (each then counts as a hit),
    # and slices updated by the merge path instead of a full recompute.
    cache_adopted: int = 0
    slices_merged: int = 0
    # Fault-tolerance totals (DESIGN.md §14): transient re-attempts,
    # speculative load re-dispatches, quarantined (degraded-mode) units,
    # and shards that died mid-run whose slices were re-dealt.
    retries: int = 0
    speculations: int = 0
    quarantined_units: int = 0
    shards_lost: tuple[int, ...] = ()
    # Cold-start visibility (DESIGN.md §17): process-wide kernel-library
    # activity since the session was constructed (``kernels._build``
    # counter deltas — concurrent sessions in one process share the
    # counters). ``compile_cache_misses`` counts nvcc builds started,
    # ``compile_cache_hits`` libraries loaded from ``build/kernels/``
    # without a build, ``compiles`` both. A library loads once a process,
    # so a second session in the same process reports 0. ``traces`` stays
    # 0: eager PyTorch traces nothing.
    traces: int = 0
    compiles: int = 0
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    shard_reports: dict[int, list[ExecutorReport]] = field(default_factory=dict)
    # Per-stage latency percentiles over every completed unit (seconds):
    # {"load"|"compute"|"persist": {"p50": ..., "p99": ...}} — from the
    # executors' StepMonitors, merged across shards. The serve layer's stats
    # endpoint reuses the same monitors/estimator verbatim.
    stage_percentiles: dict[str, dict[str, float]] = field(default_factory=dict)

    @property
    def load_hidden_seconds(self) -> float:
        return max(0.0, self.load_seconds - self.wait_seconds)

    @property
    def load_hidden_fraction(self) -> float:
        return (self.load_hidden_seconds / self.load_seconds
                if self.load_seconds > 0 else 0.0)


class PDFSession:
    """Execute a validated ``PipelineSpec``.

    ``data_source`` overrides the source the spec would build (required for
    ``source.kind='external'``; it must expose ``geometry`` and
    ``load_window``). ``tree`` injects a pre-trained decision tree —
    otherwise one is trained lazily per ``spec.method.tree`` the first time
    an ml/sampling method needs it. ``device`` is where the session's
    executors and the tree's training run (``core.pipeline.resolve_device``:
    ``cuda`` unless given); ``placement.shard_devices`` moves a shard's
    executor to another CUDA device.
    """

    def __init__(self, spec: PipelineSpec, data_source=None,
                 tree: mlp.DecisionTree | None = None,
                 fault_injector: FaultInjector | None = None,
                 device: torch.device | str | None = None):
        if not isinstance(spec, PipelineSpec):
            raise TypeError(f"spec must be a PipelineSpec, got {type(spec).__name__}")
        exe = spec.execution
        if exe.placement.num_processes > 1 or exe.placement.process_id is not None:
            raise NotImplementedError(
                "multi-process placement (execution.placement.num_processes "
                "> 1 or a process_id) is not ported yet: ROADMAP item 15 "
                "(cluster on torch.distributed)")
        if exe.compile_cache_dir is not None:
            raise NotImplementedError(
                "execution.compile_cache_dir is not ported yet: ROADMAP item "
                "15 (the kernel cache keyed by spec hash); kernels build once "
                "into build/kernels/")
        if spec.stream.persist_stats and exe.out_dir is not None:
            raise NotImplementedError(
                "stream.persist_stats (sufficient-statistic sidecars) is not "
                "ported yet: ROADMAP item 13 (streaming)")
        self.device = resolve_device(device)
        self._shard_devices = self._check_shard_devices(exe.placement.shard_devices)
        self.spec = spec
        self.source = data_source if data_source is not None else build_source(spec.source)
        self._tree = tree
        self._executors: dict[int, StagedExecutor] = {}
        self._reports: dict[int, list[ExecutorReport]] = {}
        self._slices_done = 0
        # Chaos layer (DESIGN.md §14): an explicit injector wins; otherwise
        # ExecSpec.fault_plan (the --fault-plan JSON file) builds one. Each
        # shard's executor reads through its own injector-wrapped source,
        # so shard-targeted rules (shard_death) see the right identity.
        self.injector = fault_injector
        if self.injector is None and spec.execution.fault_plan:
            self.injector = FaultInjector(
                FaultPlan.load(spec.execution.fault_plan))
        self.shards_lost: tuple[int, ...] = ()
        # Hashed once: the spec is frozen, and for kind='file' hashing reads
        # + digests the on-disk manifest — per-slice cache lookups must not
        # repeat that (and a manifest swapped mid-run must not split the
        # session across two hashes).
        self._spec_hash = spec.content_hash()
        # The counter baseline makes report()'s build counts session-scoped.
        self._compile_baseline = _build.counters()
        self.cache = (ResultCache(spec.execution.cache_dir,
                                  max_bytes=spec.execution.cache_max_bytes,
                                  injector=self.injector)
                      if spec.execution.cache_dir else None)
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_adopted = 0
        self.slices_merged = 0
        self._manifest: dict | None = None  # file-source manifest, read once
        self._lineage: tuple[str, ...] | None = None  # archived-version hashes
        if self.cache is not None and spec.source.kind == "external":
            # Same honesty gap as resume: the hash covers the pipeline
            # knobs but cannot capture an external source's data identity,
            # so a cache entry could be served to a run over different data.
            warnings.warn(
                "result cache with an external data source: the spec hash "
                "keys the pipeline knobs only, not the dataset's identity — "
                "make sure cache_dir belongs to this source (or export the "
                "data with file_source.export_cube and use kind='file')",
                stacklevel=2)

    # -- components ------------------------------------------------------------

    def _check_shard_devices(self, shard_devices) -> tuple[int, ...] | None:
        """``placement.shard_devices`` as CUDA device indices, refused on a
        CPU session or past the devices present."""
        if shard_devices is None:
            return None
        if self.device.type != "cuda":
            raise ValueError(
                f"execution.placement.shard_devices {shard_devices} names CUDA "
                f"devices, but the session runs on {self.device}")
        count = torch.cuda.device_count()
        bad = [d for d in shard_devices if d >= count]
        if bad:
            raise ValueError(
                f"execution.placement.shard_devices {bad} beyond the "
                f"{count} CUDA device(s) present")
        return tuple(shard_devices)

    @property
    def geometry(self) -> regions.CubeGeometry:
        return self.source.geometry

    @property
    def spec_hash(self) -> str:
        return self._spec_hash

    def _needs_tree(self) -> bool:
        m = self.spec.method.name
        return "ml" in m or m == "sampling"

    @property
    def tree(self) -> mlp.DecisionTree | None:
        """The decision tree (§5.3.1), trained on demand from the spec's
        TreeSpec when the method requires one."""
        if self._tree is None and self._needs_tree():
            from repro_torch.core.pipeline import train_type_tree

            ts = self.spec.method.tree
            slices = ts.train_slices
            if slices is None:
                slices = tuple(range(min(4, self.geometry.num_slices)))
            self._tree = train_type_tree(
                self.source,
                types=tuple(self.spec.compute.types),
                slices=slices,
                window_lines=ts.train_window_lines,
                depth=ts.depth,
                max_bins=ts.max_bins,
                device=self.device,
            )
        return self._tree

    def executor(self, shard: int = 0) -> StagedExecutor:
        """The shard's ``StagedExecutor`` (built on first use; its reuse
        cache persists across every slice the shard runs). With a fault
        injector active, the shard reads through an injector-wrapped source
        (read faults, shard death) and its persist stage gets the injector's
        write hook. It runs on its ``placement.shard_devices`` entry
        (round-robin when the list is shorter), else on the session's
        device: the same kernels on the same inputs, so any placement gives
        the same bits."""
        if shard not in self._executors:
            source = self.source
            if self.injector is not None:
                source = self.injector.wrap_source(source, shard=shard)
            sd = self._shard_devices
            self._executors[shard] = StagedExecutor(
                self.spec.pdf_config(),
                source,
                self.device if sd is None else torch.device("cuda", sd[shard % len(sd)]),
                tree=self.tree,
                out_dir=self.spec.execution.out_dir,
                exec_config=self.spec.exec_config(),
                spec_hash=self.spec_hash,
                injector=self.injector,
            )
        return self._executors[shard]

    # -- execution -------------------------------------------------------------

    def resolve_slices(self, slices) -> list[int]:
        if slices is None:
            slices = self.spec.execution.slices
        if slices is None:
            slices = range(self.geometry.num_slices)
        return list(slices)

    def run(
        self,
        slices=None,
        resume: bool | None = None,
        on_window: Callable | None = None,
    ) -> Iterator[SliceResult]:
        """Stream ``SliceResult``s (each carries its ``slice_i`` and the
        spec hash). ``slices`` defaults to ``spec.execution.slices`` (then
        to the whole cube); ``resume`` defaults to ``spec.execution.resume``.
        Shards run in assignment order; within a shard, slices stream in the
        order given.

        With ``ExecSpec.cache_dir`` set, each slice first consults the
        ``ResultCache`` under the spec's content hash: a hit streams the
        stored result bitwise-identical (``cached=True``, no executor work,
        no ``on_window`` callbacks), a miss computes the slice and stores
        it. Executors are built lazily, so a fully cache-served run never
        builds one (nor trains the decision tree)."""
        if resume is None:
            resume = self.spec.execution.resume
        if resume and self.spec.source.kind == "external":
            # The hash covers the pipeline knobs but admits it cannot
            # capture an external source's identity — two different
            # datasets with the same knobs hash alike, so the watermark
            # check cannot catch that particular mixup.
            warnings.warn(
                "resuming with an external data source: the spec hash "
                "verifies the pipeline knobs only, not the dataset's "
                "identity — make sure out_dir belongs to this source",
                stacklevel=2)
        exe = self.spec.execution
        bound = self.spec.method.error_bound
        resolved = self.resolve_slices(slices)
        self._adopt_unchanged(resolved)
        lost: list[int] = []
        pending: list[int] = []  # slices stranded on dead shards, in order
        healthy: list[int] = []
        for a in assign_slices(resolved, exe.shards):
            if exe.shard is not None and a.shard != exe.shard:
                continue
            dead = False
            ex = None
            for i, s in enumerate(a.slices):
                if self.cache is not None:
                    hit = self.cache.lookup(self.spec_hash, s)
                    if hit is not None:
                        if bound is not None:
                            hit.error_bound_satisfied = hit.avg_error <= bound
                        self.cache_hits += 1
                        self._slices_done += 1
                        self._persist_cached(hit, resume=resume)
                        yield hit
                        continue
                    self.cache_misses += 1
                merged = self._try_merge(s)
                if merged is not None:
                    # merge-mode incremental update (streaming/incremental):
                    # NOT stored in the ResultCache — merged results are
                    # path-dependent (within the recorded ulp budget, not
                    # bitwise), and the cache serves only bitwise entries.
                    if bound is not None:
                        merged.error_bound_satisfied = merged.avg_error <= bound
                    self._slices_done += 1
                    self.slices_merged += 1
                    yield merged
                    continue
                if ex is None:
                    ex = self.executor(a.shard)
                try:
                    result = self._run_one(ex, a.shard, s, resume, on_window)
                except ShardLostError:
                    # The batch form of a transient failure: the shard is
                    # gone, its unfinished slices get re-dealt below over
                    # whoever survives (runtime/elastic.plan_redeal). In
                    # pinned single-shard mode (a cluster worker) there is
                    # nobody else in this process — the death propagates so
                    # a cross-process protocol can publish the lost marker
                    # and let survivors redeal.
                    if exe.shard is not None:
                        raise
                    lost.append(a.shard)
                    pending.extend(a.slices[i:])
                    dead = True
                    break
                yield result
            if not dead:
                healthy.append(a.shard)
        if pending:
            self.shards_lost = tuple(lost)
            plan = elastic.plan_redeal(pending, healthy, lost)
            # resume=True when persisting: windows the dead shard already
            # made durable are restored, only its remaining units re-run
            # (the watermark + failed-unit manifest are the recovery line).
            redeal_resume = bool(resume or exe.out_dir is not None)
            for h in plan.healthy_shards:
                for s in plan.slices_for(h):
                    yield self._run_one(
                        self.executor(h), h, s, redeal_resume, on_window)

    def run_local(
        self,
        slices,
        shard: int | None = None,
        resume: bool | None = None,
        on_window: Callable | None = None,
    ) -> Iterator[SliceResult]:
        """Run an explicit slice list on ONE shard's executor, bypassing the
        round-robin deal — the redeal seam a cluster layer uses: a
        survivor (or join-only worker) takes its ``plan_redeal`` share here,
        where ``run(slices=...)`` would re-deal the list over all shards and
        skip the ones not pinned to this process. ``resume`` defaults to
        True when an out_dir exists (windows a dead shard persisted are
        skipped; recomputed windows are bitwise-identical)."""
        if shard is None:
            shard = self.spec.execution.shard or 0
        if resume is None:
            resume = bool(self.spec.execution.resume
                          or self.spec.execution.out_dir is not None)
        for s in slices:
            yield self._run_one(self.executor(shard), shard, s, resume,
                                on_window)

    def _run_one(self, ex: StagedExecutor, shard: int, s: int,
                 resume: bool, on_window: Callable | None) -> SliceResult:
        """Run one slice on one shard's executor, recording its report and
        result-cache traffic. Degraded results are NOT stored: a cache entry
        answers for the whole slice, and a quarantined window's zeros are a
        hole, not an answer — the cache must only ever serve complete
        slices."""
        plan = regions.build_plan(
            self.geometry, [s], self.spec.compute.window_lines
        )
        result = ex.run(plan, resume=resume, on_window=on_window)[s]
        if ex.last_report is not None:
            self._reports.setdefault(shard, []).append(ex.last_report)
        self._slices_done += 1
        if self.cache is not None:
            if result.degraded:
                warnings.warn(
                    f"slice {s} completed degraded "
                    f"({len(result.quarantined)} quarantined unit(s)) — "
                    "not stored in the result cache", stacklevel=2)
            else:
                self.cache.store(result, deps=self._slice_deps(s))
        return result

    # -- streaming: adoption / merge updates (DESIGN.md §16) -------------------

    def _file_source(self):
        """The underlying ``FileCubeSource`` (unwrapping a throttle), or
        None when the session does not read a file cube."""
        if self.spec.source.kind != "file":
            return None
        src = getattr(self.source, "inner", self.source)
        return src if hasattr(src, "load_window_obs") else None

    def _slice_deps(self, s: int) -> tuple[str, ...] | None:
        """The slice's chunk-dependency fingerprint under the manifest this
        session hashed against (read once — a manifest swapped mid-run must
        not split the session across two fingerprints)."""
        if self.spec.source.kind != "file":
            return None
        from repro_torch.data.file_source import read_manifest, slice_chunk_shas

        if self._manifest is None:
            self._manifest = read_manifest(self.spec.source.path)
        return slice_chunk_shas(self._manifest, s)

    def _adopt_unchanged(self, slices) -> None:
        """Chunk-granular invalidation, the adoption half: re-key cached
        entries from earlier manifest versions whose chunk fingerprints are
        unchanged by the appends since (``ResultCache.adopt`` proves that
        per slice), so only chunk-overlapping slices miss. Most-recent
        version first; each adopted entry becomes a plain cache hit."""
        if (self.cache is None or not self.spec.stream.incremental
                or self._file_source() is None):
            return
        from repro_torch.data.file_source import manifest_version

        try:
            cur = manifest_version(self.spec.source.path)
        except (OSError, ValueError, KeyError):
            return
        remaining = [s for s in slices
                     if not self.cache.path(self.spec_hash, s).exists()]
        for v in range(cur - 1, 0, -1):
            if not remaining:
                return
            try:
                old_hash = self.spec.content_hash(manifest_version=v)
            except (OSError, ValueError, KeyError):
                return  # archived manifest missing: nothing older to scan
            still = []
            for s in remaining:
                deps = self._slice_deps(s)
                if deps and self.cache.adopt(old_hash, self.spec_hash, s, deps):
                    self.cache_adopted += 1
                else:
                    still.append(s)
            remaining = still

    def _lineage_hashes(self) -> tuple[str, ...]:
        """The spec's hashes at every archived manifest version, newest
        first — the set of stamps a sidecar written by an ancestor run of
        THIS spec over THIS cube may legitimately carry (``merge_slice``
        accepts them after a cache-hit persist re-stamped the watermark
        without rewriting the sidecars). Memoized per spec hash;
        ``refresh_source`` invalidates."""
        if self._lineage is None:
            from repro_torch.data.file_source import manifest_version

            hashes: list[str] = []
            try:
                cur = manifest_version(self.spec.source.path)
                for v in range(cur - 1, 0, -1):
                    hashes.append(self.spec.content_hash(manifest_version=v))
            except (OSError, ValueError, KeyError):
                pass  # unversioned/missing archives: lineage ends here
            self._lineage = tuple(hashes)
        return self._lineage

    def _try_merge(self, s: int):
        """The merge-mode incremental path for one slice: None to fall
        through to a full recompute wherever the reference's
        ``streaming.incremental.merge_slice`` returns None (strict mode,
        non-file sources, no out_dir, no complete prior watermark, a
        missing, foreign or mis-windowed sufficient-statistic sidecar, a
        sidecar at other bins, nothing appended since it, or edges the
        append moved). Where the reference would merge, the port raises:
        the merge path is ROADMAP item 13, and recomputing instead would
        silently give other bits than the reference's merge."""
        out_dir = self.spec.execution.out_dir
        if self.spec.stream.update_mode != "merge" or out_dir is None:
            return None
        src = self._file_source()
        if src is None:
            return None
        from repro_torch.core.executor import PersistStage

        geom = src.geometry
        info = PersistStage(out_dir, async_writes=False).watermark_info(s)
        old_hash = info.get("spec_hash")
        if not old_hash or int(info.get("next_line", 0)) < geom.lines_per_slice:
            return None  # no complete prior run to merge forward
        accept = {old_hash, *self._lineage_hashes(), ""}
        for w in regions.iter_windows(geom, s, self.spec.compute.window_lines):
            f = Path(out_dir) / f"slice{s}_stats_{w.line_start:05d}.npz"
            try:
                with np.load(f) as z:
                    if (str(z["spec_hash"]) not in accept
                            or (int(z["line_start"]), int(z["line_end"]))
                            != (w.line_start, w.line_end)
                            or int(z["num_bins"]) != self.spec.compute.num_bins):
                        return None
                    n_old = int(float(z["n"]))
                    vmin, vmax = z["vmin"], z["vmax"]
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                return None  # sidecar missing or unreadable
            n_now = src.slice_observations(s)
            if n_now <= n_old:
                return None  # nothing appended since the sidecar was recorded
            new = src.load_window_obs(w, n_old, n_now).astype(np.float64)
            if (new.min(axis=1) < vmin).any() or (new.max(axis=1) > vmax).any():
                return None  # edges moved: old Eq.-5 counts are not reusable
        raise NotImplementedError(
            f"slice {s}: a merge-mode incremental update applies (sidecars of "
            f"a complete prior run in {out_dir}), and the merge path is not "
            "ported yet: ROADMAP item 13 (streaming); run with "
            "stream.update_mode='strict' to recompute the slice in full")

    def refresh_source(self) -> str:
        """Re-open a file source at the cube's current manifest version and
        re-hash the spec — the serve layer's ``invalidate`` and ``run_pdf
        --watch`` call this after an append lands. Executors are dropped
        (their sources pin the old version); returns the new spec hash."""
        if self.spec.source.kind == "file":
            self.source = build_source(self.spec.source)
        self._manifest = None
        self._lineage = None
        self._executors.clear()
        self._spec_hash = self.spec.content_hash()
        return self._spec_hash

    def _persist_cached(self, result: SliceResult, resume: bool = False) -> None:
        """Honor ``ExecSpec.out_dir`` for cache-served slices: a hit skips
        the executor, so its window ``.npz`` files + watermark are written
        here from the cached arrays instead (same ``PersistStage`` format,
        identical bytes per the cache's bitwise contract) — a run with both
        ``--cache-dir`` and ``--out-dir`` never leaves out_dir empty. A
        resuming run applies the same watermark spec-hash mismatch check
        the executor does: a cache hit must not quietly overwrite another
        computation's watermark where the computed path would refuse."""
        out_dir = self.spec.execution.out_dir
        if out_dir is None:
            return
        from repro_torch.core.executor import _FIELDS, PersistStage

        geom, s = self.geometry, result.slice_i
        persist = PersistStage(out_dir, async_writes=False,
                               spec_hash=self.spec_hash,
                               total_lines=geom.lines_per_slice)
        mark = 0
        if resume:
            info = persist.watermark_info(s)
            persist.check_resume_hash(s, info)
            # like the executor, skip windows the watermark already covers —
            # a resumed cache-hit run over a fully persisted out_dir must
            # not rewrite identical bytes for the whole slice
            mark = int(info["next_line"])
        for w in regions.iter_windows(geom, s, self.spec.compute.window_lines,
                                      start_line=mark):
            lo, hi = w.line_start * geom.points_per_line, w.line_end * geom.points_per_line
            persist.submit(
                s, w, {name: getattr(result, name)[lo:hi] for name in _FIELDS}
            )
        persist.close()
        persist.raise_if_failed()

    def run_all(
        self,
        slices=None,
        resume: bool | None = None,
        on_window: Callable | None = None,
    ) -> dict[int, SliceResult]:
        """Drain ``run`` into a ``{slice: SliceResult}`` map."""
        return {
            r.slice_i: r
            for r in self.run(slices, resume=resume, on_window=on_window)
        }

    def stage_percentiles(self) -> dict[str, dict[str, float]]:
        """p50/p99 unit latency per executor stage (seconds), merged over
        every shard's monitors — not just totals, so a serving/streaming
        consumer can see tail behaviour. Stages with no completed units are
        omitted."""
        from repro_torch.runtime.monitor import percentiles

        merged: dict[str, list[float]] = {}
        for ex in self._executors.values():
            for stage, mon in ex.monitors.items():
                merged.setdefault(stage, []).extend(mon.history)
        return {stage: percentiles(h) for stage, h in merged.items() if h}

    def report(self) -> SessionReport:
        """Aggregate per-stage totals over everything run so far."""
        totals = dict(wall=0.0, load=0.0, wait=0.0, compute=0.0, persist=0.0)
        windows = retries = speculations = quarantined = 0
        for reps in self._reports.values():
            for r in reps:
                totals["wall"] += r.wall_seconds
                totals["load"] += r.load_seconds
                totals["wait"] += r.wait_seconds
                totals["compute"] += r.compute_seconds
                totals["persist"] += r.persist_seconds
                windows += r.units
                retries += r.retries
                speculations += r.speculations
                quarantined += r.quarantined
        now = _build.counters()
        builds = now["builds"] - self._compile_baseline["builds"]
        loads = now["cached_loads"] - self._compile_baseline["cached_loads"]
        return SessionReport(
            spec_hash=self.spec_hash,
            slices_done=self._slices_done,
            windows=windows,
            compiles=builds + loads,
            compile_cache_hits=loads,
            compile_cache_misses=builds,
            cache_hits=self.cache_hits,
            cache_misses=self.cache_misses,
            cache_adopted=self.cache_adopted,
            slices_merged=self.slices_merged,
            retries=retries,
            speculations=speculations,
            quarantined_units=quarantined,
            shards_lost=self.shards_lost,
            wall_seconds=totals["wall"],
            load_seconds=totals["load"],
            wait_seconds=totals["wait"],
            compute_seconds=totals["compute"],
            persist_seconds=totals["persist"],
            shard_reports={k: list(v) for k, v in self._reports.items()},
            stage_percentiles=self.stage_percentiles(),
        )
