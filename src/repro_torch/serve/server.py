"""``PDFServer``: coalescing query serving over warm executors (DESIGN.md §13).

Port of ``repro.serve.server``; the server runs its session on ``cuda``
unless the caller passes ``device=``.

The batch pipeline answers "compute every PDF of the cube"; the paper's
stated consumers ask much smaller questions, concurrently — the PDF at one
point, one horizon span, one slice. This module is the long-lived layer
between those consumers and the warm machinery a ``PDFSession`` owns:

  submit     callers (any thread) put queries on a FIFO queue and get a
             ``Future``; ``query()`` is the blocking convenience.
  coalesce   one background thread drains whatever is pending each tick,
             maps every query onto the aligned window grid
             (``compute.window_lines`` — the executor's unit of work), and
             deduplicates: ten point queries in one hot window become ONE
             window to produce.
  resolve    each needed window comes from, in order: the in-memory
             hot-window LRU, the spec-hash-keyed ``ResultCache`` (a stored
             slice is sliced into windows without touching an executor),
             else the compute batch.
  launch     every window still missing is computed by ONE
             ``StagedExecutor.run_window_batch`` call (chunked at
             ``serve.max_batch_windows``) — shared H2D + barrier, packed
             representative fits — not one synced dispatch per query.
  scatter    per-request answers are cut from the resolved windows and set
             on the futures; completed slices are stored back to the
             ``ResultCache`` so the next server process starts warm.

The batching thread follows the offline-inference engine pattern the
ROADMAP points at (batch slots + request queue + background thread that
fails loudly), refined by a transient/fatal split (DESIGN.md §14): a
*transient* launch failure (``faults.is_transient`` — injected faults,
OSError, timeouts) is retried up to ``serve.retry_transient`` times and,
if still failing, fails ONLY the futures whose windows that launch
covered — the server keeps serving everything else. Any *fatal* exception
keeps the original behaviour: it fails the in-flight batch's futures,
poisons the server, and re-raises — a wedged server is impossible to
mistake for a slow one. Two more overload guards: ``serve.max_queue_depth``
sheds submissions (``ServerOverloadedError``) once the queue gauge hits
the cap, and ``serve.request_deadline_s`` expires requests that waited in
the queue longer than their deadline (their futures get ``TimeoutError``
before any compute is spent on them).

**Coalescing-equivalence contract**: answers are bitwise-identical to
running each query's windows through the executor serially
(``serve.coalesce=False`` is exactly that baseline), because
``run_window_batch`` shares the batch's copy and fit launches but keeps
every fit row-pure — a row's bits do not depend on the rows launched with
it (DESIGN.md §13.2) — so no per-window Select decision or reduction order
changes. That is the contract ``ServeSpec`` being excluded from
``content_hash`` rests on (tests/test_torch_serve.py).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from repro_torch.api.session import PDFSession
from repro_torch.api.spec import PipelineSpec
from repro_torch.core import regions
from repro_torch.core.executor import RESULT_FIELDS, SliceResult, WindowResult
from repro_torch.runtime.faults import is_transient
from repro_torch.runtime.monitor import StepMonitor, StragglerPolicy

_SHUTDOWN = object()


@dataclass
class _Invalidate:
    """Control item for ``PDFServer.invalidate``: processed on the serving
    thread (never mid-batch), so it can rewire the session and prune the
    hot-window state without racing a launch."""

    version: int | None
    done: threading.Event
    result: dict
    error: BaseException | None = None


class ServerOverloadedError(RuntimeError):
    """Raised by ``submit`` when the queue gauge is at
    ``serve.max_queue_depth``: load shedding — the caller should back off
    and retry, the server is protecting its latency for admitted work."""


# -- queries -------------------------------------------------------------------


@dataclass(frozen=True)
class PointQuery:
    """The PDF at one point of the cube."""

    slice_i: int
    line: int
    point: int


@dataclass(frozen=True)
class WindowQuery:
    """Per-point PDFs over a span of lines ``[line_start, line_end)`` of one
    slice — any span, not necessarily aligned to the window grid."""

    slice_i: int
    line_start: int
    line_end: int


@dataclass(frozen=True)
class RegionQuery:
    """Per-point PDFs of one whole slice."""

    slice_i: int


@dataclass
class QueryAnswer:
    """Per-point results for the queried span (arrays are 1-point long for a
    ``PointQuery``), plus where its windows came from."""

    query: object
    spec_hash: str
    type_idx: np.ndarray  # (Q,) int32
    params: np.ndarray  # (Q, 3)
    error: np.ndarray  # (Q,)
    mean: np.ndarray  # (Q,)
    std: np.ndarray  # (Q,)
    skew: np.ndarray  # (Q,)
    kurt: np.ndarray  # (Q,)
    windows_computed: int = 0
    windows_from_memory: int = 0
    windows_from_disk: int = 0
    latency_seconds: float = 0.0


@dataclass(frozen=True)
class ServerStats:
    """A consistent snapshot of the server's counters (``PDFServer.stats()``).

    ``coalesce_ratio`` is windows requested (pre-dedup, over all queries)
    per window actually computed — the fused-launch sharing factor;
    ``batch_occupancy`` is computed windows per launch. ``latency`` /
    ``stage_percentiles`` quote the same p50/p99 estimator as
    ``SessionReport`` (runtime.monitor.percentiles)."""

    spec_hash: str
    queries: int
    queries_by_kind: dict[str, int]
    ticks: int
    launches: int
    windows_requested: int
    windows_unique: int
    windows_computed: int
    windows_from_memory: int
    windows_from_disk: int
    slices_stored: int
    max_queue_depth: int
    latency: dict[str, float]  # request p50/p99, seconds
    launch_latency: dict[str, float]  # run_window_batch p50/p99, seconds
    stage_percentiles: dict[str, dict[str, float]] = field(default_factory=dict)
    # failure-model counters (DESIGN.md §14)
    shed_requests: int = 0  # submits refused at serve.max_queue_depth
    deadline_expired: int = 0  # requests timed out waiting in the queue
    launch_retries: int = 0  # transient launch failures (retried attempts)
    windows_failed: int = 0  # windows whose launches exhausted retries

    @property
    def coalesce_ratio(self) -> float:
        return self.windows_requested / max(self.windows_computed, 1)

    @property
    def batch_occupancy(self) -> float:
        return self.windows_computed / max(self.launches, 1)

    @property
    def window_hit_rate(self) -> float:
        served = self.windows_from_memory + self.windows_from_disk
        return served / max(served + self.windows_computed, 1)


class _Pending(NamedTuple):
    query: object
    slice_i: int
    lo: int  # point span within the slice, [lo, hi)
    hi: int
    windows: tuple[regions.Window, ...]  # aligned windows covering the span
    future: Future
    t_submit: float


class PDFServer:
    """Serve point / window / region PDF queries for one ``PipelineSpec``.

    Construction is cheap: executors compile and the tree trains lazily on
    the first computed window (a server in front of a fully-populated
    ``ResultCache`` never builds either). Start/stop with ``start()`` /
    ``close()`` or use as a context manager. ``data_source`` / ``tree`` /
    ``device`` forward to ``PDFSession``.
    """

    def __init__(self, spec: PipelineSpec, data_source=None, tree=None, device=None):
        self.session = PDFSession(spec, data_source=data_source, tree=tree, device=device)
        self.spec = self.session.spec
        self._serve = spec.serve
        self._grid = spec.compute.window_lines
        geom = self.session.geometry
        self._geom = geom
        self._ppl = geom.points_per_line
        self._windows_per_slice = regions.num_windows(geom, self._grid)

        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        # _depth and _counts are mutated from caller threads (submit/shed)
        # AND the serving thread — every mutation holds _stats_lock (the
        # LOCK rule enforces this); stats() reads are lock-snapshot too.
        self._stats_lock = threading.Lock()
        self._depth = 0  # queued-request gauge
        self._lru: OrderedDict[tuple[int, int], WindowResult] = OrderedDict()
        # per-slice window accumulation -> ResultCache store on completion
        self._parts: dict[int, dict[tuple[int, int], WindowResult]] = {}
        self._stored_slices: set[int] = set()

        self.monitors = {
            # serving latencies are ms-scale: drop the straggler grace floor
            # so the percentile reservoirs stay meaningful out of the box
            "request": StepMonitor(StragglerPolicy(grace_seconds=0.0)),
            "launch": StepMonitor(StragglerPolicy(grace_seconds=0.0)),
        }
        self._counts = dict(
            queries=0, ticks=0, launches=0, windows_requested=0,
            windows_unique=0, windows_computed=0, windows_from_memory=0,
            windows_from_disk=0, slices_stored=0, max_queue_depth=0,
            shed_requests=0, deadline_expired=0, launch_retries=0,
            windows_failed=0,
        )
        self._by_kind: dict[str, int] = {}
        self._failure: BaseException | None = None
        self._closed = False
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "PDFServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._thread = threading.Thread(
            target=self._serve_loop, name="pdf-serve", daemon=True
        )
        self._thread.start()
        return self

    def close(self, timeout: float | None = None) -> None:
        """Graceful drain: stop accepting new queries, serve everything
        already queued (FIFO up to the shutdown marker), stop the thread.

        The *first* close re-raises a serving-thread failure (a crash must
        surface loudly at least once); every later close is a silent no-op,
        so ``close()`` is safe from ``finally`` blocks and ``__exit__``
        stacks even after the serving thread died mid-batch."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._queue.put(_SHUTDOWN)
            self._thread.join(timeout)
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        if self._failure is not None:
            raise RuntimeError("PDF server thread failed") from self._failure

    def __enter__(self) -> "PDFServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission ------------------------------------------------------------

    def submit(self, q) -> Future:
        """Enqueue a query; returns a ``Future`` resolving to its
        ``QueryAnswer``. Raises immediately on malformed queries, a closed
        server, a failed serving thread, or (``ServerOverloadedError``) a
        queue already at ``serve.max_queue_depth``."""
        self.raise_if_failed()
        if self._closed:
            raise RuntimeError("server is closed")
        if self._thread is None:
            raise RuntimeError("server not started (use start() or 'with')")
        cap = self._serve.max_queue_depth
        if cap:
            with self._stats_lock:
                if self._depth >= cap:
                    self._counts["shed_requests"] += 1
                    raise ServerOverloadedError(
                        f"queue depth {self._depth} at max_queue_depth={cap}"
                        " — request shed, retry with backoff")
        pending = self._resolve_span(q)
        with self._stats_lock:
            self._depth += 1
            self._counts["max_queue_depth"] = max(
                self._counts["max_queue_depth"], self._depth)
        self._queue.put(pending)
        return pending.future

    def query(self, q, timeout: float | None = None) -> QueryAnswer:
        """Submit + wait."""
        return self.submit(q).result(timeout)

    # -- streaming invalidation (DESIGN.md §16) --------------------------------

    def invalidate(self, version: int | None = None,
                   timeout: float | None = None) -> dict:
        """Pick up an append to the served file cube without a restart.

        Computes the chunk-diff from the version this server opened to
        ``version`` (default: the cube's current manifest), re-opens the
        source at the new version (re-hashing the spec), adopts cached
        results for slices the diff proves untouched, and drops the
        hot-window LRU / pending slice assemblies / known-stored marks for
        exactly the changed slices — untouched slices keep serving from
        memory bitwise-identically (their bytes are unchanged; that is what
        the fingerprint check certifies).

        Applied on the serving thread between batches: queries submitted
        before the call are answered from pre-append state, queries after
        see the new version. Returns ``{"old_version", "new_version",
        "changed_slices", "adopted"}``. Requires a ``kind='file'`` source."""
        self.raise_if_failed()
        inv = _Invalidate(version, threading.Event(), {})
        if self._thread is None or self._closed:
            # not serving: no batch to race — apply inline (lets a server be
            # invalidated before start(), e.g. warm-up flows)
            self._apply_invalidate(inv)
        else:
            self._queue.put(inv)
            if not inv.done.wait(timeout):
                raise TimeoutError("invalidate not applied within timeout")
        if inv.error is not None:
            raise inv.error
        return inv.result

    def _apply_invalidate(self, inv: _Invalidate) -> None:
        try:
            src = self.session._file_source()
            if src is None:
                raise ValueError(
                    "invalidate() requires a kind='file' source (appends "
                    "land as manifest versions of an exported cube)")
            from repro_torch.data.file_source import chunk_diff

            old_version = src.version
            diff = chunk_diff(self.spec.source.path, old_version, inv.version)
            changed = set(diff["changed_slices"])
            adopted0 = self.session.cache_adopted
            self.session.refresh_source()
            if self.session.cache is not None:
                self.session._adopt_unchanged(
                    [s for s in range(self._geom.num_slices)
                     if s not in changed])
            for key in [k for k in self._lru if k[0] in changed]:
                del self._lru[key]
            for s in changed:
                self._parts.pop(s, None)
                self._stored_slices.discard(s)
            inv.result.update(
                old_version=old_version,
                new_version=diff["new_version"],
                changed_slices=sorted(changed),
                adopted=self.session.cache_adopted - adopted0,
            )
        except BaseException as e:  # repro: allow[ERR]: parked — invalidate() re-raises it on the calling thread
            inv.error = e
        finally:
            inv.done.set()

    def _resolve_span(self, q) -> _Pending:
        """Validate a query and map it to its within-slice point span plus
        the aligned windows covering it."""
        geom = self._geom
        if isinstance(q, PointQuery):
            s, lo_line, hi_line = q.slice_i, q.line, q.line + 1
            if not 0 <= q.point < self._ppl:
                raise ValueError(f"point {q.point} outside line of {self._ppl}")
            if not 0 <= q.line < geom.lines_per_slice:
                raise ValueError(
                    f"line {q.line} outside slice of {geom.lines_per_slice}")
            lo = q.line * self._ppl + q.point
            hi = lo + 1
        elif isinstance(q, WindowQuery):
            s, lo_line, hi_line = q.slice_i, q.line_start, q.line_end
            if not 0 <= lo_line < hi_line <= geom.lines_per_slice:
                raise ValueError(
                    f"lines [{lo_line}, {hi_line}) outside slice of "
                    f"{geom.lines_per_slice}")
            lo, hi = lo_line * self._ppl, hi_line * self._ppl
        elif isinstance(q, RegionQuery):
            s, lo_line, hi_line = q.slice_i, 0, geom.lines_per_slice
            lo, hi = 0, geom.points_per_slice
        else:
            raise TypeError(f"unknown query type {type(q).__name__}")
        if not 0 <= s < geom.num_slices:
            raise ValueError(f"slice {s} outside cube of {geom.num_slices}")
        first = (lo_line // self._grid) * self._grid
        windows = tuple(
            regions.Window(s, ls, min(ls + self._grid, geom.lines_per_slice))
            for ls in range(first, hi_line, self._grid)
        )
        return _Pending(q, s, lo, hi, windows, Future(), time.perf_counter())

    # -- the serving thread ----------------------------------------------------

    def _serve_loop(self) -> None:
        try:
            while True:
                item = self._queue.get()
                if item is _SHUTDOWN:
                    break
                if isinstance(item, _Invalidate):
                    self._apply_invalidate(item)
                    continue
                batch = [item]
                invs: list[_Invalidate] = []
                stop = False
                while True:  # free drain: whatever is already pending
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _SHUTDOWN:
                        stop = True
                        break
                    if isinstance(nxt, _Invalidate):
                        # applied after this batch: queries submitted before
                        # the invalidate are answered from pre-append state
                        invs.append(nxt)
                        continue
                    batch.append(nxt)
                # The coalescing wait only pays off when a launch is coming:
                # a batch fully covered by the hot-window LRU / known-stored
                # slices is answered immediately, so cache hits never pay
                # the tick tax.
                if (not stop and self._serve.tick_seconds > 0
                        and self._needs_compute(batch)):
                    deadline = time.monotonic() + self._serve.tick_seconds
                    while True:
                        wait = deadline - time.monotonic()
                        if wait <= 0:
                            break
                        try:
                            nxt = self._queue.get(timeout=wait)
                        except queue.Empty:
                            break
                        if nxt is _SHUTDOWN:
                            stop = True
                            break
                        if isinstance(nxt, _Invalidate):
                            invs.append(nxt)
                            continue
                        batch.append(nxt)
                with self._stats_lock:
                    self._depth -= len(batch)
                self._serve_batch(batch)
                for inv in invs:
                    self._apply_invalidate(inv)
                if stop:
                    break
        except BaseException as e:  # noqa: BLE001 — fail loudly (see below)
            self._failure = e
            self._drain_failed(e)
            raise
        finally:
            self._drain_failed(RuntimeError("server closed"))

    def _needs_compute(self, batch: list[_Pending]) -> bool:
        """Cheap host-side guess at whether this batch will launch anything:
        a window neither in the LRU nor in a slice known stored on disk.
        Only gates the coalescing wait — resolution stays authoritative."""
        for p in batch:
            for w in p.windows:
                if ((w.slice_i, w.line_start) not in self._lru
                        and w.slice_i not in self._stored_slices):
                    return True
        return False

    def _drain_failed(self, exc: BaseException) -> None:
        """Fail anything still queued (post-shutdown stragglers, or the
        whole queue after a serving-thread crash)."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is _SHUTDOWN:
                continue
            if isinstance(item, _Invalidate):
                item.error = exc
                item.done.set()
                continue
            if not item.future.done():
                item.future.set_exception(exc)

    def _bump(self, key: str, n: int = 1) -> None:
        """All counter mutations funnel through here: ``_counts`` is shared
        with caller threads (shed/queue-depth accounting in ``submit``), so
        even serving-thread increments hold ``_stats_lock``."""
        with self._stats_lock:
            self._counts[key] += n

    def _serve_batch(self, batch: list[_Pending]) -> None:
        self._bump("ticks")
        batch = self._expire(batch)
        if not batch:
            return
        try:
            if self._serve.coalesce:
                resolved, failed = self._resolve_coalesced(batch)
            else:
                resolved, failed = self._resolve_naive(batch)
        except BaseException as e:
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(e)
            raise
        now = time.perf_counter()
        rmon = self.monitors["request"]
        for i, p in enumerate(batch):
            self._bump("queries")
            kind = type(p.query).__name__
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            bad = None
            if failed:
                for w in p.windows:
                    bad = failed.get((w.slice_i, w.line_start))
                    if bad is not None:
                        break
            if bad is not None:
                # Only the requests touching a failed launch's windows fail;
                # the rest of the batch is answered normally.
                if not p.future.done():
                    p.future.set_exception(bad)
                continue
            rmon.start(f"q{self._counts['queries']}", now=p.t_submit)
            latency = rmon.finish(f"q{self._counts['queries']}", now=now)
            p.future.set_result(self._answer(p, resolved, latency))

    def _expire(self, batch: list[_Pending]) -> list[_Pending]:
        """Fail (``TimeoutError``) requests that sat in the queue longer
        than ``serve.request_deadline_s`` — no compute is spent on an answer
        the caller has already given up on. Returns the live remainder."""
        deadline = self._serve.request_deadline_s
        if deadline is None:
            return batch
        now = time.perf_counter()
        live = []
        for p in batch:
            waited = now - p.t_submit
            if waited > deadline:
                self._bump("deadline_expired")
                if not p.future.done():
                    p.future.set_exception(TimeoutError(
                        f"request expired: queued {waited:.3f}s > "
                        f"deadline {deadline}s"))
            else:
                live.append(p)
        return live

    def _resolve_coalesced(self, batch):
        """Dedup every pending query's windows, serve what the caches hold,
        compute the rest in (chunked) single launches. Returns
        ``(resolved, failed)``: windows whose launch exhausted its transient
        retries land in ``failed`` (key -> exception) instead of poisoning
        the server."""
        needed: OrderedDict[tuple[int, int], str] = OrderedDict()
        for p in batch:
            self._bump("windows_requested", len(p.windows))
            for w in p.windows:
                needed.setdefault((w.slice_i, w.line_start), w)
        self._bump("windows_unique", len(needed))

        resolved: dict[tuple[int, int], tuple[str, WindowResult]] = {}
        failed: dict[tuple[int, int], BaseException] = {}
        to_compute: list[regions.Window] = []
        for key, w in needed.items():
            served = self._from_caches(key, w)
            if served is not None:
                resolved[key] = served
            else:
                to_compute.append(w)

        ex = self.session.executor(0) if to_compute else None
        for i in range(0, len(to_compute), self._serve.max_batch_windows):
            chunk = to_compute[i:i + self._serve.max_batch_windows]
            results = self._launch(
                lambda: ex.run_window_batch(chunk), chunk, failed)
            if results is None:
                continue
            self._bump("windows_computed", len(chunk))
            for wr in results:
                key = (wr.window.slice_i, wr.window.line_start)
                resolved[key] = ("computed", wr)
                self._remember(key, wr)
        return resolved, failed

    def _resolve_naive(self, batch):
        """The one-launch-per-query baseline: no cross-request dedup, each
        query's windows dispatched individually (cache layers still apply —
        coalescing is the lever this baseline isolates)."""
        resolved: dict[tuple[int, int], tuple[str, WindowResult]] = {}
        failed: dict[tuple[int, int], BaseException] = {}
        for p in batch:
            self._bump("windows_requested", len(p.windows))
            for w in p.windows:
                key = (w.slice_i, w.line_start)
                self._bump("windows_unique")
                if key in resolved or key in failed:
                    continue
                served = self._from_caches(key, w)
                if served is not None:
                    resolved[key] = served
                    continue
                ex = self.session.executor(0)
                results = self._launch(
                    lambda: [ex.run_window(w)], (w,), failed)
                if results is None:
                    continue
                self._bump("windows_computed")
                resolved[key] = ("computed", results[0])
                self._remember(key, results[0])
        return resolved, failed

    def _launch(self, run, chunk, failed):
        """One monitored launch with transient retry (DESIGN.md §14).

        ``run()`` computes the ``WindowResult``s for ``chunk``. A transient
        failure (``faults.is_transient``) is retried up to
        ``serve.retry_transient`` times with a short linear backoff — the
        failed attempt's timing is abandoned so it cannot skew the launch
        percentiles. Exhaustion marks every window of the chunk in
        ``failed`` (only their requests' futures fail) and returns None; a
        fatal error raises and keeps the poison-the-server path."""
        lmon = self.monitors["launch"]
        last: BaseException | None = None
        for attempt in range(self._serve.retry_transient + 1):
            uid = f"launch{self._counts['launches']}"
            lmon.start(uid, now=time.perf_counter())
            try:
                results = run()
            except Exception as e:
                lmon.abandon(uid)
                if not is_transient(e):
                    raise
                last = e
                self._bump("launch_retries")
                time.sleep(0.01 * (attempt + 1))
                continue
            lmon.finish(uid, now=time.perf_counter())
            self._bump("launches")
            return results
        for w in chunk:
            failed[(w.slice_i, w.line_start)] = last
            self._bump("windows_failed")
        return None

    # -- cache layers ----------------------------------------------------------

    def _from_caches(self, key, w: regions.Window):
        wr = self._lru_get(key)
        if wr is not None:
            self._bump("windows_from_memory")
            return ("memory", wr)
        wr = self._from_result_cache(w)
        if wr is not None:
            self._bump("windows_from_disk")
            self._lru_put(key, wr)
            return ("disk", wr)
        return None

    def _from_result_cache(self, w: regions.Window) -> WindowResult | None:
        """Serve one window out of a ``ResultCache``-stored slice (the hot
        path that never touches an executor). A slice known stored skips the
        disk probe for slices this server itself completed."""
        cache = self.session.cache
        if cache is None:
            return None
        hit = cache.lookup(self.session.spec_hash, w.slice_i)
        if hit is None:
            return None
        self._stored_slices.add(w.slice_i)
        lo, hi = w.line_start * self._ppl, w.line_end * self._ppl
        return WindowResult(
            w, *(getattr(hit, name)[lo:hi] for name in RESULT_FIELDS))

    def _lru_get(self, key) -> WindowResult | None:
        wr = self._lru.get(key)
        if wr is not None:
            self._lru.move_to_end(key)
        return wr

    def _lru_put(self, key, wr: WindowResult) -> None:
        cap = self._serve.window_cache_entries
        if cap <= 0:
            return
        self._lru[key] = wr
        self._lru.move_to_end(key)
        while len(self._lru) > cap:
            self._lru.popitem(last=False)

    def _remember(self, key, wr: WindowResult) -> None:
        """A freshly computed window enters the LRU and, when a
        ``ResultCache`` is configured, the per-slice assembly — a slice
        whose every window the server has computed is stored back, so the
        next server (or batch run) of this spec starts warm."""
        self._lru_put(key, wr)
        cache = self.session.cache
        s = wr.window.slice_i
        if cache is None or s in self._stored_slices:
            return
        parts = self._parts.setdefault(s, {})
        parts[key] = wr
        if len(parts) < self._windows_per_slice:
            return
        total = self._geom.points_per_slice
        outs = {
            name: np.zeros((total, 3) if name == "params" else (total,),
                           dtype=wr.arrays()[name].dtype)
            for name in RESULT_FIELDS
        }
        for part in parts.values():
            lo = part.window.line_start * self._ppl
            hi = part.window.line_end * self._ppl
            for name in RESULT_FIELDS:
                outs[name][lo:hi] = getattr(part, name)
        result = SliceResult(
            *(outs[name] for name in RESULT_FIELDS),
            avg_error=float(outs["error"].mean()),
            stats=[], slice_i=s, spec_hash=self.session.spec_hash,
        )
        # deps-stamped like the session's stores, so invalidate() can adopt
        # this entry across a later append when the slice's chunks survive
        cache.store(result, deps=self.session._slice_deps(s))
        self._stored_slices.add(s)
        self._bump("slices_stored")
        del self._parts[s]

    # -- answers / stats -------------------------------------------------------

    def _answer(self, p: _Pending, resolved, latency: float) -> QueryAnswer:
        n = p.hi - p.lo
        first = resolved[(p.slice_i, p.windows[0].line_start)][1]
        outs = {
            name: np.empty((n, 3) if name == "params" else (n,),
                           dtype=first.arrays()[name].dtype)
            for name in RESULT_FIELDS
        }
        origin = dict(computed=0, memory=0, disk=0)
        for w in p.windows:
            source, wr = resolved[(w.slice_i, w.line_start)]
            origin[source] += 1
            w_lo = w.line_start * self._ppl
            lo = max(p.lo, w_lo)
            hi = min(p.hi, w.line_end * self._ppl)
            for name in RESULT_FIELDS:
                outs[name][lo - p.lo:hi - p.lo] = (
                    getattr(wr, name)[lo - w_lo:hi - w_lo])
        return QueryAnswer(
            query=p.query, spec_hash=self.session.spec_hash,
            **outs,
            windows_computed=origin["computed"],
            windows_from_memory=origin["memory"],
            windows_from_disk=origin["disk"],
            latency_seconds=latency,
        )

    def stats(self) -> ServerStats:
        """Consistent counter snapshot (taken under ``_stats_lock``, so a
        mid-tick read never sees a half-updated counter set)."""
        with self._stats_lock:
            c = dict(self._counts)
        return ServerStats(
            spec_hash=self.session.spec_hash,
            queries=c["queries"],
            queries_by_kind=dict(self._by_kind),
            ticks=c["ticks"],
            launches=c["launches"],
            windows_requested=c["windows_requested"],
            windows_unique=c["windows_unique"],
            windows_computed=c["windows_computed"],
            windows_from_memory=c["windows_from_memory"],
            windows_from_disk=c["windows_from_disk"],
            slices_stored=c["slices_stored"],
            max_queue_depth=c["max_queue_depth"],
            shed_requests=c["shed_requests"],
            deadline_expired=c["deadline_expired"],
            launch_retries=c["launch_retries"],
            windows_failed=c["windows_failed"],
            latency=self.monitors["request"].percentiles(),
            launch_latency=self.monitors["launch"].percentiles(),
            stage_percentiles=self.session.stage_percentiles(),
        )
