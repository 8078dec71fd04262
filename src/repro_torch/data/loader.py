"""Window-addressable data sources + the executor's load stage.

Port of ``repro.data.loader``: ``ArrayDataSource`` wraps an in-memory cube
(tests); ``ThrottledSource`` models an NFS read path's bandwidth;
``WindowPrefetcher`` runs the load stage in a background thread, loading
window *k+1* while the device is still fitting window *k*, and hands staged
items to the compute stage through a bounded queue (depth = how far ahead
the loader may run).

``WindowStager`` is the host-to-device step of that stage, the counterpart
of the reference's asynchronous ``jax.device_put``: on a CUDA device the
window goes through a pinned host buffer from a small pool and a
``non_blocking`` copy on a dedicated copy stream, so window *k+1*'s copy
runs beside window *k*'s kernels; on the CPU it is ``torch.from_numpy``.
``ShardedStager`` pads a window to a shard divisor and stages it onto one
device; splitting one window's points over several cards is still to come
(ROADMAP: the multi-card ``ShardedStager``).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, NamedTuple, TypeVar

import numpy as np
import torch

from repro_torch.core.regions import CubeGeometry, Window

T = TypeVar("T")
U = TypeVar("U")


class ArrayDataSource:
    """In-memory cube: values (slices, lines, points_per_line, n_obs)."""

    def __init__(self, values: np.ndarray):
        if values.ndim != 4:
            raise ValueError("expected (slices, lines, points, n_obs)")
        self.values = values
        self.geometry = CubeGeometry(*values.shape[:3])
        self.num_observations = values.shape[3]

    def load_window(self, w: Window) -> np.ndarray:
        block = self.values[w.slice_i, w.line_start : w.line_end]
        return block.reshape(-1, self.num_observations).astype(np.float32)


class ThrottledSource:
    """Models the paper's NFS read path for any window-addressable source:
    ``load_window`` returns no earlier than ``nbytes / bandwidth`` after the
    call, sleeping for the remainder. The sleep releases the GIL, so a
    prefetch thread reading through this wrapper overlaps with device
    compute exactly like a real remote read."""

    def __init__(self, source, bandwidth_bytes_per_s: float):
        if bandwidth_bytes_per_s <= 0:
            raise ValueError("bandwidth must be positive")
        self.inner = source
        self.geometry = source.geometry
        self.bandwidth = float(bandwidth_bytes_per_s)

    def load_window(self, w: Window) -> np.ndarray:
        t0 = time.perf_counter()
        block = self.inner.load_window(w)
        remain = block.nbytes / self.bandwidth - (time.perf_counter() - t0)
        if remain > 0:
            time.sleep(remain)
        return block


class StagedValues(NamedTuple):
    """A window staged on the device: ``values`` (P, n) float32 and, on a
    CUDA device, ``ready``, the event recorded on the copy stream after its
    host-to-device copy (None on the CPU). Use ``WindowStager.ready``
    before any kernel reads ``values``."""

    values: torch.Tensor
    ready: object = None


@dataclass
class _PinnedSlot:
    buf: torch.Tensor | None = None  # pinned float32, grown to the largest window
    event: object = None  # recorded after the last copy out of ``buf``
    busy: bool = False  # a thread is writing into ``buf``


class WindowStager:
    """Host window -> device tensor, the load stage's staging step.

    On a CUDA device each ``stage`` takes a pinned host buffer from a pool of
    at most ``pool_size``, copies the numpy window into it, and on a
    dedicated copy stream allocates the device tensor and issues
    ``copy_(non_blocking=True)``, recording an event after it. A pinned
    buffer is written again only once that event has completed: a thread
    that finds every buffer busy waits on the event of one whose copy
    runs, which always completes (a copy waits on nothing else), or, when
    every buffer is being written, for one to be handed back. Any thread
    may stage: each enters the copy stream itself (the current stream is
    per thread). The consumer calls ``ready``: its stream waits on the
    event and the tensor is recorded as used there, so the caching
    allocator does not give its block to a later copy while the consumer's
    kernels still read it.

    On the CPU ``stage`` is ``torch.from_numpy``: the type of the device
    chooses the route; there is no fallback from one to the other.
    """

    def __init__(self, device: torch.device | str, pool_size: int = 8):
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        self.device = torch.device(device)
        self.pool_size = pool_size
        self.copies = 0  # host-to-device copies issued on the copy stream
        self.pool_waits = 0  # stages that waited for a pinned buffer's copy
        self._cond = threading.Condition()
        self._slots: list[_PinnedSlot] = []
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def stage(self, *parts: np.ndarray) -> StagedValues:
        """Stage the row-wise concatenation of ``parts`` (each (rows, n)) as
        one float32 tensor: one copy for a whole batch of windows."""
        if self._stream is None:
            host = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
            values = torch.from_numpy(np.ascontiguousarray(host, dtype=np.float32))
            return StagedValues(values.to(self.device))
        rows, n = sum(p.shape[0] for p in parts), parts[0].shape[1]
        slot = self._acquire()
        try:
            if slot.buf is None or slot.buf.numel() < rows * n:
                slot.buf = None
                slot.buf = torch.empty(rows * n, dtype=torch.float32, pin_memory=True)
            host, r = slot.buf[: rows * n].view(rows, n), 0
            for p in parts:
                # PyTorch's CPU copy runs on all its threads; numpy's
                # copyto on one made this stage slower than the pageable
                # copy it replaces (chip_smoke.py [staging] times both)
                host[r:r + p.shape[0]].copy_(torch.from_numpy(np.ascontiguousarray(p)))
                r += p.shape[0]
            with torch.cuda.stream(self._stream):
                values = torch.empty((rows, n), dtype=torch.float32, device=self.device)
                values.copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            slot.event = event
        finally:
            with self._cond:
                slot.busy = False
                self._cond.notify()
        with self._cond:
            self.copies += 1
        return StagedValues(values, event)

    def ready(self, staged: StagedValues) -> torch.Tensor:
        """``staged.values``, safe to read on the caller's current stream."""
        if staged.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.ready)
            staged.values.record_stream(stream)
        return staged.values

    def _acquire(self) -> _PinnedSlot:
        while True:
            with self._cond:
                pending = None
                for slot in self._slots:
                    if slot.busy:
                        continue
                    if slot.event is None or slot.event.query():
                        slot.busy = True
                        return slot
                    pending = pending or slot
                if len(self._slots) < self.pool_size:
                    slot = _PinnedSlot(busy=True)
                    self._slots.append(slot)
                    return slot
                if pending is None:  # every buffer is being written
                    self._cond.wait()
                    continue
                event = pending.event
                self.pool_waits += 1
            event.synchronize()


class ShardedStager:
    """Stages (P, n_obs) windows for ``divisor`` shards of the points.

    Port of the reference's ``ShardedStager`` on one device: pads the point
    dimension to a multiple of ``divisor`` by repeating the last row (the
    reference's rule) and stages the result through ``stager`` onto its one
    device; callers slice results back with the returned valid count. On
    one card the divisor is 1 and nothing is padded. Placing the shards'
    rows on several cards is still to come (ROADMAP: the multi-card
    ``ShardedStager``); cluster workers each stage whole windows onto their
    own device (``runtime.cluster.device_placement``).
    """

    def __init__(self, stager: WindowStager, divisor: int = 1):
        if divisor < 1:
            raise ValueError(f"divisor must be >= 1, got {divisor}")
        self.stager = stager
        self.divisor = divisor

    def stage(self, values: np.ndarray) -> tuple[StagedValues, int]:
        p = values.shape[0]
        pad = (-p) % self.divisor
        if pad:
            values = np.concatenate([values, np.repeat(values[-1:], pad, axis=0)])
        return self.stager.stage(values), p


class PrefetchError(RuntimeError):
    """Raised by the consumer when the background load stage failed; the
    original exception is ``__cause__``."""


class _Stop:
    """Queue sentinels: end-of-stream or carried error."""

    def __init__(self, error: BaseException | None = None):
        self.error = error


class WindowPrefetcher(Iterable[U]):
    """Runs ``stage_fn`` over ``items`` in a background thread, ``depth``
    items ahead of the consumer.

    ``stage_fn`` does the load + host->device staging for one work unit and
    returns whatever the compute stage consumes. Order is preserved (FIFO),
    which the resume watermark requires. Iteration re-raises any loader
    exception as ``PrefetchError``; ``close()`` stops the thread early (e.g.
    the compute stage crashed) without blocking on a full queue.
    """

    def __init__(self, items: Iterable[T], stage_fn: Callable[[T], U], depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._items = items
        self._stage_fn = stage_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="window-prefetch", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._items:
                if self._stop.is_set():
                    return
                staged = self._stage_fn(item)
                if not self._put(staged):
                    return
            self._put(_Stop())
        except BaseException as e:  # repro: allow[ERR]: parked for the consumer — __iter__ re-raises it as PrefetchError
            self._put(_Stop(e))

    def _put(self, obj) -> bool:
        """Blocking put that stays responsive to close(); False = stopped."""
        while not self._stop.is_set():
            try:
                self._q.put(obj, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[U]:
        while True:
            got = self._q.get()
            if isinstance(got, _Stop):
                if got.error is not None:
                    raise PrefetchError("window load stage failed") from got.error
                return
            yield got

    def close(self) -> None:
        self._stop.set()
        while True:  # unblock a producer waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)
