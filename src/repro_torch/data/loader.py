"""Window-addressable data sources + the executor's load stage.

Port of ``repro.data.loader``: ``ArrayDataSource`` wraps an in-memory cube
(tests); ``WindowPrefetcher`` runs the load stage in a background thread,
loading window *k+1* while the device is still fitting window *k*, and
hands staged items to the compute stage through a bounded queue (depth =
how far ahead the loader may run). The stage function itself lives on the
executor (``StagedExecutor._load_unit``: ``torch.from_numpy(raw).to(device)``).
Pinned host buffers and a copy stream for the host-to-device copy are not
part of this module yet.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

import numpy as np

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
