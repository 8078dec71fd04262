"""Reuse optimization (§5.2.1): cache fitted PDFs across windows.

Port of ``repro.core.reuse`` (numpy only, copied so the port imports no
part of the reference). The store is a host dict keyed by the quantized
(mu, sigma) key pair; lookups, hits and the time spent searching are
counted, as the paper observes the search can cost more than it saves.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ReuseCache:
    """Cross-window PDF result cache. Keys: (q_mu, q_sigma) int tuples.
    Values: (type_idx, params[3], error) packed as a small np array."""

    max_entries: int = 50_000_000
    _store: dict = field(default_factory=dict)
    lookups: int = 0
    hits: int = 0
    search_seconds: float = 0.0

    def lookup_window(self, keys: np.ndarray):
        """keys (G, 2) for a window's representatives -> (mask_hit (G,),
        results (G, 5)) where results rows for misses are zero."""
        t0 = time.perf_counter()
        g = len(keys)
        hit = np.zeros((g,), dtype=bool)
        out = np.zeros((g, 5), dtype=np.float64)
        for i in range(g):
            self.lookups += 1
            rec = self._store.get((int(keys[i, 0]), int(keys[i, 1])))
            if rec is not None:
                hit[i] = True
                out[i] = rec
                self.hits += 1
        self.search_seconds += time.perf_counter() - t0
        return hit, out

    def insert_window(self, keys: np.ndarray, results: np.ndarray) -> None:
        """Store newly computed representative results (G, 5)."""
        if len(self._store) >= self.max_entries:
            return
        for i in range(len(keys)):
            self._store[(int(keys[i, 0]), int(keys[i, 1]))] = results[i]

    @property
    def size(self) -> int:
        return len(self._store)

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0
