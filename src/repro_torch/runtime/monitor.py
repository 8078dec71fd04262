"""Step/window heartbeat monitoring + straggler policy.

A copy of ``repro.runtime.monitor`` (standard library only).

Straggler mitigation happens at the *work-unit* level (a window of the
PDF pipeline, a data shard, a checkpoint write): the host records a
heartbeat per unit, and units that exceed ``k x median`` of the trailing
distribution are flagged for re-dispatch (the PDF pipeline's windows are idempotent — re-running one is
safe, results overwrite byte-identically because data loading is
deterministic).

On a real cluster the same monitor ingests per-host heartbeats; here it is
driven by the single-process loops and unit-tested with synthetic timings.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

# Trailing-latency reservoir per monitor: enough samples for stable p99 at
# serving rates while bounding memory on long-lived daemons (a PDFServer's
# request monitor outlives any single run).
HISTORY_LIMIT = 8192


def percentiles(durations, qs=(0.5, 0.99)) -> dict[str, float]:
    """``{"p50": ..., "p99": ...}`` over a duration sample (nearest-rank on
    the sorted sample; empty input -> zeros). Shared by ``SessionReport``
    and the serve layer's stats so every latency surface quotes the same
    estimator."""
    s = sorted(durations)
    if not s:
        return {f"p{int(q * 100)}": 0.0 for q in qs}
    return {
        f"p{int(q * 100)}": s[min(len(s) - 1, int(q * (len(s) - 1) + 0.5))]
        for q in qs
    }


@dataclass(frozen=True)
class StragglerPolicy:
    window: int = 32  # trailing sample count for the median
    threshold: float = 3.0  # flag units slower than threshold x median
    min_samples: int = 5
    grace_seconds: float = 1.0  # never flag below this absolute duration


@dataclass
class StepMonitor:
    policy: StragglerPolicy = field(default_factory=StragglerPolicy)

    def __post_init__(self):
        self._durations: deque[float] = deque(maxlen=self.policy.window)
        # Separate, larger reservoir for percentile reporting: the straggler
        # median deliberately tracks only the trailing `policy.window` units,
        # but p50/p99 need the run's full distribution (bounded).
        self._history: deque[float] = deque(maxlen=HISTORY_LIMIT)
        self._inflight: dict[str, float] = {}
        self.flagged: list[str] = []
        self.completed: int = 0

    # -- heartbeat API --------------------------------------------------------

    def start(self, unit_id: str, now: float | None = None):
        self._inflight[unit_id] = now if now is not None else time.monotonic()

    def finish(self, unit_id: str, now: float | None = None) -> float:
        now = now if now is not None else time.monotonic()
        dur = now - self._inflight.pop(unit_id)
        self._durations.append(dur)
        self._history.append(dur)
        self.completed += 1
        return dur

    def abandon(self, unit_id: str) -> None:
        """Drop an inflight unit without recording a duration — for failed
        or superseded attempts (a retry, a losing speculative launch). The
        duration of an attempt that *didn't complete* must not enter the
        straggler median: an injected 10s stall recorded as a sample would
        triple the re-dispatch limit for every unit after it."""
        self._inflight.pop(unit_id, None)

    @property
    def history(self) -> tuple[float, ...]:
        """Completed-unit durations (trailing ``HISTORY_LIMIT``), oldest
        first — the percentile reservoir."""
        return tuple(self._history)

    def percentiles(self, qs=(0.5, 0.99)) -> dict[str, float]:
        """p50/p99 (by default) over every completed unit this monitor has
        seen — the per-stage latency surface of ``SessionReport`` and the
        serve-layer stats."""
        return percentiles(self._history, qs)

    def median(self) -> float | None:
        if len(self._durations) < self.policy.min_samples:
            return None
        s = sorted(self._durations)
        return s[len(s) // 2]

    def check_stragglers(self, now: float | None = None) -> list[str]:
        """Inflight units exceeding threshold x median -> flagged for
        re-dispatch. Idempotent units may simply be re-run."""
        now = now if now is not None else time.monotonic()
        med = self.median()
        if med is None:
            return []
        limit = max(self.policy.threshold * med, self.policy.grace_seconds)
        out = [u for u, t0 in self._inflight.items() if now - t0 > limit]
        for u in out:
            if u not in self.flagged:
                self.flagged.append(u)
        return out
