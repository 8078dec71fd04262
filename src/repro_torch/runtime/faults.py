"""Deterministic fault injection + the pipeline's error taxonomy (DESIGN.md §14).

Port of ``repro.runtime.faults``. A seeded, schedulable ``FaultPlan`` whose
``FaultInjector`` wraps the window source and the persist stage to inject,
deterministically,

  * transient read errors  (``kind='read_error'`` — an NFS hiccup),
  * latency spikes         (``kind='latency'`` — a straggling read),
  * corrupt chunk bytes    (``kind='corrupt'`` — torn/partial file reads,
                            detectable through the cube manifest's
                            per-chunk sha256),
  * shard "death"          (``kind='shard_death'`` — a worker lost mid-run,
                            the batch form the scheduler re-deals), and
  * persist / cache errors (``kind='persist_error'`` / ``'cache_error'``).

Every decision is a pure function of ``(plan.seed, rule, target, attempt)``
— never of thread timing or call order. Affliction hashes the same bytes as
the reference, so one plan afflicts the same units in both packages, and a
plan's JSON reads in either. The layer's one invariant: **any completed
result under injected faults is bitwise-identical to the fault-free run**
(re-loading a window yields the same bytes, fits are row-pure).

The injector covers IO-path failures (reads, writes, cache traffic,
whole-shard loss) and scheduling skew (latency). It does not simulate
wrong-answer device compute, process crashes mid-persist (the
watermark/resume contract's job) or network partitions. Device errors are
fatal: ``torch.OutOfMemoryError`` and CUDA errors (``RuntimeError``s) are
never retried, so never quarantined. The cache hook (``on_cache``) is here
for the result cache, which is not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

FAULT_KINDS = (
    "read_error", "latency", "corrupt", "shard_death",
    "persist_error", "cache_error",
)


# -- error taxonomy ------------------------------------------------------------


class TransientError(Exception):
    """An error worth retrying: the operation may well succeed on a fresh
    attempt (NFS hiccup, torn read, momentary contention). The executor's
    per-unit retry and the server's launch retry key off this."""


class InjectedFault(TransientError, OSError):
    """A fault the injector raised. Also an ``OSError`` so IO layers that
    already degrade gracefully on real OS errors (the reference's result
    cache, the persist stage's re-attempts) treat injected faults exactly
    like the real thing."""


class ShardLostError(RuntimeError):
    """A shard (worker) died. NOT retryable at the work-unit level — the
    scheduler re-deals the shard's remaining slices over the healthy shards
    (``runtime.elastic.plan_redeal``)."""

    def __init__(self, shard: int, message: str | None = None):
        self.shard = shard
        super().__init__(message or f"shard {shard} lost")


# The device's errors (torch >= 2.8 names CUDA errors AcceleratorError).
_DEVICE_ERRORS = tuple(e for e in (getattr(torch, "OutOfMemoryError", None),
                                   getattr(torch, "AcceleratorError", None)) if e is not None)


def is_transient(exc: BaseException) -> bool:
    """Transient/fatal classification for the retry machinery.

    Transient: ``TransientError``, ``OSError`` (incl. ``TimeoutError`` /
    ``ConnectionError`` — the real-world IO failures the injector models).
    Fatal: everything else — a ``ValueError`` from shape validation, a
    kernel that does not build or launch, will fail identically on every
    attempt, so retrying it only delays the loud failure. The device's own
    errors are explicitly fatal wherever they sit in the chain:
    ``torch.OutOfMemoryError`` and ``torch.AcceleratorError`` (CUDA errors;
    both ``RuntimeError``s) leave the device in a state no re-read repairs.
    ``ShardLostError`` is fatal at unit level (its recovery is re-dealing,
    not re-reading). Wrapper exceptions (``PrefetchError``, persist-stage
    ``RuntimeError``) are classified by their ``__cause__`` chain."""
    seen: set[int] = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (ShardLostError, *_DEVICE_ERRORS)):
            return False
        if isinstance(exc, (TransientError, OSError, TimeoutError)):
            return True
        exc = exc.__cause__
    return False


def shard_lost_from(exc: BaseException) -> ShardLostError | None:
    """The ``ShardLostError`` in ``exc``'s ``__cause__`` chain, or None.

    The reference's cluster workers classify a failed run with this: shard
    death — possibly wrapped by a prefetch/persist layer — hands recovery
    to the survivors, while any other exception is a real crash that must
    propagate."""
    seen: set[int] = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, ShardLostError):
            return exc
        exc = exc.__cause__
    return None


# -- the plan ------------------------------------------------------------------


@dataclass(frozen=True)
class FaultRule:
    """One scheduled fault. ``slice_i``/``line_start`` target a window (or
    chunk); ``None`` matches any. ``times`` bounds how many *attempts* per
    target are afflicted — ``times <= max_retries`` injects a recoverable
    fault, ``times`` large makes the unit unrecoverable (quarantine path).
    ``rate`` afflicts only that deterministic fraction of matching targets
    (hashed from the plan seed, not sampled). ``shard``/``after_units``
    configure ``shard_death``: the shard serves ``after_units`` window
    loads, then every subsequent load on it raises ``ShardLostError``."""

    kind: str
    slice_i: int | None = None
    line_start: int | None = None
    times: int = 1
    seconds: float = 0.25  # latency: injected sleep per afflicted attempt
    rate: float = 1.0
    shard: int | None = None
    after_units: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}")
        if self.times < 1:
            raise ValueError(f"fault times must be >= 1, got {self.times}")
        if self.seconds < 0:
            raise ValueError(f"fault seconds must be >= 0, got {self.seconds}")
        if not 0 < self.rate <= 1:
            raise ValueError(f"fault rate must be in (0, 1], got {self.rate}")
        if self.kind == "shard_death" and self.shard is None:
            raise ValueError("shard_death rules require a target shard")
        if self.after_units < 0:
            raise ValueError(
                f"fault after_units must be >= 0, got {self.after_units}")


@dataclass(frozen=True)
class FaultPlan:
    """A seeded schedule of fault rules — JSON-serializable so a chaos run
    is one file away from a run (``FaultPlan.load``)."""

    seed: int = 0
    rules: tuple[FaultRule, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "rules": [
                {k: v for k, v in vars(r).items()} for r in self.rules
            ],
        }

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        if not isinstance(d, dict):
            raise ValueError(
                f"fault plan must be a JSON object, got {type(d).__name__}")
        d = dict(d)
        rules = tuple(FaultRule(**r) for r in d.pop("rules", []))
        seed = int(d.pop("seed", 0))
        if d:
            raise ValueError(f"unknown fault plan keys: {sorted(d)}")
        return cls(seed=seed, rules=rules)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str | Path) -> "FaultPlan":
        return cls.from_json(Path(path).read_text())


# -- the injector --------------------------------------------------------------


class FaultInjector:
    """Runtime state for one plan: thread-safe per-(rule, target) attempt
    counters plus event counts for reporting. Affliction is decided by
    hashing ``(seed, rule index, target)`` — identical across runs and
    independent of which thread asks first, which is what lets the chaos
    tests assert bitwise equality against the fault-free run."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._attempts: dict[tuple[int, object], int] = {}
        self._shard_units: dict[int, int] = {}
        self.events: dict[str, int] = {}

    # -- deterministic decision machinery --------------------------------------

    def _afflicted(self, rule_i: int, rule: FaultRule, key) -> bool:
        if rule.rate >= 1.0:
            return True
        blob = json.dumps([self.plan.seed, rule_i, key], sort_keys=True)
        h = int(hashlib.sha256(blob.encode()).hexdigest()[:8], 16)
        return h / float(0x100000000) < rule.rate

    def _bump(self, rule_i: int, key) -> int:
        """Post-increment attempt counter for (rule, target); returns the
        attempt index BEFORE this call (0 on the first)."""
        with self._lock:
            n = self._attempts.get((rule_i, key), 0)
            self._attempts[(rule_i, key)] = n + 1
            return n

    def _note(self, kind: str) -> None:
        with self._lock:
            self.events[kind] = self.events.get(kind, 0) + 1

    @staticmethod
    def _match(rule: FaultRule, slice_i: int, line_start: int) -> bool:
        return ((rule.slice_i is None or rule.slice_i == slice_i)
                and (rule.line_start is None or rule.line_start == line_start))

    # -- hooks ------------------------------------------------------------------

    def on_read(self, slice_i: int, line_start: int,
                shard: int | None = None) -> None:
        """Window-read hook (``FaultySource.load_window``): may sleep
        (latency), raise ``InjectedFault`` (read_error), or raise
        ``ShardLostError`` (shard_death). Attempt counters are per target,
        so a retry or a speculative re-dispatch of the same window sees a
        fresh — typically fault-free — attempt, exactly like a real
        transient."""
        for i, r in enumerate(self.plan.rules):
            if r.kind == "shard_death" and shard is not None and r.shard == shard:
                with self._lock:
                    n = self._shard_units.get(shard, 0)
                    self._shard_units[shard] = n + 1
                if n >= r.after_units:
                    self._note("shard_death")
                    raise ShardLostError(shard)
                continue
            if r.kind not in ("read_error", "latency"):
                continue
            if not self._match(r, slice_i, line_start):
                continue
            key = (slice_i, line_start)
            if not self._afflicted(i, r, key):
                continue
            if self._bump(i, key) >= r.times:
                continue
            if r.kind == "latency":
                self._note("latency")
                time.sleep(r.seconds)
            else:
                self._note("read_error")
                raise InjectedFault(
                    f"injected transient read error "
                    f"(slice {slice_i}, line {line_start})")

    def chunk_hook(self, slice_i: int, line_start: int, arr: np.ndarray,
                   attempt: int) -> np.ndarray:
        """File-chunk read hook (``FileCubeSource`` verified reads): returns
        the chunk bytes a read observes — corrupted for the first ``times``
        reads of a targeted chunk, pristine after, so the re-read recovers.
        ``attempt`` is the source's 1-based re-read counter (unused for the
        decision — the injector keeps its own per-chunk count so corruption
        does not recur when a chunk is read again later)."""
        for i, r in enumerate(self.plan.rules):
            if r.kind != "corrupt" or not self._match(r, slice_i, line_start):
                continue
            key = ("chunk", slice_i, line_start)
            if not self._afflicted(i, r, key):
                continue
            if self._bump(i, key) >= r.times:
                continue
            self._note("corrupt")
            bad = np.array(arr, copy=True)
            flat = bad.view(np.uint8).reshape(-1)
            flat[:: max(1, flat.size // 17)] ^= 0xFF  # scatter bit flips
            return bad
        return arr

    def on_persist(self, slice_i: int, line_start: int) -> None:
        """Persist-stage hook: raises ``InjectedFault`` before the window's
        ``.npz`` write for the first ``times`` attempts of a target."""
        for i, r in enumerate(self.plan.rules):
            if r.kind != "persist_error" or not self._match(r, slice_i, line_start):
                continue
            key = ("persist", slice_i, line_start)
            if (self._afflicted(i, r, key)
                    and self._bump(i, key) < r.times):
                self._note("persist_error")
                raise InjectedFault(
                    f"injected persist error (slice {slice_i}, "
                    f"line {line_start})")

    def on_cache(self, op: str, slice_i: int) -> None:
        """ResultCache hook (``op`` is 'lookup' or 'store'): raises
        ``InjectedFault`` — which the cache's existing OSError handling
        degrades to a warned miss / skipped store, never a crash."""
        for i, r in enumerate(self.plan.rules):
            if r.kind != "cache_error":
                continue
            if r.slice_i is not None and r.slice_i != slice_i:
                continue
            key = ("cache", op, slice_i)
            if (self._afflicted(i, r, key)
                    and self._bump(i, key) < r.times):
                self._note("cache_error")
                raise InjectedFault(
                    f"injected cache {op} error (slice {slice_i})")

    # -- wiring -----------------------------------------------------------------

    def wrap_source(self, source, shard: int | None = None) -> "FaultySource":
        """Wrap a window source with this injector's read-path faults.
        ``corrupt`` rules additionally arm the underlying
        ``FileCubeSource``'s verified-read path: corruption is only a
        *recoverable* fault when a checksum can detect it, which is what
        keeps completed results bitwise-identical (an undetected flip would
        silently change results — exactly what the manifest exists to
        prevent)."""
        if any(r.kind == "corrupt" for r in self.plan.rules):
            from repro_torch.data.file_source import FileCubeSource

            inner = source
            while not isinstance(inner, FileCubeSource) and hasattr(inner, "inner"):
                inner = inner.inner
            if not isinstance(inner, FileCubeSource):
                raise ValueError(
                    "corrupt fault rules need a file-backed source "
                    "(a FileCubeSource): detection relies on the cube "
                    "manifest's per-chunk sha256")
            inner.enable_read_verification(read_hook=self.chunk_hook)
        return FaultySource(source, self, shard=shard)


class FaultySource:
    """A window source with the injector's read hook in front of every
    ``load_window``. Forwards everything else to the wrapped source
    (``geometry``, ``num_observations``, ...)."""

    def __init__(self, inner, injector: FaultInjector, shard: int | None = None):
        self.inner = inner
        self.injector = injector
        self.shard = shard
        self.geometry = inner.geometry

    def load_window(self, w) -> np.ndarray:
        self.injector.on_read(w.slice_i, w.line_start, shard=self.shard)
        return self.inner.load_window(w)

    def __getattr__(self, name):
        return getattr(self.inner, name)
