"""``ResultCache``: content-addressed per-slice results, keyed by spec hash.

Port of ``repro.api.cache``, numpy only; the entry format is the
reference's, so either package reads the other's entries (the port's spec
hash keeps their keys apart).

The hash rule (DESIGN.md §11/§12) makes this cache sound: equal
``content_hash`` ⇒ bitwise-identical per-point results, so a ``SliceResult``
persisted under a hash can be served verbatim to ANY later run of an equal
spec — across processes, benchmark sweeps, and ``ExecSpec``-only variations
(staging knobs are excluded from the hash by the staged-executor
equivalence contract). A ``kind='file'`` source hashes by its manifest's
content sha256, so the cache also misses when the underlying bytes change,
not just when a knob does.

Layout: one ``.npz`` per (spec hash, slice) —

    cache_dir/<spec_hash>/slice<N>.npz    # _FIELDS arrays + avg_error

Writes are tmp + atomic rename, so two concurrent runs of the same spec
race benignly (last writer wins with identical bytes) and a crashed write
never leaves a half-entry a later run could load. ``PDFSession`` consults
the cache per slice when ``ExecSpec.cache_dir`` is set and counts
hits/misses into its ``report()``.

Long-lived shared ``cache_dir``s (the serve layer, cross-run benchmark
sweeps) add two requirements this module owns:

* **LRU size cap** — ``max_bytes`` bounds the directory: after every store
  the oldest-*used* entries are evicted until the total fits. Recency is
  the entry's mtime, touched atomically on every hit (``os.utime``), so
  eviction is LRU rather than FIFO. Eviction is plain ``unlink``: a reader
  that already opened the file keeps its data (POSIX), a reader that opens
  later sees a clean miss — eviction can never corrupt a concurrent read.
* **crash hygiene** — ``*.tmp`` files left by writers that died before
  their rename are reaped at open time once they are old enough to be
  provably dead (``tmp_reap_seconds``; a live writer's tmp is always
  younger). Every cross-process race on unlink/utime tolerates the file
  vanishing first.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import warnings
import zipfile
from pathlib import Path

import numpy as np

from repro_torch.core.executor import _FIELDS, SliceResult

# A writer holds its .tmp only for one np.savez + rename; a tmp this old
# belongs to a crashed process, not a slow one.
TMP_REAP_SECONDS = 3600.0

# A .lock is held only for one entry write or unlink; one this old belongs
# to a process that died holding it, and may be broken.
LOCK_STALE_SECONDS = 30.0


class _DirLock:
    """Best-effort cross-process mutex for one cache entry directory: an
    ``O_CREAT | O_EXCL`` ``.lock`` file (atomic on POSIX and NFSv3+ —
    exactly the shared-filesystem case two processes sharing a cache_dir
    are in). Store-vs-evict races coordinate through this; contention
    *degrades* (the caller warns and skips) — it never hangs, because
    acquisition is a bounded poll and locks older than ``stale_s`` are
    presumed orphaned by a dead holder and broken."""

    def __init__(self, dirpath: Path, timeout_s: float,
                 stale_s: float = LOCK_STALE_SECONDS,
                 name: str = ".lock"):
        self.path = dirpath / name
        self.timeout_s = timeout_s
        self.stale_s = stale_s
        self.acquired = False

    def acquire(self) -> bool:
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                try:
                    age = time.time() - self.path.stat().st_mtime  # repro: allow[DET]: lock age
                    if age > self.stale_s:
                        os.unlink(self.path)  # break a dead holder's lock
                        continue
                except OSError:
                    continue  # holder released between open and stat: retry
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.005)
                continue
            except OSError:
                return False  # unwritable/vanished dir: degrade, never hang
            try:
                os.write(fd, str(os.getpid()).encode())
            finally:
                os.close(fd)
            self.acquired = True
            return True

    def release(self) -> None:
        if self.acquired:
            self.acquired = False
            try:
                os.unlink(self.path)
            except OSError:
                pass


class ResultCache:
    """Filesystem-backed map ``(spec_hash, slice) -> SliceResult``.

    ``max_bytes=None`` (default) leaves the directory unbounded — the
    pre-existing behaviour. With a cap, ``store`` evicts least-recently-used
    entries (see module docstring); the cap is advisory during a store burst
    (entries land, then eviction trims), exact between stores.
    """

    def __init__(self, cache_dir: str | Path, max_bytes: int | None = None,
                 tmp_reap_seconds: float = TMP_REAP_SECONDS,
                 lock_timeout_s: float = 5.0, injector=None):
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError(f"max_bytes must be > 0 (or None), got {max_bytes}")
        if lock_timeout_s < 0:
            raise ValueError(
                f"lock_timeout_s must be >= 0, got {lock_timeout_s}")
        self.dir = Path(cache_dir)
        self.max_bytes = max_bytes
        self.lock_timeout_s = lock_timeout_s
        self.injector = injector  # faults.FaultInjector (on_cache hook)
        # one cache instance is shared across threads (a PDFServer's serving
        # thread stores slices while the owning session reads): counter
        # bumps hold _stats_lock (the LOCK rule enforces consistency)
        self._stats_lock = threading.Lock()
        self.evictions = 0  # entries unlinked by the size cap, this process
        self.lock_misses = 0  # stores/evictions skipped on lock contention
        self.adoptions = 0  # entries re-keyed across an append (streaming)
        self._reap_stale_tmps(tmp_reap_seconds)

    def path(self, spec_hash: str, slice_i: int) -> Path:
        return self.dir / spec_hash / f"slice{slice_i}.npz"

    def lookup(self, spec_hash: str, slice_i: int) -> SliceResult | None:
        """The cached ``SliceResult``, or ``None`` on miss. Served results
        carry ``cached=True`` and empty window ``stats`` (no work ran — the
        same shape a fully resumed slice has). A hit touches the entry's
        mtime so the LRU cap evicts cold entries first."""
        f = self.path(spec_hash, slice_i)
        if not f.exists():
            return None
        try:
            if self.injector is not None:
                # InjectedFault is an OSError: a chaos plan's cache_error
                # exercises exactly this warned-miss path.
                self.injector.on_cache("lookup", slice_i)
            with np.load(f) as z:  # close the zip handle: no fd per hit
                if str(z["spec_hash"]) != spec_hash:  # misfiled: miss
                    return None
                result = SliceResult(
                    *(z[name] for name in _FIELDS),
                    avg_error=float(z["avg_error"]),
                    stats=[],
                    slice_i=slice_i,
                    spec_hash=spec_hash,
                    cached=True,
                )
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            # A truncated / foreign / partially-synced entry (e.g. an
            # interrupted copy into a shared cache_dir — the writer's
            # tmp+rename cannot protect against that) is a miss, not a
            # crash: the slice recomputes and the store *atomically
            # replaces* it (never a partial overwrite another reader could
            # trip on — it keeps serving the corrupt bytes until the rename
            # and gets its own warned miss).
            warnings.warn(f"ignoring unreadable cache entry {f}: {e}",
                          stacklevel=2)
            return None
        self._touch(f)
        return result

    def store(self, result: SliceResult,
              deps: tuple[str, ...] | None = None) -> None:
        """Persist one computed slice under its own ``spec_hash``; then, with
        a ``max_bytes`` cap, evict least-recently-used entries until the
        directory fits again (never the entry just written).

        ``deps`` is the slice's chunk-dependency fingerprint (the sha256s of
        every cube chunk the slice reads, ``file_source.slice_chunk_shas``):
        stored inside the entry so ``adopt`` can later prove the slice's
        input bytes are unchanged across an append (chunk-granular
        invalidation — entries *without* deps simply can never be adopted).

        The write happens under the entry dir's ``.lock`` (``_DirLock``) so
        it cannot race another process's eviction pass over the same dir.
        Lock contention — and any IO failure — degrades to a *warned skip*:
        the cache is an optimization, a failed store must cost a future
        recompute, never the run."""
        if result.spec_hash is None or result.slice_i is None:
            raise ValueError(
                "cannot cache a SliceResult without spec_hash and slice_i")
        payload = {
            "spec_hash": result.spec_hash,
            "slice_i": result.slice_i,
            "avg_error": result.avg_error,
            **{name: getattr(result, name) for name in _FIELDS},
        }
        if deps is not None:
            payload["deps"] = np.asarray(list(deps), dtype=np.str_)
        f = self.path(result.spec_hash, result.slice_i)
        try:
            if self.injector is not None:
                self.injector.on_cache("store", result.slice_i)
            if not self._write_entry(f, payload):
                warnings.warn(
                    f"cache entry dir {f.parent} locked by another process — "
                    f"skipping store for slice {result.slice_i}", stacklevel=2)
                return
        except OSError as e:
            warnings.warn(
                f"cache store failed for {f}: {e} — continuing without "
                "caching this slice", stacklevel=2)
            return
        if self.max_bytes is not None:
            self._evict(keep=f)

    def _write_entry(self, f: Path, payload: dict) -> bool:
        """tmp + atomic-rename one entry under its dir's ``.lock``; False on
        lock contention (counted), OSError propagates to the caller's
        warned-skip handling."""
        f.parent.mkdir(parents=True, exist_ok=True)
        lock = _DirLock(f.parent, self.lock_timeout_s)
        if not lock.acquire():
            with self._stats_lock:
                self.lock_misses += 1
            return False
        try:
            fd, tmp = tempfile.mkstemp(dir=f.parent, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as fh:
                    np.savez(fh, **payload)
                os.replace(tmp, f)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        finally:
            lock.release()
        return True

    # -- chunk-granular adoption (streaming appends) ---------------------------

    def deps(self, spec_hash: str, slice_i: int) -> tuple[str, ...] | None:
        """The chunk-dependency fingerprint stored with an entry, or None
        when the entry is missing or predates dependency tracking."""
        f = self.path(spec_hash, slice_i)
        try:
            with np.load(f) as z:
                if "deps" not in z.files:
                    return None
                return tuple(str(d) for d in z["deps"])
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            return None

    def adopt(self, old_hash: str, new_hash: str, slice_i: int,
              expected_deps: tuple[str, ...]) -> bool:
        """Re-key one slice's entry from ``old_hash`` to ``new_hash`` iff
        its stored chunk fingerprint equals ``expected_deps``.

        This is the soundness core of incremental recompute across appends:
        the two hashes come from the SAME spec differing only in manifest
        version, so equal fingerprints prove the slice reads identical
        bytes under both — the old result is bitwise-valid for the new
        hash. Anything less (missing deps, mismatched fingerprint, entry
        gone) refuses, and the slice recomputes normally. Returns True when
        the new entry exists afterwards."""
        target = self.path(new_hash, slice_i)
        if target.exists():
            return True
        if not expected_deps:
            return False
        old = self.path(old_hash, slice_i)
        if not old.exists():
            return False
        try:
            with np.load(old) as z:
                if str(z["spec_hash"]) != old_hash or "deps" not in z.files:
                    return False
                if tuple(str(d) for d in z["deps"]) != tuple(expected_deps):
                    return False
                payload = {
                    "spec_hash": new_hash,
                    "slice_i": slice_i,
                    "avg_error": float(z["avg_error"]),
                    "deps": z["deps"],
                    **{name: z[name] for name in _FIELDS},
                }
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            warnings.warn(f"ignoring unreadable cache entry {old}: {e}",
                          stacklevel=2)
            return False
        try:
            if not self._write_entry(target, payload):
                return False
        except OSError as e:
            warnings.warn(
                f"cache adopt failed for {target}: {e} — slice will "
                "recompute", stacklevel=2)
            return False
        with self._stats_lock:
            self.adoptions += 1
        return True

    # -- size accounting / eviction -------------------------------------------

    def entries(self) -> list[tuple[Path, float, int]]:
        """Every ``(path, mtime, size)`` entry currently in the cache,
        oldest-used first. Entries vanishing mid-scan (a concurrent evictor
        or store race) are skipped, not errors."""
        out = []
        if not self.dir.is_dir():
            return out
        for f in self.dir.glob("*/slice*.npz"):
            try:
                st = f.stat()
            except OSError:
                continue  # lost a race with a concurrent unlink
            out.append((f, st.st_mtime, st.st_size))
        out.sort(key=lambda e: (e[1], str(e[0])))
        return out

    def size_bytes(self) -> int:
        return sum(size for _, _, size in self.entries())

    def _evict(self, keep: Path | None = None) -> None:
        """Unlink oldest-used entries until the cap holds. ``keep`` (the
        entry a store just wrote) is never evicted, even when it alone
        exceeds the cap — a store must not erase its own result.

        The whole pass runs under a root-level ``.sweep.lock`` so two
        processes sharing one cache_dir never trim from independent stale
        snapshots (each would over-evict, blind to the other's unlinks); a
        contended sweep is skipped outright — the other process is already
        enforcing the cap. Each unlink additionally takes its entry dir's
        ``.lock`` with a short timeout so it cannot race another process's
        in-flight store into the same dir; a contended dir is simply
        skipped this pass (the next store's eviction will see it again)."""
        sweep = _DirLock(self.dir, min(0.1, self.lock_timeout_s),
                         name=".sweep.lock")
        if not sweep.acquire():
            with self._stats_lock:
                self.lock_misses += 1
            return
        try:
            self._evict_locked(keep)
        finally:
            sweep.release()

    def _evict_locked(self, keep: Path | None) -> None:
        entries = self.entries()
        total = sum(size for _, _, size in entries)
        for f, _mtime, size in entries:
            if total <= self.max_bytes:
                break
            if keep is not None and f == keep:
                continue
            lock = _DirLock(f.parent, min(0.1, self.lock_timeout_s))
            if not lock.acquire():
                with self._stats_lock:
                    self.lock_misses += 1
                continue
            try:
                os.unlink(f)
            except OSError:
                continue  # another process evicted it first: size unknown,
                # stay conservative and keep trimming from our own snapshot
            finally:
                lock.release()
            total -= size
            with self._stats_lock:
                self.evictions += 1

    def _touch(self, f: Path) -> None:
        """Refresh an entry's recency; racing with eviction is benign (a
        touched-then-evicted entry is simply a future miss)."""
        try:
            os.utime(f)
        except OSError:
            pass

    def _reap_stale_tmps(self, reap_seconds: float) -> None:
        """Remove ``*.tmp`` files old enough that their writer must have
        crashed before its atomic rename. Younger tmps may belong to a live
        concurrent writer and are left alone; unlink races are benign."""
        if not self.dir.is_dir():
            return
        cutoff = time.time() - reap_seconds  # repro: allow[DET]: tmp age, defines no result
        for tmp in self.dir.glob("*/*.tmp"):
            try:
                if tmp.stat().st_mtime <= cutoff:
                    os.unlink(tmp)
            except OSError:
                continue
