"""Chunked cube-on-disk format: the pipeline's real file/NFS source (§3, §6).

Port of ``repro.data.file_source`` (numpy only): the same on-disk format and
manifest, so a cube exported by either package reads bitwise in the other
and has the same ``content_sha256``. Format-2 cubes are written by the
streaming append (``repro_torch.streaming.append``, bitwise the
reference's); this reader reads them, from either package.

The paper's input is not synthetic — it is a cube "produced by observation
… or numerical simulation programs" persisted on disk/NFS, which Spark's
workers then read window by window. This module is that persistence layer
for the reproduction:

  * ``export_cube`` snapshots ANY window-addressable source (the lazy
    ``SeismicSimulation``, an ``ArrayDataSource``, another file cube) into a
    directory of chunked ``.npy`` files plus a ``manifest.json``, so a
    simulation becomes real bytes on disk once and every later run reads
    those bytes instead of regenerating them;
  * ``FileCubeSource`` is the window reader: ``load_window`` memmaps only
    the chunks a window overlaps (a window read touches O(window) bytes, not
    the cube), so it plugs straight into ``WindowPrefetcher`` prefetching and
    the ``ThrottledSource`` NFS-bandwidth model like every other source;
  * the manifest carries a per-chunk sha256 and a ``content_sha256`` over
    the whole description — the cube's *data identity*, which the
    reference's file ``SourceSpec`` hashes by (DESIGN.md §12).

On-disk layout (``layout='chunked'``, the only layout so far)::

    cube_dir/
      manifest.json                # geometry, dtype, chunk index, hashes
      s00000_l00000.npy            # (lines_per_chunk, ppl, n_obs) float32
      s00000_l00016.npy
      ...

Chunks split each slice along lines (``lines_per_chunk``), independent of
the pipeline's ``window_lines`` — the reader stitches windows from whatever
chunks they overlap, so one exported cube serves every window size.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Callable

import numpy as np

from repro_torch.core.regions import CubeGeometry, Window, iter_windows

MANIFEST_NAME = "manifest.json"
FORMAT_NAME = "repro-cube"
# Format 1: immutable snapshot cubes (export_cube). Format 2 adds the
# streaming-append extensions — a monotone manifest ``version``, archived
# ``manifest.vNNNNNN.json`` bodies, and delta chunks carrying an
# ``obs_start``/``obs_end`` observation range (streaming/append.py). A
# reader speaks both; export still writes format 1 so snapshot cubes stay
# readable by builds that predate streaming.
FORMAT_VERSION = 1
APPEND_FORMAT_VERSION = 2
SUPPORTED_FORMAT_VERSIONS = (1, 2)
LAYOUTS = ("chunked",)
DEFAULT_LINES_PER_CHUNK = 16

# How many chunk memmaps a reader keeps open at once. Sequential window
# reads touch a sliding band of chunks, so a small LRU is enough; the cap
# keeps a paper-scale cube (thousands of chunks) from exhausting file
# descriptors.
_MMAP_CACHE_SIZE = 64


def _chunk_name(slice_i: int, line_start: int) -> str:
    return f"s{slice_i:05d}_l{line_start:05d}.npy"


def _array_sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _manifest_content_sha(manifest: dict) -> str:
    """The cube's data identity: sha256 over the canonical JSON of the
    manifest *without* its own ``content_sha256`` field. The per-chunk
    hashes are inside, so any byte of observation data changing changes
    this digest — and with it every dependent spec ``content_hash``."""
    payload = {k: v for k, v in manifest.items() if k != "content_sha256"}
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _archive_name(version: int) -> str:
    return f"manifest.v{version:06d}.json"


def read_manifest(path: str | Path, version: int | None = None) -> dict:
    """Load + sanity-check a cube directory's manifest.

    ``version=None`` reads the current manifest; an explicit version reads
    that snapshot of the cube's history — the current manifest if it *is*
    that version, else the ``manifest.vNNNNNN.json`` body an append
    archived (streaming/append.py)."""
    f = Path(path) / MANIFEST_NAME
    if not f.exists():
        raise ValueError(
            f"no cube manifest at {f} — export one first with "
            "data.file_source.export_cube(source, out_dir)")
    manifest = json.loads(f.read_text())
    current = int(manifest.get("version", 1))
    if version is not None and version != current:
        if not 1 <= version < current:
            raise ValueError(
                f"cube at {path} has no version {version} "
                f"(current is {current})")
        arch = Path(path) / _archive_name(version)
        if not arch.exists():
            raise ValueError(
                f"cube at {path}: archived manifest {arch.name} is missing "
                f"(crash-orphaned history?) — only the current version "
                f"{current} is readable")
        manifest = json.loads(arch.read_text())
    if manifest.get("format") != FORMAT_NAME:
        raise ValueError(
            f"{f} is not a {FORMAT_NAME} manifest (format="
            f"{manifest.get('format')!r})")
    if manifest.get("format_version") not in SUPPORTED_FORMAT_VERSIONS:
        raise ValueError(
            f"cube format version {manifest.get('format_version')} "
            f"unsupported (this build reads versions "
            f"{SUPPORTED_FORMAT_VERSIONS})")
    return manifest


def manifest_sha(path: str | Path, version: int | None = None) -> str:
    """The cube's ``content_sha256`` — what a file source's spec hashes
    by. Recomputed from the manifest body (not trusted from the
    stored field), so a hand-edited manifest cannot alias another cube's
    provenance. ``version`` addresses an archived manifest — how the
    incremental layer reconstructs the spec hash a *previous* version of
    the cube ran under (streaming/incremental.py)."""
    return _manifest_content_sha(read_manifest(path, version=version))


def manifest_version(path: str | Path) -> int:
    """The cube's current manifest version (1 for never-appended cubes —
    format-1 manifests carry no ``version`` field)."""
    return int(read_manifest(path).get("version", 1))


def chunk_obs_range(entry: dict, base_obs: int) -> tuple[int, int]:
    """A chunk's observation range ``[obs_start, obs_end)``. Base chunks
    (format 1, or the original export inside an appended cube) carry no
    range and cover the base observations."""
    return (int(entry.get("obs_start", 0)),
            int(entry.get("obs_end", base_obs)))


def slice_chunk_shas(manifest: dict, slice_i: int) -> tuple[str, ...]:
    """The slice's chunk sha256 set in canonical (obs_start, line_start)
    order — the per-slice *dependency fingerprint* the reference's
    chunk-granular result-cache invalidation records and compares:
    equal fingerprints ⇒ the slice's input bytes are unchanged."""
    base_obs = int(manifest["num_observations"])
    mine = [c for c in manifest["chunks"] if c["slice"] == slice_i]
    mine.sort(key=lambda c: (chunk_obs_range(c, base_obs)[0], c["line_start"]))
    return tuple(c["sha256"] for c in mine)


def chunk_diff(path: str | Path, old_version: int,
               new_version: int | None = None) -> dict:
    """What changed between two versions of a cube: the slices whose chunk
    set differs and the chunk entries present only in the newer version.
    Drives chunk-granular invalidation — a consumer holding results for
    ``old_version`` needs to recompute exactly ``changed_slices`` and can
    keep everything else."""
    old_m = read_manifest(path, version=old_version)
    new_m = read_manifest(path, version=new_version)
    old_files = {c["file"] for c in old_m["chunks"]}
    new_chunks = [c for c in new_m["chunks"] if c["file"] not in old_files]
    num_slices = int(new_m["num_slices"])
    changed = sorted({
        s for s in range(num_slices)
        if slice_chunk_shas(old_m, s) != slice_chunk_shas(new_m, s)})
    return {
        "old_version": int(old_m.get("version", 1)),
        "new_version": int(new_m.get("version", 1)),
        "changed_slices": changed,
        "new_chunks": new_chunks,
    }


def export_cube(
    source,
    out_dir: str | Path,
    lines_per_chunk: int = DEFAULT_LINES_PER_CHUNK,
    progress: Callable[[int, int], None] | None = None,
    overwrite: bool = False,
):
    """Snapshot a window-addressable source to a chunked cube directory.

    ``source`` is either a live source object (``geometry`` +
    ``load_window``) or a ``SourceSpec`` — a simulation spec is materialized
    here (with its NFS-throttle model stripped: the throttle describes the
    *read* path, and export is the write path). Returns a ready-to-run
    ``SourceSpec(kind='file', path=out_dir)`` carrying the original spec's
    throttle, so ``export_cube(spec.source, d)`` drops straight back into a
    ``PipelineSpec``.

    The manifest is written last (tmp + atomic rename): a crashed export
    leaves a directory without a manifest, which every reader refuses —
    never a readable-but-truncated cube. A directory that already holds a
    cube (its ``manifest.json`` exists) is refused *before any chunk is
    written* unless ``overwrite=True`` — re-exporting over a live cube
    would silently change its data identity, so clobbering must be
    explicit.
    """
    from repro_torch.api.spec import SourceSpec, build_source

    throttle = None
    if isinstance(source, SourceSpec):
        throttle = source.throttle_mb_s
        source = build_source(dataclasses.replace(source, throttle_mb_s=None))
    if lines_per_chunk < 1:
        raise ValueError(f"lines_per_chunk must be >= 1, got {lines_per_chunk}")

    geom: CubeGeometry = source.geometry
    out = Path(out_dir)
    if not overwrite and (out / MANIFEST_NAME).exists():
        raise FileExistsError(
            f"{out} already holds a cube ({MANIFEST_NAME} exists) — "
            "exporting over it would replace its data identity; pass "
            "overwrite=True to clobber, or export elsewhere")
    out.mkdir(parents=True, exist_ok=True)

    chunks = []
    num_obs = None
    total = sum(1 for s in range(geom.num_slices)
                for _ in iter_windows(geom, s, lines_per_chunk))
    done = 0
    for s in range(geom.num_slices):
        for w in iter_windows(geom, s, lines_per_chunk):
            block = np.asarray(source.load_window(w), dtype=np.float32)
            if num_obs is None:
                num_obs = block.shape[1]
            arr = block.reshape(w.num_lines, geom.points_per_line, num_obs)
            name = _chunk_name(s, w.line_start)
            np.save(out / name, arr)
            chunks.append({
                "file": name,
                "slice": s,
                "line_start": w.line_start,
                "line_end": w.line_end,
                "sha256": _array_sha256(arr),
            })
            done += 1
            if progress is not None:
                progress(done, total)

    manifest = {
        "format": FORMAT_NAME,
        "format_version": FORMAT_VERSION,
        "layout": "chunked",
        "num_slices": geom.num_slices,
        "lines_per_slice": geom.lines_per_slice,
        "points_per_line": geom.points_per_line,
        "num_observations": int(num_obs),
        "dtype": "float32",
        "lines_per_chunk": lines_per_chunk,
        "chunks": chunks,
    }
    manifest["content_sha256"] = _manifest_content_sha(manifest)
    tmp = out / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(manifest, indent=1, sort_keys=True))
    os.replace(tmp, out / MANIFEST_NAME)

    # Geometry fields on a file spec are advisory (the manifest is
    # authoritative, and they are excluded from the hash) — fill them in
    # anyway so the returned spec reads true.
    return SourceSpec(
        kind="file", path=str(out), throttle_mb_s=throttle,
        num_slices=geom.num_slices, lines_per_slice=geom.lines_per_slice,
        points_per_line=geom.points_per_line, observations=int(num_obs))


class FileCubeSource:
    """Window reader over an exported cube directory.

    ``load_window(w) -> (num_points, n_obs) float32``, bit-identical to what
    the exported source produced (tests/test_file_source.py asserts the
    round-trip against the simulation, and through the full pipeline;
    tests/test_torch_file_source.py holds the port's reader to it).
    Reads memmap only the chunks the window overlaps and copy them into a
    fresh array — the copy forces the actual page-in, so a wrapping
    ``ThrottledSource`` times real bytes moved, and the buffer handed to the
    prefetcher is safe to donate.

    ``enable_read_verification()`` arms *verified reads*: every chunk a
    window touches is fully loaded (no memmap) and re-hashed against the
    manifest, with ONE automatic re-read on mismatch before raising — a torn
    read over NFS (reader racing a copy, transient bit flip in transit)
    recovers transparently; persistent corruption raises with the chunk path
    and attempt count (DESIGN.md §14). ``verify()`` uses the same re-read
    policy. ``read_hook`` is the chaos-testing seam ``runtime.faults`` uses
    to corrupt chunk bytes deterministically in tests.
    """

    def __init__(self, path: str | Path, verify_reads: bool = False,
                 read_hook: Callable | None = None,
                 version: int | None = None):
        self.path = Path(path)
        self.verify_reads = bool(verify_reads)
        self.read_hook = read_hook
        self.manifest = read_manifest(self.path, version=version)
        m = self.manifest
        self.version = int(m.get("version", 1))
        self.geometry = CubeGeometry(
            m["num_slices"], m["lines_per_slice"], m["points_per_line"])
        # The BASE observation count (the original export's). Appended
        # slices carry extra observation *layers* on top — per-slice totals
        # come from slice_observations().
        self.num_observations = m["num_observations"]
        self.content_sha256 = _manifest_content_sha(m)
        # Per-slice chunk index, ordered by (obs_start, line_start) — and
        # validated so load_window can never silently return uninitialized
        # buffer regions: every observation layer must tile the slice's
        # lines exactly, and the layers themselves must be contiguous in
        # observations ([0, base), [base, e1), [e1, e2), ...).
        self._chunks: dict[int, list[dict]] = {}
        for c in m["chunks"]:
            self._chunks.setdefault(c["slice"], []).append(c)
        self._slice_obs: dict[int, int] = {}
        for s in range(self.geometry.num_slices):
            lst = self._chunks.get(s, ())
            layers: dict[tuple[int, int], list[dict]] = {}
            for c in lst:
                layers.setdefault(chunk_obs_range(c, self.num_observations),
                                  []).append(c)
            obs_end = 0
            for (o0, o1), layer in sorted(layers.items()):
                if o0 != obs_end or o1 <= o0:
                    raise ValueError(
                        f"cube manifest at {self.path} slice {s}: "
                        f"observation layer [{o0}, {o1}) does not extend "
                        f"the covered range [0, {obs_end})")
                layer.sort(key=lambda c: c["line_start"])
                line = 0
                for c in layer:
                    if c["line_start"] != line or c["line_end"] <= c["line_start"]:
                        break
                    line = c["line_end"]
                if line != self.geometry.lines_per_slice:
                    raise ValueError(
                        f"cube manifest at {self.path} does not cover slice "
                        f"{s} (obs [{o0}, {o1})): chunks tile lines "
                        f"[0, {line}) of [0, {self.geometry.lines_per_slice})")
                obs_end = o1
            if obs_end == 0:
                raise ValueError(
                    f"cube manifest at {self.path} has no chunks for "
                    f"slice {s}")
            self._slice_obs[s] = obs_end
            lst = sorted(
                lst, key=lambda c: (
                    chunk_obs_range(c, self.num_observations)[0],
                    c["line_start"]))
            self._chunks[s] = lst
        self._mmaps: OrderedDict[str, np.ndarray] = OrderedDict()
        # Speculative re-dispatch (core.executor) can read two windows of
        # one source from two threads; the LRU mutations must not race.
        self._mmap_lock = threading.Lock()

    def slice_observations(self, slice_i: int) -> int:
        """Total observations for one slice — the base export's count plus
        every appended layer's (appends touch a subset of slices, so the
        per-slice totals may differ)."""
        return self._slice_obs[slice_i]

    def enable_read_verification(self, read_hook: Callable | None = None):
        """Arm verified (full-load + sha256 + one re-read) window reads; see
        the class docstring. ``read_hook(slice_i, line_start, arr, attempt)
        -> arr`` intercepts each freshly read chunk — the fault-injection
        seam. Returns ``self`` for chaining."""
        self.verify_reads = True
        if read_hook is not None:
            self.read_hook = read_hook
        return self

    def _mmap(self, entry: dict) -> np.ndarray:
        name = entry["file"]
        with self._mmap_lock:
            if name in self._mmaps:
                self._mmaps.move_to_end(name)
                return self._mmaps[name]
        arr = np.load(self.path / name, mmap_mode="r")
        o0, o1 = chunk_obs_range(entry, self.num_observations)
        expect = (entry["line_end"] - entry["line_start"],
                  self.geometry.points_per_line, o1 - o0)
        if arr.shape != expect or arr.dtype != np.float32:
            raise ValueError(
                f"cube chunk {name}: shape {arr.shape} dtype {arr.dtype} "
                f"does not match manifest ({expect}, float32)")
        with self._mmap_lock:
            self._mmaps[name] = arr
            if len(self._mmaps) > _MMAP_CACHE_SIZE:
                self._mmaps.popitem(last=False)
        return arr

    def _read_chunk_verified(self, entry: dict) -> np.ndarray:
        """Fully load one chunk and check its sha256 against the manifest.

        A mismatch triggers exactly ONE re-read (the torn-read/transient
        case self-heals); a second mismatch raises with the chunk path and
        attempt count, so the operator knows retrying was already tried."""
        name = entry["file"]
        attempts = 0
        while True:
            attempts += 1
            arr = np.load(self.path / name)
            if self.read_hook is not None:
                arr = self.read_hook(
                    entry["slice"], entry["line_start"], arr, attempts)
            got = _array_sha256(arr)
            if got == entry["sha256"]:
                return arr
            if attempts >= 2:
                raise ValueError(
                    f"cube chunk {self.path / name} corrupt after "
                    f"{attempts} read attempts: sha256 {got} != "
                    f"manifest {entry['sha256']}")

    def load_window(self, w: Window) -> np.ndarray:
        if w.slice_i not in self._slice_obs:
            raise ValueError(f"window {w} outside cube {self.geometry}")
        return self.load_window_obs(w, 0, self._slice_obs[w.slice_i])

    def load_window_obs(self, w: Window, obs_start: int,
                        obs_end: int) -> np.ndarray:
        """One window restricted to the observation range ``[obs_start,
        obs_end)`` — ``load_window`` is the full range. The restricted form
        is the streaming delta read: an incremental update touches only the
        chunks of the appended layers, O(new data) bytes, never the base
        cube (streaming/incremental.py)."""
        geom = self.geometry
        if not (0 <= w.slice_i < geom.num_slices
                and 0 <= w.line_start < w.line_end <= geom.lines_per_slice):
            raise ValueError(f"window {w} outside cube {geom}")
        slice_obs = self._slice_obs[w.slice_i]
        if not 0 <= obs_start < obs_end <= slice_obs:
            raise ValueError(
                f"observation range [{obs_start}, {obs_end}) outside the "
                f"slice's [0, {slice_obs})")
        width = obs_end - obs_start
        out = np.empty((w.num_lines, geom.points_per_line, width),
                       dtype=np.float32)
        for entry in self._chunks.get(w.slice_i, ()):
            o0, o1 = chunk_obs_range(entry, self.num_observations)
            if o1 <= obs_start or o0 >= obs_end:
                continue
            if entry["line_end"] <= w.line_start or entry["line_start"] >= w.line_end:
                continue
            lo = max(w.line_start, entry["line_start"])
            hi = min(w.line_end, entry["line_end"])
            co0 = max(o0, obs_start)
            co1 = min(o1, obs_end)
            src = (self._read_chunk_verified(entry) if self.verify_reads
                   else self._mmap(entry))
            out[lo - w.line_start : hi - w.line_start, :,
                co0 - obs_start : co1 - obs_start] = src[
                lo - entry["line_start"] : hi - entry["line_start"], :,
                co0 - o0 : co1 - o0]
        return out.reshape(w.num_lines * geom.points_per_line, width)

    def verify(self) -> None:
        """Re-hash every chunk against the manifest; raises on the first
        *persistent* mismatch (bit rot, partial copy, or tampering) — each
        chunk gets the standard one-re-read grace for torn reads."""
        for c in self.manifest["chunks"]:
            self._read_chunk_verified(c)

    def nominal_bytes(self) -> int:
        return sum(self.geometry.points_per_slice * obs * 4
                   for obs in self._slice_obs.values())
