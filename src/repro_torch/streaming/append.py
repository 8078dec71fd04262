"""``append_realizations``: extend an exported cube with new observations.

Port of ``repro.streaming.append`` (numpy only, bitwise the reference's:
the same chunk files, manifest and ``content_sha256`` for the same append).

An append adds ``k`` new Monte-Carlo realizations to every point of a
*subset* of slices — the streaming-ingestion shape of the paper's cube
(sensors and simulation campaigns keep producing realizations; the spatial
geometry never changes). On disk an append is purely additive:

* new chunk files named ``s{slice:05d}_l{line:05d}.v{version:06d}.npy`` —
  version-stamped so a delta chunk can never collide with the base export
  or any earlier append;
* new manifest chunk entries carrying the observation range
  ``obs_start``/``obs_end`` the layer covers (base chunks keep their
  implicit ``[0, num_observations)`` range);
* the previous manifest body archived as ``manifest.vNNNNNN.json`` and a
  new ``manifest.json`` with a monotonically bumped ``version`` written
  via the repo's tmp + atomic-rename discipline.

Write order is chunks → archive → manifest replace, so a crash at ANY
point leaves the previous version fully readable (orphaned delta chunks
and a pre-archived body are inert until a manifest references them, and a
retried append overwrites them idempotently). ``FileCubeSource`` opens any
archived version, and ``chunk_diff`` reports exactly which slices an
append touched — the unit of chunk-granular cache invalidation.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from repro_torch.core.regions import CubeGeometry, iter_windows
from repro_torch.data.file_source import (
    APPEND_FORMAT_VERSION,
    MANIFEST_NAME,
    _archive_name,
    _array_sha256,
    _manifest_content_sha,
    chunk_obs_range,
    read_manifest,
)


def _delta_chunk_name(slice_i: int, line_start: int, version: int) -> str:
    return f"s{slice_i:05d}_l{line_start:05d}.v{version:06d}.npy"


def _slice_obs_total(manifest: dict, slice_i: int) -> int:
    base = int(manifest["num_observations"])
    ends = [chunk_obs_range(c, base)[1]
            for c in manifest["chunks"] if c["slice"] == slice_i]
    return max(ends) if ends else 0


def append_realizations(cube_dir: str | Path,
                        new_data: dict[int, np.ndarray]) -> int:
    """Append new realizations to ``cube_dir`` and return the new manifest
    version.

    ``new_data`` maps ``slice_i -> (lines_per_slice, points_per_line, k)``
    float32 observations (``(points_per_slice, k)`` is accepted and
    reshaped); every point of a written slice gains the same ``k`` new
    observations, untouched slices keep their chunk set bit-for-bit — the
    property the chunk-diff invalidation layer relies on."""
    out = Path(cube_dir)
    manifest = read_manifest(out)
    geom = CubeGeometry(manifest["num_slices"], manifest["lines_per_slice"],
                        manifest["points_per_line"])
    lines_per_chunk = int(manifest["lines_per_chunk"])
    cur_version = int(manifest.get("version", 1))
    new_version = cur_version + 1

    if not new_data:
        raise ValueError("append_realizations: new_data is empty — nothing "
                         "to append")
    blocks: dict[int, np.ndarray] = {}
    for s, arr in sorted(new_data.items()):
        if not 0 <= int(s) < geom.num_slices:
            raise ValueError(
                f"append slice {s} outside the cube's {geom.num_slices} "
                "slices")
        a = np.asarray(arr, dtype=np.float32)
        if a.ndim == 2:
            a = a.reshape(geom.lines_per_slice, geom.points_per_line, -1)
        if (a.ndim != 3 or a.shape[:2] !=
                (geom.lines_per_slice, geom.points_per_line) or
                a.shape[2] < 1):
            raise ValueError(
                f"append data for slice {s} has shape {np.shape(arr)}; "
                f"expected ({geom.lines_per_slice}, {geom.points_per_line}, "
                "k>=1)")
        blocks[int(s)] = a

    # 1) delta chunks — additive files, inert until the manifest lands
    new_entries = []
    for s, a in blocks.items():
        o0 = _slice_obs_total(manifest, s)
        o1 = o0 + a.shape[2]
        for w in iter_windows(geom, s, lines_per_chunk):
            chunk = np.ascontiguousarray(a[w.line_start:w.line_end])
            name = _delta_chunk_name(s, w.line_start, new_version)
            np.save(out / name, chunk)
            new_entries.append({
                "file": name,
                "slice": s,
                "line_start": w.line_start,
                "line_end": w.line_end,
                "obs_start": o0,
                "obs_end": o1,
                "sha256": _array_sha256(chunk),
            })

    # 2) archive the current body under its own version (idempotent on a
    #    retried append — the body is identical)
    arch_tmp = out / (_archive_name(cur_version) + ".tmp")
    arch_tmp.write_text(json.dumps(manifest, indent=1, sort_keys=True))
    os.replace(arch_tmp, out / _archive_name(cur_version))

    # 3) the new manifest, atomically — the commit point of the append
    new_manifest = dict(manifest)
    new_manifest["format_version"] = APPEND_FORMAT_VERSION
    new_manifest["version"] = new_version
    new_manifest["chunks"] = list(manifest["chunks"]) + new_entries
    new_manifest.pop("content_sha256", None)
    new_manifest["content_sha256"] = _manifest_content_sha(new_manifest)
    tmp = out / (MANIFEST_NAME + ".tmp")
    tmp.write_text(json.dumps(new_manifest, indent=1, sort_keys=True))
    os.replace(tmp, out / MANIFEST_NAME)
    return new_version
