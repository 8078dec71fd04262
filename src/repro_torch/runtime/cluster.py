"""Multi-process cluster execution + cold-start elimination (DESIGN.md §17).

Port of ``repro.runtime.cluster``. The paper's weak-scaling runs put
independent Spark workers on separate nodes, each computing whole slices of
the cube against shared storage. This module is that topology for the
PyTorch pipeline: N ``repro_torch.launch.run_pdf`` processes, each pinned to
one shard of the round-robin slice deal (``scheduler.assign_slices``),
optionally joined into one ``torch.distributed`` world, all persisting to a
shared ``out_dir``. There are **no cross-process collectives** — slices are
independently recomputable partitions, so bitwise identity with the
single-process run follows from the staged executor's per-slice
equivalence contract, and process failure is survivable by construction.

Three seams live here:

* **Placement** (``ExecSpec.placement``): ``apply_placement`` pins the
  process to its shard; ``device_placement`` maps a shard to a local CUDA
  device (``placement.shard_devices``); ``init_distributed`` joins the
  ``torch.distributed`` world at ``tcp://<coordinator>`` with the gloo
  backend — no collective runs, and NCCL refuses two ranks on one device,
  which is how several workers share one card.
* **Elasticity** (shrink *and* grow): every worker writes ``alive`` →
  ``done``/``lost`` marker files under ``out_dir/cluster``. Survivors wait
  for every original shard's terminal marker, then re-deal the incomplete
  slices of lost shards over the *done* set (``elastic.plan_redeal``) —
  deterministic across survivors because the healthy set is exactly the
  original shards with ``done`` markers. A join-only worker
  (``process_id >= num_processes``) adds itself via ``plan_redeal``'s
  ``joined`` parameter.
* **Cold start**: ``enable_compilation_cache`` points the kernel build
  directory (``kernels/_build.BUILD_DIR``) at
  ``<compile_cache_dir>/<spec_hash>``, so a re-launched identical spec loads
  every CUDA library from disk without ``nvcc``; ``compile_counters``
  snapshots the process-wide build/load counts that ``SessionReport``
  exposes, so "zero new compilations" is assertable. A corrupt library
  there is a warned miss that rebuilds, never a crash.

``python -m repro_torch.runtime.cluster --compare REF OUT`` verifies two
persisted output directories bitwise.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import json
import os
import time
from pathlib import Path
from typing import Callable, Iterator

import torch

from repro_torch.kernels import _build
from repro_torch.runtime import elastic
from repro_torch.runtime.faults import shard_lost_from
from repro_torch.runtime.scheduler import assign_slices

# -- compile counters (cold-start visibility) ----------------------------------


def compile_counters() -> dict[str, int]:
    """Snapshot of the process's kernel-library activity, under the
    reference's keys: ``persistent_cache_misses`` counts ``nvcc`` builds
    started, ``persistent_cache_hits`` libraries loaded from the build
    directory without a build, ``compiles`` both, and ``traces`` stays 0
    (eager PyTorch traces nothing). The cold-start indicator is
    ``persistent_cache_misses == 0``. A library loads once a process, so
    the counts are process-wide and monotonic."""
    c = _build.counters()
    return {
        "traces": 0,
        "compiles": c["builds"] + c["cached_loads"],
        "persistent_cache_hits": c["cached_loads"],
        "persistent_cache_misses": c["builds"],
    }


def counters_delta(baseline: dict[str, int]) -> dict[str, int]:
    now = compile_counters()
    return {k: now[k] - baseline.get(k, 0) for k in now}


# -- persistent kernel cache ---------------------------------------------------


def enable_compilation_cache(base_dir: str | Path, spec_hash: str) -> Path:
    """Point the kernel build directory at ``<base_dir>/<spec_hash>`` —
    keyed next to the spec hash so the cache carries the same provenance as
    every other artifact. Libraries built from then on go there, and a
    re-launch finds them. Process-wide, like JAX's cache config: call it
    before the first kernel loads (a library already loaded stays loaded
    from where it was). Safe to call repeatedly."""
    path = Path(base_dir) / spec_hash
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path
    return path


# -- placement -----------------------------------------------------------------


def apply_placement(spec):
    """Pin a spec to this process's seat in the cluster: with
    ``placement.num_processes > 1``, ``execution.shards`` becomes the
    process count and ``execution.shard`` this process's id. Join-only
    workers (``process_id >= num_processes``) get no shard pin (they run
    nothing until redeal). Single-process specs pass through unchanged."""
    pl = spec.execution.placement
    if pl.num_processes <= 1 and pl.process_id is None:
        return spec
    if pl.num_processes > 1 and pl.process_id is None:
        raise ValueError(
            "placement.num_processes > 1 requires placement.process_id: "
            "each worker process must know its seat (launch/cluster.sh "
            "passes --process-id per process)")
    if spec.execution.shards not in (1, pl.num_processes):
        raise ValueError(
            f"execution.shards={spec.execution.shards} conflicts with "
            f"placement.num_processes={pl.num_processes} — leave shards "
            "unset in cluster mode (the placement section owns the deal)")
    shard = pl.process_id if pl.process_id < pl.num_processes else None
    return dataclasses.replace(spec, execution=dataclasses.replace(
        spec.execution, shards=pl.num_processes, shard=shard))


def init_distributed(placement) -> bool:
    """Join the ``torch.distributed`` world this placement describes
    (gloo, ``tcp://<coordinator>``; idempotent). Returns True when this
    process holds a seat — join-only workers and single-process runs return
    False (the world size is fixed at initialization, which is why growth
    goes through the marker protocol instead)."""
    if placement.num_processes <= 1 or not placement.distributed:
        return False
    pid = placement.process_id
    if pid is None or pid >= placement.num_processes:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    dist.init_process_group(
        "gloo", init_method=f"tcp://{placement.coordinator}",
        world_size=placement.num_processes, rank=pid,
        timeout=datetime.timedelta(seconds=placement.peer_timeout_s))
    atexit.register(_leave_world)
    return True


def _leave_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def device_placement(placement, shard: int, device: torch.device) -> torch.device:
    """The device a shard's executor stages onto: its
    ``placement.shard_devices`` entry (round-robin when the list is
    shorter) as a CUDA device, else ``device``. Refused on a session that
    does not run on CUDA, and past the CUDA devices present. Single-device
    staging keeps results bitwise-identical on any placement."""
    device = torch.device(device)
    sd = None if placement is None else placement.shard_devices
    if sd is None:
        return device
    if device.type != "cuda":
        raise ValueError(
            f"execution.placement.shard_devices {sd} names CUDA "
            f"devices, but the session runs on {device}")
    count = torch.cuda.device_count()
    bad = [d for d in sd if d >= count]
    if bad:
        raise ValueError(
            f"execution.placement.shard_devices {bad} beyond the "
            f"{count} CUDA device(s) present")
    return torch.device("cuda", sd[shard % len(sd)])


# -- the marker protocol -------------------------------------------------------

MARKER_DIRNAME = "cluster"
_POLL_S = 0.05


def _marker_dir(out_dir: str | Path) -> Path:
    return Path(out_dir) / MARKER_DIRNAME


def marker_path(out_dir: str | Path, shard: int, state: str) -> Path:
    return _marker_dir(out_dir) / f"shard{shard}.{state}"


def write_marker(out_dir: str | Path, shard: int, state: str,
                 payload: dict | None = None) -> None:
    """Atomically publish a worker state file (tmp + rename, so a peer never
    reads a torn marker)."""
    d = _marker_dir(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".shard{shard}.{state}.tmp"
    tmp.write_text(json.dumps({"shard": shard, "pid": os.getpid(),
                               **(payload or {})}))
    tmp.replace(marker_path(out_dir, shard, state))


def wait_for_peers(out_dir: str | Path, placement,
                   my_shard: int) -> tuple[list[int], list[int]]:
    """Block until every original shard has a terminal (done/lost) marker,
    up to ``peer_timeout_s`` — silent peers past the deadline are treated
    as lost. Returns ``(done, lost)`` sorted; ``done`` includes this worker
    when it holds an original seat. Because every survivor waits for the
    same terminal set, all survivors compute the same redeal plan."""
    deadline = time.monotonic() + placement.peer_timeout_s
    peers = [s for s in range(placement.num_processes) if s != my_shard]
    done = {my_shard} if my_shard < placement.num_processes else set()
    lost: set[int] = set()
    while True:
        for s in peers:
            if s in done or s in lost:
                continue
            if marker_path(out_dir, s, "done").exists():
                done.add(s)
            elif marker_path(out_dir, s, "lost").exists():
                lost.add(s)
        if len(done) + len(lost) >= placement.num_processes:
            break
        if time.monotonic() > deadline:
            lost.update(s for s in peers if s not in done)
            break
        time.sleep(_POLL_S)
    return sorted(done), sorted(lost)


def slice_complete(out_dir: str | Path, slice_i: int, lines_per_slice: int,
                   spec_hash: str | None) -> bool:
    """Whether a slice's persisted watermark says it finished under this
    spec — the recovery line the redeal scan uses to compute a dead shard's
    *unfinished* slices. Prefers the watermark's explicit ``complete``
    stamp, falling back to the line-count comparison."""
    f = Path(out_dir) / f"slice{slice_i}_watermark.json"
    if not f.exists():
        return False
    try:
        info = json.loads(f.read_text())
    except (OSError, ValueError):
        return False  # torn mid-write: treat as incomplete, recompute
    stored = info.get("spec_hash")
    if stored and spec_hash and stored != spec_hash:
        return False
    if "complete" in info:
        return bool(info["complete"])
    return int(info.get("next_line", 0)) >= lines_per_slice


# -- the worker loop -----------------------------------------------------------


def run_worker(session, on_window: Callable | None = None,
               log: Callable[[str], None] | None = None) -> Iterator:
    """One cluster worker's whole life, as a ``SliceResult`` generator:
    run this process's dealt slices, publish the terminal marker, then (with
    ``placement.redeal``) wait for peers and pick up this worker's share of
    any dead peer's unfinished slices (``resume=True`` — windows the dead
    worker persisted are skipped, recomputed windows are bitwise-identical).
    A worker whose own shard dies (``ShardLostError``) publishes ``lost``
    and stops — its recovery belongs to the survivors. Join-only workers
    skip the initial run and enter directly at the redeal step."""
    spec = session.spec
    pl = spec.execution.placement
    out_dir = spec.execution.out_dir
    if out_dir is None:
        raise ValueError("cluster workers require execution.out_dir")
    emit = log if log is not None else (lambda s: None)
    my = pl.process_id if pl.process_id is not None else (
        spec.execution.shard or 0)
    joiner = my >= pl.num_processes
    write_marker(out_dir, my, "alive", {"join": joiner})
    try:
        if not joiner:
            yield from session.run(on_window=on_window)
    except Exception as e:
        if shard_lost_from(e) is None:
            write_marker(out_dir, my, "lost", {"error": repr(e)})
            raise
        write_marker(out_dir, my, "lost", {"injected": True})
        emit(f"[cluster] shard {my} lost mid-run — survivors will redeal")
        return
    write_marker(out_dir, my, "done", {})
    if not pl.redeal or pl.num_processes <= 1:
        return
    done, lost = wait_for_peers(out_dir, pl, my)
    if not lost:
        return
    resolved = session.resolve_slices(None)
    assignment = {a.shard: a.slices
                  for a in assign_slices(resolved, pl.num_processes)}
    lines = session.geometry.lines_per_slice
    pending = [s for sh in lost for s in assignment.get(sh, ())
               if not slice_complete(out_dir, s, lines, session.spec_hash)]
    if not pending:
        return
    session.shards_lost = tuple(lost)
    plan = elastic.plan_redeal(pending, done, lost,
                               joined=(my,) if joiner else ())
    mine = plan.slices_for(my)
    if not mine:
        return
    emit(f"[cluster] shard {my} redealing slices {list(mine)} from lost "
         f"shard(s) {lost}")
    yield from session.run_local(mine, shard=my, resume=True,
                                 on_window=on_window)


# -- bitwise output verification -----------------------------------------------


def verify_outputs(ref_dir: str | Path, out_dir: str | Path) -> tuple[int, int]:
    """Assert two persisted output directories hold bitwise-identical window
    results: the same ``slice*_window_*.npz`` names, the same array keys,
    ``np.array_equal`` on every array (the files' zip bytes differ by
    timestamps; the *arrays* are the contract). Returns ``(windows,
    arrays)`` compared; raises ``AssertionError`` on any divergence."""
    import numpy as np

    ref_dir, out_dir = Path(ref_dir), Path(out_dir)
    ref_files = sorted(p.name for p in ref_dir.glob("slice*_window_*.npz"))
    out_files = sorted(p.name for p in out_dir.glob("slice*_window_*.npz"))
    if not ref_files:
        raise AssertionError(f"no persisted windows under {ref_dir}")
    if ref_files != out_files:
        raise AssertionError(
            f"window sets differ: only-ref={sorted(set(ref_files) - set(out_files))} "
            f"only-out={sorted(set(out_files) - set(ref_files))}")
    arrays = 0
    for name in ref_files:
        with np.load(ref_dir / name, allow_pickle=False) as a, \
                np.load(out_dir / name, allow_pickle=False) as b:
            if sorted(a.files) != sorted(b.files):
                raise AssertionError(
                    f"{name}: array keys differ ({sorted(a.files)} vs "
                    f"{sorted(b.files)})")
            for k in a.files:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(
                        f"{name}[{k}]: arrays differ (not bitwise-identical)")
                arrays += 1
    return len(ref_files), arrays


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.cluster",
        description="cluster tooling: bitwise output verification")
    ap.add_argument("--compare", nargs=2, metavar=("REF", "OUT"),
                    help="assert two persisted out_dirs are bitwise-identical")
    args = ap.parse_args(argv)
    if not args.compare:
        ap.error("nothing to do — pass --compare REF OUT")
    windows, arrays = verify_outputs(*args.compare)
    print(f"[cluster] bitwise-identical windows={windows} arrays={arrays}")


if __name__ == "__main__":
    main()
