"""Multi-slice PDF run — the production launcher over the ``repro_torch.api``
surface (port of ``repro.launch.run_pdf``).

Every pipeline knob comes from the declarative ``PipelineSpec``: flags are
auto-generated from the spec fields (``api.cli``), ``--spec FILE`` loads a
JSON spec (explicit flags override), and the run streams slice results from
a ``PDFSession``. Whole slices are dealt to shards of the mesh data axis
(the paper's per-node slice assignment); ``--shard`` restricts execution to
one shard. Watermark files are per-slice and
stamped with the spec's content hash, so ``--resume`` refuses to mix
windows persisted by a *different* computation (DESIGN.md §API).

``--watch`` (kind='file' sources) keeps the process alive after the first
run, polling the cube's manifest version every ``stream.poll_interval_s``
seconds: when an append lands, the session re-opens the cube at the new
version and applies the update incrementally — unchanged slices are adopted
in the result cache and served as hits, appended slices merge forward or
recompute per ``stream.update_mode`` (DESIGN.md §16). ``--stream-max-updates
N`` exits after N applied appends. The port recomputes where no merge
applies and refuses (``NotImplementedError``) where the reference would
merge: the merge path is ROADMAP item 13.

``--device`` picks the torch device (default ``cuda``; ``cpu`` runs the
kernels' plain versions). A placement over more than one process is
refused by the session: the cluster mode is ROADMAP item 15.

  PYTHONPATH=src python -m repro_torch.launch.run_pdf --slices 0 1 2 3 --shards 2
  PYTHONPATH=src python -m repro_torch.launch.run_pdf --method grouping_ml --serial
  PYTHONPATH=src python -m repro_torch.launch.run_pdf --spec run.json --resume
  PYTHONPATH=src python -m repro_torch.launch.run_pdf --source-path cube/ --watch
  PYTHONPATH=src python -m repro_torch.launch.run_pdf --device cpu --lines 12 --ppl 30 --obs 200
"""

from __future__ import annotations

import argparse
import time

from repro_torch.api import (
    ExecSpec,
    MethodSpec,
    PDFSession,
    PipelineSpec,
    add_spec_args,
    spec_from_args,
)

# The launcher's only defaults that differ from the spec's own: the paper's
# headline method and a 4-slice demo run. Everything else — geometry,
# backends, staging — is the spec's single declaration.
BASE_SPEC = PipelineSpec(
    method=MethodSpec(name="grouping"),
    execution=ExecSpec(slices=(0, 1, 2, 3)),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_spec_args(ap)
    ap.add_argument("--watch", action="store_true", help=(
        "after the first run, poll the file cube's manifest version and "
        "apply appends incrementally as they land (stream.* knobs govern "
        "polling and update mode)"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    spec = spec_from_args(args, base=BASE_SPEC)
    if args.watch and spec.source.kind != "file":
        ap.error("--watch requires a file source (--source-path)")

    session = PDFSession(spec, device=args.device)
    # the session's memoized hash: one manifest read for kind='file', and
    # the banner can never disagree with the hash keying the run/cache
    print(f"[spec] hash={session.spec_hash} source={spec.source.kind} "
          f"method={spec.method.name} "
          f"mode={spec.compute.mode} fit={spec.compute.fit_backend} "
          f"select={spec.compute.select_backend} device={session.device}")
    from repro_torch.runtime.scheduler import assign_slices

    slices = session.resolve_slices(None)
    for a in assign_slices(slices, spec.execution.shards):
        print(f"[assign] shard {a.shard}: slices {list(a.slices)}")

    _run_once(session, spec)
    if args.watch:
        _watch(session, spec)


def _watch(session: PDFSession, spec: PipelineSpec) -> None:
    """Poll the manifest version; on a bump, re-open the cube and run the
    session again — adoption + merge/strict updates make the re-run cost
    O(appended data) for cached/persisted slices."""
    from repro_torch.data.file_source import manifest_version

    last_v = manifest_version(spec.source.path)
    applied = 0
    limit = spec.stream.max_updates
    print(f"[watch] cube at version {last_v}; polling every "
          f"{spec.stream.poll_interval_s}s"
          + (f" (max {limit} update(s))" if limit else ""))
    try:
        while limit is None or applied < limit:
            time.sleep(spec.stream.poll_interval_s)
            try:
                v = manifest_version(spec.source.path)
            except (OSError, ValueError):
                continue  # manifest mid-replace: next poll sees it whole
            if v == last_v:
                continue
            print(f"[watch] manifest version {last_v} -> {v}: updating")
            session.refresh_source()
            print(f"[spec] hash={session.spec_hash} (version {v})")
            _run_once(session, spec)
            last_v = v
            applied += 1
    except KeyboardInterrupt:
        print(f"[watch] stopped after {applied} update(s)")


def _run_once(session: PDFSession, spec: PipelineSpec) -> None:
    window_durations: list[float] = []

    def on_window(ws):
        window_durations.append(ws.load_seconds + ws.compute_seconds)

    t0 = time.perf_counter()
    for r in session.run(on_window=on_window):
        if r.cached:
            print(f"[slice {r.slice_i}] E={r.avg_error:.4f} served from "
                  f"result cache (spec {r.spec_hash})")
            continue
        print(f"[slice {r.slice_i}] E={r.avg_error:.4f} windows={len(r.stats)} "
              f"fitted={sum(w.num_fitted for w in r.stats)}"
              f"/{session.geometry.points_per_slice}")
        if r.degraded:
            print(f"[degraded] slice {r.slice_i}: {len(r.quarantined)} "
                  f"window(s) quarantined — see the failed-unit manifest "
                  f"next to the watermark")
    wall = time.perf_counter() - t0

    rep = session.report()
    for shard, reports in sorted(rep.shard_reports.items()):
        load = sum(r.load_seconds for r in reports)
        wait = sum(r.wait_seconds for r in reports)
        comp = sum(r.compute_seconds for r in reports)
        pers = sum(r.persist_seconds for r in reports)
        swall = sum(r.wall_seconds for r in reports)
        hidden = max(0.0, load - wait) / load if load > 0 else 0.0
        print(f"[shard {shard}] wall={swall:.3f}s load={load:.3f}s "
              f"wait={wait:.3f}s compute={comp:.3f}s persist={pers:.3f}s "
              f"load_hidden={hidden:.0%}")
    if spec.execution.cache_dir:
        print(f"[cache] hits={rep.cache_hits} misses={rep.cache_misses} "
              f"dir={spec.execution.cache_dir}")
    if rep.cache_adopted or rep.slices_merged:
        print(f"[stream] adopted={rep.cache_adopted} "
              f"merged={rep.slices_merged} "
              f"mode={spec.stream.update_mode}")
    if (rep.retries or rep.speculations or rep.quarantined_units
            or rep.shards_lost or spec.execution.fault_plan):
        print(f"[faults] retries={rep.retries} "
              f"speculations={rep.speculations} "
              f"quarantined={rep.quarantined_units} "
              f"shards_lost={len(rep.shards_lost)}")
    # cold-start visibility: "new_compilations" counts the nvcc builds this
    # run started — a relaunch over an existing build/kernels/ reports
    # new_compilations=0 (its libraries load as cache hits)
    print(f"[compile] traces={rep.traces} compiled={rep.compiles} "
          f"cache_hits={rep.compile_cache_hits} "
          f"cache_misses={rep.compile_cache_misses} "
          f"new_compilations={rep.compile_cache_misses}")
    if window_durations:
        med = sorted(window_durations)[len(window_durations) // 2]
        print(f"[total] wall={wall:.3f}s windows={rep.windows} "
              f"median_window={med * 1e3:.1f}ms spec={rep.spec_hash}")
    else:
        print(f"[total] wall={wall:.3f}s windows={rep.windows} "
              f"spec={rep.spec_hash}")


if __name__ == "__main__":
    main()
