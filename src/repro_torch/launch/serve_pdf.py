"""PDF query server launcher — stand up a ``PDFServer`` for one spec.

Port of ``repro.launch.serve_pdf``; ``--device`` picks the torch device
(default ``cuda``; ``cpu`` runs the kernels' plain versions).

Every pipeline *and serving* knob comes from the declarative
``PipelineSpec``: flags are auto-generated from the spec fields
(``api.cli``, including the ``serve.*`` group — tick length, batch cap,
coalescing on/off, hot-window LRU size), ``--spec FILE`` loads a JSON spec
(explicit flags override). The launcher starts the server, fires a demo
query mix from ``--clients`` concurrent threads (point + window + region
queries over ``--slices``, each client re-asking its point queries so the
hot path shows up), then prints the server's counters: launches vs windows
requested (the coalescing win), memory/disk hit rates, and request/launch
p50/p99.

  PYTHONPATH=src python -m repro_torch.launch.serve_pdf --clients 8
  PYTHONPATH=src python -m repro_torch.launch.serve_pdf --cache-dir /tmp/pdfcache \\
      --cache-max-bytes 50000000 --serve-max-batch-windows 16
  PYTHONPATH=src python -m repro_torch.launch.serve_pdf --no-serve-coalesce  # naive
  PYTHONPATH=src python -m repro_torch.launch.serve_pdf --device cpu --lines 12 --ppl 30 --obs 200

With ``--cache-dir`` the server answers straight from the ``ResultCache``
when a stored slice covers the query (no executor, no tree), and stores
back every slice it fully computes — run twice with the same cache dir and
the second run is all disk hits.
"""

from __future__ import annotations

import argparse
import threading
import time

from repro_torch.api import (
    ExecSpec,
    MethodSpec,
    PipelineSpec,
    add_spec_args,
    spec_from_args,
)
from repro_torch.serve import PDFServer, PointQuery, RegionQuery, WindowQuery

BASE_SPEC = PipelineSpec(
    method=MethodSpec(name="grouping"),
    execution=ExecSpec(slices=(0, 1)),
)


def _client(server: PDFServer, cid: int, slices: list[int], repeats: int,
            errors: list[BaseException]) -> None:
    """One closed-loop client: a small point/window/region mix, point
    queries re-asked ``repeats`` times (the hot path)."""
    try:
        geom = server.session.geometry
        s = slices[cid % len(slices)]
        line = (3 * cid + 1) % geom.lines_per_slice
        point = (7 * cid + 2) % geom.points_per_line
        for _ in range(repeats):
            server.query(PointQuery(s, line, point))
        hi = min(geom.lines_per_slice, line + 4)
        server.query(WindowQuery(s, max(0, line - 1), hi))
        if cid % 4 == 0:
            server.query(RegionQuery(s))
    except BaseException as e:  # noqa: BLE001 — surface on the main thread
        errors.append(e)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_spec_args(ap)
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent demo query threads (default 4)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="times each client re-asks its point query")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    spec = spec_from_args(args, base=BASE_SPEC)
    slices = list(spec.execution.slices
                  or range(spec.source.num_slices))

    server = PDFServer(spec, device=args.device)
    print(f"[serve] hash={server.session.spec_hash} device={server.session.device} "
          f"method={spec.method.name} coalesce={spec.serve.coalesce} "
          f"tick={spec.serve.tick_seconds * 1e3:.1f}ms "
          f"max_batch={spec.serve.max_batch_windows} "
          f"lru={spec.serve.window_cache_entries}")

    errors: list[BaseException] = []
    t0 = time.perf_counter()
    with server:
        threads = [
            threading.Thread(target=_client,
                             args=(server, c, slices, args.repeats, errors))
            for c in range(args.clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        st = server.stats()
    wall = time.perf_counter() - t0

    print(f"[queries] total={st.queries} by_kind={st.queries_by_kind} "
          f"wall={wall:.3f}s qps={st.queries / wall:.1f}")
    print(f"[coalesce] ticks={st.ticks} launches={st.launches} "
          f"requested={st.windows_requested} unique={st.windows_unique} "
          f"computed={st.windows_computed} "
          f"ratio={st.coalesce_ratio:.2f} occupancy={st.batch_occupancy:.2f}")
    print(f"[cache] memory={st.windows_from_memory} disk={st.windows_from_disk} "
          f"hit_rate={st.window_hit_rate:.0%} stored_slices={st.slices_stored} "
          f"max_queue_depth={st.max_queue_depth}")
    print(f"[latency] request p50={st.latency['p50'] * 1e3:.2f}ms "
          f"p99={st.latency['p99'] * 1e3:.2f}ms | launch "
          f"p50={st.launch_latency['p50'] * 1e3:.2f}ms "
          f"p99={st.launch_latency['p99'] * 1e3:.2f}ms")
    for stage, pct in sorted(st.stage_percentiles.items()):
        print(f"[stage {stage}] p50={pct['p50'] * 1e3:.2f}ms "
              f"p99={pct['p99'] * 1e3:.2f}ms")
    return st


if __name__ == "__main__":
    main()
