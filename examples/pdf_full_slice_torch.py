"""End-to-end driver through the PyTorch port (the paper's kind of
workload): a full slice through the production pipeline (slice-feature
sampling, method comparison, crash + restart), every stage declared as a
``PipelineSpec`` and run by a ``PDFSession``. The specs differ only in
their ``MethodSpec``; everything else (cube, windowing, backends) is
declared once and shared.

The counterpart of ``examples/pdf_full_slice.py``, with the same flags
(every pipeline knob of ``repro_torch.api.add_spec_args``) and
``--device``:

  PYTHONPATH=src python examples/pdf_full_slice_torch.py --device cpu [--obs 500] [--method grouping]

Without ``--device`` it runs on the CUDA device (and raises when there is
none), as the port's entry points do.
"""

import argparse
import dataclasses
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.api import (
    ComputeSpec,
    PDFSession,
    PipelineSpec,
    add_spec_args,
    explicit_fields,
    spec_from_args,
)

METHODS = ["baseline", "grouping", "reuse", "ml", "grouping_ml"]
SLICE = 6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_spec_args(ap)  # every pipeline knob, incl. --method/--types/--obs
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = args.device
    base = PipelineSpec(
        source=dataclasses.replace(
            PipelineSpec().source, num_slices=8, observations=400),
        compute=ComputeSpec(window_lines=6, mode="faithful"),
    )
    spec = spec_from_args(args, base=base)
    # default: compare all methods; an explicit --method narrows to one
    methods = [spec.method.name] if "method.name" in explicit_fields(args) \
        else METHODS

    def with_method(**method_kw) -> PipelineSpec:
        return dataclasses.replace(
            spec, method=dataclasses.replace(spec.method, **method_kw))

    # --- sampling first (Algorithm 5): choose the slice cheaply -------------
    # method='sampling' classifies a fraction of points with the decision
    # tree (no Eq.-5 fitting) through the same executor as every method.
    t0 = time.perf_counter()
    s_spec = with_method(name="sampling", sample_frac=0.25)
    s_session = PDFSession(s_spec, device=dev)
    tree = s_session.tree  # trained once (§5.3.1), shared by every run below
    res = s_session.run_all([SLICE])[SLICE]
    f = res.features(spec.compute.types)
    print(f"[sampling] slice {SLICE} features in {time.perf_counter()-t0:.2f}s: "
          f"avg_mu={f.avg_mean:.1f} avg_sigma={f.avg_std:.2f} "
          f"pct={np.round(f.type_percentage, 3)} "
          f"({f.num_sampled} points, spec {s_spec.content_hash()}, device {s_session.device})")

    # --- full methods comparison on the chosen slice ------------------------
    sim = s_session.source  # share the generator across sessions
    base_time = None
    errors = {}
    for method in methods:
        m_spec = with_method(name=method)
        # warm up on another slice so timings exclude the kernels' build
        PDFSession(m_spec, data_source=sim, tree=tree, device=dev).run_all([1])
        session = PDFSession(m_spec, data_source=sim, tree=tree, device=dev)
        res = session.run_all([SLICE])[SLICE]
        c = res.total_compute_seconds
        base_time = c if method == "baseline" else base_time
        rep = session.report()  # per-stage totals (staged executor)
        cache = session.executor(0).cache
        errors[method] = res.avg_error
        print(f"[{method:12s}] compute {c:7.2f}s  "
              f"speedup {(base_time or c)/max(c,1e-9):5.2f}x  "
              f"E={res.avg_error:.4f}  fitted {sum(s.num_fitted for s in res.stats)}"
              f"/{session.geometry.points_per_slice}"
              f"  load_hidden={rep.load_hidden_fraction:.0%}"
              + (f"  cache_hits={cache.hits}" if method.startswith("reuse") else ""))

    # --- fault tolerance: crash after 1 window, restart from watermark ------
    # The watermark carries the spec's content hash, so resume refuses to
    # mix windows persisted by a different computation.
    out = Path(tempfile.mkdtemp(prefix="pdf_ckpt_"))
    try:
        c_spec = dataclasses.replace(
            with_method(name="grouping_ml"),
            execution=dataclasses.replace(spec.execution, out_dir=str(out)))
        count = 0

        class Crash(Exception):
            pass

        def crash(ws):
            nonlocal count
            count += 1
            if count == 1:
                raise Crash()

        session = PDFSession(c_spec, data_source=sim, tree=tree, device=dev)
        try:
            session.run_all([SLICE], on_window=crash)
        except Crash:
            mark = session.executor(0).watermark(SLICE)
            print(f"[restart] simulated crash after 1 window "
                  f"(watermark at line {mark}, spec {c_spec.content_hash()})")
        resumed = PDFSession(c_spec, data_source=sim, tree=tree, device=dev).run_all(
            [SLICE], resume=True)[SLICE]
        print(f"[restart] resumed: {len(resumed.stats)} windows re-run, "
              f"E={resumed.avg_error:.4f} (matches full run)")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return errors, resumed


if __name__ == "__main__":
    main()
