"""Quickstart through the PyTorch port: compute PDFs of a spatial slice.

The counterpart of ``examples/quickstart.py``. One declarative
``PipelineSpec`` describes the whole run: the synthetic seismic cube (the
paper's Monte-Carlo structure), the paper's winning method (Grouping + ML
prediction), and the execution strategy. A ``PDFSession`` of
``repro_torch.api`` executes it on the card. The spec JSON printed below is
a complete, replayable description of this run: save it to a file and
``python -m repro_torch.launch.run_pdf --spec FILE`` reproduces it (same
content hash, same results).

  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Without ``--device`` it runs on the CUDA device (and raises when there is
none), as the port's entry points do.
"""

import argparse

import numpy as np

from repro_torch.api import (
    ComputeSpec,
    ExecSpec,
    MethodSpec,
    PDFSession,
    PipelineSpec,
    SourceSpec,
)
from repro_torch.core import distributions as d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    spec = PipelineSpec(
        # a small cube: 16 slices x 12 lines x 40 points, 400 observations
        source=SourceSpec(num_slices=16, lines_per_slice=12,
                          points_per_line=40, observations=400),
        # the paper's winner (§6): group identical (mu, sigma) points, let
        # the decision tree skip the per-type Eq.-5 search
        method=MethodSpec(name="grouping_ml", error_bound=0.5),
        compute=ComputeSpec(window_lines=4, num_bins=20),
        execution=ExecSpec(slices=(6,)),
    )
    print(f"spec {spec.content_hash()}:")
    print(spec.to_json())

    session = PDFSession(spec, device=args.device)
    sim = session.source
    print(f"cube: {sim.geometry}, {sim.config.num_simulations} observations/point "
          f"({sim.nominal_bytes() / 1e6:.0f} MB if materialized); device {session.device}")

    # The session trains the (mu, sigma) -> type decision tree on first use
    # (§5.3.1: baseline over the spec's training slices) and streams one
    # SliceResult per requested slice.
    results = []
    for res in session.run():
        fitted = sum(s.num_fitted for s in res.stats)
        pct = np.bincount(res.type_idx, minlength=4) / len(res.type_idx)
        print(f"slice {res.slice_i} grouping+ml: E={res.avg_error:.4f} "
              f"(bound satisfied: {res.error_bound_satisfied})")
        print(f"  fitted {fitted}/{len(res.type_idx)} points "
              f"({res.total_compute_seconds:.2f}s compute, "
              f"{res.total_load_seconds:.2f}s load)")
        for t, p in zip(d.TYPES_4, pct):
            print(f"  {t:12s} {p:6.1%}")
        results.append(res)
    return results


if __name__ == "__main__":
    main()
