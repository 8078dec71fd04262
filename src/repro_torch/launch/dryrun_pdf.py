"""Dry run of the paper's own workload: one PDF-computation window step on
meta tensors (the analog of ``launch/dryrun.py`` for the LM cells).

Port of ``repro.launch.dryrun_pdf``. The step is the device part of
Algorithms 1-3 for a window of points: moments -> fit all candidate types
-> Eq.-5 error -> argmin, through the port's fit backends as the card runs
them. Its work is that of the kernels the variant launches, charged by
their work models (``launch/roofline.py``), plus the plain PyTorch
operators between them, counted op by op by ``dryrun.count``:

  fused           K1 + K2 (``fit_backend="fused"``): the shared histogram,
                  CDF masses and Eq.-5 error in K2's epilogue
  faithful        K3, then K4 once per type (``fit_backend="kernels"``,
                  ``mode="faithful"``): the paper's per-type passes
  fused_scatter   the plain PyTorch chain (``fit_backend="reference"``):
                  moments and a scatter-add histogram shared across types

K2's float64 special-function work depends on the data, so a meta pass
counts none of it (``f64_ops_per_device`` 0). Two variants run on the
production mesh (16x16, or 2x16x16 with ``--multi-pod``), counted as rank
0 of a fake world of its size (``launch.mesh.fake_world``, meta tensors,
``dryrun.count_local``: one rank's work and its collectives):

  fused_scatter_shmap  the per-rank window step: each rank runs
                  ``fused_scatter`` on its own block of the window's rows
                  (the reference's ``shard_map``: the per-point fit is the
                  paper's Map, so no rank needs another's rows)
  grouping_global faithful, then the quantised (mean, std) keys of the
                  device Select and ``group_device_global`` over the whole
                  world (every mesh axis): the paper's global shuffle, an
                  all-gather of the keys (the reference's variant, which
                  runs in faithful mode, ``repro/launch/dryrun_pdf.py:69``)

Their points are split over every mesh axis, as the reference's ``P(axes)``.

Shapes (--pdf-shape), the reference's:
  window_small    6,656 pts x 1,000 obs   (Set1's 6,275 padded to the 512-device mesh)
  window_prod     262,144 pts x 1,000 obs (Set2-scale, mesh-sized window)
  window_obs10k   65,536 pts x 10,000 obs (Set3 regime: 10x observations)

  PYTHONPATH=src python -m repro_torch.launch.dryrun_pdf --all --out results/dryrun_pdf_torch
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.core import distributions as d
from repro_torch.core import fitting
from repro_torch.core import grouping as grp
from repro_torch.launch.dryrun import ONE_CARD, count, count_local, step_roofline
from repro_torch.launch.mesh import Mesh, make_production_mesh

PDF_SHAPES = {
    # Set1 window (25 lines x 251 points = 6,275) padded to the 512-device
    # mesh divisor, as the reference's loader does (data/loader.ShardedStager).
    "window_small": (6_656, 1_000),
    "window_prod": (262_144, 1_000),
    "window_obs10k": (65_536, 10_000),
}

VARIANTS = ("faithful", "fused", "fused_scatter", "fused_scatter_shmap", "grouping_global")
MESH_VARIANTS = ("fused_scatter_shmap", "grouping_global")
NUM_BINS = 20
TYPES = d.TYPES_4
# The fit backend and mode each one-card variant runs.
_BACKENDS = {"fused": ("fused", "fused"), "faithful": ("kernels", "faithful"),
             "fused_scatter": ("reference", "fused"), "fused_scatter_shmap": ("reference", "fused"),
             "grouping_global": ("kernels", "faithful")}


def _base_spec():
    from repro_torch.api import ComputeSpec, PipelineSpec

    return PipelineSpec(compute=ComputeSpec(num_bins=NUM_BINS, types=TYPES))


def make_window_step(variant: str, types=TYPES, num_bins: int = NUM_BINS,
                     group_tol: float = grp.DEFAULT_TOL):
    """step(values (P, n) f32) -> (type_idx, params, error, mean, var), plus
    each point's global representative for ``grouping_global``. A mesh
    variant's ``values`` are this rank's rows, and the step must run on
    every rank of a world (or a fake one)."""
    backend, mode = _BACKENDS[variant]
    fb = fitting.get_fit_backend(backend, num_bins)

    def step(values):
        m = fb.moments(values)
        r = fb.fit_all(values, m, types, num_bins, mode)
        out = (r.type_idx, r.params, r.error, m.mean, m.var)
        if variant == "grouping_global":
            keys = grp.quantize_keys(m.mean, m.var, tol=group_tol)
            out += (grp.group_device_global(keys).rep_for_point,)
        return out

    return step


def model_flops(points: int, obs: int, t_types: int, num_bins: int) -> float:
    """The minimum useful work: one moments pass (5 flops/value) + one
    histogram pass (2) + T x O(L) CDF math (the reference's formula)."""
    return points * obs * (5.0 + 2.0) + points * t_types * num_bins * 25.0


def run_pdf_cell(variant: str, shape_name: str, verbose=True, types=TYPES,
                 num_bins: int = NUM_BINS, spec_hash: str | None = None,
                 mesh: Mesh | None = None, group_tol: float = grp.DEFAULT_TOL) -> dict:
    """The cell's record. A mesh variant runs on ``mesh`` (default: the
    production mesh), the others on one card."""
    points, obs = PDF_SHAPES[shape_name]
    if variant not in MESH_VARIANTS:
        mesh = ONE_CARD
    mesh = mesh or make_production_mesh()
    if points % mesh.size:
        raise ValueError(f"{points} points do not split over {mesh.size} devices")
    step = make_window_step(variant, types=types, num_bins=num_bins, group_tol=group_tol)
    values = torch.empty((points // mesh.size, obs), dtype=torch.float32, device="meta")
    t0 = time.perf_counter()
    if mesh.size == 1:
        _, costs = count(lambda: step(values))
    else:
        from repro_torch.launch.mesh import fake_world

        with fake_world(mesh.size):
            _, costs = count_local(lambda: step(values))
    t1 = time.perf_counter()
    mf = model_flops(points, obs, len(types), num_bins)
    roof = step_roofline(costs, mf, mesh.size)
    coll = costs.get("collectives")
    ops = costs["flops"] + costs["f32_ops"] + costs["f64_ops"]
    rec = {
        "workload": "pdf-seismic",
        "variant": variant,
        "spec_hash": spec_hash,
        "shape": shape_name,
        "points": points,
        "obs": obs,
        "mesh": list(mesh.shape),
        "chips": mesh.size,
        "ok": True,
        "count_seconds": round(t1 - t0, 2),
        "flops_per_device": ops,
        "f32_ops_per_device": costs["f32_ops"],
        "f64_ops_per_device": costs["f64_ops"],
        "bytes_per_device": costs["bytes"],
        "collective_traffic_per_device": coll.per_device_traffic_bytes if coll else 0.0,
        "collective_ops": dict(coll.op_counts) if coll else {},
        "memory_analysis": {
            "argument_size_in_bytes": values.numel() * 4,
            "temp_size_in_bytes": costs["temp_bytes"],
        },
        "kernels": costs["kernels"],
        "operators": costs["ops"],
        "model_flops": mf,
        "terms_seconds": {
            "compute": roof.compute_s,
            "memory": roof.memory_s,
            "collective": roof.collective_s,
        },
        "bound_seconds": roof.bound_s,
        "dominant": roof.dominant,
        "useful_ratio": mf / (ops * mesh.size) if ops else 0.0,
        "roofline_fraction": roof.roofline_fraction,
    }
    if "comm_debug_counts" in costs:
        rec["comm_debug_counts"] = costs["comm_debug_counts"]
    if costs["assumed_nonzero"]:
        rec["grouping_dedup"] = "every key distinct (unique on meta): an upper bound"
    if verbose:
        t = rec["terms_seconds"]
        print(f"[pdf {variant} x {shape_name} x {'x'.join(map(str, mesh.shape))}] counted in "
              f"{rec['count_seconds']}s; collectives {rec['collective_ops']}; kernels "
              f"{ {k: v['launches'] for k, v in costs['kernels'].items()} }")
        print(f"  ops/dev {ops:.3e} bytes/dev {costs['bytes']:.3e}")
        print(f"  compute {t['compute']*1e3:.3f}ms memory {t['memory']*1e3:.3f}ms "
              f"collective {t['collective']*1e3:.3f}ms -> {rec['dominant']} "
              f"(useful {rec['useful_ratio']:.3f})")
    return rec


def main(argv=None):
    from repro_torch.api import add_spec_args, spec_from_args

    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=VARIANTS, default=None)
    ap.add_argument("--pdf-shape", choices=list(PDF_SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the mesh variants on 2x16x16 (pod, data, model), else 16x16")
    ap.add_argument("--out", default="results/dryrun_pdf_torch",
                    help="directory for per-cell roofline records")
    # every pipeline knob (--group-tol, --types, --num-bins, --spec ...)
    # comes from the shared spec surface
    add_spec_args(ap)
    args = ap.parse_args(argv)
    spec = spec_from_args(args, base=_base_spec())
    print(f"[spec] hash={spec.content_hash()} source={spec.source.kind} "
          f"types={len(spec.compute.types)} bins={spec.compute.num_bins} "
          f"group_tol={spec.method.group_tol}")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    variants = VARIANTS if (args.all or not args.variant) else [args.variant]
    shapes = list(PDF_SHAPES) if (args.all or not args.pdf_shape) else [args.pdf_shape]

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    failures = []
    for v in variants:
        for s in shapes:
            where = "x".join(map(str, mesh.shape)) if v in MESH_VARIANTS else "1x1"
            cid = f"pdf__{v}__{s}__{where}"
            try:
                rec = run_pdf_cell(v, s, types=tuple(spec.compute.types),
                                   num_bins=spec.compute.num_bins, spec_hash=spec.content_hash(),
                                   mesh=mesh, group_tol=spec.method.group_tol)
            except Exception as e:  # noqa: BLE001
                traceback.print_exc()
                rec = {"ok": False, "variant": v, "shape": s, "error": str(e)}
                failures.append(cid)
            (out / f"{cid}.json").write_text(json.dumps(rec, indent=1))
    if failures:
        raise SystemExit(f"failed: {failures}")
    print("pdf dry-run complete")


if __name__ == "__main__":
    main()
