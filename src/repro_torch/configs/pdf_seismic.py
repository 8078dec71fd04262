"""The paper's own workload config: PDF computation over the HPC4e-style
seismic cube (§6.1 datasets + §5 method settings). Port of
``repro.configs.pdf_seismic``."""

from __future__ import annotations

import dataclasses

from repro_torch.core.distributions import TYPES_4, TYPES_10
from repro_torch.core.regions import CubeGeometry


@dataclasses.dataclass(frozen=True)
class PDFWorkloadConfig:
    name: str
    geometry: CubeGeometry
    num_simulations: int
    types: tuple[str, ...]
    num_bins: int = 20
    window_lines: int = 25  # the paper's tuned optimum (Fig. 8/9)
    slice_index: int = 201  # "Slice 201 because it has interesting information"
    method: str = "grouping_ml"  # the paper's winner at <=10 nodes


# Set1: 235 GB — 251 x 501 x 501, 1000 observations/point.
SET1 = PDFWorkloadConfig(
    "pdf-seismic-set1", CubeGeometry(501, 501, 251), 1000, TYPES_4
)
# Set2: 1.9 TB — 501 x 1001 x 1001, 1000 observations/point.
SET2 = PDFWorkloadConfig(
    "pdf-seismic-set2", CubeGeometry(1001, 1001, 501), 1000, TYPES_4
)
# Set3: 2.4 TB — 251 x 501 x 501, 10000 observations/point.
SET3 = PDFWorkloadConfig(
    "pdf-seismic-set3", CubeGeometry(501, 501, 251), 10000, TYPES_4
)

SET1_10TYPES = dataclasses.replace(SET1, name="pdf-seismic-set1-10t", types=TYPES_10)

CONFIG = SET1


def to_spec(cfg: PDFWorkloadConfig = CONFIG):
    """Express a paper-scale workload as a declarative ``PipelineSpec``
    (DESIGN.md §11) — ``to_spec(SET1).to_json()`` is a runnable
    ``--spec`` file for the launchers."""
    from repro_torch.api import (ComputeSpec, ExecSpec, MethodSpec, PipelineSpec,
                           SourceSpec)

    g = cfg.geometry
    return PipelineSpec(
        source=SourceSpec(
            num_slices=g.num_slices,
            lines_per_slice=g.lines_per_slice,
            points_per_line=g.points_per_line,
            observations=cfg.num_simulations,
        ),
        method=MethodSpec(name=cfg.method, rep_bucket=256),
        compute=ComputeSpec(types=cfg.types, num_bins=cfg.num_bins,
                            window_lines=cfg.window_lines),
        execution=ExecSpec(slices=(cfg.slice_index,)),
    )
