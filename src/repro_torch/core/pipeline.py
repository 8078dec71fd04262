"""Algorithms 1-2: the windowed PDF-computation pipeline (facade).

Port of ``repro.core.pipeline``. ``PDFComputer`` is a thin facade over one
``StagedExecutor`` (core/executor.py) on one device. It runs on ``cuda``
unless the caller passes ``device="cpu"``: with no device given and no CUDA
device present it raises rather than carry on on the CPU. The public entry
point is ``repro_torch.api`` (``PipelineSpec`` + ``PDFSession``);
``PDFComputer`` lifts its configs into the same spec and stamps the same
content hash, so its results equal a session's bit for bit and resume works
across the two.

After each window the per-window results are persisted as ``.npz`` plus a
watermark (with ``out_dir``); ``run_slice(resume=True)`` skips completed
windows. The ML and sampling methods take a decision tree: ``tree=``, from
``train_type_tree`` or ``interop.tree_from_numpy``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.core import distributions as dists
from repro_torch.core import ml_predict as mlp
from repro_torch.core import regions
from repro_torch.core.executor import (  # noqa: F401
    METHODS,
    SELECT_BACKENDS,
    ExecutorConfig,
    ExecutorReport,
    PDFConfig,
    SliceResult,
    StagedExecutor,
    WindowStats,
)

__all__ = [
    "METHODS", "SELECT_BACKENDS", "ExecutorConfig", "ExecutorReport",
    "PDFConfig", "PDFComputer", "SliceResult", "StagedExecutor", "WindowStats",
    "resolve_device", "train_type_tree",
]


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when no CUDA device exists
    and the caller did not ask for another device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class PDFComputer:
    """The pipeline's entry point: ``PDFComputer(config, source).run_slice(i)``.

    ``data_source`` must expose ``geometry: regions.CubeGeometry`` and
    ``load_window(window) -> np.ndarray (num_points, n_obs) float32``.
    ``tree`` is the decision tree the ML and sampling methods need.
    ``spec`` is the ``PipelineSpec`` the configs lift to
    (``api.spec.spec_from_config``); its content hash is stamped into every
    result and persisted watermark.
    """

    def __init__(
        self,
        config: PDFConfig,
        data_source,
        tree: mlp.DecisionTree | None = None,
        out_dir: str | Path | None = None,
        exec_config: ExecutorConfig | None = None,
        device: torch.device | str | None = None,
    ):
        # Lazy import: api.spec imports core.executor and this module's
        # package; loading it here keeps the import graph acyclic.
        from repro_torch.api.spec import source_spec_for, spec_from_config

        self.config = config
        self.data = data_source
        self.tree = tree
        self.out_dir = Path(out_dir) if out_dir else None
        self.device = resolve_device(device)
        self.spec = spec_from_config(config, exec_config, source=source_spec_for(data_source))
        self._executor = StagedExecutor(
            config, data_source, self.device, tree=tree, out_dir=out_dir,
            exec_config=exec_config, spec_hash=self.spec.content_hash(),
        )

    @property
    def executor(self) -> StagedExecutor:
        return self._executor

    @property
    def cache(self):
        """The reuse cache (§5.2.1): it lives on the executor, so it spans
        windows and consecutive slices."""
        return self._executor.cache

    @property
    def last_report(self) -> ExecutorReport | None:
        """Per-stage totals of the most recent run (overlap evidence)."""
        return self._executor.last_report

    def run_slice(
        self,
        slice_i: int,
        resume: bool = False,
        on_window: Callable[[WindowStats], None] | None = None,
    ) -> SliceResult:
        return self._executor.run_slice(slice_i, resume=resume, on_window=on_window)

    def run(
        self,
        slices,
        resume: bool = False,
        on_window: Callable[[WindowStats], None] | None = None,
    ) -> dict[int, SliceResult]:
        """Multi-slice entry point: one plan spanning ``slices``, slice-major."""
        plan = regions.build_plan(self.data.geometry, list(slices), self.config.window_lines)
        return self._executor.run(plan, resume=resume, on_window=on_window)


def train_type_tree(
    data_source,
    types=dists.TYPES_4,
    slices=(0, 1, 2, 3),
    window_lines: int = 4,
    depth: int = 4,
    max_bins: int = 32,
    device: torch.device | str | None = None,
) -> mlp.DecisionTree:
    """§5.3.1: produce 'previously generated output data' with the baseline
    over ``slices`` on ``device`` (``cuda`` unless the caller asks for
    another), then train the features -> type decision tree on the host.
    Four consecutive slices of the synthetic cube cover all four layer
    types."""
    feats, labels = [], []
    for s in slices:
        res = PDFComputer(
            PDFConfig(types=types, window_lines=window_lines, method="baseline"),
            data_source, device=device,
        ).run_slice(s)
        feats.append(mlp.tree_features_np(res.mean, res.std, res.skew, res.kurt))
        labels.append(res.type_idx)
    x = np.concatenate(feats).astype(np.float32)
    y = np.concatenate(labels).astype(np.int32)
    return mlp.train_tree(x, y, len(types), depth=depth, max_bins=max_bins)
