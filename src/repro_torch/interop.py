"""Carry the reference package's state into the port.

This system's state is data, configuration and fit results, not weights:
the data is regenerated bitwise from the same source (``data/simulation``),
and these two functions carry the rest. Both take plain Python and numpy
values, so neither package imports the other.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.distributions import Moments
from repro_torch.core.executor import PDFConfig


def pdf_config_from_dict(d: Mapping) -> PDFConfig:
    """The port's ``PDFConfig`` from ``dataclasses.asdict`` of the
    reference's; raises on any field the port lacks."""
    known = {f.name for f in dataclasses.fields(PDFConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"PDFConfig fields the port lacks: {unknown}")
    kw = dict(d)
    if "types" in kw:
        kw["types"] = tuple(kw["types"])
    return PDFConfig(**kw)


def moments_from_numpy(fields: Sequence, device: torch.device | str) -> Moments:
    """The port's ``Moments`` from the reference's six arrays, in its field
    order (mean, var, skew, kurt, vmin, vmax; a reference ``Moments`` is
    such a sequence), as float32 tensors on ``device``."""
    arrays = list(fields)
    if len(arrays) != len(Moments._fields):
        raise ValueError(f"expected {len(Moments._fields)} moment arrays, got {len(arrays)}")
    return Moments(*(
        torch.tensor(np.asarray(a, dtype=np.float32), device=device) for a in arrays
    ))
