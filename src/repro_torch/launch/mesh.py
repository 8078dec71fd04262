"""Mesh descriptors for accounting: axis names and their sizes.

Port of ``repro.launch.mesh``. The reference builds a ``jax.sharding.Mesh``
over placeholder host devices; the port's dry run only needs the mesh's
shape and axis names (``models/sharding.py`` reads nothing else), so a
``Mesh`` here is that descriptor and holds no device. Building a real
``torch.distributed.DeviceMesh`` and placing tensors on it comes with the
multi-device pieces of ROADMAP.md queue 1, item 18.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ in rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips (data, model). Multi-pod: 2 pods =
    512 chips (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Arbitrary mesh (tests, the dry run's ``--mesh``)."""
    return Mesh(tuple(int(s) for s in shape), tuple(axes))


def parse_mesh(text: str) -> Mesh:
    """``"DxM"`` -> (data, model); ``"PxDxM"`` -> (pod, data, model)."""
    shape = tuple(int(s) for s in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"--mesh {text!r}: expected DxM or PxDxM")
    return make_mesh(shape, axes)
