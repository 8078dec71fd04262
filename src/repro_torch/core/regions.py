"""Spatial cube geometry (§3): cube -> slices -> lines -> points, windows.

A verbatim copy of ``repro.core.regions`` (standard library only).

A cube is (num_slices, lines_per_slice, points_per_line); a point's integer
identification (the paper's RDD key) is its flattened index. A window is a
contiguous run of lines within a slice (§4.2 principle 4: windows are
disjoint, fixed size once configured).

The ``WorkUnit``/``Plan`` layer turns (slice, window) pairs into a
schedulable queue spanning multiple slices — the unit of the staged
executor (core/executor.py) and of per-node slice assignment
(runtime/scheduler.py), mirroring the paper's RDD-partition scheduling.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Mapping, NamedTuple, Sequence


@dataclass(frozen=True)
class CubeGeometry:
    num_slices: int
    lines_per_slice: int
    points_per_line: int

    @property
    def points_per_slice(self) -> int:
        return self.lines_per_slice * self.points_per_line

    @property
    def total_points(self) -> int:
        return self.num_slices * self.points_per_slice

    def point_id(self, slice_i: int, line: int, point: int) -> int:
        return (slice_i * self.lines_per_slice + line) * self.points_per_line + point


class Window(NamedTuple):
    slice_i: int
    line_start: int
    line_end: int  # exclusive

    @property
    def num_lines(self) -> int:
        return self.line_end - self.line_start


def iter_windows(
    geom: CubeGeometry, slice_i: int, window_lines: int, start_line: int = 0
) -> Iterator[Window]:
    """Disjoint sliding windows over a slice; ``start_line`` supports
    restart-from-watermark (checkpointed window progress)."""
    line = start_line
    while line < geom.lines_per_slice:
        end = min(line + window_lines, geom.lines_per_slice)
        yield Window(slice_i, line, end)
        line = end


def num_windows(geom: CubeGeometry, window_lines: int) -> int:
    return -(-geom.lines_per_slice // window_lines)


# -- work units / plans --------------------------------------------------------


class WorkUnit(NamedTuple):
    """One schedulable unit of PDF computation: a window plus its position in
    the plan. ``seq`` orders units globally; within a slice the order equals
    line order, which the reuse cache and the resume watermark rely on."""

    window: Window
    seq: int

    @property
    def unit_id(self) -> str:
        """Stable id for heartbeat monitoring (runtime/monitor.py)."""
        return f"s{self.window.slice_i}/l{self.window.line_start:05d}"


@dataclass(frozen=True)
class Plan:
    """An ordered queue of WorkUnits, possibly spanning multiple slices.

    Slices appear as contiguous runs (slice-major order): the executor
    processes a slice's windows in line order before moving to the next
    slice, which keeps reuse-cache behaviour identical to running the
    slices back-to-back through the serial loop.
    """

    geometry: CubeGeometry
    window_lines: int
    units: tuple[WorkUnit, ...]

    @property
    def slices(self) -> tuple[int, ...]:
        out: list[int] = []
        for u in self.units:
            if not out or out[-1] != u.window.slice_i:
                out.append(u.window.slice_i)
        return tuple(out)

    def units_for_slice(self, slice_i: int) -> tuple[WorkUnit, ...]:
        return tuple(u for u in self.units if u.window.slice_i == slice_i)

    def __len__(self) -> int:
        return len(self.units)


def build_plan(
    geom: CubeGeometry,
    slices: Sequence[int],
    window_lines: int,
    start_lines: Mapping[int, int] | None = None,
) -> Plan:
    """Expand ``slices`` into a slice-major WorkUnit queue.

    ``start_lines`` maps slice -> first line still to do (resume from a
    watermark); omitted slices start at line 0. A slice whose watermark is
    already past the end contributes no units.
    """
    units: list[WorkUnit] = []
    for s in slices:
        if not 0 <= s < geom.num_slices:
            raise ValueError(f"slice {s} outside cube with {geom.num_slices} slices")
        start = start_lines.get(s, 0) if start_lines else 0
        for w in iter_windows(geom, s, window_lines, start):
            units.append(WorkUnit(w, len(units)))
    return Plan(geom, window_lines, tuple(units))
