"""The device's trace over a steady stretch of a traced run.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activity) inside a ``record_function`` range that ends after a
synchronise, so the range holds all the device work of the stretch. From
the trace, on the profiler's one clock:

* ``window_s``: the range's length;
* ``busy_s``: the union of every device interval (kernels, copies, sets)
  inside the range; a host range's annotation on the device's timeline
  is not device work and is left out;
* ``device_ops``: device time by operation name (``short``), the 10
  longest;
* ``idle_gaps``: the 10 longest stretches of the range with nothing on the
  device, each named by the innermost host operation running when it
  began ("host" where none was).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

_MARK = "portbench.traced_window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def profiled(fn, device) -> Trace:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(_MARK):
            fn()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    events = prof.events()
    marks = [e for e in events if e.name == _MARK]
    if not marks:
        raise RuntimeError("the traced window's range is missing from the trace")
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type != DeviceType.CUDA and e.name != _MARK]
    # A host range (record_function) also shows on the device's timeline as an
    # annotation over the kernels it launched: not device work.
    ranges = {name for _, _, name in host} | {_MARK}
    dev = [(max(e.time_range.start, w0), min(e.time_range.end, w1), short(e.name)) for e in events
           if e.device_type == DeviceType.CUDA and e.name not in ranges
           and e.time_range.end > w0 and e.time_range.start < w1]
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=_busy(dev) / 1e6, device_ops=_by_name(dev),
                 idle_gaps=_gaps(dev, host, w0, w1))


def short(name: str) -> str:
    """A kernel's name without the namespaces and words that every
    PyTorch kernel's name repeats."""
    for word in ("void ", "at::native::", "(anonymous namespace)::", "gpu_kernel_impl_nocast<",
                 "c10::", "std::"):
        name = name.replace(word, "")
    return name


def _busy(dev: list) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(dev):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _by_name(dev: list, top: int = 10) -> list:
    sums: dict[str, float] = {}
    for s, e, name in dev:
        sums[name] = sums.get(name, 0.0) + (e - s)
    ranked = sorted(sums.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return [[name[:160], us / 1e6] for name, us in ranked]


def _gaps(dev: list, host: list, w0: float, w1: float, top: int = 10) -> list:
    gaps, at = [], w0
    for s, e, _ in sorted(dev):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]
    host = sorted(host)
    starts = [h[0] for h in host]
    out = []
    for g0, g1 in gaps:
        name = "host"
        i = bisect.bisect_right(starts, g0) - 1
        # the innermost host range open at the gap's start: the latest-starting one that covers it
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= g0:
                name = host[j][2]
                break
        out.append([name[:160], (g1 - g0) / 1e6])
    return out
