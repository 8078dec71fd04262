"""Timing a kernel apart from its wrapper's host work, with CUDA events.

A wrapper does host work before its launch (checks, a ctypes call, output
allocation). Events recorded around the call count the card's idle time
through that work as time on the card. ``kernel_times`` queues a sleep on
the card after the L2 flush, then records event ``a``, calls ``fn`` and
records ``b``: while the card sleeps, the host queues ``a``, the launch and
``b``, so the card runs them back to back and ``b - a`` is the kernel's own
time. A run where the card had already passed ``a`` when ``b`` was queued is
taken again with a longer sleep.

The L2 flush before each run reads a buffer larger than L2, so it leaves
clean lines and the kernel's reads evict nothing that has to be written
back. Zeroing the buffer, as ``chip_smoke.py``'s call timing does, leaves
L2 full of dirty lines, and their write-back then lands in the kernel's
time (``dirty=True`` times it so).
"""

from __future__ import annotations

import torch

_SLEEP_CYCLES = 200_000  # ~0.1 ms at the H100's clock
_MAX_SLEEP_CYCLES = 2**31 - 1


def kernel_times(fn, reps: int, flush: torch.Tensor, warmup: int = 3,
                 dirty: bool = False) -> list[float]:
    """ms of ``fn()``'s device work in each of ``reps`` runs, after
    ``warmup`` calls, with L2 flushed before each by reading ``flush`` (by
    zeroing it with ``dirty``). Raises if ``fn`` synchronises with the
    host, which no sleep can hide."""
    for _ in range(warmup):
        fn()
    cycles, times = _SLEEP_CYCLES, []
    while len(times) < reps:
        flush.zero_() if dirty else flush.sum()
        torch.cuda._sleep(cycles)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        hidden = not a.query()  # the card had not reached ``a`` when ``b`` was queued
        b.synchronize()
        if hidden:
            times.append(a.elapsed_time(b))
        elif cycles > _MAX_SLEEP_CYCLES // 2:
            raise RuntimeError("the timed call synchronises with the host: its device time "
                               "cannot be taken apart from its host work")
        else:
            cycles *= 2
    return times


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]
