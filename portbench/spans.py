"""Spans around the calls into the program's layers, recorded from the
benchmark's side: each target ``"module:function"`` is replaced, for the
traced window only, by a wrapper that records a CUDA event before and
after the call (on the CPU, the host clock), so a span brackets the device
work the call enqueued. Where the host runs ahead of the card (a prefill,
a training step), the span is that call's device time.

A per-layer metric's reader names the calls it needs in ``SPANS``
({span name: target}); the harness installs the union of its cell's
metrics' targets.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import torch


class _HostEvent:
    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


class Spans:
    def __init__(self, targets: dict[str, str], device):
        self.targets = dict(targets)
        self.cuda = torch.device(device).type == "cuda"
        self.pairs: dict[str, list] = {name: [] for name in self.targets}

    def _event(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()

    def _wrap(self, name, fn):
        pairs = self.pairs[name]

        def call(*args, **kw):
            a, b = self._event(), self._event()
            a.record()
            out = fn(*args, **kw)
            b.record()
            pairs.append((a, b))
            return out

        return call

    @contextlib.contextmanager
    def installed(self):
        saved = []
        try:
            for name, target in self.targets.items():
                mod_name, attr = target.split(":")
                mod = importlib.import_module(mod_name)
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, self._wrap(name, getattr(mod, attr)))
            yield self
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)

    def ms(self) -> dict[str, list[float]]:
        """{span: [ms of each call]}; call after a synchronise."""
        return {name: [a.elapsed_time(b) for a, b in pairs] for name, pairs in self.pairs.items()}
