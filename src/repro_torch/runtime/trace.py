"""Spans inside the port's LM paths: where a prefill's or a training step's
device time goes, layer by layer, phase by phase.

    from repro_torch.runtime import trace

    trace.enable()
    ...                           # prefills or training steps
    torch.cuda.synchronize()
    spans = trace.drain()         # [Span], in the order they opened
    trace.disable()

Off by default. Off, ``span()`` returns one shared no-op object after a
single check of a module-level flag: no event, no ``record_function``, no
autograd node, so a traced function computes the same bits as untraced.
Nothing switches it on but ``enable()``: there is no exporter, command-line
flag or environment variable. An operator who wants the spans calls
``enable()`` and reads ``drain()``, or opens a ``torch.profiler`` trace.

On, a span records its name, its parent (the span open around it), its
unit (one id for each prefill or training step, shared by every span of
that unit), its phase, its layer index where there is one, its host start
and end (``time.perf_counter_ns``) and its device time between a pair of
CUDA events (on the CPU, the host times stand in). While a
``torch.profiler`` trace runs, each span also enters
``torch.profiler.record_function(name)``: in the trace the spans are host
ranges on the profiler's clock around the operators and kernels they
launched.

What it costs. A span's record is kept as numbers and strings in a few
lists beside its two events, and the events are read only by ``drain()``,
after the caller's synchronise, so nothing is read while units run. A
span costs its host a few microseconds and two objects that the cyclic
collector tracks until the drain.

Phases. A unit's root sets the process's phase for what it runs:
``prefill`` and ``train.forward`` set ``forward``, ``train.backward``
sets ``backward``. A span that forward code opens while the phase is
``backward`` is a ``recompute`` (``torch.utils.checkpoint`` running a
layer again inside the backward). A backward span is opened and closed by
autograd itself, through the identity functions that ``grad_in`` and
``grad_out`` put at a forward span's inputs and output: the output's
backward opens the span, the inputs' backward closes it. Autograd runs
ready nodes by descending sequence number, so the nodes a span's forward
created run between the two. A recompute that autograd starts inside a
backward span (a layer whose first saved tensor is inside it) is that
span's child in phase ``recompute``: ``Span.phase_ms`` leaves it out.

The phase, the unit and the stack of open spans are process-wide, not
per thread: on CUDA the autograd engine runs the backward and the
recompute on its own device thread while the caller waits. One unit runs
at a time. On tensor subclasses (DTensor) no backward boundary is put in:
in a sharded step attention's spans are forward and recompute only, and
the SSD's backward span is each rank's, on the plain rows that
``sharding.local_rows`` hands it.
"""

from __future__ import annotations

import time

import torch

_on = False
_cuda = False
_profiling = torch._C._autograd._profiler_enabled

# The spans recorded since the last drain, one entry each in these columns.
_name: list = []
_parent: list = []  # index of the parent span, -1 for none
_unit: list = []
_phase: list = []
_layer: list = []
_t0: list = []
_t1: list = []
_ev0: list = []  # CUDA events (None on the CPU)
_ev1: list = []
_drains = 0  # spans still open at a drain are not recorded

_stack: list = []  # the open spans, innermost last
_open_unit = None
_units = 0
_open_phase = None  # "forward" or "backward" while a unit runs


def enable(device=None) -> None:
    """Record spans from now on, timed by CUDA events when ``device`` (by
    default: CUDA when present) is a CUDA device, else by the host clock."""
    global _on, _cuda
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    _cuda = torch.device(device).type == "cuda"
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


class Span:
    """A recorded span. ``ms`` is its device time (the host's on the CPU);
    ``self_ms`` that less its children's; ``phase_ms`` that less its
    children's of another phase."""

    __slots__ = ("name", "parent", "children", "unit", "phase", "layer", "t0_ns", "t1_ns", "device_ms")

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    @property
    def ms(self) -> float:
        return self.host_ms if self.device_ms is None else self.device_ms

    @property
    def self_ms(self) -> float:
        return self.ms - sum(c.ms for c in self.children)

    @property
    def phase_ms(self) -> float:
        return self.ms - sum(c.ms for c in self.children if c.phase != self.phase)


def drain() -> list:
    """The spans closed since the last drain, in the order they opened, as
    ``Span``s; forgets them. Call it after a synchronise: their events are
    read here."""
    global _drains
    spans = []
    for i in range(len(_name)):
        s = Span()
        s.name, s.unit, s.phase, s.layer = _name[i], _unit[i], _phase[i], _layer[i]
        s.t0_ns, s.t1_ns, s.children = _t0[i], _t1[i], []
        s.device_ms = _ev0[i].elapsed_time(_ev1[i]) if _ev0[i] is not None and _t1[i] is not None else None
        p = spans[_parent[i]] if _parent[i] >= 0 else None
        s.parent = p if p is not None and p.t1_ns is not None else None
        if s.parent is not None:
            s.parent.children.append(s)
        spans.append(s)
    for col in (_name, _parent, _unit, _phase, _layer, _t0, _t1, _ev0, _ev1):
        col.clear()
    _drains += 1
    return [s for s in spans if s.t1_ns is not None]


class _Open:
    """An open span, the context manager ``span()`` returns while on."""

    __slots__ = ("name", "layer", "unit", "phase", "i", "drains", "saved", "rf", "end", "backward")

    def __init__(self, name: str, unit: bool, phase: str | None, layer):
        self.name, self.unit, self.phase, self.layer = name, unit, phase, layer
        self.backward = None

    def __enter__(self):
        global _open_unit, _units, _open_phase
        t0 = time.perf_counter_ns()
        parent = _stack[-1] if _stack else None
        if self.layer is None and parent is not None:
            self.layer = parent.layer
        self.saved = (_open_unit, _open_phase)
        if self.unit:
            _units += 1
            _open_unit = _units
        if self.phase is not None:
            _open_phase = phase = self.phase
        else:
            phase = "recompute" if _open_phase == "backward" else _open_phase
        self.i, self.drains = len(_name), _drains
        _name.append(self.name)
        _parent.append(parent.i if parent is not None and parent.drains == _drains else -1)
        _unit.append(_open_unit)
        _phase.append(phase)
        _layer.append(self.layer)
        _t0.append(t0)
        _t1.append(None)
        _stack.append(self)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        start = self.end = None
        if _cuda:
            start, self.end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        _ev0.append(start)
        _ev1.append(self.end)
        return self

    def __exit__(self, *exc) -> bool:
        global _open_unit, _open_phase
        if self.saved is None:
            return False
        while _stack and _stack[-1] is not self and self in _stack:
            # left open inside this one: a backward span whose inputs took no gradient
            _stack[-1].__exit__(None, None, None)
        if self.end is not None:
            self.end.record()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if _stack and _stack[-1] is self:
            _stack.pop()
        _open_unit, _open_phase = self.saved
        self.saved = None
        if self.drains == _drains:
            # the host times hold the span's own cost, so its parent's children cover the parent
            _t1[self.i] = time.perf_counter_ns()
        return False

    def grad_in(self, *xs: torch.Tensor) -> tuple:
        """``xs`` through an identity whose backward closes this span's
        backward span: put at the span's inputs. Returns a tuple."""
        if not _boundary(xs):
            return xs
        return _InBoundary.apply(self, *xs)

    def grad_out(self, y: torch.Tensor) -> torch.Tensor:
        """``y`` through an identity whose backward opens this span's
        backward span: put at the span's output."""
        if not _boundary((y,)):
            return y
        return _OutBoundary.apply(self, y)


def _boundary(xs) -> bool:
    return (_on and torch.is_grad_enabled() and all(type(x) is torch.Tensor for x in xs)
            and any(x.requires_grad for x in xs))


class _OutBoundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, y):
        ctx.span = span
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        fwd = ctx.span
        if _on:
            fwd.backward = _Open(fwd.name, False, "backward", fwd.layer).__enter__()
        return None, g


class _InBoundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, *xs):
        ctx.span = span
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        bwd, ctx.span.backward = ctx.span.backward, None
        if bwd is not None:
            bwd.__exit__(None, None, None)
        return (None, *grads)


class _Off:
    """What ``span()`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def grad_in(self, *xs):
        return xs

    def grad_out(self, y):
        return y


OFF = _Off()


def span(name: str, *, unit: bool = False, phase: str | None = None, layer: int | None = None):
    """A span named ``name`` around a ``with`` block. ``unit=True`` makes it
    a unit's root (a new unit id); ``phase`` sets the process's phase for
    the block (``forward`` or ``backward``); ``layer`` is the layer index,
    which nested spans take from their parent."""
    if not _on:
        return OFF
    return _Open(name, unit, phase, layer)
