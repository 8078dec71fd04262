"""The program's own spans (``repro_torch.runtime.trace``), for the
per-layer metrics that read them.

Importing this module switches the port's tracing on. The harness loads a
cell's per-layer readers only in a traced run, just before the window
(``run._spans``), so tracing is on for the window and the profiled stretch
after it, and off in every ``--trace 0`` run. A program without
``runtime.trace`` (a commit before it) leaves tracing off: ``window_spans``
then returns None, and so does every reader of this module's spans.
"""

from __future__ import annotations

from portbench import flops

try:
    from repro_torch.runtime import trace as _trace
except ImportError:
    _trace = None
else:
    _trace.enable()


def window_spans(run) -> list | None:
    """The spans of the window's units, a list of each unit's spans in the
    order they opened: the first ``run.units`` units recorded since
    tracing went on. The first call drains the recorder after a
    synchronise and keeps the result on ``run`` for the other readers.
    None without the program's tracing or without units."""
    if _trace is None or not run.units:
        return None
    got = getattr(run, "program_spans", None)
    if got is None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        units: dict = {}
        for s in _trace.drain():
            if s.unit is not None:
                units.setdefault(s.unit, []).append(s)
        got = [units[u] for u in sorted(units)[:run.units]]
        run.program_spans = got
    return got if len(got) == run.units else None


def expected(config: dict) -> dict:
    """How many spans a unit holds by the configuration: its layers, those
    with an SSD and those of global attention, and of each the number a
    training step recomputes (the layers after the prefix, unless remat
    is off)."""
    layers = flops.layer_defs(config)
    start = len(config.get("prefix", [])) if config.get("remat", "none") != "none" else len(layers)
    kinds = {"layers": [True] * len(layers),
             "ssd": [l["mixer"] in ("ssm", "hybrid") for l in layers],
             "global": [l["mixer"] in ("attn", "hybrid") and l.get("window") is None for l in layers]}
    out = {}
    for kind, has in kinds.items():
        out[kind] = sum(has)
        out[f"{kind}_recomputed"] = sum(has[start:])
    return out


def ms_a_unit(run, name: str, counts: dict, phases=None) -> float | None:
    """Device ms a unit of the spans ``name`` of ``phases`` (by default
    every phase in ``counts``), each less its children of another phase
    (a recompute that autograd runs inside a backward span), averaged over
    the window's units. None unless every unit holds exactly ``counts``
    ({phase: spans a unit}) of them, and no other phase."""
    units = window_spans(run)
    counts = {k: v for k, v in counts.items() if v}
    phases = set(counts if phases is None else phases)
    if not units or not phases <= set(counts):
        return None
    total = 0.0
    for spans in units:
        mine = [s for s in spans if s.name == name]
        got: dict = {}
        for s in mine:
            got[s.phase] = got.get(s.phase, 0) + 1
        if got != counts:
            return None
        total += sum(s.phase_ms for s in mine if s.phase in phases)
    return total / len(units)
