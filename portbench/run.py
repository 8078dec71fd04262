"""One run of one cell:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell's configuration and traffic
mix, builds the port's model with weights drawn on the card from the seed,
warms up the cell's own shapes (set-up), measures for ``--seconds``, then
checks what the timed path produced against the plain reference, and
prints one JSON object as the last line of standard output (the numbers
compared, each beside its limit, also as the last lines of standard
error). With ``--trace 0`` the metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from spans around the
program's calls and from the profiler's trace of a steady stretch after
the window.

It exits with another code than 0, and prints no result, where no CUDA
device (or fewer than the cell asks for) is present, where the program
cannot be imported (a checkout without ``src/``), or where JAX, ``flax``
or the JAX package ``repro`` is loaded in this process.

The port's kernels build into ``build/kernels`` of the checkout (its fixed
``kernels/_build.BUILD_DIR``); ``TORCH_EXTENSIONS_DIR`` and
``TRITON_CACHE_DIR`` are pinned under ``build/`` too, so only a cell's
first run in a checkout compiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here: before torch is imported

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

from portbench import manifest as M  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Run:
    """What a metric's reader reads: the cell's files, the set-up time,
    each unit's (request's or step's) latency in the window, the window's
    length from its first issue to its last completion, and in a traced
    run the spans ({name: [ms a call]}) of the window and the device's
    trace of the stretch after it."""

    cell: M.Cell
    setup_s: float
    latencies_s: list
    window_s: float
    spans: dict = field(default_factory=dict)
    trace: object = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @property
    def units(self) -> int:
        return len(self.latencies_s)


def pin_caches(root=M.ROOT) -> None:
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def window(unit, seconds: float, device) -> tuple[list, list, float]:
    """Units ``unit(0)``, ``unit(1)``, ... back to back (a closed loop of one
    client), each timed from its issue to its output synchronised on the
    host, issued while the window's ``seconds`` have not passed. Returns
    (outputs, latencies, seconds from the first issue to the last
    completion)."""
    outs, lat = [], []
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        outs.append(unit(i))
        sync(device)
        lat.append(time.perf_counter() - t0)
        i += 1
    return outs, lat, time.perf_counter() - start


def _spans(cell: M.Cell, trace: bool, device):
    from portbench.spans import Spans

    targets = {}
    if trace:
        for m in cell.per_layer:
            targets.update(getattr(M.reader(m["name"]), "SPANS", {}))
    return Spans(targets, device)


def _free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def run_prefill(cell: M.Cell, seed: int, seconds: float, trace: bool, device):
    import torch

    from portbench import check, system
    from portbench import trace as TRACE
    from portbench import traffic as TR
    from portbench.weights import stream_seed

    cfg, tr = cell.config, cell.traffic
    prog = system.Prefill(cfg, tr, seed, device)
    log(f"model built at {time.perf_counter() - T_START} s")
    _reset_peak(device)
    for i in range(tr["warmup"]):
        prog(TR.prompt(tr, cfg, seed, -1 - i, device))
        sync(device)
        log(f"warm-up request {i} done at {time.perf_counter() - T_START} s")
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s} s")
    spans = _spans(cell, trace, device)
    with spans.installed():
        outs, lat, window_s = window(lambda i: prog(TR.prompt(tr, cfg, seed, i, device)), seconds, device)
    run = Run(cell, setup_s, lat, window_s, spans.ms())
    n = len(outs)
    if trace:
        extra = [TR.prompt(tr, cfg, seed, n + k, device) for k in range(tr["profile_units"])]
        run.trace = TRACE.profiled(lambda: [prog(p) for p in extra], device)
    peak = _peak(device)
    failed = int(sum(int(not bool(torch.isfinite(o).all())) for o in outs))
    sample = sorted(random.Random(stream_seed(seed, "check")).sample(range(n), min(tr["check"], n)))
    got = [outs[i].float().cpu() for i in sample]
    del outs
    prog.close()
    del prog
    _free(device)
    refs = check.ref_prefill(cfg, tr, seed, sample, device)
    numbers = {"logit_err": max(check.logit_err(g, r.cpu()) for g, r in zip(got, refs))}
    log(f"checked requests {sample} of {n}")
    return run, n, failed, peak, numbers


def checked_steps(prog, cell: M.Cell, seed: int, device) -> dict:
    """The job's checked steps through the window's own call and feed
    (rows 0, 1, ... of the seed), and the program's readings of them: each
    step's loss, the first gradient as the optimizer took it (its first
    moment after one step over 1 - b1, kept on the host, and its norm by
    leaf) and the parameters' change after the steps by leaf, read before
    any later step moves them."""
    from portbench import check
    from portbench import traffic as TR

    cfg, tr = cell.config, cell.traffic
    losses = []
    for i in range(tr["checked_steps"]):
        loss, _ = prog(TR.train_batch(tr, cfg, seed, i, device))
        losses.append(loss)
        sync(device)
        log(f"checked step {i} done at {time.perf_counter() - T_START} s")
        if i == 0:  # a host copy: the reference runs after the program's state is freed
            first = {n: m / (1 - prog.b1) for n, m in prog.first_moment().items()}
            grad_norms = check.leaf_norms(first)
            first_grad = {n: g.cpu() for n, g in first.items()}
            del first
            log(f"first gradient on the host at {time.perf_counter() - T_START} s")
    changes = check.change_norms(cfg, seed, prog.params(), device)
    log(f"changes read at {time.perf_counter() - T_START} s")
    return dict(losses=[float(x) for x in losses], first_grad=first_grad, grad_norms=grad_norms,
                change_norms=changes)


def run_train(cell: M.Cell, seed: int, seconds: float, trace: bool, device):
    import torch

    from portbench import check, system
    from portbench import trace as TRACE
    from portbench import traffic as TR

    cfg, tr = cell.config, cell.traffic
    prog = system.Train(cfg, tr, seed, device)
    log(f"model built at {time.perf_counter() - T_START} s")
    _reset_peak(device)
    checked = tr["checked_steps"]
    readings = checked_steps(prog, cell, seed, device)
    sync(device)
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s} s (with the {checked} checked steps)")
    spans = _spans(cell, trace, device)

    def step(i):
        return prog(TR.train_batch(tr, cfg, seed, checked + i, device))[0]

    with spans.installed():
        outs, lat, window_s = window(step, seconds, device)
    run = Run(cell, setup_s, lat, window_s, spans.ms())
    n = len(outs)
    if trace:
        run.trace = TRACE.profiled(lambda: [step(n + k) for k in range(tr["profile_units"])], device)
    peak = _peak(device)
    failed = int(sum(int(not bool(torch.isfinite(o).all())) for o in outs))
    del outs
    prog.close()
    del prog
    _free(device)
    ref = check.ref_train(cfg, tr, seed, device)
    log(f"change_err over {len(check.moving_leaves(ref['grad_norms']))} of {len(ref['grad_norms'])} leaves")
    return run, n, failed, peak, check.train_numbers(readings, ref)


DRIVERS = {"prefill": run_prefill, "train": run_train}


def execute(cell: M.Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of ``cell`` on ``device``: the result object (without the
    look for a card, which ``main`` makes)."""
    import torch

    from portbench import check

    run, attempted, failed, peak, numbers = DRIVERS[cell.traffic["kind"]](cell, seed, seconds, trace, device)
    correct, checks = check.judge(numbers, cell.limits)
    for name in sorted(set(numbers) - set(checks)):
        log(f"not compared (no upper reading): {name} {numbers[name]!r}")
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = M.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    return result


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port's run must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = M.Cell(M.load(), args.workload)
    pin_caches()
    sys.path.insert(0, str(M.ROOT / "src"))
    import torch

    log(f"torch imported at {time.perf_counter() - T_START} s")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import repro_torch  # noqa: F401  (a checkout without the program stops here)

    torch.cuda.synchronize(torch.device("cuda", 0))
    log(f"program imported and card ready at {time.perf_counter() - T_START} s")
    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        log(f"modules that the port's run must not load are loaded: {bad}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
