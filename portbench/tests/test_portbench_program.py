"""The per-layer metrics that read the program's own spans
(``portbench/program.py``), on the CPU at tiny widths: a traced run gives
each a number, the SSD's parts cover the SSD, and a program without
``runtime.trace`` gives none of them and still prints its last line."""

import json
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import manifest as M
from portbench import run
from portbench.tests.helpers import tiny

CPU = torch.device("cpu")
SEED = 2**31 + 101
PROGRAM = {"ssd_ms.train", "recompute_ms.train", "global_attn_ms.train", "global_attn_ms.prefill",
           "ssd_intra_ms.prefill"}
SSD_PARTS = ("ssd.proj", "ssd.intra", "ssd.states", "ssd.scan", "ssd.inter", "ssd.out")


@pytest.mark.parametrize("cell", ["mamba2-prefill-4k", "hymba-train-4k", "hymba-prefill-4k",
                                  "mamba2-train-4k"])
def test_traced_run_reads_the_programs_spans(cell):
    # 128 wide under a sequence of 128: the SSD's work, not the host's few
    # microseconds a span, sets its time
    c = tiny(cell, deep=True, compute_dtype="float32")
    captured = {}
    real = run.Run

    def keep(*args, **kw):
        captured["run"] = real(*args, **kw)
        return captured["run"]

    run.Run = keep
    try:
        res = run.execute(c, SEED, 0.3, True, CPU)
    finally:
        run.Run = real
    mine = {m["name"] for m in c.per_layer} & PROGRAM
    assert mine and mine <= set(res["metrics"])
    for name in mine:
        assert res["metrics"][name]["value"] > 0
    units = captured["run"].program_spans
    assert len(units) == res["attempted"]
    for spans in units:
        ssd = [s for s in spans if s.name == "ssd" and s.phase != "backward"]
        assert ssd
        for s in ssd:
            assert [ch.name for ch in s.children] == list(SSD_PARTS)
        # the parts cover the SSD's host time, a unit's calls together
        covered = sum(ch.ms for s in ssd for ch in s.children)
        assert covered == pytest.approx(sum(s.ms for s in ssd), rel=0.02)


def test_readers_give_none_without_the_programs_tracing():
    """With ``repro_torch.runtime.trace`` unimportable once the program is
    loaded (as in a program before it), tracing stays off, each new
    reader returns None and the run prints its last line with the other
    metrics."""
    code = textwrap.dedent(f"""
        import json, sys, torch
        from portbench.tests.helpers import tiny
        import repro_torch.launch.serve_decode, repro_torch.launch.train, repro_torch.runtime
        sys.modules["repro_torch.runtime.trace"] = None
        del repro_torch.runtime.trace
        from portbench import run
        for cell in ("hymba-train-4k", "hymba-prefill-4k"):
            res = run.execute(tiny(cell, compute_dtype="float32"), {SEED}, 0.2, True, torch.device("cpu"))
            print(json.dumps(res))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=M.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()[-2:]]
    for res in lines:
        assert not set(res["metrics"]) & PROGRAM
        assert res["metrics"] and set(res["breakdown"]) == {"device_ops", "idle_gaps"}
