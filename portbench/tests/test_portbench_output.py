"""The shape of a run's last line, and the runs that must print none."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from portbench import manifest as M
from portbench import run
from portbench.tests.helpers import tiny

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["mamba2-prefill-4k", "hymba-train-4k"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(cell, trace):
    c = tiny(cell)
    res = run.execute(c, 2**31 + 7, 0.3, trace, CPU)
    json.loads(json.dumps(res))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool) and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = c.per_layer if trace else c.end_to_end
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(res["metrics"]) <= set(units)
    for name, m in res["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not trace:
        assert set(res["metrics"]) == set(units)  # every end-to-end metric is reported
    else:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in res["breakdown"].values())
    for name, chk in res["checks"].items():
        assert set(chk) == {"value", "limit"} and name in c.limits


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert run.main(["--workload", "mamba2-prefill-4k", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_checkout_without_the_program_prints_nothing(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder (a card faked present), the run fails before any result."""
    shutil.copy(M.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(M.HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = textwrap.dedent("""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: True
        torch.cuda.device_count = lambda: 1
        sys.argv = ["run", "--workload", "mamba2-prefill-4k", "--seed", "1", "--seconds", "1"]
        runpy.run_module("portbench.run", run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
