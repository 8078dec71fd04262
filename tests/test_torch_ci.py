"""The port's CI sequences (``.github/workflows/ci_torch.yml``) on the CPU.

Each job's launcher commands run as subprocesses on ``--device cpu``, each
under its own timeout, and make the workflow's assertions. Steps that other
port tests already hold in process (the result cache's hits, the kernel
cache keyed by spec hash, the merge after an append, the lint, the doc's
render) are held here only in their command-line form. ``run_pdf --watch``
applying an append that lands while it polls is held here alone. The last
tests check the workflow file's own shape against ``ci.yml``.
"""

import importlib
import json
import os
import re
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.api import (
    ComputeSpec,
    ExecSpec,
    MethodSpec,
    PipelineSpec,
    SourceSpec,
    StreamSpec,
)
from repro_torch.api import cli as tcli
from repro_torch.core.regions import Window
from repro_torch.data.file_source import FileCubeSource, export_cube
from repro_torch.runtime.faults import FaultPlan, FaultRule
from repro_torch.streaming import append_realizations

ROOT = Path(__file__).resolve().parents[1]
WORKFLOWS = ROOT / ".github" / "workflows"
TIMEOUT = 120  # seconds a launcher may take on the tiny cube
WATCH_TIMEOUT = 180  # the watcher's whole life: a run, a poll, an update

# The cli-smoke and chaos-smoke jobs' tiny cube: 4 slices of 6 x 10 points,
# 80 observations, grouping, two slices run (chaos's fast retry backoff).
SPEC = PipelineSpec(
    source=SourceSpec(num_slices=4, lines_per_slice=6, points_per_line=10, observations=80),
    method=MethodSpec(name="grouping"),
    compute=ComputeSpec(window_lines=3, num_bins=20),
    execution=ExecSpec(slices=(0, 1), retry_backoff_s=0.001),
)


def _env(**extra) -> dict:
    path = os.pathsep.join(filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")]))
    return {**os.environ, "PYTHONPATH": path, "PYTHON": sys.executable, **extra}


def _run(argv, timeout=TIMEOUT, **env) -> str:
    p = subprocess.run(argv, cwd=ROOT, env=_env(**env), capture_output=True, text=True,
                       timeout=timeout, stdin=subprocess.DEVNULL)
    assert p.returncode == 0, f"{argv}\nstdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    return p.stdout


def _launch(module: str, *args, timeout=TIMEOUT) -> str:
    return _run([sys.executable, "-m", f"repro_torch.launch.{module}", *map(str, args)], timeout)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _windows(out_dir: Path) -> list[Path]:
    return sorted(out_dir.glob("slice*_window_*.npz"))


@pytest.fixture(scope="module")
def spec_file(tmp_path_factory) -> Path:
    f = tmp_path_factory.mktemp("ci") / "spec.json"
    f.write_text(SPEC.to_json())
    return f


@pytest.fixture(scope="module")
def clean(spec_file):
    """cli-smoke's cold run, which is also chaos-smoke's clean run and the
    reference of the two-worker cluster: (stdout, out_dir, cache_dir)."""
    out, cache = spec_file.parent / "clean", spec_file.parent / "result-cache"
    log = _launch("run_pdf", "--spec", spec_file, "--device", "cpu", "--cache-dir", cache,
                  "--out-dir", out)
    return log, out, cache


# -- cli-smoke ------------------------------------------------------------------


def test_run_pdf_prints_the_hash_and_the_cache_serves_the_rerun(spec_file, clean):
    cold, _, cache = clean
    assert f"hash={SPEC.content_hash()} " in cold
    assert "[cache] hits=0 misses=2" in cold
    warm = _launch("run_pdf", "--spec", spec_file, "--device", "cpu", "--cache-dir", cache)
    assert f"hash={SPEC.content_hash()} " in warm
    assert "[cache] hits=2 misses=0" in warm and "served from result cache" in warm


def test_dryrun_pdf_prints_the_same_hash(spec_file, tmp_path):
    out = _launch("dryrun_pdf", "--spec", spec_file, "--variant", "fused", "--pdf-shape",
                  "window_small", "--out", tmp_path)
    assert f"hash={SPEC.content_hash()} " in out


def test_serve_pdf_answers_four_clients(spec_file):
    out = _launch("serve_pdf", "--spec", spec_file, "--device", "cpu", "--clients", 4)
    assert f"hash={SPEC.content_hash()} " in out and "[latency]" in out


# -- chaos-smoke ----------------------------------------------------------------


def test_transient_fault_plan_recovers_bitwise(spec_file, clean, tmp_path):
    plan = tmp_path / "transient.json"
    plan.write_text(FaultPlan(rules=(FaultRule("read_error", times=1),)).to_json())
    out = _launch("run_pdf", "--spec", spec_file, "--device", "cpu", "--out-dir",
                  tmp_path / "chaos", "--fault-plan", plan)
    assert "[faults] retries=" in out and "[degraded]" not in out
    want, got = _windows(clean[1]), _windows(tmp_path / "chaos")
    assert want and [f.name for f in want] == [f.name for f in got]
    for a, b in zip(want, got):
        za, zb = np.load(a), np.load(b)
        assert za.files == zb.files
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{a.name}/{k}")


def test_dead_unit_degrades_with_a_manifest(spec_file, tmp_path):
    plan = tmp_path / "dead_unit.json"
    plan.write_text(FaultPlan(rules=(
        FaultRule("read_error", slice_i=1, line_start=3, times=10_000),)).to_json())
    out = _launch("run_pdf", "--spec", spec_file, "--device", "cpu", "--out-dir",
                  tmp_path / "degraded", "--fault-plan", plan)
    assert "[degraded] slice 1: 1 window(s) quarantined" in out and "quarantined=1" in out
    manifest = json.loads((tmp_path / "degraded" / "slice1_failed_units.json").read_text())
    assert [e["line_start"] for e in manifest["failed"]] == [3], manifest


# -- distributed-smoke ----------------------------------------------------------


def test_cluster_sh_two_workers_over_a_compile_cache(spec_file, clean, tmp_path):
    """The port's cluster.sh: two gloo workers, one slice each, bitwise the
    single-process run, the kernel cache keyed by the spec's hash and no
    compilation (nothing builds on the CPU)."""
    cache = tmp_path / "compile-cache"
    out = _run(["bash", str(ROOT / "src" / "repro_torch" / "launch" / "cluster.sh"), "2",
                "--spec", str(spec_file), "--device", "cpu", "--out-dir", str(tmp_path / "c2"),
                "--compile-cache-dir", str(cache)],
               COORD_PORT=str(_free_port()), CLUSTER_REF=str(clean[1]))
    assert "[cluster] torch.distributed (gloo) process 0/2" in out
    assert "[cluster] torch.distributed (gloo) process 1/2" in out
    assert "[cluster] bitwise-identical windows=4" in out
    assert out.count("new_compilations=0") == 2
    assert (cache / SPEC.content_hash()).is_dir()


# -- streaming-smoke ------------------------------------------------------------


def _append_midpoints(cube: Path, slice_i: int, n: int = 5) -> None:
    """Append n realizations at each point's mid-range to one slice."""
    src = FileCubeSource(cube)
    g = src.geometry
    vals = src.load_window(Window(slice_i, 0, g.lines_per_slice))
    mid = (vals.min(axis=1) + vals.max(axis=1)) / 2.0
    block = np.repeat(mid[:, None], n, axis=1).astype(np.float32)
    append_realizations(cube, {slice_i: block.reshape(g.lines_per_slice, g.points_per_line, n)})


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """streaming-smoke's exported cube and spec, its cold run, then an
    append to slice 1 and the rerun: (dir, spec file, cold, warm stdout)."""
    d = tmp_path_factory.mktemp("stream")
    sim = SourceSpec(num_slices=3, lines_per_slice=4, points_per_line=6, observations=48)
    spec = PipelineSpec(
        source=export_cube(sim, d / "cube", lines_per_chunk=2),
        compute=ComputeSpec(window_lines=2, num_bins=16),
        execution=ExecSpec(cache_dir=str(d / "cache"), out_dir=str(d / "out")),
        stream=StreamSpec(persist_stats=True, poll_interval_s=0.2, max_updates=1),
    )
    f = d / "spec.json"
    f.write_text(spec.to_json())
    cold = _launch("run_pdf", "--spec", f, "--device", "cpu")
    _append_midpoints(d / "cube", 1)
    return d, f, cold, _launch("run_pdf", "--spec", f, "--device", "cpu")


def test_stream_cold_run_writes_sidecars(stream):
    d, _, cold, _ = stream
    assert "[cache] hits=0 misses=3" in cold
    assert list((d / "out").glob("slice1_stats_*.npz"))


def test_rerun_after_an_append_touches_only_the_appended_slice(stream):
    warm = stream[3]
    assert "[cache] hits=2 misses=1" in warm and "adopted=2 merged=1 mode=merge" in warm


def test_watch_applies_an_append_that_lands_mid_poll(stream):
    """``run_pdf --watch`` after the rerun: a thread appends to slice 2 once
    the polling banner is out, and the watcher applies it, adopting slices
    0 and 1 and merging slice 2 (one update, then it exits by
    ``max_updates=1``)."""
    d, f, _, _ = stream
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.run_pdf", "--spec", str(f),
         "--device", "cpu", "--watch"],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        stdin=subprocess.DEVNULL)
    lines, failed = [], []

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "polling every" in line:
                try:
                    _append_midpoints(d / "cube", 2)
                except Exception as e:  # noqa: BLE001 — raised on the test's thread
                    failed.append(e)

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=WATCH_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    out = "".join(lines)
    assert not failed, failed
    assert rc == 0, out
    update = out.partition("polling every")[2]
    assert re.search(r"manifest version .* updating", update), out
    assert "adopted=2 merged=1 mode=merge" in update, out


# -- docs-sync ------------------------------------------------------------------


def test_port_doc_matches_the_committed_spec_reference(tmp_path):
    """``--doc --out`` writes the port's render, whose sections and field
    rows are the committed ``docs/spec_reference.md``'s (last column aside)."""
    from test_torch_api import _rows

    tcli.main(["--doc", "--out", str(tmp_path / "spec_reference.md")])
    port = _rows((tmp_path / "spec_reference.md").read_text())
    assert port == _rows((ROOT / "docs" / "spec_reference.md").read_text())
    assert len(port) > 60


# -- the workflow's shape ---------------------------------------------------------


@pytest.fixture(scope="module")
def workflows():
    yaml = pytest.importorskip("yaml")
    return (yaml.safe_load((WORKFLOWS / "ci.yml").read_text()),
            yaml.safe_load((WORKFLOWS / "ci_torch.yml").read_text()))


def _commands(job: dict) -> list[str]:
    """Each job's shell lines, continuations joined, with the job's
    environment variables expanded."""
    text = "\n".join(step.get("run", "") for step in job["steps"]).replace("\\\n", " ")
    for name, value in job.get("env", {}).items():
        text = text.replace(f"${name}", str(value))
    return text.splitlines()


def test_workflow_has_a_counterpart_of_each_job(workflows):
    ref, port = workflows
    assert set(port["jobs"]) == {f"{name}-torch" for name in ref["jobs"]}
    for name, job in port["jobs"].items():
        steps = " ".join(step.get("run", "") for step in job["steps"])
        assert "benchmarks/" not in steps and "--check" not in steps, name
        setup = [s for s in job["steps"] if s.get("uses", "").startswith("actions/setup-python")]
        assert setup and setup[0]["with"]["python-version"] == "3.12", name
        if "pip install" in steps:
            assert "download.pytorch.org/whl/cpu" in steps, name


def test_workflow_runs_only_the_port_on_the_cpu(workflows):
    _, port = workflows
    env = port.get("env", {})
    assert env.get("PYTHONPATH") == "src" and env.get("JAX_PLATFORMS") == "cpu"
    assert env.get("HYPOTHESIS_PROFILE") == "ci"
    modules, launches = set(), 0
    for name, job in port["jobs"].items():
        for line in _commands(job):
            assert not re.search(r"-m\s+repro\.", line), (name, line)
            assert not re.search(r"\brepro\.(launch|runtime)\b", line), (name, line)
            assert not re.search(r"(?<!repro_torch/)\blaunch/cluster\.sh", line), (name, line)
            modules.update(re.findall(r"-m (repro_torch[\w.]*)", line))
            if re.search(r"launch\.(run_pdf|serve_pdf)\b|cluster\.sh", line):
                launches += 1
                assert "--device cpu" in line, (name, line)
    assert launches >= 10
    assert {"repro_torch.launch.run_pdf", "repro_torch.launch.serve_pdf",
            "repro_torch.launch.dryrun_pdf", "repro_torch.api.cli",
            "repro_torch.analysis"} <= modules
    lint = _commands(port["jobs"]["lint-invariants-torch"])
    assert {"python -m repro_torch.analysis",
            "python -m repro_torch.analysis --self-check"} <= {line.strip() for line in lint}
    for m in sorted(modules):
        importlib.import_module(m)
