"""Port vs reference: the cluster layer (``repro_torch.runtime.cluster``).

Real multi-process runs on the CPU: ``repro_torch.launch.run_pdf`` workers
(``--device cpu``), one process a seat, joined into one ``torch.distributed``
world (gloo) and sharing one ``--out-dir``, bitwise equal to the serial run
(``verify_outputs``, the port's and the reference's alike), also through the
port's ``launch/cluster.sh``. In process: a lost worker's slices re-dealt to
a survivor and to a join-only worker, placement misuse refused, the marker
protocol and the watermark scan as the reference's. The kernel cache with a
fake ``nvcc`` (the CPU has none): a first load builds into
``<dir>/<spec_hash>``, a second process's load is a cache hit, and a corrupt
library there is a warned rebuild. Every subprocess has its own timeout.
"""

import dataclasses
import os
import re
import socket
import stat
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
pytest.importorskip("torch")

from repro.runtime import cluster as r_cluster
from repro_torch import api as tapi
from repro_torch.core.executor import RESULT_FIELDS
from repro_torch.kernels import _build
from repro_torch.runtime import cluster
from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultRule

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 120

# The reference's shared cluster spec: 4 slices, so a 4-process run still
# deals one slice a seat.
SPEC_FLAGS = [
    "--num-slices", "4", "--lines", "6", "--ppl", "10", "--obs", "80",
    "--method", "grouping", "--window-lines", "3", "--num-bins", "20",
    "--slices", "0", "1", "2", "3", "--device", "cpu",
]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(REPO / "src"), "PYTHON": sys.executable}


def _run_pdf(*args, check=True) -> subprocess.CompletedProcess:
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.run_pdf", *args],
                       env=_env(), capture_output=True, text=True, timeout=TIMEOUT,
                       stdin=subprocess.DEVNULL)
    if check:
        assert p.returncode == 0, f"stdout:\n{p.stdout}\nstderr:\n{p.stderr}"
    return p


def _run_cluster(nprocs, out_dir, extra=()) -> list[str]:
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.run_pdf", *SPEC_FLAGS,
             "--out-dir", str(out_dir), "--num-processes", str(nprocs),
             "--process-id", str(i), "--coordinator", coord, *extra],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            stdin=subprocess.DEVNULL)
        for i in range(nprocs)
    ]
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=TIMEOUT)[0], p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out, rc in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{out}"
    return [out for out, _ in outs]


@pytest.fixture(scope="module")
def serial_ref(tmp_path_factory):
    """The single-process out_dir every cluster run is compared against."""
    out = tmp_path_factory.mktemp("serial") / "out"
    log = _run_pdf(*SPEC_FLAGS, "--out-dir", str(out)).stdout
    assert "[total]" in log
    return out


@pytest.mark.parametrize("nprocs", [1, 2, 4])
def test_cluster_matches_serial_reference(nprocs, serial_ref, tmp_path):
    """N worker processes sharing one out_dir persist exactly the windows
    the serial run does, bitwise — as both packages' verify_outputs say."""
    out = tmp_path / f"out{nprocs}"
    logs = _run_cluster(nprocs, out)
    if nprocs > 1:
        assert all("[cluster] torch.distributed (gloo) process" in log for log in logs)
        assert sum(int(re.search(r"windows=(\d+)", log.split("[total]")[1]).group(1))
                   for log in logs) == 8
    assert cluster.verify_outputs(serial_ref, out) == (8, 80)
    assert r_cluster.verify_outputs(serial_ref, out) == (8, 80)
    if nprocs > 1:
        for i in range(nprocs):
            assert cluster.marker_path(out, i, "done").exists()


def test_cluster_sh_verifies_against_a_reference(serial_ref, tmp_path):
    """The port's launcher: two workers and CLUSTER_REF's bitwise check."""
    out = tmp_path / "sh"
    p = subprocess.run(
        ["bash", str(REPO / "src" / "repro_torch" / "launch" / "cluster.sh"), "2",
         *SPEC_FLAGS, "--out-dir", str(out)],
        env={**_env(), "COORD_PORT": str(_free_port()), "CLUSTER_REF": str(serial_ref)},
        capture_output=True, text=True, timeout=TIMEOUT, stdin=subprocess.DEVNULL)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "[cluster] bitwise-identical windows=8 arrays=80" in p.stdout
    assert "[proc 0] [launches]" in p.stdout and "[proc 1] [launches]" in p.stdout


def test_worker_requires_seat_and_out_dir():
    """Placement misuse fails loudly: more than one process without a
    process id, and without a shared out_dir, both refuse to launch."""
    p = _run_pdf(*SPEC_FLAGS, "--num-processes", "2", "--out-dir", "unused-seatless",
                 check=False)
    assert p.returncode != 0 and "process_id" in p.stderr
    p = _run_pdf(*SPEC_FLAGS, "--num-processes", "2", "--process-id", "0", check=False)
    assert p.returncode != 0 and "out_dir" in p.stderr


def test_verify_outputs_detects_divergence(serial_ref, tmp_path):
    """A changed array or a missing window fails both packages' check."""
    import shutil

    bad = tmp_path / "bad"
    shutil.copytree(serial_ref, bad)
    victim = sorted(bad.glob("slice*_window_*.npz"))[3]
    with np.load(victim) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["mean"] = arrays["mean"] + np.float32(1e-3)
    np.savez(victim, **arrays)
    for verify in (cluster.verify_outputs, r_cluster.verify_outputs):
        with pytest.raises(AssertionError, match="not bitwise"):
            verify(serial_ref, bad)
    victim.unlink()
    with pytest.raises(AssertionError, match="window sets differ"):
        cluster.verify_outputs(serial_ref, bad)


# -- placement, markers and the redeal, in process -------------------------------

SOURCE = tapi.SourceSpec(num_slices=3, lines_per_slice=10, points_per_line=8, observations=60)


def _spec(out_dir=None, **pl):
    execution = tapi.ExecSpec(out_dir=str(out_dir) if out_dir else None, retry_backoff_s=0.001,
                              placement=tapi.PlacementSpec(**pl))
    return tapi.PipelineSpec(source=SOURCE, method=tapi.MethodSpec(name="grouping"),
                             compute=tapi.ComputeSpec(window_lines=4), execution=execution)


def _ref(spec):
    import repro.api as rapi

    return rapi.PipelineSpec.from_json(spec.to_json())


@pytest.fixture(scope="module")
def clean():
    return tapi.PDFSession(_spec(), device="cpu").run_all()


def _bitwise(a, b):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("pl", [
    dict(num_processes=3, process_id=1),
    dict(num_processes=3, process_id=5),
    dict(num_processes=1, process_id=0),
    dict(),
], ids=["seat", "joiner", "single_seat", "single"])
def test_apply_placement_matches_reference(pl, tmp_path):
    spec = _spec(tmp_path, **pl)
    got, want = cluster.apply_placement(spec), r_cluster.apply_placement(_ref(spec))
    assert (got.execution.shards, got.execution.shard) == \
        (want.execution.shards, want.execution.shard)


def test_apply_placement_refuses_like_reference(tmp_path):
    for spec in (_spec(tmp_path, num_processes=2),
                 dataclasses.replace(_spec(tmp_path, num_processes=2, process_id=0),
                                     execution=dataclasses.replace(
                                         _spec(tmp_path, num_processes=2,
                                               process_id=0).execution, shards=3))):
        with pytest.raises(ValueError) as mine:
            cluster.apply_placement(spec)
        with pytest.raises(ValueError) as theirs:
            r_cluster.apply_placement(_ref(spec))
        assert str(mine.value) == str(theirs.value)


def test_init_distributed_without_a_seat_joins_nothing():
    for pl in (tapi.PlacementSpec(), tapi.PlacementSpec(num_processes=2, process_id=0,
                                                        distributed=False),
               tapi.PlacementSpec(num_processes=2, process_id=2)):
        assert cluster.init_distributed(pl) is False


def test_device_placement(tmp_path):
    import torch

    assert cluster.device_placement(tapi.PlacementSpec(), 3, torch.device("cpu")) == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="names CUDA devices"):
        cluster.device_placement(tapi.PlacementSpec(shard_devices=(0,)), 0, torch.device("cpu"))


def test_markers_and_slice_complete_match_reference(tmp_path):
    """Workers of either package read each other's markers; the watermark
    scan agrees on complete, partial, foreign and torn watermarks."""
    pl = tapi.PlacementSpec(num_processes=3, process_id=0, peer_timeout_s=0.2)
    cluster.write_marker(tmp_path, 1, "done")
    r_cluster.write_marker(tmp_path, 2, "lost", {"injected": True})
    assert cluster.wait_for_peers(tmp_path, pl, 0) == ([0, 1], [2])
    assert r_cluster.wait_for_peers(tmp_path, pl, 0) == ([0, 1], [2])
    silent = tapi.PlacementSpec(num_processes=4, process_id=0, peer_timeout_s=0.2)
    assert cluster.wait_for_peers(tmp_path, silent, 0) == ([0, 1], [2, 3])
    marks = {0: '{"next_line": 10, "spec_hash": "h"}', 1: '{"next_line": 4, "spec_hash": "h"}',
             2: '{"next_line": 10, "spec_hash": "x"}', 3: '{"next_line": 1',
             4: '{"next_line": 4, "spec_hash": "h", "complete": true}'}
    for s, text in marks.items():
        (tmp_path / f"slice{s}_watermark.json").write_text(text)
    for s in range(6):
        assert cluster.slice_complete(tmp_path, s, 10, "h") == \
            r_cluster.slice_complete(tmp_path, s, 10, "h")
    assert [cluster.slice_complete(tmp_path, s, 10, "h") for s in range(6)] == \
        [True, False, False, False, True, False]


def _cluster_spec(out_dir, pid, num_processes=2, peer_timeout_s=30.0):
    return cluster.apply_placement(_spec(out_dir, num_processes=num_processes, process_id=pid,
                                         distributed=False, peer_timeout_s=peer_timeout_s))


def test_lost_worker_is_redealt(clean, tmp_path):
    """Worker 1's shard dies on its first window load and publishes
    ``lost``; worker 0 finishes its own deal, sees the marker, re-deals the
    dead shard's slice onto itself and completes it bitwise."""
    out = tmp_path / "out"
    inj = FaultInjector(FaultPlan(rules=(FaultRule("shard_death", shard=1, after_units=0),)))
    s1 = tapi.PDFSession(_cluster_spec(out, pid=1), fault_injector=inj, device="cpu")
    assert list(cluster.run_worker(s1)) == []
    assert cluster.marker_path(out, 1, "lost").exists()
    s0 = tapi.PDFSession(_cluster_spec(out, pid=0), device="cpu")
    results = {r.slice_i: r for r in cluster.run_worker(s0)}
    assert set(results) == {0, 1, 2}
    for s in (0, 1, 2):
        assert not results[s].degraded
        _bitwise(results[s], clean[s])
    assert s0.report().shards_lost == (1,)
    assert cluster.marker_path(out, 0, "done").exists()


def test_joiner_completes_when_all_originals_die(clean, tmp_path):
    out = tmp_path / "out"
    inj = FaultInjector(FaultPlan(rules=(FaultRule("shard_death", shard=0, after_units=0),)))
    s0 = tapi.PDFSession(_cluster_spec(out, pid=0), fault_injector=inj, device="cpu")
    assert list(cluster.run_worker(s0)) == []
    joiner = tapi.PDFSession(_cluster_spec(out, pid=2, peer_timeout_s=0.3), device="cpu")
    results = {r.slice_i: r for r in cluster.run_worker(joiner)}
    assert set(results) == {0, 1, 2}
    for s in (0, 1, 2):
        _bitwise(results[s], clean[s])
    assert joiner.shards_lost == (0, 1)


def test_run_worker_requires_out_dir():
    with pytest.raises(ValueError, match="out_dir"):
        list(cluster.run_worker(tapi.PDFSession(_spec(), device="cpu")))


# -- the kernel cache: counters and the build directory --------------------------


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An ``nvcc`` stand-in that "builds" a loadable shared library (a copy
    of the interpreter's ``_ctypes`` extension) at its ``-o`` path, with a
    fresh library table: what a new process sees."""
    import _ctypes

    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys\n"
        "args = sys.argv[1:]\n"
        f"shutil.copyfile({_ctypes.__file__!r}, args[args.index('-o') + 1])\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_libs", {})

    def new_process():
        monkeypatch.setattr(_build, "_libs", {})

    return new_process


def test_cache_dir_builds_once_then_loads(fake_nvcc, tmp_path):
    """A first process builds into ``<dir>/<spec_hash>`` (misses = builds);
    a second loads from there with no build (new_compilations = 0)."""
    before = cluster.compile_counters()
    path = cluster.enable_compilation_cache(tmp_path / "cc", "abcd1234abcd1234")
    assert path == tmp_path / "cc" / "abcd1234abcd1234" == _build.BUILD_DIR and path.is_dir()
    _build.library("hist")
    first = cluster.counters_delta(before)
    assert first == {"traces": 0, "compiles": 1, "persistent_cache_hits": 0,
                     "persistent_cache_misses": 1}
    assert [p.name.split("-")[0] for p in path.iterdir()] == ["hist"]
    fake_nvcc()  # a relaunch: nothing loaded yet, the library on disk
    mid = cluster.compile_counters()
    _build.library("hist")
    _build.library("hist")  # loaded once a process
    assert cluster.counters_delta(mid) == {"traces": 0, "compiles": 1,
                                           "persistent_cache_hits": 1,
                                           "persistent_cache_misses": 0}


def test_corrupt_cache_entry_is_warned_miss_not_crash(fake_nvcc, tmp_path):
    """Garbage bytes where a library should be: a warned miss that rebuilds
    and loads, never a crash."""
    path = cluster.enable_compilation_cache(tmp_path / "cc", "feedfacefeedface")
    target = _build._target("moments")
    assert target.parent == path
    target.write_bytes(b"not a shared library")
    before = cluster.compile_counters()
    with pytest.warns(RuntimeWarning, match="does not load"):
        _build.library("moments")
    assert cluster.counters_delta(before)["persistent_cache_misses"] == 1
    assert target.read_bytes() != b"not a shared library"
    fake_nvcc()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _build.library("moments")  # healed: a plain hit now


def test_session_reports_compilations_over_the_cache(fake_nvcc, tmp_path):
    """``SessionReport`` counts what the session's process built and loaded
    after the cache was enabled under the spec's hash."""
    spec = dataclasses.replace(_spec(), execution=tapi.ExecSpec(
        compile_cache_dir=str(tmp_path / "cc")))
    session = tapi.PDFSession(spec, device="cpu")
    assert _build.BUILD_DIR == tmp_path / "cc" / session.spec_hash
    _build.library("hist")  # what a CUDA run's first K4 launch does
    rep = session.report()
    assert (rep.compile_cache_misses, rep.new_compilations, rep.compiles) == (1, 1, 1)
    fake_nvcc()
    session2 = tapi.PDFSession(spec, device="cpu")
    _build.library("hist")
    rep2 = session2.report()
    assert (rep2.new_compilations, rep2.compile_cache_hits) == (0, 1)


def test_run_pdf_keys_the_cache_by_spec_hash(tmp_path):
    """A launch with --compile-cache-dir creates ``<dir>/<spec_hash>`` and
    prints the [compile] line (nothing builds on the CPU)."""
    cache = tmp_path / "cc"
    log = _run_pdf(*SPEC_FLAGS, "--slices", "0", "--compile-cache-dir", str(cache)).stdout
    spec_hash = re.search(r"hash=([0-9a-f]{16})", log).group(1)
    assert (cache / spec_hash).is_dir()
    assert "new_compilations=0" in log
