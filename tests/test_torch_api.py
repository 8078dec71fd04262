"""Port vs reference: the declarative API (``repro_torch.api``).

Specs: JSON written by either package loads in the other with an equal
``to_dict``; every field of every section changes the port's content hash
exactly when it changes the reference's and when its ``hashed`` tag says
so, yet the two hashes never agree (``HASH_IMPL``); the generated CLI and
its rendered reference match the reference's. Sessions: whole slices of a
small cube (4 slices of 12 lines x 30 points, 200 observations, windows of
5 lines) through both packages' ``PDFSession`` under the ROADMAP's parity
rules (and the tree-margin rule of tests/test_torch_ml.py for
``grouping_ml``); within the port, a session equals ``PDFComputer`` bit for
bit. The cluster knobs, sufficient-statistic sidecars and merge-mode
updates run as the reference's do."""

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
pytest.importorskip("torch")

import repro.api as rapi
from repro.api import cli as rcli
from repro.api import spec as rspec
from repro.configs import pdf_seismic as r_seismic
from repro.core import distributions as rd
from repro.core import executor as rex
from repro.core import regions as r_regions
from repro.kernels import fitpdf as rfp
from repro_torch import api as tapi
from repro_torch import interop
from repro_torch.api import cli as tcli
from repro_torch.api import spec as tspec
from repro_torch.configs import pdf_seismic as t_seismic
from repro_torch.core import ml_predict as tmlp
from repro_torch.core import pipeline as tp
from repro_torch.core.executor import METHODS, RESULT_FIELDS, SAMPLERS, PDFConfig
from repro_torch.core.regions import Window
from repro_torch.data import file_source as t_fs

ROOT = Path(__file__).resolve().parents[1]
MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)
SLICES = (0, 1, 2, 3)
CUBE = dict(num_slices=4, lines_per_slice=12, points_per_line=30, observations=200)
WINDOW_LINES = 5
# Share of the cube's points the tree-margin rule must decide (see
# tests/test_torch_ml.py: slices 1 and 3 sit at a split threshold).
MIN_DECIDED = 0.5
SMALL_SOURCE = tapi.SourceSpec(num_slices=8, lines_per_slice=9, points_per_line=12,
                               observations=250)


def _spec(method="baseline", **exec_kw):
    return tapi.PipelineSpec(
        source=tapi.SourceSpec(**CUBE), method=tapi.MethodSpec(name=method),
        compute=tapi.ComputeSpec(window_lines=WINDOW_LINES),
        execution=tapi.ExecSpec(**exec_kw))


def _ref(spec):
    """The reference package's spec of the same JSON."""
    return rapi.PipelineSpec.from_json(spec.to_json())


def _bitwise(a, b):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.avg_error == b.avg_error


# -- JSON across the packages --------------------------------------------------


def _every_section_non_default():
    return tapi.PipelineSpec(
        source=tapi.SourceSpec(num_slices=5, lines_per_slice=7, points_per_line=9,
                               observations=120, num_layers=8, base_vp=2500.0,
                               quantize_decimals=2, group_block=3, line_block=1, seed=4,
                               throttle_mb_s=80.0),
        method=tapi.MethodSpec(name="reuse_ml", group_tol=1e-3, rep_bucket=32,
                               error_bound=2.0, sample_frac=0.3, sampler="kmeans",
                               kmeans_iters=4, sample_seed=9,
                               tree=tapi.TreeSpec(depth=3, max_bins=16, train_slices=(0, 2),
                                                  train_window_lines=3)),
        compute=tapi.ComputeSpec(types=rd.TYPES_10, num_bins=24, window_lines=4,
                                 mode="faithful", fit_backend="kernels",
                                 select_backend="device"),
        execution=tapi.ExecSpec(
            slices=(1, 3), shards=2, shard=1, prefetch=False, prefetch_depth=3,
            async_persist=False, out_dir="out", resume=True, cache_dir="cache",
            cache_max_bytes=10_000, max_retries=1, retry_backoff_s=0.01, speculate=False,
            straggler_grace_s=0.5, degraded_mode=False, fault_plan="plan.json",
            compile_cache_dir="cc",
            placement=tapi.PlacementSpec(num_processes=2, process_id=1,
                                         coordinator="10.0.0.1:9999", distributed=False,
                                         shard_devices=(0, 1), redeal=False,
                                         peer_timeout_s=30.0)),
        serve=tapi.ServeSpec(tick_seconds=0.0, max_batch_windows=4, coalesce=False,
                             window_cache_entries=0, request_deadline_s=2.0,
                             max_queue_depth=16, retry_transient=0),
        stream=tapi.StreamSpec(update_mode="strict", persist_stats=True, incremental=False,
                               poll_interval_s=0.5, max_updates=3))


@pytest.mark.parametrize("make", [
    lambda: tapi.PipelineSpec(),
    lambda: t_seismic.to_spec(t_seismic.SET1),
    lambda: t_seismic.to_spec(t_seismic.SET1_10TYPES),
    _every_section_non_default,
], ids=["default", "set1", "set1_10types", "every_section"])
def test_spec_json_round_trips_both_ways(make):
    port = make()
    ref = _ref(port)
    assert ref.to_dict() == port.to_dict()
    back = tapi.PipelineSpec.from_json(ref.to_json())
    assert back == port and back.to_dict() == ref.to_dict()
    assert port.content_hash() != ref.content_hash()


def test_paper_configs_match_reference():
    for name in ("SET1", "SET2", "SET3", "SET1_10TYPES"):
        t, r = getattr(t_seismic, name), getattr(r_seismic, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(r), name
        assert t_seismic.to_spec(t).to_dict() == r_seismic.to_spec(r).to_dict(), name
    s1 = t_seismic.to_spec(t_seismic.SET1)
    assert s1.execution.slices == (201,) and s1.method.rep_bucket == 256
    assert t_seismic.to_spec(t_seismic.SET3).content_hash() != s1.content_hash()


def test_version_2_spec_upgrades_as_in_reference():
    d = t_seismic.to_spec(t_seismic.SET1).to_dict()
    d["version"] = 2
    del d["stream"]
    del d["execution"]["placement"]
    del d["execution"]["compile_cache_dir"]
    with pytest.warns(UserWarning) as t_warn:
        port = tapi.PipelineSpec.from_dict(json.loads(json.dumps(d)))
    with pytest.warns(UserWarning) as r_warn:
        ref = rapi.PipelineSpec.from_dict(json.loads(json.dumps(d)))
    assert [str(w.message) for w in t_warn] == [str(w.message) for w in r_warn]
    assert "upgrading spec from version 2 to 4" in str(t_warn[0].message)
    assert port.to_dict() == ref.to_dict()
    assert port.version == tapi.SPEC_VERSION == rapi.SPEC_VERSION == 4


def test_randomized_specs_round_trip():
    rng = np.random.default_rng(7)
    for _ in range(60):
        n = int(rng.integers(1, 20))
        spec = tapi.PipelineSpec(
            source=tapi.SourceSpec(num_slices=n, lines_per_slice=int(rng.integers(1, 40)),
                                   points_per_line=int(rng.integers(1, 40)),
                                   observations=int(rng.integers(1, 1000)),
                                   seed=int(rng.integers(0, 2**31)),
                                   throttle_mb_s=None if rng.random() < 0.5
                                   else float(rng.uniform(0.1, 1e3))),
            method=tapi.MethodSpec(name=str(rng.choice(METHODS)),
                                   group_tol=float(10.0 ** rng.uniform(-9, 2)),
                                   rep_bucket=int(rng.integers(1, 512)),
                                   sampler=str(rng.choice(SAMPLERS))),
            compute=tapi.ComputeSpec(num_bins=int(rng.integers(2, 128)),
                                     window_lines=int(rng.integers(1, 50)),
                                     fit_backend=str(rng.choice(["reference", "kernels",
                                                                 "fused"]))),
            execution=tapi.ExecSpec(shards=int(rng.integers(1, 5)),
                                    prefetch=bool(rng.random() < 0.5)))
        back = tapi.PipelineSpec.from_json(spec.to_json())
        assert back == spec and back.content_hash() == spec.content_hash()
        assert _ref(spec).to_dict() == spec.to_dict()


# -- the content hash, field by field -------------------------------------------

# A valid value other than the default, where the generic rule below cannot
# find one; companions other fields need for the value to validate.
SPECIAL = {
    ("source", "kind"): "external",
    ("source", "throttle_mb_s"): 50.0,
    ("method", "error_bound"): 1.0,
    ("method", "tree"): tapi.TreeSpec(depth=5),
    ("method.tree", "train_slices"): (0, 1),
    ("compute", "types"): rd.TYPES_10,
    ("execution", "slices"): (0,),
    ("execution", "shard"): 0,
    ("execution", "placement"): tapi.PlacementSpec(redeal=False),
    ("execution.placement", "coordinator"): "127.0.0.1:12724",
    ("execution.placement", "shard_devices"): (0,),
}
COMPANIONS = {
    ("execution", "resume"): {"execution": {"out_dir": "o"}},
    ("execution", "cache_max_bytes"): {"execution": {"cache_dir": "c"}},
    ("execution.placement", "num_processes"): {"execution": {"out_dir": "o"}},
}


def _other_value(path, f):
    if (path, f.name) in SPECIAL:
        return SPECIAL[(path, f.name)]
    v, meta = f.default, f.metadata
    if meta.get("choices"):
        return next(c for c in meta["choices"] if c != v)
    if meta["type"] is bool:
        return not v
    if v is None:
        return {int: 1, float: 1.0, str: "x"}[meta["type"]]
    if meta["type"] is int:
        return v + 1
    if meta["type"] is float:
        return v * 2 if v else 1.0
    raise AssertionError(f"no other value for {path}.{f.name}")


def _with(spec, path, **changes):
    """``spec`` with ``changes`` applied to the (possibly nested) section at
    ``path``."""
    head, _, rest = path.partition(".")
    sub = getattr(spec, head)
    if rest:
        inner = _with(sub, rest, **changes)
        return dataclasses.replace(spec, **{head: inner})
    return dataclasses.replace(spec, **{head: dataclasses.replace(sub, **changes)})


FIELD_CASES = [(path, f) for path, cls, _ in tspec._GROUPS for f in dataclasses.fields(cls)
               if (path, f.name) not in (("source", "path"), ("source", "layout"))]


@pytest.mark.parametrize("path,f", FIELD_CASES, ids=[f"{p}.{f.name}" for p, f in FIELD_CASES])
def test_each_field_moves_the_hash_as_in_reference_and_as_tagged(path, f):
    base = tapi.PipelineSpec()
    for sec, kw in COMPANIONS.get((path, f.name), {}).items():
        base = _with(base, sec, **kw)
    changed = _with(base, path, **{f.name: _other_value(path, f)})
    assert changed != base
    port_moved = changed.content_hash() != base.content_hash()
    ref_moved = _ref(changed).content_hash() != _ref(base).content_hash()
    assert port_moved == ref_moved == f.metadata["hashed"]
    assert changed.content_hash() != _ref(changed).content_hash()


def test_file_source_hashes_by_manifest_not_location(tmp_path):
    """``source.path`` and ``layout`` (the one layout there is) stay out of
    both packages' hashes: a cube moved elsewhere keeps its hash, and the
    manifest's content sha is what keys it."""
    f = {f.name: f for f in dataclasses.fields(tapi.SourceSpec)}
    assert not f["path"].metadata["hashed"] and not f["layout"].metadata["hashed"]
    assert tspec.HASH_EXCLUDED_FIELDS == rspec.HASH_EXCLUDED_FIELDS
    assert tspec.FILE_LAYOUTS == rspec.FILE_LAYOUTS == ("chunked",)
    a = t_fs.export_cube(SMALL_SOURCE, tmp_path / "a", lines_per_chunk=4)
    shutil.copytree(a.path, tmp_path / "b")
    b = dataclasses.replace(a, path=str(tmp_path / "b"))
    other = t_fs.export_cube(dataclasses.replace(SMALL_SOURCE, seed=5), tmp_path / "c",
                             lines_per_chunk=4)
    specs = [tapi.PipelineSpec(source=s) for s in (a, b, other)]
    port = [s.content_hash() for s in specs]
    ref = [_ref(s).content_hash() for s in specs]
    assert port[0] == port[1] != port[2] and ref[0] == ref[1] != ref[2]
    assert not set(port) & set(ref)


def test_hash_impl_enters_the_payload_not_the_json():
    spec = tapi.PipelineSpec()
    assert tapi.HASH_IMPL == "repro_torch" and "impl" not in spec.to_dict()
    assert tspec.HASHED_SECTIONS == rspec.HASHED_SECTIONS
    staged = dataclasses.replace(spec, execution=tapi.ExecSpec(prefetch=False, shards=4),
                                 serve=tapi.ServeSpec(coalesce=False))
    assert staged.content_hash() == spec.content_hash()


# -- the CLI ---------------------------------------------------------------------


ARGVS = [
    [],
    ["--method", "grouping_ml", "--types", "10", "--group-tol", "1e-4", "--window-lines", "9",
     "--tree-depth", "6", "--slices", "0", "2", "--serial"],
    ["--kind", "file", "--source-path", "/data/cube", "--cache-dir", "/tmp/rc",
     "--cache-max-bytes", "1000", "--no-speculate", "--serve-max-batch-windows", "8",
     "--no-serve-coalesce", "--stream-update-mode", "strict", "--shard-devices", "0", "1",
     "--fault-plan", "p.json", "--types", "normal", "gamma"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["empty", "method", "exec_serve_stream"])
def test_same_argv_same_spec(argv):
    def parse(mod, base):
        ap = argparse.ArgumentParser()
        mod.add_spec_args(ap)
        args = ap.parse_args(argv)
        return mod.spec_from_args(args, base=base), mod.explicit_fields(args)

    t, t_fields = parse(tcli, tapi.PipelineSpec(compute=tapi.ComputeSpec(num_bins=20)))
    r, r_fields = parse(rcli, rapi.PipelineSpec(compute=rapi.ComputeSpec(num_bins=20)))
    assert t.to_dict() == r.to_dict() and t_fields == r_fields


def test_cli_spec_file_and_overrides(tmp_path):
    spec = tapi.PipelineSpec(source=SMALL_SOURCE, method=tapi.MethodSpec(name="reuse"),
                             compute=tapi.ComputeSpec(num_bins=24))
    f = tmp_path / "spec.json"
    f.write_text(spec.to_json())
    ap = argparse.ArgumentParser()
    tcli.add_spec_args(ap)
    assert tcli.spec_from_args(ap.parse_args(["--spec", str(f)])) == spec
    over = tcli.spec_from_args(ap.parse_args(["--spec", str(f), "--method", "baseline"]))
    assert over.method.name == "baseline"


def _rows(doc: str) -> list:
    """Every section heading and table row of a rendered reference, without
    the description column."""
    out = []
    for line in doc.splitlines():
        if line.startswith("## "):
            out.append(line)
        elif line.startswith("| `"):
            out.append(line.split(" | ")[:-1])
    return out


def test_rendered_reference_lists_the_reference_fields():
    port, ref = tcli.render_spec_reference(), rcli.render_spec_reference()
    assert _rows(port) == _rows(ref) and len(_rows(port)) > 60
    out = subprocess.run([sys.executable, "-m", "repro_torch.api.cli", "--doc"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout == port


# -- validation and live sources ------------------------------------------------


@pytest.mark.parametrize("build", [
    lambda: tapi.ComputeSpec(num_bins=1),
    lambda: tapi.ComputeSpec(types=("nope",)),
    lambda: tapi.ComputeSpec(mode="turbo"),
    lambda: tapi.MethodSpec(name="magic"),
    lambda: tapi.MethodSpec(error_bound=0.0),
    lambda: tapi.MethodSpec(sample_frac=1.5),
    lambda: tapi.TreeSpec(train_slices=()),
    lambda: tapi.SourceSpec(kind="parquet"),
    lambda: tapi.SourceSpec(kind="file"),
    lambda: tapi.SourceSpec(throttle_mb_s=0.0),
    lambda: tapi.ExecSpec(shard=2, shards=2),
    lambda: tapi.ExecSpec(resume=True),
    lambda: tapi.ExecSpec(cache_max_bytes=10),
    lambda: tapi.PlacementSpec(coordinator="nohost"),
    lambda: tapi.ServeSpec(max_batch_windows=0),
    lambda: tapi.StreamSpec(update_mode="lazy"),
    lambda: tapi.PipelineSpec(version=99),
    lambda: tapi.PipelineSpec(source=tapi.SourceSpec(num_slices=2),
                              execution=tapi.ExecSpec(slices=(5,))),
])
def test_invalid_specs_rejected_at_construction(build):
    with pytest.raises(ValueError):
        build()


def test_from_json_rejects_unknown_keys():
    payload = tapi.PipelineSpec().to_dict()
    payload["method"]["group_tolerance"] = 1e-3
    with pytest.raises(ValueError, match="unknown spec.method keys"):
        tapi.PipelineSpec.from_dict(payload)


def test_source_spec_describes_and_rebuilds_the_simulation():
    sim = tapi.build_source(SMALL_SOURCE)
    assert tapi.source_spec_for(sim) == SMALL_SOURCE
    from repro_torch.data.loader import ThrottledSource

    throttled = tapi.source_spec_for(ThrottledSource(sim, 25e6))
    assert throttled == dataclasses.replace(SMALL_SOURCE, throttle_mb_s=25.0)
    w = Window(2, 0, 3)
    np.testing.assert_array_equal(tapi.build_source(throttled).load_window(w), sim.load_window(w))
    np.testing.assert_array_equal(sim.load_window(w), rapi.build_source(
        rapi.SourceSpec(**dataclasses.asdict(SMALL_SOURCE))).load_window(r_regions.Window(2, 0, 3)))
    with pytest.raises(ValueError, match="external"):
        tapi.build_source(tapi.SourceSpec(kind="external"))


# -- sessions: the port against itself --------------------------------------------


@pytest.mark.parametrize("method", ["baseline", "grouping", "reuse"])
def test_session_matches_pdfcomputer_bitwise(method):
    spec = _spec(method)
    sim = tapi.build_source(spec.source)
    comp = tp.PDFComputer(spec.pdf_config(), sim, device="cpu")
    want = comp.run_slice(2)
    got = tapi.PDFSession(spec, device="cpu").run_all([2])[2]
    _bitwise(want, got)
    assert comp.spec.content_hash() == want.spec_hash == got.spec_hash == spec.content_hash()
    assert not got.cached and not want.cached


def test_session_streams_slices_in_order_and_reports():
    spec = _spec(slices=(3, 1, 2), shards=2)
    session = tapi.PDFSession(spec, device="cpu")
    # dealt round-robin: shard 0 runs slices 3 and 2, then shard 1 slice 1
    assert [r.slice_i for r in session.run()] == [3, 2, 1]
    rep = session.report()
    assert rep.slices_done == 3 and rep.windows == 9 and rep.spec_hash == spec.content_hash()
    assert set(rep.shard_reports) == {0, 1}
    assert rep.traces == 0 and rep.compiles == rep.compile_cache_hits + rep.compile_cache_misses
    assert set(rep.stage_percentiles) >= {"load", "compute"}


def test_sampling_session_trains_its_tree_on_the_session_device():
    spec = tapi.PipelineSpec(
        source=SMALL_SOURCE, method=tapi.MethodSpec(name="sampling", sample_frac=0.25,
                                                    sample_seed=3),
        compute=tapi.ComputeSpec(window_lines=3))
    session = tapi.PDFSession(spec, device="cpu")
    res = session.run_all([2])[2]
    assert session.tree is not None
    mask = res.type_idx >= 0
    assert 0.2 <= mask.mean() <= 0.3 and res.avg_error == 0.0
    assert (res.mean[~mask] == 0).all()
    again = tapi.PDFSession(spec, device="cpu", tree=session.tree).run_all([2])[2]
    _bitwise(res, again)


def test_watermark_and_npz_carry_the_port_hash(tmp_path):
    out = tmp_path / "ckpt"
    spec = _spec(out_dir=str(out))
    tapi.PDFSession(spec, device="cpu").run_all([2])
    mark = json.loads((out / "slice2_watermark.json").read_text())
    assert mark["spec_hash"] == spec.content_hash() != _ref(spec).content_hash()
    z = np.load(next(out.glob("slice2_window_*.npz")))
    assert str(z["spec_hash"]) == spec.content_hash()
    res = tapi.PDFSession(spec, device="cpu").run_all([2], resume=True)[2]
    assert res.stats == []


def test_port_refuses_to_resume_a_reference_out_dir(tmp_path):
    """The same spec persisted by the reference: its watermark's hash is
    not the port's, so a port resume is refused, never mixed in."""
    out = str(tmp_path / "ckpt")
    spec = _spec("grouping", out_dir=out)
    rapi.PDFSession(_ref(spec)).run_all([2])
    with pytest.raises(ValueError, match="resume mismatch"):
        tapi.PDFSession(spec, device="cpu").run_all([2], resume=True)


def test_session_without_a_device_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.PDFSession(_spec())


# -- cluster knobs, sidecars and merges: accepted, and as the reference -------------


@pytest.mark.parametrize("exec_kw", [
    dict(out_dir="o", placement=tapi.PlacementSpec(num_processes=2)),
    dict(placement=tapi.PlacementSpec(process_id=0)),
    dict(compile_cache_dir="cc"),
], ids=["num_processes", "process_id", "compile_cache_dir"])
def test_cluster_knobs_are_refused(exec_kw, tmp_path, monkeypatch):
    """Once refused, now run: a session with a placement or a kernel cache
    directory computes slice 2 bitwise as one without, and matches the
    reference's session under the parity rules. The cache directory
    ``<dir>/<spec_hash>`` becomes the build directory, and nothing builds
    on the CPU."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    exec_kw = {k: (str(tmp_path / v) if k in ("out_dir", "compile_cache_dir") else v)
               for k, v in exec_kw.items()}
    spec = _spec("grouping", **exec_kw)
    session = tapi.PDFSession(spec, device="cpu")
    got = session.run_all([2])[2]
    _bitwise(got, tapi.PDFSession(_spec("grouping"), device="cpu").run_all([2])[2])
    ref = rapi.PDFSession(_ref(_spec("grouping"))).run_all([2])[2]
    for name in ("mean", "std", "skew", "kurt"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), **MOM_TOL)
    rep = session.report()
    assert rep.new_compilations == rep.compile_cache_misses == 0
    if "compile_cache_dir" in exec_kw:
        assert _build.BUILD_DIR == tmp_path / "cc" / session.spec_hash
        assert _build.BUILD_DIR.is_dir()


def test_persist_stats_is_refused(tmp_path):
    """Once refused, now written: with an ``out_dir`` the session writes a
    sufficient-statistic sidecar a window, equal to the reference's; without
    one neither package writes any."""
    from repro.streaming import stats as r_stats
    from repro_torch.streaming import stats as t_stats

    spec = dataclasses.replace(_spec(out_dir=str(tmp_path / "t")),
                               stream=tapi.StreamSpec(persist_stats=True))
    tapi.PDFSession(spec, device="cpu").run_all([1])
    rspec = _ref(spec)
    rspec = dataclasses.replace(rspec, execution=dataclasses.replace(
        rspec.execution, out_dir=str(tmp_path / "r")))
    rapi.PDFSession(rspec).run_all([1])
    starts = (0, 5, 10)
    assert sorted(p.name for p in (tmp_path / "t").glob("slice1_stats_*.npz")) == \
        [f"slice1_stats_{s:05d}.npz" for s in starts]
    for s in starts:
        a = t_stats.load_stats(tmp_path / "t", 1, s)
        b = r_stats.load_stats(tmp_path / "r", 1, s)
        np.testing.assert_array_equal(a["freq"], b["freq"])
        for fa, fb in zip(a["stats"], b["stats"]):
            np.testing.assert_array_equal(fa, fb)
    no_out = tapi.PDFSession(dataclasses.replace(spec, execution=tapi.ExecSpec()), device="cpu")
    assert no_out.executor(0).stats_recorder is None


def test_shard_devices_need_cuda_devices():
    spec = _spec(placement=tapi.PlacementSpec(shard_devices=(0,)))
    with pytest.raises(ValueError, match="shard_devices"):
        tapi.PDFSession(spec, device="cpu")


def test_merge_update_raises_where_the_reference_merges(tmp_path):
    """Once a refusal, now a merge: a reference run with sidecars over a
    file cube, then an append inside every point's range. The port merges
    the slice forward from the reference's sidecars, as the reference
    would (counts exact, moments and errors at the parity tolerances,
    ``type_idx`` equal outside ties), without an executor; with no prior
    run, in strict mode, or past a sidecar-free out_dir it recomputes."""
    from repro.streaming import append_realizations

    src = tapi.SourceSpec(num_slices=2, lines_per_slice=10, points_per_line=8, observations=60)
    cube = t_fs.export_cube(src, tmp_path / "cube", lines_per_chunk=5)
    out = str(tmp_path / "out")
    spec = tapi.PipelineSpec(source=cube, compute=tapi.ComputeSpec(window_lines=5),
                             execution=tapi.ExecSpec(out_dir=out, slices=(1,)))
    # no prior run: nothing to merge, the slice computes
    fresh = tapi.PDFSession(dataclasses.replace(
        spec, execution=tapi.ExecSpec(out_dir=str(tmp_path / "fresh"), slices=(1,))),
        device="cpu").run_all()[1]
    rapi.PDFSession(dataclasses.replace(_ref(spec), stream=rapi.StreamSpec(
        persist_stats=True))).run_all()
    shutil.copytree(out, tmp_path / "ref_out")
    obs = t_fs.FileCubeSource(cube.path).load_window(Window(1, 0, 10))
    append_realizations(cube.path, {1: obs[:, :3].reshape(10, 8, 3)})
    rspec = dataclasses.replace(_ref(spec), execution=rapi.ExecSpec(
        out_dir=str(tmp_path / "ref_out"), slices=(1,)))
    want = rapi.PDFSession(rspec).run_all()[1]
    session = tapi.PDFSession(spec, device="cpu")
    got = session.run_all()[1]
    assert session.report().slices_merged == 1 and not session._executors
    for name in ("mean", "std", "skew", "kurt"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), **MOM_TOL)
    same = got.type_idx == want.type_idx
    assert same.mean() > 0.9
    np.testing.assert_allclose(got.error[same], want.error[same], **ERR_TOL)
    for w0 in (0, 5):
        a = np.load(Path(out) / f"slice1_stats_{w0:05d}.npz")
        b = np.load(tmp_path / "ref_out" / f"slice1_stats_{w0:05d}.npz")
        np.testing.assert_array_equal(a["freq"], b["freq"])
    strict = dataclasses.replace(spec, stream=tapi.StreamSpec(update_mode="strict"))
    res = tapi.PDFSession(strict, device="cpu").run_all()[1]
    assert len(res.stats) == 2 and not np.array_equal(res.mean, fresh.mean)
    for f in Path(out).glob("slice1_stats_*.npz"):
        f.unlink()
    assert len(tapi.PDFSession(spec, device="cpu").run_all()[1].stats) == 2


# -- sessions: the port against the reference ---------------------------------------


@pytest.fixture(scope="module")
def reference_errors():
    """The reference's per-type Eq.-5 errors per slice, for the tie rule."""
    src = rapi.build_source(_ref(_spec()).source)
    out = {}
    for s in SLICES:
        v = jnp.asarray(np.concatenate([
            src.load_window(w) for w in r_regions.iter_windows(src.geometry, s, WINDOW_LINES)]))
        m = rfp.moments(v, 64)
        out[s] = np.asarray(rfp.fit_errors(v, m, rd.fit_all(rd.TYPES_4, m), rd.TYPES_4, 64))
    return out


def _assert_parity(ref, errs, got):
    """The ROADMAP's parity rules for one slice."""
    for name in ("mean", "std", "skew", "kurt"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), **MOM_TOL,
                                   err_msg=name)
    e = np.where(np.isfinite(errs), errs, 1e30)
    srt = np.sort(e, axis=1)
    tol = ERR_TOL["atol"] + ERR_TOL["rtol"] * srt[:, 0]
    clear = srt[:, 1] - srt[:, 0] > tol
    np.testing.assert_array_equal(got.type_idx[clear], ref.type_idx[clear])
    picked = np.take_along_axis(e, got.type_idx[:, None].astype(np.int64), axis=1)[:, 0]
    assert (picked - srt[:, 0] <= tol).all()
    same = got.type_idx == ref.type_idx
    np.testing.assert_allclose(got.params[same], ref.params[same], **MOM_TOL)
    np.testing.assert_allclose(got.error[same], ref.error[same], **ERR_TOL)
    assert abs(got.avg_error - ref.avg_error) <= ERR_TOL["atol"]


@pytest.mark.parametrize("method", ["baseline", "grouping", "reuse"])
def test_session_matches_reference_session(reference_errors, method):
    spec = _spec(method, slices=SLICES)
    ref = rapi.PDFSession(_ref(spec)).run_all()
    got = tapi.PDFSession(spec, device="cpu").run_all()
    assert sorted(got) == sorted(ref) == list(SLICES)
    for s in SLICES:
        _assert_parity(ref[s], reference_errors[s], got[s])
        assert [(w.num_fitted, w.cache_hits) for w in got[s].stats] == \
            [(w.num_fitted, w.cache_hits) for w in ref[s].stats]
        assert got[s].spec_hash == spec.content_hash() != ref[s].spec_hash


def test_grouping_ml_session_follows_the_tree_margin_rule():
    spec = _spec("grouping_ml", slices=SLICES)
    r_session = rapi.PDFSession(_ref(spec))
    ref = r_session.run_all()
    tree = r_session.tree
    got = tapi.PDFSession(spec, device="cpu", tree=interop.tree_from_numpy(
        tree.depth, tree.feature, tree.threshold, tree.leaf_label)).run_all()
    decided = 0
    for s in SLICES:
        r, t = ref[s], got[s]
        for name in ("mean", "std", "skew", "kurt"):
            np.testing.assert_allclose(getattr(t, name), getattr(r, name), **MOM_TOL)
        feats = rex.tree_features_np(r.mean, r.std, r.skew, r.kurt)
        tol = tmlp.feature_tolerance(r.mean, r.std, r.skew, r.kurt, **MOM_TOL)
        reach = tmlp.reachable_leaves(tree, feats, tol)
        ok = reach.sum(1) == 1
        np.testing.assert_array_equal(t.type_idx[ok], r.type_idx[ok])
        assert (reach & (tree.leaf_label[None, :] == t.type_idx[:, None])).any(1).all()
        same = t.type_idx == r.type_idx
        np.testing.assert_allclose(t.params[same], r.params[same], **MOM_TOL)
        np.testing.assert_allclose(t.error[same], r.error[same], **ERR_TOL)
        assert [w.num_fitted for w in t.stats] == [w.num_fitted for w in r.stats]
        decided += int(ok.sum())
    assert decided >= MIN_DECIDED * len(SLICES) * spec.source.lines_per_slice * \
        spec.source.points_per_line


def test_pdf_config_bridges_match_reference():
    spec = _every_section_non_default()
    assert dataclasses.asdict(spec.pdf_config()) == dataclasses.asdict(_ref(spec).pdf_config())
    assert dataclasses.asdict(spec.exec_config()) == dataclasses.asdict(_ref(spec).exec_config())
    cfg = PDFConfig(method="grouping", num_bins=20, window_lines=5, group_tol=1e-4)
    port = tapi.spec_from_config(cfg)
    ref = rapi.spec_from_config(rex.PDFConfig(**dataclasses.asdict(cfg)))
    assert port.to_dict() == ref.to_dict()


def test_launchers_print_the_session_hash(tmp_path, capsys):
    from repro_torch.launch import run_pdf, serve_pdf

    spec = _spec("grouping", slices=(1,), cache_dir=str(tmp_path / "cache"))
    f = tmp_path / "spec.json"
    f.write_text(spec.to_json())
    for _ in range(2):  # the second run is served from the cache
        run_pdf.main(["--spec", str(f), "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count(f"[spec] hash={spec.content_hash()} ") == 2
    assert "[cache] hits=0 misses=1" in out and "[cache] hits=1 misses=0" in out
    assert "served from result cache" in out and "[compile] traces=0" in out
    st = serve_pdf.main(["--spec", str(f), "--device", "cpu", "--clients", "2",
                         "--repeats", "1", "--slices", "1", "2"])
    assert st.spec_hash == spec.content_hash() and st.queries == 2 * 2 + 1
