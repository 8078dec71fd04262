"""Port vs reference: file cubes (``data/file_source.py``).

A small seismic cube (4 slices of 12 lines x 30 points, 200 observations)
is exported by each package. The two formats are one: a cube exported by
either reads bitwise through the other's ``FileCubeSource``, and the same
data and chunking give the same ``content_sha256``. Within the port: a
slice run from the cube is bitwise equal to the slice run from the
simulation, with prefetch on and off and with verified reads."""

import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
pytest.importorskip("torch")

from repro.core import regions as r_regions
from repro.data import file_source as r_fs
from repro.data import simulation as r_sim
from repro_torch.core import executor as tex
from repro_torch.core import regions as t_regions
from repro_torch.data import file_source as t_fs
from repro_torch.data import simulation as t_sim
from repro_torch.data.loader import ThrottledSource

DIMS, OBS, WINDOW_LINES, LINES_PER_CHUNK = (4, 12, 30), 200, 5, 4


def _sim(mod, regions, seed=0):
    return mod.SeismicSimulation(mod.SimulationConfig(
        geometry=regions.CubeGeometry(*DIMS), num_simulations=OBS, seed=seed))


def _windows(geom, window_lines):
    return [w for s in range(geom.num_slices)
            for w in t_regions.iter_windows(geom, s, window_lines)]


@pytest.fixture(scope="module")
def cubes(tmp_path_factory):
    """The same simulation exported by the port and by the reference."""
    base = tmp_path_factory.mktemp("cubes")
    t_spec = t_fs.export_cube(_sim(t_sim, t_regions), base / "port",
                              lines_per_chunk=LINES_PER_CHUNK)
    r_spec = r_fs.export_cube(_sim(r_sim, r_regions), base / "ref",
                              lines_per_chunk=LINES_PER_CHUNK)
    assert (t_spec.kind, t_spec.path) == ("file", str(base / "port"))
    # the reference's returned spec, field for field but the path
    assert dataclasses.asdict(dataclasses.replace(t_spec, path=r_spec.path)) == \
        dataclasses.asdict(r_spec)
    t_path = Path(t_spec.path)
    return t_path, t_fs.manifest_sha(t_path), base / "ref"


def test_export_returns_path_and_content_sha(cubes):
    t_path, t_sha, _ = cubes
    assert t_sha == t_fs.manifest_sha(t_path) == t_fs.read_manifest(t_path)["content_sha256"]
    src = t_fs.FileCubeSource(t_path)
    assert src.content_sha256 == t_sha and src.version == 1
    assert src.geometry == t_regions.CubeGeometry(*DIMS) and src.num_observations == OBS
    assert src.nominal_bytes() == 4 * 12 * 30 * OBS * 4


def test_same_data_same_content_sha(cubes):
    """Both packages write the same manifest for the same data and
    chunking, so the data identity is one."""
    t_path, t_sha, r_path = cubes
    assert t_sha == r_fs.manifest_sha(r_path) == r_fs.manifest_sha(t_path)
    assert t_fs.read_manifest(t_path) == r_fs.read_manifest(r_path)
    assert (t_path / "manifest.json").read_bytes() == (r_path / "manifest.json").read_bytes()


@pytest.mark.parametrize("window_lines", [5, 3, 12, 1])
@pytest.mark.parametrize("verify", [False, True])
def test_cubes_cross_read_bitwise(cubes, window_lines, verify):
    """Every window of either package's cube, through either package's
    reader, bitwise equal to the simulation's ``load_window``."""
    t_path, _, r_path = cubes
    sim = _sim(t_sim, t_regions)
    readers = [t_fs.FileCubeSource(p, verify_reads=verify) for p in (t_path, r_path)] + \
              [r_fs.FileCubeSource(p, verify_reads=verify) for p in (t_path, r_path)]
    for w in _windows(sim.geometry, window_lines):
        want = sim.load_window(w)
        for rd in readers:
            got = rd.load_window(w)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_load_window_obs_and_bounds_match_reference(cubes):
    t_path, _, _ = cubes
    t, r = t_fs.FileCubeSource(t_path), r_fs.FileCubeSource(t_path)
    w = t_regions.Window(2, 3, 9)
    np.testing.assert_array_equal(t.load_window_obs(w, 17, 150),
                                  r.load_window_obs(r_regions.Window(2, 3, 9), 17, 150))
    for bad in (t_regions.Window(4, 0, 1), t_regions.Window(0, 5, 13), t_regions.Window(0, 3, 3)):
        with pytest.raises(ValueError, match="outside"):
            t.load_window(bad)
    with pytest.raises(ValueError, match="observation range"):
        t.load_window_obs(w, 0, OBS + 1)


def test_verify_catches_corrupt_chunk(cubes, tmp_path):
    t_path, _, _ = cubes
    bad = tmp_path / "bad"
    shutil.copytree(t_path, bad)
    chunk = bad / t_fs.read_manifest(bad)["chunks"][5]["file"]
    arr = np.load(chunk).copy()
    arr.flat[7] += 1.0
    np.save(chunk, arr)
    t_fs.FileCubeSource(t_path).verify()  # the pristine cube passes
    with pytest.raises(ValueError, match="corrupt after 2 read attempts"):
        t_fs.FileCubeSource(bad).verify()
    with pytest.raises(ValueError, match=str(chunk)):
        t_fs.FileCubeSource(bad, verify_reads=True).load_window(t_regions.Window(1, 0, 12))
    # an unverified read does not look: it returns the corrupt bytes
    t_fs.FileCubeSource(bad).load_window(t_regions.Window(1, 0, 12))


def test_verified_read_rereads_once(cubes):
    """The read hook sees attempt 1, then 2 after a mismatch; a torn first
    read heals."""
    t_path, _, _ = cubes
    seen = []

    def hook(slice_i, line_start, arr, attempt):
        seen.append((slice_i, line_start, attempt))
        if attempt == 1 and (slice_i, line_start) == (0, 4):
            arr = arr.copy()
            arr.flat[0] += 1.0
        return arr

    src = t_fs.FileCubeSource(t_path).enable_read_verification(read_hook=hook)
    np.testing.assert_array_equal(src.load_window(t_regions.Window(0, 3, 9)),
                                  _sim(t_sim, t_regions).load_window(t_regions.Window(0, 3, 9)))
    assert seen == [(0, 0, 1), (0, 4, 1), (0, 4, 2), (0, 8, 1)]


def test_manifest_with_coverage_gap_rejected(cubes, tmp_path):
    t_path, _, _ = cubes
    gappy = tmp_path / "gappy"
    shutil.copytree(t_path, gappy)
    m = json.loads((gappy / "manifest.json").read_text())
    m["chunks"] = [c for c in m["chunks"] if not (c["slice"] == 1 and c["line_start"] == 4)]
    (gappy / "manifest.json").write_text(json.dumps(m))
    for mod in (t_fs, r_fs):
        with pytest.raises(ValueError, match="does not cover slice 1"):
            mod.FileCubeSource(gappy)


def test_missing_or_foreign_manifest_is_refused(tmp_path):
    with pytest.raises(ValueError, match="export_cube"):
        t_fs.FileCubeSource(tmp_path)
    (tmp_path / "manifest.json").write_text(json.dumps({"format": "other"}))
    with pytest.raises(ValueError, match="not a repro-cube manifest"):
        t_fs.read_manifest(tmp_path)


def test_export_refuses_to_clobber_live_cube(tmp_path):
    d = tmp_path / "cube"
    t_fs.export_cube(_sim(t_sim, t_regions), d, lines_per_chunk=LINES_PER_CHUNK)
    sha = t_fs.manifest_sha(d)
    before = sorted(p.name for p in d.iterdir()), (d / "manifest.json").read_bytes()
    other = _sim(t_sim, t_regions, seed=99)
    with pytest.raises(FileExistsError, match="overwrite=True"):
        t_fs.export_cube(other, d, lines_per_chunk=LINES_PER_CHUNK)
    assert (sorted(p.name for p in d.iterdir()), (d / "manifest.json").read_bytes()) == before
    t_fs.export_cube(other, d, lines_per_chunk=LINES_PER_CHUNK, overwrite=True)
    sha2 = t_fs.manifest_sha(d)
    assert sha2 != sha
    with pytest.raises(ValueError, match="lines_per_chunk"):
        t_fs.export_cube(other, tmp_path / "x", lines_per_chunk=0)


def test_versioned_manifests_read_as_reference(tmp_path):
    """A format-2 cube (the reference's streaming append) reads in the
    port: versions, archived manifests, content shas, chunk diffs, the
    per-slice chunk fingerprint and the appended observations."""
    from repro.streaming import append_realizations

    d = tmp_path / "cube"
    t_fs.export_cube(_sim(t_sim, t_regions), d, lines_per_chunk=LINES_PER_CHUNK)
    sha1 = t_fs.manifest_sha(d)
    block = np.random.default_rng(0).normal(3000.0, 10.0, (12, 30, 3)).astype(np.float32)
    assert append_realizations(d, {2: block}) == 2
    assert t_fs.manifest_version(d) == 2
    assert t_fs.manifest_sha(d, version=1) == sha1 != t_fs.manifest_sha(d)
    assert t_fs.manifest_sha(d) == r_fs.manifest_sha(d)
    assert t_fs.chunk_diff(d, 1) == r_fs.chunk_diff(d, 1)
    assert t_fs.chunk_diff(d, 1)["changed_slices"] == [2]
    m = t_fs.read_manifest(d)
    for s in range(4):
        assert t_fs.slice_chunk_shas(m, s) == r_fs.slice_chunk_shas(m, s)
    with pytest.raises(ValueError, match="no version 7"):
        t_fs.read_manifest(d, version=7)
    src, ref = t_fs.FileCubeSource(d), r_fs.FileCubeSource(d)
    assert src.slice_observations(2) == OBS + 3 and src.slice_observations(1) == OBS
    w = t_regions.Window(2, 0, 5)
    got = src.load_window(w)
    np.testing.assert_array_equal(got, ref.load_window(r_regions.Window(2, 0, 5)))
    np.testing.assert_array_equal(got[:, OBS:], block[:5].reshape(-1, 3))
    np.testing.assert_array_equal(src.load_window_obs(w, OBS, OBS + 3), block[:5].reshape(-1, 3))
    old = t_fs.FileCubeSource(d, version=1)
    assert old.slice_observations(2) == OBS and old.content_sha256 == sha1


def _run(source, **exec_kw):
    cfg = tex.PDFConfig(window_lines=WINDOW_LINES, method="grouping")
    ex = tex.StagedExecutor(cfg, source, "cpu", exec_config=tex.ExecutorConfig(**exec_kw))
    return ex.run(t_regions.build_plan(source.geometry, [0, 1, 2, 3], WINDOW_LINES)), ex


@pytest.mark.parametrize("exec_kw", [dict(), dict(prefetch=False, async_persist=False),
                                     dict(prefetch_depth=1)])
@pytest.mark.parametrize("verify", [False, True])
def test_slices_from_cube_bitwise_equal_simulation(cubes, exec_kw, verify):
    t_path, _, r_path = cubes
    want, _ = _run(_sim(t_sim, t_regions))
    for path in (t_path, r_path):
        got, ex = _run(t_fs.FileCubeSource(path, verify_reads=verify), **exec_kw)
        for s in range(4):
            for f in tex.RESULT_FIELDS:
                np.testing.assert_array_equal(getattr(got[s], f), getattr(want[s], f), err_msg=f)
            assert [w.num_fitted for w in got[s].stats] == [w.num_fitted for w in want[s].stats]
        assert ex.last_report.units == 12


def test_throttled_file_source(cubes):
    """ThrottledSource over the cube: the same bytes, no earlier than
    nbytes / bandwidth (a lower bound only; no upper bound is asserted)."""
    import time

    t_path, _, _ = cubes
    src = t_fs.FileCubeSource(t_path)
    slow = ThrottledSource(src, bandwidth_bytes_per_s=24e6)
    assert slow.geometry == src.geometry
    w = t_regions.Window(1, 0, 10)
    t0 = time.perf_counter()
    got = slow.load_window(w)
    assert time.perf_counter() - t0 >= got.nbytes / 24e6
    np.testing.assert_array_equal(got, src.load_window(w))
    with pytest.raises(ValueError, match="bandwidth"):
        ThrottledSource(src, 0)


def test_export_takes_a_source_spec(tmp_path):
    """A simulation ``SourceSpec`` is materialized with its throttle
    stripped; the returned file spec carries the throttle back, and the
    cube is the one the reference exports from the same spec."""
    from repro.api import SourceSpec as RSourceSpec
    from repro_torch.api import SourceSpec, build_source

    src = SourceSpec(num_slices=2, lines_per_slice=7, points_per_line=9, observations=50,
                     throttle_mb_s=500.0)
    got = t_fs.export_cube(src, tmp_path / "port", lines_per_chunk=LINES_PER_CHUNK)
    ref = r_fs.export_cube(RSourceSpec(**dataclasses.asdict(src)), tmp_path / "ref",
                           lines_per_chunk=LINES_PER_CHUNK)
    assert got.kind == "file" and got.throttle_mb_s == 500.0
    assert dataclasses.asdict(dataclasses.replace(got, path=ref.path)) == dataclasses.asdict(ref)
    assert t_fs.manifest_sha(got.path) == r_fs.manifest_sha(ref.path)
    cube = build_source(got)
    assert isinstance(cube, ThrottledSource) and cube.bandwidth == 500e6
    w = t_regions.Window(1, 3, 7)
    np.testing.assert_array_equal(cube.load_window(w), build_source(dataclasses.replace(
        src, throttle_mb_s=None)).load_window(w))
