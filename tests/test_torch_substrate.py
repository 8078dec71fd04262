"""Port vs reference: the window substrate (regions, simulation, loader).

The same geometry and seed go through ``repro`` and ``repro_torch``; window
plans must be equal and generated windows bitwise equal."""

import threading

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import regions as r_regions
from repro.data import loader as r_loader
from repro.data import simulation as r_sim
from repro_torch.core import regions as t_regions
from repro_torch.data import loader as t_loader
from repro_torch.data import simulation as t_sim

SMALL = (2, 12, 30)  # (slices, lines, points per line): 12 lines -> ragged windows
SMALL_OBS = 200


def _sims(dims=SMALL, obs=SMALL_OBS, seed=0):
    r = r_sim.SeismicSimulation(r_sim.SimulationConfig(
        geometry=r_regions.CubeGeometry(*dims), num_simulations=obs, seed=seed))
    t = t_sim.SeismicSimulation(t_sim.SimulationConfig(
        geometry=t_regions.CubeGeometry(*dims), num_simulations=obs, seed=seed))
    return r, t


@pytest.mark.parametrize("dims,slices,window_lines,start", [
    ((2, 12, 30), [0, 1], 5, None),
    ((501, 501, 251), [201], 25, None),
    ((4, 501, 251), [3, 1], 25, {1: 400}),
    ((3, 7, 2), [2], 7, {2: 7}),
])
def test_build_plan_equal(dims, slices, window_lines, start):
    ref = r_regions.build_plan(r_regions.CubeGeometry(*dims), slices, window_lines, start)
    got = t_regions.build_plan(t_regions.CubeGeometry(*dims), slices, window_lines, start)
    assert [(tuple(u.window), u.seq, u.unit_id) for u in got.units] == \
        [(tuple(u.window), u.seq, u.unit_id) for u in ref.units]
    assert got.slices == ref.slices and len(got) == len(ref)
    assert t_regions.num_windows(got.geometry, window_lines) == \
        r_regions.num_windows(ref.geometry, window_lines)


def test_build_plan_rejects_out_of_range_slice():
    with pytest.raises(ValueError):
        t_regions.build_plan(t_regions.CubeGeometry(2, 12, 30), [2], 5)


@pytest.mark.parametrize("slice_i,line_start,line_end", [
    (0, 0, 5),    # a full window
    (1, 10, 12),  # the ragged last window of window_lines=5
    (1, 5, 10),
])
def test_load_window_bitwise(slice_i, line_start, line_end):
    r, t = _sims()
    want = r.load_window(r_regions.Window(slice_i, line_start, line_end))
    got = t.load_window(t_regions.Window(slice_i, line_start, line_end))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((line_end - line_start) * SMALL[2], SMALL_OBS)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("slice_i", range(4))
def test_true_type_index_equal(slice_i):
    r, t = _sims((4, 12, 30))
    assert t.true_type_index(slice_i) == r.true_type_index(slice_i)
    assert t.nominal_bytes() == r.nominal_bytes()


def test_array_data_source_equal():
    rng = np.random.default_rng(1)
    cube = rng.normal(size=(2, 6, 4, 9)).astype(np.float64)
    r, t = r_loader.ArrayDataSource(cube), t_loader.ArrayDataSource(cube)
    assert (t.geometry.num_slices, t.geometry.lines_per_slice, t.geometry.points_per_line) == \
        (r.geometry.num_slices, r.geometry.lines_per_slice, r.geometry.points_per_line)
    np.testing.assert_array_equal(
        t.load_window(t_regions.Window(1, 2, 5)), r.load_window(r_regions.Window(1, 2, 5)))
    with pytest.raises(ValueError):
        t_loader.ArrayDataSource(cube[0])


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_keeps_order(depth):
    items = list(range(20))
    pf = t_loader.WindowPrefetcher(items, lambda i: torch.full((2,), float(i)), depth=depth)
    try:
        got = [int(x[0]) for x in pf]
    finally:
        pf.close()
    assert got == items


def test_prefetcher_carries_errors():
    def stage(i):
        if i == 3:
            raise KeyError("window 3")
        return i

    pf = t_loader.WindowPrefetcher(range(6), stage, depth=2)
    seen = []
    try:
        with pytest.raises(t_loader.PrefetchError) as ei:
            for x in pf:
                seen.append(x)
    finally:
        pf.close()
    assert seen == [0, 1, 2]
    assert isinstance(ei.value.__cause__, KeyError)


def test_prefetcher_close_unblocks_a_full_queue():
    started = threading.Event()

    def stage(i):
        started.set()
        return i

    pf = t_loader.WindowPrefetcher(range(1000), stage, depth=1)
    assert started.wait(5.0)
    it = iter(pf)
    assert next(it) == 0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(ValueError):
        t_loader.WindowPrefetcher([], lambda i: i, depth=0)
