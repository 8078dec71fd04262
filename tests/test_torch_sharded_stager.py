"""``data.loader.ShardedStager`` across ranks and the executor's
``run_window_sharded``: a window's points split over the ranks of a mesh,
each rank staging its block of the padded rows onto its own device and
fitting them (K1 and K2 on the card, their plain versions here), the
results gathered back on the host.

The fit is row by row, so the split window's results are bitwise the
one-rank window's (ROADMAP item 19's contract): held here on a reduced
Set1 geometry (windows of 5 lines x 31 points = 155 points, an odd count
that 2 and 4 ranks must pad, 200 observations) in gloo worlds of 2 and 4
ranks, split over ``data`` and, on a 2x2 mesh, over both axes."""

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M

TIMEOUT = 300
GEOMETRY = (4, 10, 31)  # slices, lines per slice, points per line
WINDOW_LINES = 5


def stager_world(rank, world_size, meshes):
    from repro_torch.core import regions
    from repro_torch.core.executor import PDFConfig, StagedExecutor
    from repro_torch.data.loader import ShardedStager
    from repro_torch.data.simulation import SeismicSimulation, SimulationConfig

    sim = SeismicSimulation(SimulationConfig(geometry=regions.CubeGeometry(*GEOMETRY),
                                             num_simulations=200))
    out = {}
    for method in ("baseline", "ml") if world_size == 2 else ("baseline",):
        tree = None
        if method == "ml":
            from repro_torch.core.pipeline import train_type_tree

            tree = train_type_tree(sim, window_lines=WINDOW_LINES, device="cpu")
        ex = StagedExecutor(PDFConfig(method=method, window_lines=WINDOW_LINES), sim, "cpu",
                            tree=tree)
        for shape, axes in meshes:
            dm = M.device_mesh(M.make_mesh(shape, ("data", "model")), "cpu")
            sharded = ShardedStager(ex.stager, mesh=dm, axes=axes)
            for w in regions.iter_windows(sim.geometry, 1, WINDOW_LINES):
                got = ex.run_window_sharded(w, sharded)
                want = ex.run_window(w)
                staged, valid = sharded.stage(sim.load_window(w))
                out[(method, shape, axes, w.line_start)] = (
                    [np.asarray(getattr(got, f)) for f in ("type_idx", "params", "error", "mean")],
                    [np.asarray(getattr(want, f)) for f in ("type_idx", "params", "error", "mean")],
                    tuple(staged.values.shape), valid, sharded.divisor)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    meshes = {2: [((2, 1), ("data",))],
              4: [((4, 1), ("data",)), ((2, 2), ("data", "model"))]}
    return {n: M.run_world(stager_world, n, "gloo", tmp_path_factory.mktemp(f"world{n}"),
                           args=(meshes[n],), timeout=TIMEOUT) for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_split_window_is_bitwise_the_one_rank_window(worlds, n):
    points = WINDOW_LINES * GEOMETRY[2]
    cases = 0
    for rank_out in worlds[n]:
        for (method, shape, axes, line), (got, want, staged, valid, divisor) in rank_out.items():
            assert divisor == n and valid == points
            assert staged == (-(-points // n), 200)  # this rank's block of the padded rows
            for g, w in zip(got, want):
                assert g.shape == w.shape and np.array_equal(g, w, equal_nan=True), (method, line)
            cases += 1
    assert cases == {2: 2 * 2 * 2, 4: 4 * 2 * 2}[n]


def test_stager_without_a_mesh_pads_and_stages_whole():
    from repro_torch.data.loader import ShardedStager, WindowStager

    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    staged, valid = ShardedStager(WindowStager("cpu"), divisor=4).stage(x)
    assert valid == 5 and staged.values.shape == (8, 6)
    assert torch.equal(staged.values[5:], torch.from_numpy(np.repeat(x[-1:], 3, axis=0)))
    assert [a.tolist() for a in ShardedStager(WindowStager("cpu")).gather([x[:, 0]], 3)] == [[0, 6, 12]]


def test_split_refuses_methods_that_group_over_the_window():
    from repro_torch.core import regions
    from repro_torch.core.executor import PDFConfig, StagedExecutor
    from repro_torch.data.loader import ShardedStager
    from repro_torch.data.simulation import SeismicSimulation, SimulationConfig

    sim = SeismicSimulation(SimulationConfig(geometry=regions.CubeGeometry(*GEOMETRY),
                                             num_simulations=50))
    ex = StagedExecutor(PDFConfig(method="grouping", window_lines=WINDOW_LINES), sim, "cpu")
    with pytest.raises(ValueError, match="groups"):
        ex.run_window_sharded(regions.Window(0, 0, 5), ShardedStager(ex.stager))
