"""``repro_torch.launch.mesh``'s worlds and meshes, and the collectives
ported with them: ``optim.pod_allreduce_compressed``,
``core.grouping.group_device_global`` and ``launch.pipeline_pp``.

Each reference function runs in a subprocess with forced host devices, as
``tests/test_mesh_multidevice.py`` runs it, and writes its outputs to an
``.npz``; the port runs in a gloo world of as many ranks through
``run_world`` on the same numpy inputs (seeded). Tolerances are the
reference's own (``tests/test_mesh_multidevice.py``): the compressed
all-reduce within 1e-6 of the reference's output and within atol 0.05 of
the mean (l.100-101), the pipeline within atol 1e-5 of the unpipelined
chain (l.166), global grouping bitwise (l.107-146). Every world and
subprocess has its own timeout."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as M

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300


def run_reference(code: str, devices: int, out: Path) -> dict:
    """Runs ``code`` (which writes ``sys.argv[1]``, an .npz) in a subprocess
    that sees ``devices`` host devices; returns the arrays."""
    env = {**os.environ, "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}",
           "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), str(out)], env=env,
                       capture_output=True, text=True, timeout=TIMEOUT, stdin=subprocess.DEVNULL)
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(out))


# -- the same inputs for both packages ------------------------------------------------


def allreduce_input(n):
    return np.random.default_rng(0).normal(size=(n, 128)).astype(np.float32)


def grouping_keys():
    return np.random.default_rng(0).integers(0, 5, size=(32, 2)).astype(np.int64)


def pipeline_inputs(n):
    rng = np.random.default_rng(1)
    ws = [(rng.normal(size=(16, 16)) * 0.3).astype(np.float32) for _ in range(n)]
    x = rng.normal(size=(8, 4, 16)).astype(np.float32)  # (microbatches, b, d)
    return ws, x


REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.core import grouping as grp
from repro.launch.mesh import make_mesh
from repro.launch.pipeline_pp import pipelined_forward
from repro.optim import pod_allreduce_compressed

out = {}
for n in (2, 4):
    x = np.random.default_rng(0).normal(size=(n, 128)).astype(np.float32)
    mesh = make_mesh((n,), ("pod",))
    f = jax.jit(shard_map(lambda v: pod_allreduce_compressed(v[0], "pod")[None],
                          mesh=mesh, in_specs=P("pod"), out_specs=P("pod")))
    out[f"allreduce{n}"] = np.asarray(f(jnp.asarray(x)))

    rng = np.random.default_rng(1)
    ws = [jnp.asarray((rng.normal(size=(16, 16)) * 0.3).astype(np.float32)) for _ in range(n)]
    xs = jnp.asarray(rng.normal(size=(8, 4, 16)).astype(np.float32))
    out[f"pipeline{n}"] = np.asarray(pipelined_forward(make_mesh((n,), ("stage",)), "stage", ws, xs))

mesh = make_mesh((4,), ("data",))
keys = np.random.default_rng(0).integers(0, 5, size=(32, 2)).astype(np.int32)

def shard_fn(k):
    g = grp.group_device_global(k, ("data",))
    return g.rep_for_point, g.is_rep, g.num_groups[None], g.num_groups_local[None]

f = jax.jit(shard_map(shard_fn, mesh=mesh, in_specs=P("data"),
                      out_specs=(P("data"), P("data"), P("data"), P("data"))))
for name, v in zip(("rep", "is_rep", "num_groups", "num_groups_local"), f(jnp.asarray(keys))):
    out[f"grouping_{name}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(REFERENCE, 4, tmp_path_factory.mktemp("ref") / "out.npz")


def collectives_world(rank, world_size):
    """One rank's share of every collective check (a gloo world on the CPU)."""
    from repro_torch.core import grouping as grp
    from repro_torch.launch.pipeline_pp import pipelined_forward
    from repro_torch.optim import pod_allreduce_compressed

    out = {}
    x = torch.from_numpy(allreduce_input(world_size))
    out["allreduce"] = pod_allreduce_compressed(x[rank]).numpy()
    ws, xs = pipeline_inputs(world_size)
    dmesh = M.device_mesh(M.make_mesh((world_size,), ("stage",)), "cpu")
    out["pipeline"] = pipelined_forward(dmesh, "stage", [torch.from_numpy(w) for w in ws],
                                        torch.from_numpy(xs)).numpy()
    if world_size == 4:
        keys = torch.from_numpy(grouping_keys())
        p = keys.shape[0] // world_size
        g = grp.group_device_global(keys[rank * p:(rank + 1) * p])
        out["grouping"] = (g.rep_for_point.numpy(), g.is_rep.numpy(), g.num_groups,
                           g.num_groups_local)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: M.run_world(collectives_world, n, "gloo", tmp_path_factory.mktemp(f"world{n}"),
                           timeout=TIMEOUT) for n in (2, 4)}


# -- the launcher and the mesh --------------------------------------------------------


def mesh_world(rank, world_size):
    dm = M.device_mesh(M.make_mesh((2, 2), ("data", "model")), "cpu")
    return (dm.mesh_dim_names, tuple(dm.shape), dm.get_local_rank("data"),
            dm.get_local_rank("model"), M.flat_index(dm, ("data", "model")),
            M.describe(dm), M.gather_rows(torch.full((2, 3), float(rank)), dm,
                                          ("data", "model"))[:, 0].tolist())


def test_run_world_builds_a_named_mesh(tmp_path):
    """Rank r sits at (r // 2, r % 2) of a 2x2 mesh named after the
    reference's axes; flat_index and gather_rows follow that row-major
    order."""
    got = M.run_world(mesh_world, 4, "gloo", tmp_path, timeout=TIMEOUT)
    for r, (names, shape, d, m, flat, desc, gathered) in enumerate(got):
        assert names == ("data", "model") and shape == (2, 2)
        assert (d, m) == divmod(r, 2) and flat == (r, 4)
        assert desc == M.make_mesh((2, 2), ("data", "model"))
        assert gathered == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0]


def failing_world(rank, world_size):
    if rank == 1:
        raise ValueError("rank one fails")
    torch.distributed.barrier()  # rank 0 waits for a peer that never comes


def test_run_world_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the call with its traceback, and the world
    is stopped without waiting out the timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank one fails"):
        M.run_world(failing_world, 2, "gloo", tmp_path, timeout=TIMEOUT)
    assert time.monotonic() - t0 < TIMEOUT / 2


def sleeping_world(rank, world_size):
    import time

    time.sleep(60)


def test_run_world_times_out(tmp_path):
    with pytest.raises(TimeoutError):
        M.run_world(sleeping_world, 2, "gloo", tmp_path, timeout=5)


def test_backend_is_chosen_by_the_device():
    assert M.backend_for("cuda") == "nccl" and M.backend_for(torch.device("cuda", 1)) == "nccl"
    assert M.backend_for("cpu") == "gloo"


def test_device_mesh_needs_a_world():
    with pytest.raises(RuntimeError, match="torchrun"):
        M.device_mesh(M.make_mesh((2, 2), ("data", "model")), "cpu")


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
def test_fake_world_builds_the_production_meshes(shape):
    """A fake world of 256 or 512 ranks builds the production mesh in one
    process, with nothing to rendezvous with."""
    mesh = M.make_production_mesh(multi_pod=len(shape) == 3)
    with M.fake_world(mesh.size):
        dm = M.device_mesh(mesh, "cpu")
        assert tuple(dm.shape) == shape and dm.mesh_dim_names == mesh.axis_names
    assert not torch.distributed.is_initialized()


# -- the collectives against the reference ---------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_allreduce(worlds, reference, n):
    """Every participant gets the reference's output within 1e-6, and the
    mean within atol 0.05."""
    x = allreduce_input(n)
    for r, out in enumerate(worlds[n]):
        np.testing.assert_allclose(out["allreduce"], reference[f"allreduce{n}"][r], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(out["allreduce"], x.mean(0), atol=0.05)


def test_compressed_allreduce_single_participant():
    """On one rank it is the int8 round trip of x itself (n = 1)."""
    from repro_torch.optim import compress_int8, decompress_int8

    x = torch.from_numpy(allreduce_input(1)[0])
    got = M.run_world(single_allreduce_world, 1, "gloo", _tmp(), args=(x,), timeout=TIMEOUT)[0]
    q, scale = compress_int8(x)
    torch.testing.assert_close(got, decompress_int8(q, scale), rtol=0, atol=1e-6)


def single_allreduce_world(rank, world_size, x):
    from repro_torch.optim import pod_allreduce_compressed

    return pod_allreduce_compressed(x)


def _tmp() -> Path:
    import tempfile

    return Path(tempfile.mkdtemp())


def test_global_grouping_bitwise(worlds, reference):
    """4 shards: rep_for_point, is_rep, num_groups and num_groups_local
    bitwise the reference's; num_groups is global on every shard, the
    locals are each shard's sum(is_rep) and sum to it."""
    shards = [out["grouping"] for out in worlds[4]]
    rep = np.concatenate([s[0] for s in shards])
    is_rep = np.concatenate([s[1] for s in shards])
    np.testing.assert_array_equal(rep, reference["grouping_rep"])
    np.testing.assert_array_equal(is_rep, reference["grouping_is_rep"])
    np.testing.assert_array_equal([s[2] for s in shards], reference["grouping_num_groups"])
    np.testing.assert_array_equal([s[3] for s in shards], reference["grouping_num_groups_local"])
    n_global = len(np.unique(grouping_keys(), axis=0))
    assert all(s[2] == n_global for s in shards)
    assert [s[3] for s in shards] == [int(s[1].sum()) for s in shards]
    assert sum(s[3] for s in shards) == n_global


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline(worlds, reference, n):
    """n stages: the replicated outputs equal the unpipelined chain and the
    reference's within atol 1e-5."""
    ws, x = pipeline_inputs(n)
    chain = torch.from_numpy(x)
    for w in ws:
        chain = torch.tanh(chain @ torch.from_numpy(w))
    for out in worlds[n]:
        np.testing.assert_allclose(out["pipeline"], chain.numpy(), atol=1e-5)
        np.testing.assert_allclose(out["pipeline"], reference[f"pipeline{n}"], atol=1e-5)
