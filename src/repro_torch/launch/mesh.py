"""Meshes: the descriptor the accounting reads, and real device meshes.

Port of ``repro.launch.mesh``. The reference builds a ``jax.sharding.Mesh``
over devices. The port keeps two things apart:

* ``Mesh``, a descriptor (the shape and the axis names, no device), which
  ``models/sharding.py``'s placement rules and the dry run read;
* ``device_mesh(mesh, device_type)``, a ``torch.distributed.DeviceMesh``
  over the ranks of the current world with the descriptor's shape and its
  axis names as the mesh dimensions' names.

A world is a ``torch.distributed`` process group, one rank a device.
``run_world(fn, world_size, backend, store_dir)`` spawns one, and
``fake_world(world_size)`` makes a fake one in this process for counting
(the fake process group: collectives move nothing, so a world of 256 or
512 ranks counts on meta tensors). The backend is always chosen by the
caller: ``backend_for(device)`` names ``nccl`` for a CUDA device and
``gloo`` for the CPU, and a caller may pass another (gloo carries CUDA
tensors for ``all_reduce`` and ``broadcast`` only); nothing here swaps one
backend for another.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import pickle
import time
import traceback
from pathlib import Path

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ in rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips (data, model). Multi-pod: 2 pods =
    512 chips (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Arbitrary mesh (tests, the dry run's ``--mesh``)."""
    return Mesh(tuple(int(s) for s in shape), tuple(axes))


def parse_mesh(text: str) -> Mesh:
    """``"DxM"`` -> (data, model); ``"PxDxM"`` -> (pod, data, model)."""
    shape = tuple(int(s) for s in text.lower().split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(len(shape))
    if axes is None:
        raise ValueError(f"--mesh {text!r}: expected DxM or PxDxM")
    return make_mesh(shape, axes)


# -- real meshes ---------------------------------------------------------------------


def backend_for(device: torch.device | str) -> str:
    """The process group backend for tensors on ``device``: ``nccl`` for
    CUDA, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def device_mesh(mesh: Mesh, device_type: str):
    """``mesh`` as a ``DeviceMesh`` over every rank of the current world
    (row-major: rank r sits at ``unravel_index(r, mesh.shape)``), its
    dimensions named after ``mesh.axis_names``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"a {'x'.join(map(str, mesh.shape))} mesh needs a torch.distributed "
                           "world: launch with torchrun, or run_world / fake_world")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"mesh {mesh.shape} needs {mesh.size} ranks, the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type, mesh.shape, mesh_dim_names=mesh.axis_names)


def describe(dmesh) -> Mesh:
    """The descriptor of a ``DeviceMesh``."""
    return make_mesh(tuple(dmesh.shape), tuple(dmesh.mesh_dim_names))


def flat_index(dmesh, axes: tuple[str, ...]) -> tuple[int, int]:
    """(this rank's index, the count) over ``axes`` of ``dmesh`` flattened
    row-major, as the reference's ``P(axes)`` splits a dimension."""
    index, total = 0, 1
    for ax in axes:
        size = dmesh.size(dmesh.mesh_dim_names.index(ax))
        index = index * size + dmesh.get_local_rank(ax)
        total *= size
    return index, total


def gather_rows(x: torch.Tensor, dmesh, axes: tuple[str, ...]) -> torch.Tensor:
    """Every rank's block of ``x`` along dimension 0 over ``axes`` of
    ``dmesh``, in the row-major order ``flat_index`` gives (the last axis
    gathered first). Every rank of the mesh must call it. Under ``nccl`` a
    host tensor travels through the rank's CUDA device and comes back."""
    import torch.distributed as dist

    for ax in reversed(axes):
        group = dmesh.get_group(ax)
        n = dist.get_world_size(group)
        if n == 1:
            continue
        home = x.device
        if dist.get_backend(group) == "nccl" and home.type == "cpu":
            x = x.to(torch.device("cuda", torch.cuda.current_device()))
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts).to(home)
    return x


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks in this process, this
    process rank 0: meshes build and collectives dispatch, but move
    nothing. For counting on meta tensors."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, world_size: int, backend: str, store_dir: str, fn, args) -> None:
    import torch.distributed as dist

    out = Path(store_dir) / f"rank{rank}.pkl"
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(str(Path(store_dir) / "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        result = fn(rank, world_size, *args)
        dist.barrier()
        out.write_bytes(pickle.dumps(("ok", result)))
    except BaseException:  # repro: allow[ERR]: the parent re-raises it with the rank's traceback
        out.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(fn, world_size: int, backend: str, store_dir: str | os.PathLike, args=(),
              timeout: float = 300.0) -> list:
    """Runs ``fn(rank, world_size, *args)`` on every rank of a new world of
    ``world_size`` processes (spawned; ``fn`` and ``args`` must pickle) and
    returns their results in rank order.

    The ranks rendezvous on a ``FileStore`` under ``store_dir`` (an empty
    directory of the caller's: no TCP port, so worlds of concurrent
    callers cannot collide) with ``backend``; under ``nccl`` rank r takes
    CUDA device r modulo the count. Every rank meets a barrier after ``fn``
    and before it leaves the world. A rank that raises fails the call
    with its traceback; a world that runs past ``timeout`` seconds is
    killed and the call raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    store_dir = Path(store_dir)
    store_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, backend, str(store_dir), fn, args),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    try:
        # A rank that fails leaves its peers waiting in a collective: stop
        # the world as soon as one rank exits with an error.
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world_size} ({backend}) ran past {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results, errors = [], []
    for r, p in enumerate(procs):
        path = store_dir / f"rank{r}.pkl"
        if not path.exists():
            errors.append(f"rank {r} exited with code {p.exitcode} and no result")
            continue
        status, value = pickle.loads(path.read_bytes())
        if status == "ok":
            results.append(value)
        else:
            errors.append(f"rank {r}:\n{value}")
    if errors:
        raise RuntimeError(f"a world of {world_size} ({backend}) failed:\n" + "\n".join(errors))
    return results
