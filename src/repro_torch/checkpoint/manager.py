"""Checkpointing with retention and async save.

Port of ``repro.checkpoint.manager`` over the port's state: nested dicts,
lists, tuples and ``NamedTuple``s (an ``OptState``) of tensors, numpy
arrays or numbers, flattened with dict keys sorted, as ``jax.tree_util``
flattens. The reference's on-disk rules hold:

* ``leaves.npz`` (leaf i under ``l<i>``) and ``manifest.json`` (the
  structure, leaf count, shapes, dtypes, step and ``extra``) are written
  to ``<dir>.tmp``, which is then renamed to ``<dir>``: a crash mid-save
  leaves the previous checkpoint intact;
* ``latest_step`` trusts only directories that hold a manifest;
* a restore into a structure with another leaf count, or a leaf of
  another shape, raises ``ValueError``.

bfloat16 has no numpy type: such a leaf is stored as its int16 bits and
its manifest dtype says ``bfloat16``.

**Sharded state.** A DTensor leaf is saved whole: every rank of its mesh
joins the gather (``full_tensor``), so every rank must call ``save``, and
rank 0 alone writes; a synchronous save ends with a barrier, so no rank
reads a checkpoint before it is on disk. ``restore_pytree(...,
placements=...)`` (the reference's ``shardings=``) places each leaf onto
the mesh of today's world, which may have another shape than the one
that saved it: the elastic restart. ``shardings_of(tree)`` gives the
placements a tree of DTensors already has.

**Async save.** ``save(..., async_=True)`` copies every leaf to the host
before it returns and serializes on a thread. The copy is a real one:
on the CPU ``tensor.cpu()`` and ``tensor.numpy()`` alias the live
tensor, and the trainer updates its parameters in place, so a snapshot
that aliased them would write the next step's values.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, is_leaf=lambda x: False) -> tuple[list, str]:
    """(leaves in order, a description of the structure); ``is_leaf`` marks
    further leaves (a ``Sharding`` is a NamedTuple)."""
    leaves: list = []

    def walk(x) -> str:
        if is_leaf(x):
            leaves.append(x)
            return "*"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}" for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return f"{type(x).__name__}(" + ", ".join(f"{f}={walk(getattr(x, f))}" for f in x._fields) + ")"
        if isinstance(x, (list, tuple)):
            inner = ", ".join(walk(v) for v in x)
            return f"[{inner}]" if isinstance(x, list) else f"({inner})"
        leaves.append(x)
        return "*"

    return leaves, walk(tree)


def _unflatten(like, leaves: list):
    """``like``'s structure with its leaves replaced by ``leaves`` in order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}
        if _is_namedtuple(x):
            return type(x)(*(build(getattr(x, f)) for f in x._fields))
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        return next(it)

    return build(like)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _host_copy(x) -> np.ndarray:
    """A numpy array that owns its memory (never a view of ``x``); a
    DTensor gathered whole first (a collective: every rank calls it)."""
    if isinstance(x, torch.Tensor) and _is_dtensor(x):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return np.array(x, copy=True)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _write(path: Path, host: list, dtypes: list, structure: str, step, extra) -> None:
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "leaves.npz", **{f"l{i}": a for i, a in enumerate(host)})
    manifest = {
        "treedef": structure,
        "num_leaves": len(host),
        "shapes": [list(a.shape) for a in host],
        "dtypes": dtypes,
        "step": step,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)


def _writer(leaves) -> tuple[bool, bool]:
    """(is this rank the one that writes, is the save a sharded one)."""
    import torch.distributed as dist

    sharded = any(isinstance(x, torch.Tensor) and _is_dtensor(x) for x in leaves)
    return (not sharded or dist.get_rank() == 0), sharded


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()


def save_pytree(path: Path, tree, step: int | None = None, extra: dict | None = None) -> None:
    leaves, structure = _flatten(tree)
    host = [_host_copy(x) for x in leaves]
    writes, sharded = _writer(leaves)
    if writes:
        _write(path, host, [_dtype_name(x) for x in leaves], structure, step, extra)
    if sharded:
        _barrier()


def shardings_of(tree):
    """``tree``'s structure with each DTensor leaf's ``Sharding`` (its
    mesh and placements) and None at every other leaf."""
    from repro_torch.models.sharding import Sharding

    leaves, _ = _flatten(tree)
    return _unflatten(tree, [Sharding(x.device_mesh, tuple(x.placements))
                             if isinstance(x, torch.Tensor) and _is_dtensor(x) else None
                             for x in leaves])


def restore_pytree(path: Path, like_tree, placements=None):
    """Restore into the structure of ``like_tree``: each leaf a tensor on
    its ``like_tree`` leaf's device (the CPU for a non-tensor leaf), in the
    stored dtype. ``placements`` (the reference's ``shardings=``), a tree
    of ``like_tree``'s structure with a ``models.sharding.Sharding`` or
    None at each leaf, places the leaves it names onto their mesh as
    DTensors, each rank keeping its block of the whole stored tensor.
    Returns (tree, manifest)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    like, _ = _flatten(like_tree)
    if len(like) != manifest["num_leaves"]:
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, target structure expects "
            f"{len(like)} — architecture mismatch")
    data = np.load(path / "leaves.npz")
    leaves = []
    for i, (ref, dtype) in enumerate(zip(like, manifest["dtypes"])):
        arr = data[f"l{i}"]
        want = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(f"checkpoint leaf {i} has shape {tuple(arr.shape)}, target expects {want}")
        t = torch.from_numpy(arr)
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        leaves.append(t.to(_local_device(ref)) if isinstance(ref, torch.Tensor) else t)
    if placements is not None:
        from repro_torch.models.sharding import Sharding, place

        where, _ = _flatten(placements, lambda x: x is None or isinstance(x, Sharding))
        if len(where) != len(leaves):
            raise ValueError(f"placements have {len(where)} leaves, the checkpoint {len(leaves)}")
        leaves = [t if s is None else place(t.to(s.mesh.device_type), s)
                  for t, s in zip(leaves, where)]
    return _unflatten(like_tree, leaves), manifest


def _local_device(ref: torch.Tensor) -> torch.device:
    return ref.to_local().device if _is_dtensor(ref) else ref.device


class CheckpointManager:
    """Step-numbered checkpoints with retention and async save."""

    def __init__(self, root: str | Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._sharded = False

    def _dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def save(self, step: int, tree, extra: dict | None = None, async_: bool = False) -> None:
        self.wait()
        # Copy to the host before returning: the caller updates the
        # tensors in place; serialization happens on the thread.
        leaves, structure = _flatten(tree)
        host = [_host_copy(x) for x in leaves]
        dtypes = [_dtype_name(x) for x in leaves]
        writes, sharded = _writer(leaves)

        def work():
            if writes:
                _write(self._dir(step), host, dtypes, structure, step, extra)
                self._gc()

        if async_:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
            self._sharded = sharded
        else:
            work()
            if sharded:
                _barrier()

    def wait(self) -> None:
        """Waits for an async save; after a sharded one, for every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            if self._sharded:
                _barrier()

    def _steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.root.glob("step_*")
                      if (p / "manifest.json").exists())

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, like_tree, placements=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return restore_pytree(self._dir(step), like_tree, placements)

    def _gc(self) -> None:
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
