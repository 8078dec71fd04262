"""Pipeline parallelism (GPipe-style) over a mesh axis.

Port of ``repro.launch.pipeline_pp``. Each rank along the ``stage`` axis
holds one stage's weights; activations flow stage -> stage + 1 once a
tick, and the schedule runs ``n_micro + n_stages - 1`` ticks (fill,
steady state, drain). The reference moves them with ``lax.ppermute``
inside ``shard_map``; the port with ``batch_isend_irecv`` from stage s to
s + 1 on the axis's process group, then replicates the last stage's
outputs with ``all_reduce(SUM)`` where the reference ``psum``s them.

The stage compute is ``tanh(x @ w)``, as the reference's: the schedule is
the deliverable, and a transformer block would replace ``_stage_compute``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _stage_compute(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ w)


def pipelined_forward(mesh, axis: str, stage_weights, microbatches: torch.Tensor) -> torch.Tensor:
    """``mesh`` a ``DeviceMesh`` with an ``axis`` dimension; stage_weights:
    every stage's (d, d) matrix (as many as the axis has ranks, the same
    list on every rank); microbatches (n_micro, b, d). Returns the final
    stage's (n_micro, b, d) outputs on every rank. Every rank of the mesh
    must call it."""
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    if len(stage_weights) != n_stages:
        raise ValueError(f"{len(stage_weights)} stage weights for {n_stages} stages")
    group = mesh.get_group(axis)
    s = mesh.get_local_rank(axis)
    w = stage_weights[s]
    n_micro = microbatches.shape[0]
    outputs = torch.zeros_like(microbatches)
    incoming = torch.zeros_like(microbatches[0])
    is_last = s == n_stages - 1
    for t in range(n_micro + n_stages - 1):
        mb = t - s  # the microbatch this stage handles at tick t
        x_in = microbatches[min(max(t, 0), n_micro - 1)] if s == 0 else incoming
        y = _stage_compute(w, x_in)
        if is_last and 0 <= mb < n_micro:
            outputs[mb] = y
        # The reference's ppermute: stage i sends to i + 1; stage 0 receives
        # nothing (zeros), and the last stage's send goes nowhere.
        ops = []
        if s + 1 < n_stages:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), dist.get_global_rank(group, s + 1),
                                  group))
        received = torch.zeros_like(y)
        if s > 0:
            ops.append(dist.P2POp(dist.irecv, received, dist.get_global_rank(group, s - 1), group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        incoming = received
    # Only the last stage holds real outputs; replicate them.
    result = outputs if is_last else torch.zeros_like(outputs)
    dist.all_reduce(result, op=dist.ReduceOp.SUM, group=group)
    return result
