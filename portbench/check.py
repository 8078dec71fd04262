"""The comparison that decides ``correct``: the program's outputs of the
timed path against the plain reference (``reference/``), number by number,
each against its limit (``portbench/limits/<cell>.json``).

Numbers:

* ``logit_err`` (prefill): the worst prompt of the sampled requests by
  ||logits - reference|| / ||reference|| over its last position's
  vocabulary;
* ``loss_err`` (training): the worst of the checked steps by
  |loss - reference| / |reference|;
* ``grad_err`` (training): the worst leaf by the gap between the program's
  and the reference's norms of the first gradient as the optimizer takes
  it (clipped), over the larger of the reference's norm of that leaf and
  of the median leaf; the program's is its first moment after one step
  over (1 - b1);
* ``change_err`` (training): the same for the parameters' change over the
  checked steps, leaving out the leaves whose reference gradient is under
  a thousandth of the median leaf's (they move under Adam by round-off
  alone);
* ``grad_diff`` (training): the worst leaf by the distance
  ||gradient - reference|| of the first gradient, over the same
  denominator as ``grad_err``. The gap of two norms averages rounding out
  over a leaf's entries; the distance does not, so it is the number that
  separates the program's bfloat16 from the control's float8.

A cell's limits file names the numbers it compares; a number with no upper
reading (neither the control nor a fault reads far enough above the
program) is computed but not compared.
"""

from __future__ import annotations

import statistics

import torch

from portbench import traffic as TR
from portbench import weights as W
from portbench.reference.adamw import AdamW
from portbench.reference.model import Reference, fp8, no_quant, no_tf32

QUANT = {"float32": no_quant, "fp8": fp8}
QUIET_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def logit_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-300)).max())


def leaf_err(prog: dict, ref: dict, leaves=None) -> float:
    """max over ``leaves`` (default all) of |prog - ref| / max(ref, median
    of ref over those leaves); norms by leaf name."""
    names = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300) for n in names)


def leaf_diff(prog: dict, ref: dict, ref_norms: dict) -> float:
    """max over leaves of ||prog - ref|| / max(||ref||, median ||ref||):
    the worst leaf's distance, tensors by leaf name (on the host)."""
    med = statistics.median(ref_norms.values())
    return max(float(torch.linalg.vector_norm((prog[n] - ref[n]).double()))
               / max(ref_norms[n], med, 1e-300) for n in ref)


def moving_leaves(grad_norms: dict) -> list[str]:
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= QUIET_LEAF * med]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) over the numbers the cell's
    limits name: correct when each is finite and at most its limit. A
    number without a limit (it had no upper reading) is not compared."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, checks


# -- the reference's readings -----------------------------------------------------


def ref_prefill(config: dict, traffic: dict, seed: int, indices, device, quant="float32") -> list:
    """The reference's (B, V) last-position logits of the requests
    ``indices``, on the weights of ``seed``."""
    no_tf32()
    params = W.draw_all(config, seed, device)
    ref = Reference(config, params, QUANT[quant])
    out = []
    with torch.no_grad():
        for i in indices:
            out.append(ref.last_logits(TR.prompt(traffic, config, seed, i, device)).float())
    del params
    return out


def leaf_norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.detach().double())) for n, t in tensors.items()}


def change_norms(config: dict, seed: int, params: dict, device) -> dict:
    """{leaf: ||params - the initial weights of seed||}, the initial
    weights drawn again a group at a time."""
    out = {}
    for _, init in W.draw(config, seed, device):
        for n, t0 in init.items():
            out[n] = float(torch.linalg.vector_norm((params[n].detach().float() - t0.float()).double()))
        del init
    return out


def ref_train(config: dict, traffic: dict, seed: int, device, quant="float32", half=False) -> dict:
    """The reference's readings over the job's checked steps from the
    weights of ``seed``: each step's loss, the first clipped gradient's
    norm by leaf and the parameters' change by leaf after the steps. With
    ``half`` the loss is the mean over the first half of each batch's rows
    only (a fault's reading)."""
    no_tf32()
    job = traffic["optimizer"]
    params = {n: t.float().requires_grad_(True) for n, t in W.draw_all(config, seed, device).items()}
    ref = Reference(config, params, QUANT[quant])
    opt = AdamW(params, job)
    losses, grad_norms = [], None
    for i in range(traffic["checked_steps"]):
        batch = TR.train_batch(traffic, config, seed, i, device)
        tok, tgt = batch["tokens"], batch["targets"]
        if half:
            tok, tgt = tok[: tok.shape[0] // 2], tgt[: tgt.shape[0] // 2]
        loss = ref.loss(tok, tgt)
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
        losses.append(float(loss.detach()))
        clipped = opt.step(params, grads)
        if grad_norms is None:
            grad_norms = leaf_norms(clipped)
            first_grad = {n: g.detach().cpu() for n, g in clipped.items()}
        del grads, clipped, loss
    out = dict(losses=losses, grad_norms=grad_norms, first_grad=first_grad,
               change_norms=change_norms(config, seed, params, device))
    del params, opt, ref
    return out


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training numbers of readings ``prog`` against ``ref`` (both
    dicts as ``ref_train`` gives)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_err": loss,
            "grad_err": leaf_err(prog["grad_norms"], ref["grad_norms"]),
            "grad_diff": leaf_diff(prog["first_grad"], ref["first_grad"], ref["grad_norms"]),
            "change_err": leaf_err(prog["change_norms"], ref["change_norms"],
                                   moving_leaves(ref["grad_norms"]))}
