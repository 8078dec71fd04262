"""Plain AdamW as a training job states it: clipping by the global norm of
all gradients, bias corrections, decoupled weight decay, and a learning
rate under linear warm-up and cosine decay to a floor; all in float32.

``step`` returns the clipped gradient of every leaf: what the optimizer
takes in, which the training check compares.
"""

from __future__ import annotations

import math

import torch


def lr_at(job: dict, taken: int) -> float:
    """The learning rate of the step after ``taken`` steps."""
    warmup, total, floor = job["warmup_steps"], job["total_steps"], job["min_lr_ratio"]
    warm = min(taken / max(warmup, 1), 1.0)
    frac = min(max((taken - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return job["lr"] * warm * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


class AdamW:
    def __init__(self, params: dict, job: dict):
        self.job = job
        self.taken = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        j = self.job
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads.values())).float()
        scale = torch.clamp(j["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
        lr = lr_at(j, self.taken)
        self.taken += 1
        c1 = 1.0 - j["b1"] ** self.taken
        c2 = 1.0 - j["b2"] ** self.taken
        clipped = {}
        for n, p in params.items():
            g = grads[n] * scale
            clipped[n] = g
            m = self.m[n].mul_(j["b1"]).add_(g, alpha=1 - j["b1"])
            v = self.v[n].mul_(j["b2"]).addcmul_(g, g, value=1 - j["b2"])
            update = (m / c1) / (torch.sqrt(v / c2) + j["eps"]) + j["weight_decay"] * p
            p.sub_(lr * update)
        return clipped
