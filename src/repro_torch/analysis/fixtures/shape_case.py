"""SHAPE fixture: device-shape assembly outside the blessed shape-class
helpers (parsed as if it were ``core/executor.py``; never imported)."""

import numpy as np
import torch


def unblessed_batch(parts):
    flat = torch.cat(parts)  # expect[SHAPE]
    return flat.sum()


def unblessed_stack(a, b):
    return torch.stack([a, b])  # expect[SHAPE]


def unblessed_reshape(x, n):
    return torch.reshape(x, (n, -1))  # expect[SHAPE]


def blessed_batch(parts, grp):
    padded = grp.padded_size(sum(p.shape[0] for p in parts))
    flat = torch.cat(parts)
    return flat, padded


def host_assembly_ok(parts):
    return np.concatenate(parts)


def allowed_fixed_triple(a, b, c):
    return torch.stack([a, b, c], dim=-1)  # repro: allow[SHAPE]: fixed triple, not a batch seam
