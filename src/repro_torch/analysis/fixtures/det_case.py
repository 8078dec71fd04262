"""DET fixture: ambient-state leaks the rule must catch (parsed, never
imported — see fixtures/__init__)."""

import os
import random
import time

import numpy as np
import torch


def wall_clock_stamp():
    return time.time()  # expect[DET]


def global_rng_draw():
    return np.random.rand(3)  # expect[DET]


def unseeded_generator():
    return np.random.default_rng()  # expect[DET]


def seeded_generator_ok(seed):
    return np.random.default_rng(seed)


def stdlib_random():
    return random.random()  # expect[DET]


def env_read():
    return os.environ["REPRO_MODE"]  # expect[DET]


def env_get():
    return os.getenv("REPRO_MODE")  # expect[DET]


def set_comprehension_leak(items):
    return [x * 2 for x in {i % 7 for i in items}]  # expect[DET]


def set_loop_leak(tags):
    out = []
    for t in set(tags):  # expect[DET]
        out.append(t)
    return out


def set_materialize_leak(tags):
    return list({t.lower() for t in tags})  # expect[DET]


def sorted_set_ok(tags):
    return sorted({t.lower() for t in tags})


def membership_ok(tag):
    return tag in {"mean", "std", "skew"}


def perf_counter_ok():
    return time.perf_counter()


def allowed_wall_clock():
    return time.time()  # repro: allow[DET]: fixture — suppression must hold


def torch_global_draw(n):
    return torch.randn(n)  # expect[DET]


def torch_global_permutation(n):
    return torch.randperm(n)  # expect[DET]


def torch_seeded_draw_ok(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=gen)


def torch_inplace_global_draw(x):
    return x.normal_()  # expect[DET]


def torch_inplace_seeded_ok(x, gen):
    return x.uniform_(0.0, 1.0, generator=gen)


def torch_global_seed(seed):
    torch.manual_seed(seed)  # expect[DET]


def torch_cuda_rng_state(state):
    torch.cuda.set_rng_state(state)  # expect[DET]


def float_index_add(out, idx, src):
    return out.index_add_(0, idx, src)  # expect[DET]


def float_scatter_add(out, idx, src):
    return torch.scatter_add(out, 1, idx, src)  # expect[DET]


def mean_scatter_reduce(out, idx, src):
    return out.scatter_reduce_(0, idx, src, reduce="mean")  # expect[DET]


def amin_scatter_reduce_ok(out, idx, src):
    return out.scatter_reduce_(0, idx, src, reduce="amin")


def amax_scatter_reduce_ok(out, idx, src):
    return torch.scatter_reduce(out, 0, idx, src, "amax")


def accumulate_index_put(out, idx, src):
    return out.index_put_((idx,), src, accumulate=True)  # expect[DET]


def overwrite_index_put_ok(out, idx, src):
    return out.index_put_((idx,), src)


def weighted_bincount(idx, w):
    return torch.bincount(idx, weights=w)  # expect[DET]


def count_bincount_ok(idx):
    return torch.bincount(idx)


def host_bincount_ok(idx, w):
    return np.bincount(idx, weights=w)


def float_histc(x):
    return torch.histc(x, bins=10)  # expect[DET]


def allowed_exact_scatter(out, idx):
    return out.scatter_add_(1, idx, torch.ones_like(out))  # repro: allow[DET]: fixture — ones below 2^24 add exactly
