#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (``fitpdf``,
``moments``, ``hist`` and ``band_attn``, one ``nvcc`` each, all at once, into
``build/kernels/``), holds each kernel against its plain PyTorch version on
the card, then drives the paths through the entry point, each on one full
Set1 slice (501 lines x 251 points x 1,000 observations, slice 201, 21
windows) with ``PDFComputer(PDFConfig(...), SeismicSimulation()).run_slice(201)``
and every kernel's launch count set to 0 just before it:

* ``[staging]``: one window staged the old pageable way and through the
  load stage's pinned stager (the same bits, both times), then baseline on
  the fused backend, prefetch on and off bitwise equal;
* ``[file]``: the slice exported through a one-slice view into a file cube
  (0.5 GB, in a temporary directory under ``build/``, deleted at the end),
  every window of it bitwise equal to the simulation's, and the slice run
  from the cube with verified reads off and on and through
  ``ThrottledSource``, each bitwise equal to the simulation's slice;
* ``[faults]``: one fault plan over the cube through
  ``StagedExecutor(..., injector=...)`` (transient read errors, a straggler
  raced by speculation, a torn chunk read, a persist error, a window that
  never loads): every other point bitwise equal to the clean slice, that
  window at type -1 with its failed-unit manifest; with
  ``degraded_mode=False`` the plan raises;
* ``[scheduler]``: ``SliceScheduler`` with 2 shards over slices 200 and
  201, shard 0 lost after its first window and its slice re-dealt, bitwise
  equal to a clean run of both;
* ``[stream]`` on the ``[file]`` cube: a ``PDFSession`` with an
  ``out_dir``, a ``cache_dir`` and ``stream.persist_stats`` (K1 = K2 = K4 =
  21: a sidecar a window, its counts bitwise the plain
  ``histogram_scatter``; the slice bitwise the simulation's), 100
  realizations a point appended from the slice's own observations, the
  merge-mode update (K4 = 21 and nothing else, no executor, the
  watermark's ``merge_ulp_budget``, nothing cached, 50.3 MB of
  observations read, each new partition's counts bitwise the plain
  version's), and a strict recompute over 1,100 observations against
  which the merge's counts are bitwise, its moments within
  ``MERGE_ULP_BUDGET`` ulps and its ``type_idx`` equal wherever the best
  two types are apart;
* ``[cluster]``: ``run_pdf`` over simulated Set1 slices 200-203 (baseline,
  L = 20) serially with a fresh ``--compile-cache-dir`` (it must build),
  then as 1, 2 and 4 workers through ``src/repro_torch/launch/cluster.sh``
  (gloo, one shared ``out_dir``, the warm cache: ``new_compilations=0`` in
  every worker), each bitwise the serial run's, K1 = K2 = 84 over the
  workers; each worker's wall and launches logged;
* baseline on the fused backend (K1 + K2), 4 types at L = 64 and 10 types
  at L = 20: once per window each, bitwise repeat, parity with the port's
  plain PyTorch backend;
* grouping on the kernels backend (K3 + K4): once per window each, bitwise
  repeat, parity with grouping on the plain backend;
* reuse on the kernels backend: K4 once per window with a cache miss, cache
  hits, prefetch on and off bitwise equal;
* baseline on the kernels backend in faithful mode: K4 once per type and
  window, held against fused mode;
* grouping on the fused backend with host and with device Select: bitwise
  equal, the device path through K2's ``row_indices`` prologue;
* baseline on the fused backend, 4 types at L = 1,000 (K2 past the bins
  its design before took) and at L = 2,000 (past the bins one K2 block
  holds: two launches a window, one a chunk of bins), as the first two;
  then one window on the kernels backend at L = 2,000 against the plain
  backend;
* the ML and sampling methods (§5.3-5.4) with the decision tree of the
  reference's TreeSpec defaults, trained on the card by
  ``train_type_tree(sim, TYPES_4)`` (slices 0-3, windows of 4 lines, depth
  4, 32 bins; repeated, it must train the same tree): ``ml``, ``grouping_ml``
  (host and device Select, no ``row_indices`` route) and ``reuse_ml`` on the
  fused backend (K1 once a window, K2 over all types once a window, or once
  a window with cache misses), ``ml`` on the kernels backend (K3 and K4
  once a window), ``sampling`` with the random sampler (K1 on the sampled
  rows only, no K2; K1 also held against its plain version on those
  subsets) and with k-means, and the paper's Set1 configuration
  (``grouping_ml``, 4 types, L = 20). Bitwise: host and device Select,
  prefetch on and off. Against the same method on the plain backend, the
  tree-margin rule (``tree_margin``);
* ``[batch]``: ``run_window_batch`` over the slice's 21 windows and over 10
  windows of slices 200 and 201: baseline and ``ml`` on fused, grouping
  (host Select) on fused (K2's ``row_indices`` route over the batch) and
  kernels; each window bitwise equal to ``run_window``, launches as the
  packing predicts;
* ``[api faults]`` (beside ``[faults]``): the same fault plan as a JSON
  file in ``execution.fault_plan`` of a ``PipelineSpec`` run by
  ``PDFSession``: the same bits, retries, quarantine, events and launches;
* ``[api]``: ``PDFSession(to_spec(SET1))`` (``grouping_ml``, L = 20,
  slice 201, the tree of the ML phase) bitwise equal to ``PDFComputer``
  on the same configuration and stamped with its spec hash, K1 = K2 = 21,
  in turns with it twice; grouping on the kernels backend through the
  session; with a ``cache_dir`` a miss that stores, then a new session
  served bitwise from the cache with no launch, executor or tree, and
  with an ``out_dir`` too the hit's 21 windows and watermark; then
  ``python -m repro_torch.launch.run_pdf --spec`` in a subprocess,
  which must exit 0 and print the session's hash;
* ``[serve]``: ``PDFServer`` over the Set1 spec with baseline, then
  grouping (host Select), on slices 200-201: 8 client threads of 6 point,
  2 window and 1 region query each (``numpy.random.default_rng(0)``),
  coalesced (storing the completed slices in a ``cache_dir``), naive
  (``serve.coalesce`` off, no hot-window LRU) and a second server over
  the warm cache: every answer bitwise equal across the three and to the
  session's slices; coalesced K2 at most the distinct windows requested,
  naive at least as many, warm none; request and launch p50/p99,
  ``coalesce_ratio``, ``batch_occupancy`` and hit rates logged.

Then the baseline slice, the two grouping slices and the Set1
configuration run once more under
``torch.profiler`` (device time by kernel, device idle share, the
host-to-device copies' total and their overlap with K1/K2), and a timing
of each kernel at the Set1 window shape beside its bound. Every kernel
row's ``ms`` is "call ms", as earlier runs timed it: CUDA events around
the wrapper call, L2 flushed by zeroing a buffer, the card's idle time
through the wrapper's host work included. K1-K4 add ``kernel_ms``, the
kernel's own device time: the wrapper's host work queued behind a sleep
on the card, L2 flushed clean (``repro_torch.kernels._timing``). K2 and K4
are also timed at L = 1,000, 4,000 and 12,000 (``at_large_L`` in their
rows), with the chunk of bins each launch takes, and held there against
their plain versions: K2 within ERR_TOL on every route it is timed on
(the same bits on each), K4 exactly.

Last comes the LM serving path (``band_attn``, K5):

* K5 against its plain version at the serving shape (B 4, S 4096, H 16,
  KV 8, hd 256, W 1024, bf16), a ragged S = 4000 and an S = 700 < W:
  each output row's relative distance from the float32 truth within twice
  that of the plain version with the oracle's bf16 weights, repeats
  bitwise, launches counted, and a window off by one rejected by the same
  gate;
* gemma3-12b at full width cut to 12 layers (10 local, 2 global), random
  weights from a seeded generator on the card: ``generate`` on 4 prompts
  of 4,096 tokens and 16 greedy tokens with the counts set to 0 (10 K5
  launches), a prefill alone twice (bitwise equal logits), the decode steps
  alone (no K5 launch, the same tokens), and the prefill's logits and first
  token held against the plain masked path and float32 compute;
* one prefill and one decode step under ``torch.profiler`` (K5's share,
  device idle share) and
  K5's time beside its bound, its plain version and SDPA with the band as
  a mask.

The K1-K4 rows of the kernels line carry ``launches_api_serve``, the
``[api]`` and ``[serve]`` launches, and ``launches_stream_cluster``, those
of ``[stream]`` and ``[cluster]`` (summed over a cluster's workers). Any failed check raises, so the exit
code is non-zero. The line before the last is a JSON object of
per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Parity rules between two moment formulas (the ROADMAP's, from the
# reference's kernel tests): the fused slice's shifted sums against the
# reference backend's two-pass moments.
MOM_TOL = dict(rtol=2e-3, atol=2e-3)
ERR_TOL = dict(rtol=1e-4, atol=5e-4)

# K1 against its plain version. Both do the same float operations
# (-fmad=false); only the order of each row's sums differs. vmin and vmax
# are order-free, so exact. mean and var are held far below what a biased
# variance gives (n/(n-1) dropped: 1e-3 relative at n = 1,000), which the
# check must reject (a planted fault, every run). skew and kurt cancel
# between their shifted power sums, so they get an absolute term. On an
# H100 the largest differences at these shapes were 1.5e-7 (mean) and 1e-6
# (var) relative, 3.8e-6 (skew) and 3.1e-5 (kurt) absolute.
K1_STATS = ("mean", "var", "skew", "kurt", "vmin", "vmax")
K1_TOL = {
    "mean": dict(rtol=1e-5, atol=0.0),
    "var": dict(rtol=1e-4, atol=0.0),
    "skew": dict(rtol=1e-4, atol=1e-4),
    "kurt": dict(rtol=1e-4, atol=5e-4),
    "vmin": dict(rtol=0.0, atol=0.0),
    "vmax": dict(rtol=0.0, atol=0.0),
}
EDGE_TOL = dict(rtol=1e-6, atol=1e-3)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 and float64
# (outside the tensor cores) op/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12
BF16_OPS_PER_S = 989e12  # dense, tensor cores

SET1_SLICE = 201  # configs/pdf_seismic.py: slice_index
SET1_WINDOWS = 21  # ceil(501 lines / 25 lines per window)
KERNEL_SOURCES = ("fitpdf", "moments", "hist", "band_attn")  # src/repro_torch/csrc/<name>.cu

# The LM serving path: gemma3-12b at full width (configs/gemma3_12b.py) with
# the banded path on, cut to 12 of its 48 layers (two repeats of the 5 local
# + 1 global pattern: 10 local layers, so 10 K5 launches a prefill).
LM_ARCH = "gemma3-12b"
LM_LAYERS = 12
LM_LOCAL_LAYERS = 10
LM_BATCH = 4  # serve_decode's default
LM_PROMPT = 4096
LM_TOKENS = 16
# K5 in bf16 against the plain version, per query row: the bf16 kernel
# rounds the softmax weights to bf16 for the P V product, as the
# reference's oracle does (repro/kernels/band_attn/ref.py:24), so a per-entry
# tolerance no longer holds near 0. The gate is ref.row_errors, the
# relative 2-norm distance of each output row from the plain version on
# the float32 inputs (output kept in float32): the kernel's worst row may
# be at most K5_TOL times the worst row of the plain version with the
# oracle's rounding (round_weights=True). The plain version at window
# W - 1 must fail the same gate.
K5_TOL = 2.0
# (B, S, H, KV, hd, W): the serving shape, a ragged S and an S < W.
K5_CASES = ((4, 4096, 16, 8, 256, 1024), (4, 4000, 16, 8, 256, 1024), (4, 700, 16, 8, 256, 1024))


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def diff_report(torch, got, want, rtol, atol) -> tuple[int, float, float]:
    """(entries outside ``atol + rtol * |want|`` or not NaN where the other
    is, max abs difference, max relative difference) over the entries that
    are NaN in neither. A difference where ``want`` is 0 is infinitely
    relative."""
    got, want = got.double().cpu(), want.double().cpu()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    n_bad = int((nan_g != nan_w).sum())
    ok = ~(nan_g | nan_w)
    if not bool(ok.any()):
        return n_bad, 0.0, 0.0
    diff, ref = (got - want).abs()[ok], want.abs()[ok]
    n_bad += int((diff > atol + rtol * ref).sum())
    rel = torch.where(diff == 0, torch.zeros_like(diff), diff / ref)
    return n_bad, float(diff.max()), float(rel.max())


def close_report(torch, got, want, rtol, atol, what) -> float:
    """allclose with an identical NaN pattern, or raise; returns the max abs
    difference over the entries that are not NaN."""
    n_bad, max_abs, max_rel = diff_report(torch, got, want, rtol, atol)
    check(n_bad == 0, f"{what}: {n_bad} entries outside rtol={rtol} atol={atol} or NaN "
                      f"patterns differ (max abs diff {max_abs}, max rel diff {max_rel})")
    return max_abs


def k1_report(torch, stats, want) -> dict:
    """Per stat of K1: (entries outside K1_TOL, max abs, max rel difference)."""
    return {s: diff_report(torch, stats[:, i], want[:, i], **K1_TOL[s])
            for i, s in enumerate(K1_STATS)}


def kernel_cases(np, sim, slice_i):
    """Comparison inputs: a full and the ragged last window of a real slice,
    and seeded synthetics (normal rows reach gamma's Wilson-Hilferty branch,
    wider ones its exact branch at k ~ 900; one observation; constant rows)."""
    from repro_torch.core.regions import Window

    g = sim.geometry
    rng = np.random.default_rng(0)
    return [
        ("window", sim.load_window(Window(slice_i, 0, 25))),
        ("last_window", sim.load_window(Window(slice_i, g.lines_per_slice - 1, g.lines_per_slice))),
        ("normal_37x513", rng.normal(3000.0, 10.0, (37, 513)).astype(np.float32)),
        ("gamma_mid_k_64x1000", rng.normal(3000.0, 100.0, (64, 1000)).astype(np.float32)),
        ("tiny_5x1", rng.normal(3000.0, 10.0, (5, 1)).astype(np.float32)),
        ("constant_5x100", np.full((5, 100), 7.0, np.float32)),
    ]


def compare_kernels(np, torch, cases, dev):
    """Each kernel against its plain version on the same tensors: K1 stats
    and edges, K2 errors for 4 and 10 types at L = 64 and 20; each launch
    repeated must be bitwise equal; a biased variance planted in K1's
    output must be rejected. Returns K1's worst (abs, rel) difference per
    stat and K2's max abs difference."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import pdf_error as pe
    from repro_torch.kernels.fitpdf import kernel

    worst_k1 = {s: (0.0, 0.0) for s in K1_STATS}
    err_edges = err_k2 = 0.0
    for name, arr in cases:
        x = torch.from_numpy(arr).to(dev)
        n = x.shape[1]
        planted = n > 1 and bool((x.amax(1) > x.amin(1)).any())  # a variance to bias
        for num_bins in (64, 20):
            stats, edges = kernel.moments_edges_stats(x, num_bins)
            stats2, edges2 = kernel.moments_edges_stats(x, num_bins)
            p_stats, p_edges = kernel.moments_edges_stats_plain(x, num_bins)
            sync(torch, dev)
            check(torch.equal(stats, stats2) and torch.equal(edges, edges2),
                  f"[K1] {name}: repeat launch differs")
            rep = k1_report(torch, stats, p_stats)
            for s, (_, a, r) in rep.items():
                worst_k1[s] = (max(worst_k1[s][0], a), max(worst_k1[s][1], r))
            bad = {s: v for s, v in rep.items() if v[0]}
            check(not bad, f"[K1] {name} L={num_bins}: stats outside K1_TOL "
                           f"(stat: entries, max abs, max rel) {bad}")
            err_edges = max(err_edges, close_report(torch, edges, p_edges, **EDGE_TOL,
                                                    what=f"[K1] {name} edges"))
            if planted:
                biased = stats.clone()
                biased[:, 1] *= (n - 1) / n
                check(k1_report(torch, biased, p_stats)["var"][0] > 0,
                      f"[K1] {name}: a biased variance (n/(n-1) dropped) passes the check")
        log(f"[K1] {name} {tuple(arr.shape)}: stats within K1_TOL and edges (rtol 1e-6, "
            f"atol 1e-3) of the plain version, repeat bitwise; "
            + ("planted biased variance rejected" if planted else "no variance to bias"))

        stats, _ = kernel.moments_edges_stats_plain(x, 64)
        m = dists.Moments(*(stats[:, i].contiguous() for i in range(6)))
        for types in (dists.TYPES_4, dists.TYPES_10):
            params = dists.fit_all(types, m).reshape(len(x), -1).contiguous()
            for num_bins in (64, 20):
                edges = pe.interval_edges(m.vmin, m.vmax, num_bins)
                args = (x, m.vmin, m.vmax, edges, params, types, num_bins)
                got = kernel.fit_error_counts(*args)
                got2 = kernel.fit_error_counts(*args)
                want = kernel.fit_error_counts_plain(*args)
                sync(torch, dev)
                check(torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(got2, nan=-1.0)),
                      f"[K2] {name} T={len(types)} L={num_bins}: repeat launch differs")
                err_k2 = max(err_k2, close_report(
                    torch, got, want, **ERR_TOL, what=f"[K2] {name} T={len(types)} L={num_bins}"))
        log(f"[K2] {name} {tuple(arr.shape)}: errors (rtol 1e-4, atol 5e-4) match the plain "
            f"version for 4 and 10 types at L=64 and 20, NaN pattern equal, repeat bitwise; "
            f"max abs diff so far {err_k2}")
    log("[K1] worst difference from the plain version over all cases, per stat "
        "(max abs, max rel): " + ", ".join(f"{s} ({a}, {r})" for s, (a, r) in worst_k1.items())
        + f"; edges max abs {err_edges}")
    return worst_k1, err_k2


def representatives(torch, x):
    """A real grouped representative list of window ``x``: the lowest row
    of each (mu, sigma) key group, as device Select finds it."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import grouping as grp

    m = dists.moments_from_values(x)
    groups = grp.group_device(grp.quantize_keys(m.mean, m.var))
    return grp.compact_representatives(groups.rep_for_point, groups.is_rep)[0]


def compare_new_kernels(np, torch, cases, dev):
    """K3 against its plain version (K1_TOL) and bitwise against K1's stats;
    K4's counts exactly equal to the scatter histogram at L = 64, 20 and 8,
    rows summing to n; K2 with ``row_indices`` (the window's grouped
    representatives, and a list with repeats) bitwise equal to K2 on the
    gathered rows and within the error tolerance of the plain version.
    Returns K3's worst (abs, rel) per stat and K2-with-rows' max abs
    difference from the plain version."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import pdf_error as pe
    from repro_torch.kernels.fitpdf import kernel
    from repro_torch.kernels.hist import kernel as hk
    from repro_torch.kernels.moments import kernel as mk

    worst_k3 = {s: (0.0, 0.0) for s in K1_STATS}
    err_rows = 0.0
    for name, arr in cases:
        x = torch.from_numpy(arr).to(dev)
        p, n = x.shape
        stats, again = mk.moments_stats(x), mk.moments_stats(x)
        k1_stats, _ = kernel.moments_edges_stats(x, 64)
        want = mk.moments_stats_plain(x)
        sync(torch, dev)
        check(torch.equal(stats, again), f"[K3] {name}: repeat launch differs")
        check(torch.equal(stats[:, :6], k1_stats[:, :6]),
              f"[K3] {name}: stats differ from K1's stats[:, :6]")
        rep = k1_report(torch, stats, want)
        for s, (_, a, r) in rep.items():
            worst_k3[s] = (max(worst_k3[s][0], a), max(worst_k3[s][1], r))
        bad = {s: v for s, v in rep.items() if v[0]}
        check(not bad, f"[K3] {name}: stats outside K1_TOL (stat: entries, max abs, max rel) {bad}")

        for num_bins in (64, 20, 8):
            counts = hk.hist_counts(x, want[:, 4].contiguous(), want[:, 5].contiguous(), num_bins)
            plain = hk.hist_counts_plain(x, want[:, 4], want[:, 5], num_bins)
            sync(torch, dev)
            check(torch.equal(counts, plain), f"[K4] {name} L={num_bins}: counts differ "
                  f"from the scatter histogram at {int((counts != plain).sum())} entries")
            check(bool((counts.sum(1) == n).all()), f"[K4] {name} L={num_bins}: a row does not sum to n")

        m = dists.Moments(*(want[:, i].contiguous() for i in range(6)))
        reps = representatives(torch, x)
        repeats = torch.from_numpy(np.random.default_rng(p).integers(0, p, 2 * p + 1)).to(dev)
        for idx in (reps, repeats):
            sub = dists.Moments(*(f[idx] for f in m))
            for types, num_bins in ((dists.TYPES_4, 64), (dists.TYPES_10, 20)):
                params = dists.fit_all(types, sub).reshape(len(idx), -1).contiguous()
                edges = pe.interval_edges(sub.vmin, sub.vmax, num_bins)
                args = (sub.vmin, sub.vmax, edges, params, types, num_bins)
                got = kernel.fit_error_counts(x, *args, row_indices=idx)
                gathered = kernel.fit_error_counts(x[idx].contiguous(), *args)
                plain = kernel.fit_error_counts_plain(x[idx], *args)
                sync(torch, dev)
                check(torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(gathered, nan=-1.0)),
                      f"[K2 rows] {name} T={len(types)} L={num_bins}: row_indices launch differs "
                      f"from the launch on the gathered rows")
                err_rows = max(err_rows, close_report(
                    torch, got, plain, **ERR_TOL, what=f"[K2 rows] {name} T={len(types)} L={num_bins}"))
        log(f"[K3/K4/K2 rows] {name} {tuple(arr.shape)}: K3 within K1_TOL of its plain version, "
            f"bitwise equal to K1's stats, repeat bitwise; K4 counts exact at L=64, 20, 8; K2 with "
            f"row_indices ({len(reps)} representatives, then {len(repeats)} rows with repeats) "
            f"bitwise equal to K2 on the gathered rows")
    log("[K3] worst difference from the plain version over all cases, per stat "
        "(max abs, max rel): " + ", ".join(f"{s} ({a}, {r})" for s, (a, r) in worst_k3.items())
        + f"; [K2 rows] max abs difference from the plain version {err_rows}")
    return worst_k3, err_rows


# ---------------------------------------------------------------------------
# the paths: one slice through PDFComputer each
# ---------------------------------------------------------------------------


def launch_counters():
    """Every kernel wrapper's launch count, by kernel name."""
    from repro_torch.kernels.band_attn import kernel as bk
    from repro_torch.kernels.fitpdf import kernel
    from repro_torch.kernels.hist import kernel as hk
    from repro_torch.kernels.moments import kernel as mk

    return {"moments_edges_stats": (kernel.moments_edges_stats, "launches"),
            "fit_error_counts": (kernel.fit_error_counts, "launches"),
            "fit_error_counts_row_indices": (kernel.fit_error_counts, "row_index_launches"),
            "moments_stats": (mk.moments_stats, "launches"),
            "hist_counts": (hk.hist_counts, "launches"),
            "banded_attention_kernel": (bk.banded_attention_kernel, "launches")}


def zero_counts() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counters().items()}


def drive(np, torch, cfg, sim, slice_i, dev, label, exec_config=None, tree=None):
    """One slice through the entry point with every launch count set to 0
    just before it and read just after; checks the result's shapes, range
    (sampling leaves unsampled points at type -1) and finiteness and logs
    wall, launches, sums of ``num_fitted`` and ``cache_hits`` and the
    median window compute. Returns (result, launches, wall seconds); the
    run's ``ExecutorReport`` is left in ``drive.last_report``."""
    from repro_torch.core.executor import RESULT_FIELDS
    from repro_torch.core.pipeline import PDFComputer

    sync(torch, dev)
    zero_counts()
    t0 = time.perf_counter()
    comp = PDFComputer(cfg, sim, tree=tree, device=dev, exec_config=exec_config)
    res = comp.run_slice(slice_i)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    drive.last_report = comp.last_report

    g = sim.geometry
    check(res.type_idx.shape == (g.points_per_slice,), f"[{label}] type_idx shape")
    check(res.params.shape == (g.points_per_slice, 3), f"[{label}] params shape")
    for f in RESULT_FIELDS[1:]:
        check(bool(np.isfinite(getattr(res, f)).all()), f"[{label}] {f} not finite")
    lowest = -1 if cfg.method == "sampling" else 0
    check(bool(((res.type_idx >= lowest) & (res.type_idx < len(cfg.types))).all()),
          f"[{label}] type_idx out of range")
    comp_ms = sorted(s.compute_seconds * 1e3 for s in res.stats)
    log(f"[{label}] method={cfg.method} fit_backend={cfg.fit_backend} "
        f"select_backend={cfg.select_backend} mode={cfg.mode} T={len(cfg.types)} L={cfg.num_bins}: "
        f"windows={len(res.stats)} wall_s={wall} median_window_compute_ms={comp_ms[len(comp_ms) // 2]} "
        f"sum_num_fitted={sum(s.num_fitted for s in res.stats)} "
        f"sum_cache_hits={sum(s.cache_hits for s in res.stats)} avg_error={res.avg_error}; "
        f"launches {json.dumps(launches)}")
    return res, launches, wall


def check_launches(launches, expect, label):
    """Each named kernel launched exactly as expected; the others not at all."""
    for name, n in launches.items():
        want = expect.get(name, 0)
        check(n == want, f"[{label}] {name} launched {n} times, expected {want}")


def bitwise_equal(np, a, b) -> bool:
    from repro_torch.core.executor import RESULT_FIELDS

    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in RESULT_FIELDS) \
        and a.avg_error == b.avg_error


def grouped_phases(np, torch, sim, slice_i, dev):
    """The grouping and reuse paths and the kernels backend's faithful mode,
    4 types at L = 64. Returns the launches of the runs that carry K3, K4
    and K2's prologue, and the walls."""
    from repro_torch.core.executor import RESULT_FIELDS
    from repro_torch.core.pipeline import ExecutorConfig, PDFConfig

    W = SET1_WINDOWS
    walls = {}

    # grouping on the kernels backend: K3 and K4 once per window.
    cfg = PDFConfig(method="grouping", fit_backend="kernels")
    grp_k, launches_k, walls["grouping_kernels"] = drive(
        np, torch, cfg, sim, slice_i, dev, "grouping kernels")
    check_launches(launches_k, {"moments_stats": W, "hist_counts": W}, "grouping kernels")
    again, _, _ = drive(np, torch, cfg, sim, slice_i, dev, "grouping kernels repeat")
    check(bitwise_equal(np, grp_k, again), "[grouping kernels] repeat run differs")
    ref_cfg = PDFConfig(method="grouping", fit_backend="reference")
    grp_ref, _, _ = drive(np, torch, ref_cfg, sim, slice_i, dev, "grouping reference")
    n_same, n_diff = slice_parity(np, torch, grp_k, grp_ref, sim, slice_i, cfg, dev,
                                  "[grouping kernels]")
    # The reference backend's two-pass moments may merge two near-identical
    # generator cells that the shifted sums keep apart (or the reverse), so
    # the group counts are logged, not held equal; K3 and K1 share one
    # formula, so the fused backend's counts are held equal below.
    log(f"[grouping kernels] repeat bitwise; parity with the reference backend ok "
        f"(type_idx equal at {n_same} points, {n_diff} ties); sum_num_fitted "
        f"{sum(s.num_fitted for s in grp_k.stats)} (reference backend "
        f"{sum(s.num_fitted for s in grp_ref.stats)})")

    # reuse on the kernels backend: K4 only where a window has cache misses.
    cfg = PDFConfig(method="reuse", fit_backend="kernels")
    reuse, launches, walls["reuse_kernels"] = drive(np, torch, cfg, sim, slice_i, dev, "reuse kernels")
    missed = sum(1 for s in reuse.stats if s.num_fitted)
    check_launches(launches, {"moments_stats": W, "hist_counts": missed}, "reuse kernels")
    hits = sum(s.cache_hits for s in reuse.stats)
    check(hits > 0, "[reuse kernels] no cache hit in the slice")
    serial, _, _ = drive(np, torch, cfg, sim, slice_i, dev, "reuse kernels serial",
                         exec_config=ExecutorConfig(prefetch=False, async_persist=False))
    check(bitwise_equal(np, reuse, serial), "[reuse kernels] prefetch on and off differ")
    check([(s.num_fitted, s.cache_hits) for s in reuse.stats]
          == [(s.num_fitted, s.cache_hits) for s in serial.stats],
          "[reuse kernels] prefetch on and off differ in num_fitted or cache_hits")
    slice_parity(np, torch, reuse, grp_k, sim, slice_i, cfg, dev, "[reuse kernels]")
    log(f"[reuse kernels] {missed} of {W} windows had cache misses, {hits} cache hits; prefetch "
        f"on and off bitwise equal; parity with grouping ok, bitwise equal to it: "
        f"{bitwise_equal(np, reuse, grp_k)}")

    # baseline on the kernels backend, faithful mode: K4 once per type and window.
    cfg = PDFConfig(fit_backend="kernels", mode="faithful")
    faithful, launches, walls["baseline_kernels_faithful"] = drive(
        np, torch, cfg, sim, slice_i, dev, "baseline kernels faithful")
    check_launches(launches, {"moments_stats": W, "hist_counts": len(cfg.types) * W},
                   "baseline kernels faithful")
    fused_cfg = PDFConfig(fit_backend="kernels")
    fused, launches, walls["baseline_kernels"] = drive(
        np, torch, fused_cfg, sim, slice_i, dev, "baseline kernels")
    check_launches(launches, {"moments_stats": W, "hist_counts": W}, "baseline kernels")
    same = bitwise_equal(np, faithful, fused)
    if not same:
        slice_parity(np, torch, faithful, fused, sim, slice_i, cfg, dev, "[baseline kernels faithful]")
    diffs = {f: float(np.max(np.abs(getattr(faithful, f).astype(np.float64)
                                    - getattr(fused, f).astype(np.float64))))
             for f in RESULT_FIELDS}
    log(f"[baseline kernels faithful] against fused mode: bitwise equal {same}; max abs "
        f"difference per field {json.dumps(diffs)}")

    # grouping on the fused backend: host Select against device Select.
    runs = {}
    for select in ("host", "device"):
        cfg = PDFConfig(method="grouping", select_backend=select)
        label = f"grouping fused {select}"
        runs[select], launches, walls[f"grouping_fused_{select}"] = drive(
            np, torch, cfg, sim, slice_i, dev, label)
        expect = {"moments_edges_stats": W, "fit_error_counts": W}
        if select == "device":
            expect["fit_error_counts_row_indices"] = W
            launches_rows = launches
        check_launches(launches, expect, label)
    check(bitwise_equal(np, runs["host"], runs["device"]),
          "[grouping fused] device Select differs from host Select")
    for select in ("host", "device"):
        check([s.num_fitted for s in runs[select].stats] == [s.num_fitted for s in grp_k.stats],
              f"[grouping fused {select}] per-window num_fitted differs from the kernels backend's")
    slice_parity(np, torch, runs["host"], grp_ref, sim, slice_i, cfg, dev, "[grouping fused]")
    log("[grouping fused] device Select bitwise equal to host Select, every window through "
        "K2's row_indices prologue; parity with grouping on the reference backend ok")
    return launches_k, launches_rows, walls


def slice_parity(np, torch, fused, ref, sim, slice_i, cfg, dev, what):
    """Hold the fused slice to the reference-backend slice: moments at the
    moments tolerance; type_idx equal except where the two chosen types'
    Eq.-5 errors (recomputed on the plain path from the reference moments)
    are within the error tolerance, i.e. a tie; params (moments tolerance)
    and error where the types agree; Eq.-6 averages within atol."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import pdf_error as pe
    from repro_torch.core.regions import Window
    from repro_torch.kernels.fitpdf.kernel import fit_error_counts_plain

    for name in ("mean", "std", "skew", "kurt"):
        close_report(torch, torch.from_numpy(getattr(fused, name)),
                     torch.from_numpy(getattr(ref, name)), **MOM_TOL, what=f"{what} {name}")
    same = fused.type_idx == ref.type_idx
    diff_pts = np.flatnonzero(~same)
    ppl = sim.geometry.points_per_line
    for line in sorted(set((diff_pts // ppl).tolist())):
        vals = torch.from_numpy(sim.load_window(Window(slice_i, line, line + 1))).to(dev)
        m = dists.moments_from_values(vals)
        params = dists.fit_all(cfg.types, m).reshape(len(vals), -1)
        edges = pe.interval_edges(m.vmin, m.vmax, cfg.num_bins)
        errs = fit_error_counts_plain(vals, m.vmin, m.vmax, edges, params,
                                      cfg.types, cfg.num_bins).cpu().numpy()
        for pt in diff_pts[diff_pts // ppl == line]:
            a, b = errs[pt % ppl][fused.type_idx[pt]], errs[pt % ppl][ref.type_idx[pt]]
            check(abs(a - b) <= ERR_TOL["atol"] + ERR_TOL["rtol"] * abs(b),
                  f"{what}: point {pt} picks type {fused.type_idx[pt]} over "
                  f"{ref.type_idx[pt]} with Eq.-5 errors {a} vs {b}")
    sel = torch.from_numpy(same)
    close_report(torch, torch.from_numpy(fused.params)[sel], torch.from_numpy(ref.params)[sel],
                 **MOM_TOL, what=f"{what} params")
    close_report(torch, torch.from_numpy(fused.error)[sel], torch.from_numpy(ref.error)[sel],
                 **ERR_TOL, what=f"{what} error")
    check(abs(fused.avg_error - ref.avg_error) <= ERR_TOL["atol"],
          f"{what}: avg_error {fused.avg_error} vs {ref.avg_error}")
    return int(same.sum()), len(diff_pts)


def run_slice_phase(np, torch, sim, slice_i, types, num_bins, dev, windows):
    """Baseline on the fused backend: one slice through the entry point,
    counted (K1 once a window, K2 once a window and chunk of bins); again,
    bitwise; and once on the reference backend for the parity check.
    Returns (launches, wall)."""
    from repro_torch.core.pipeline import PDFConfig
    from repro_torch.kernels.fitpdf import kernel

    label = f"slice {len(types)}types_L{num_bins}"
    cfg = PDFConfig(types=types, num_bins=num_bins)
    chunks = -(-num_bins // kernel._fit_error_chunk(dev.index))
    log(f"[{label}] slice {slice_i}: {sim.geometry}, {sim.config.num_simulations} "
        f"observations, window_lines={cfg.window_lines}; K2 in {chunks} launch(es) a window")
    torch.cuda.reset_peak_memory_stats(dev)
    res, launches, wall = drive(np, torch, cfg, sim, slice_i, dev, label)
    check_launches(launches, {"moments_edges_stats": windows,
                              "fit_error_counts": windows * chunks}, label)
    peak = torch.cuda.max_memory_allocated(dev)
    hist = np.bincount(res.type_idx, minlength=len(types))
    log(f"[{label}] load_s={res.total_load_seconds} wait_s={res.total_wait_seconds} "
        f"max_memory_allocated_bytes={peak} type_histogram "
        f"{json.dumps({t: int(c) for t, c in zip(types, hist)})}")

    again, _, _ = drive(np, torch, cfg, sim, slice_i, dev, f"{label} repeat")
    check(bitwise_equal(np, res, again), f"[{label}] repeat run differs")
    log(f"[{label}] repeat run bitwise equal")

    ref_cfg = PDFConfig(types=types, num_bins=num_bins, fit_backend="reference")
    ref, _, _ = drive(np, torch, ref_cfg, sim, slice_i, dev, f"{label} reference")
    n_same, n_diff = slice_parity(np, torch, res, ref, sim, slice_i, cfg, dev, f"[{label}]")
    log(f"[{label}] reference backend (plain PyTorch on the same device): type_idx equal at "
        f"{n_same}/{len(res.type_idx)} points, the other {n_diff} are ties within the error "
        f"tolerance; parity ok")
    return launches, wall


def kernels_window_phase(np, torch, x, num_bins, dev):
    """One Set1 window through the ``kernels`` backend at ``num_bins``
    (K4 past the bins one block held before the chunked route), counted,
    against the port's plain backend: K3's moments within the moments
    tolerance of the plain backend's two-pass moments, and the fit on K3's
    moments bitwise equal to the plain backend's fit on the same moments
    (K4's counts are exact). Returns the launches."""
    from repro_torch.core import distributions as dists
    from repro_torch.core.fitting import get_fit_backend

    label = f"window kernels L={num_bins}"
    kern, plain = get_fit_backend("kernels", num_bins), get_fit_backend("reference", num_bins)
    sync(torch, dev)
    zero_counts()
    m = kern.moments(x)
    res = kern.fit_all(x, m, dists.TYPES_4, num_bins)
    sync(torch, dev)
    launches = read_counts()
    check_launches(launches, {"moments_stats": 1, "hist_counts": 1}, label)
    want = plain.fit_all(x, m, dists.TYPES_4, num_bins)
    for f in res._fields:
        check(torch.equal(getattr(res, f), getattr(want, f)),
              f"[{label}] {f} differs from the plain backend's on the same moments")
    m_plain = plain.moments(x)
    for name in ("mean", "var", "skew", "kurt", "vmin", "vmax"):
        close_report(torch, getattr(m, name), getattr(m_plain, name), **MOM_TOL,
                     what=f"[{label}] {name}")
    hist = np.bincount(res.type_idx.cpu().numpy(), minlength=len(dists.TYPES_4))
    log(f"[{label}] {tuple(x.shape)}: launches {json.dumps(launches)}; K3 moments within the moments "
        f"tolerance of the plain backend's; fit bitwise equal to the plain backend's on the same "
        f"moments; type histogram {hist.tolist()}")
    return launches


# ---------------------------------------------------------------------------
# the ML and sampling methods (§5.3-5.4)
# ---------------------------------------------------------------------------


def tree_margin(np, torch, tree, got, ref, what):
    """The tree-margin rule (ML's counterpart of ``slice_parity``'s tie
    rule), ``ref`` the plain backend's slice: moments within MOM_TOL; over
    the classified points (sampling's unsampled ones are -1 on both sides)
    a point is decided when it reaches one leaf with its features moved
    within the tolerance MOM_TOL gives them (``ml_predict.feature_tolerance``:
    cv carries the relative errors of std and mean, skew and kurt MOM_TOL
    itself); decided points have the same type, every point's type is the
    label of a leaf it may reach; where the types agree, params within
    MOM_TOL and errors within ERR_TOL. Returns (decided, undecided, type
    equal)."""
    from repro_torch.core.ml_predict import feature_tolerance, reachable_leaves, tree_features_np

    for name in ("mean", "std", "skew", "kurt"):
        close_report(torch, torch.from_numpy(getattr(got, name)),
                     torch.from_numpy(getattr(ref, name)), **MOM_TOL, what=f"{what} {name}")
    cls = ref.type_idx >= 0
    check(np.array_equal(got.type_idx >= 0, cls), f"{what}: classified points differ")
    feats = tree_features_np(ref.mean, ref.std, ref.skew, ref.kurt)[cls]
    reach = reachable_leaves(tree, feats, feature_tolerance(
        ref.mean[cls], ref.std[cls], ref.skew[cls], ref.kurt[cls], **MOM_TOL))
    ok = reach.sum(1) == 1
    got_t, ref_t = got.type_idx[cls], ref.type_idx[cls]
    check(np.array_equal(got_t[ok], ref_t[ok]),
          f"{what}: {int((got_t[ok] != ref_t[ok]).sum())} decided points differ in type")
    check(bool((reach & (tree.leaf_label[None, :] == got_t[:, None])).any(1).all()),
          f"{what}: a point's type is no leaf it can reach")
    same = torch.from_numpy(got.type_idx == ref.type_idx)
    close_report(torch, torch.from_numpy(got.params)[same], torch.from_numpy(ref.params)[same],
                 **MOM_TOL, what=f"{what} params")
    close_report(torch, torch.from_numpy(got.error)[same], torch.from_numpy(ref.error)[same],
                 **ERR_TOL, what=f"{what} error")
    check(abs(got.avg_error - ref.avg_error) <= ERR_TOL["atol"],
          f"{what}: avg_error {got.avg_error} vs {ref.avg_error}")
    return int(ok.sum()), int((~ok).sum()), int((got_t == ref_t).sum())


def train_phase(np, torch, sim, dev):
    """The decision tree of TreeSpec's defaults (slices 0-3, windows of 4
    lines, depth 4, 32 bins) through ``train_type_tree`` on the card; then
    the same baseline slices once more, whose features must train the same
    tree bit for bit, for its model error on its own training data.
    Returns the tree and its numbers."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import ml_predict as mlp
    from repro_torch.core.pipeline import PDFComputer, PDFConfig, train_type_tree

    sync(torch, dev)
    t0 = time.perf_counter()
    tree = train_type_tree(sim, dists.TYPES_4, device=dev)
    wall = time.perf_counter() - t0
    feats, labels = [], []
    t0 = time.perf_counter()
    for s in (0, 1, 2, 3):
        res = PDFComputer(PDFConfig(window_lines=4), sim, device=dev).run_slice(s)
        feats.append(mlp.tree_features_np(res.mean, res.std, res.skew, res.kurt))
        labels.append(res.type_idx)
    baseline_s = time.perf_counter() - t0
    x, y = np.concatenate(feats), np.concatenate(labels)
    t0 = time.perf_counter()
    again = mlp.train_tree(x, y, len(dists.TYPES_4), depth=4, max_bins=32)
    cart_s = time.perf_counter() - t0
    check(all(np.array_equal(getattr(tree, f), getattr(again, f))
              for f in ("feature", "threshold", "leaf_label")),
          "[tree] the baseline's features again train another tree")
    err = mlp.model_error(tree, x, y)
    g = sim.geometry
    nums = dict(train_wall_s=wall, baseline_s=baseline_s, cart_s=cart_s, points=len(y),
                windows=4 * -(-g.lines_per_slice // 4), model_error=err)
    log(f"[tree] train_type_tree(sim, TYPES_4, device={dev}): slices 0-3, window_lines=4, depth 4, "
        f"max_bins 32: {len(y)} points in {nums['windows']} windows; wall {wall} s (its baseline "
        f"slices alone again {baseline_s} s, host CART alone again {cart_s} s); retrained bitwise "
        f"from the repeated baseline; model_error on its training data {err}; type histogram "
        f"{np.bincount(y, minlength=4).tolist()}; feature {tree.feature.tolist()} threshold "
        f"{tree.threshold.tolist()} leaf_label {tree.leaf_label.tolist()}")
    return tree, nums


def check_subset_k1(np, torch, sim, slice_i, cfg, tree, dev):
    """K1 on the random sampler's subsets of the first and the 1-line last
    window (the rows the sampling path feeds it) against its plain version:
    stats within K1_TOL, edges within EDGE_TOL."""
    from repro_torch.core.pipeline import PDFComputer
    from repro_torch.core.regions import Window
    from repro_torch.kernels.fitpdf import kernel

    g = sim.geometry
    ex = PDFComputer(cfg, sim, tree=tree, device=dev).executor
    shapes = []
    for w in (Window(slice_i, 0, cfg.window_lines), Window(slice_i, g.lines_per_slice - 1,
                                                           g.lines_per_slice)):
        x = torch.from_numpy(sim.load_window(w)).to(dev)
        sub = x[torch.from_numpy(ex._draw_sample(len(x), w)).to(dev)]
        stats, edges = kernel.moments_edges_stats(sub, cfg.num_bins)
        p_stats, p_edges = kernel.moments_edges_stats_plain(sub, cfg.num_bins)
        sync(torch, dev)
        bad = {s: v for s, v in k1_report(torch, stats, p_stats).items() if v[0]}
        check(not bad, f"[K1 sampled] {tuple(sub.shape)}: stats outside K1_TOL {bad}")
        close_report(torch, edges, p_edges, **EDGE_TOL, what=f"[K1 sampled] {tuple(sub.shape)} edges")
        shapes.append(tuple(sub.shape))
    log(f"[K1 sampled] the random sampler's subsets {shapes}: K1 stats within K1_TOL and edges "
        f"within (rtol 1e-6, atol 1e-3) of its plain version")
def ml_phases(np, torch, sim, slice_i, dev, tree):
    """The ML methods on ``fused`` and ``kernels``, sampling, and the
    paper's Set1 configuration (``grouping_ml``, 4 types, L = 20), each
    through the entry point with its launches counted; bitwise checks
    within the port, the tree-margin rule against the plain backend on the
    card. Returns ({label: launches}, {label: wall}, {label: numbers})."""
    from repro_torch.core import distributions as dists
    from repro_torch.core.pipeline import ExecutorConfig, PDFConfig
    from repro_torch.core.sampling import type_percentage_distance

    W = SET1_WINDOWS
    serial = ExecutorConfig(prefetch=False, async_persist=False)
    launches, walls, nums = {}, {}, {}

    def run(cfg, label, expect=None, **kw):
        res, launches[label], walls[label] = drive(np, torch, cfg, sim, slice_i, dev, label,
                                                   tree=tree, **kw)
        if expect is not None:
            check_launches(launches[label], expect, label)
        return res

    def margin(got, ref, label):
        n_dec, n_undec, n_same = tree_margin(np, torch, tree, got, ref, f"[{label}]")
        nums[label] = dict(decided=n_dec, undecided=n_undec, type_equal=n_same)
        log(f"[{label}] tree-margin rule against the plain backend ok: {n_dec} points decided, "
            f"{n_undec} undecided (a threshold within the feature tolerance), type equal at "
            f"{n_same}/{n_dec + n_undec} classified points")

    fused_k = {"moments_edges_stats": W, "fit_error_counts": W}

    # ml: K1 and K2 (over all T types) once a window; prefetch on and off.
    ml = run(PDFConfig(method="ml"), "ml fused", fused_k)
    ml_serial = run(PDFConfig(method="ml"), "ml fused serial", fused_k, exec_config=serial)
    check(bitwise_equal(np, ml, ml_serial), "[ml fused] prefetch on and off differ")
    ml_ref = run(PDFConfig(method="ml", fit_backend="reference"), "ml reference", {})
    margin(ml, ml_ref, "ml fused")

    # grouping_ml: host Select, device Select (no row_indices route).
    grp = {}
    for select in ("host", "device"):
        grp[select] = run(PDFConfig(method="grouping_ml", select_backend=select),
                          f"grouping_ml fused {select}", fused_k)
    check(bitwise_equal(np, grp["host"], grp["device"]),
          "[grouping_ml fused] device Select differs from host Select")
    grouping = run(PDFConfig(method="grouping"), "grouping fused (for num_fitted)", fused_k)
    check([w.num_fitted for w in grp["host"].stats] == [w.num_fitted for w in grouping.stats],
          "[grouping_ml fused] per-window num_fitted differs from grouping's")
    grp_ref = run(PDFConfig(method="grouping_ml", fit_backend="reference"), "grouping_ml reference", {})
    margin(grp["host"], grp_ref, "grouping_ml fused")

    # reuse_ml: K2 only where a window has cache misses; host vs device Select.
    reuse = {}
    for select in ("host", "device"):
        reuse[select] = run(PDFConfig(method="reuse_ml", select_backend=select),
                            f"reuse_ml fused {select}")
        missed = sum(1 for w in reuse[select].stats if w.num_fitted)
        check_launches(launches[f"reuse_ml fused {select}"],
                       {"moments_edges_stats": W, "fit_error_counts": missed},
                       f"reuse_ml fused {select}")
    check(bitwise_equal(np, reuse["host"], reuse["device"]),
          "[reuse_ml fused] device Select differs from host Select")
    check([(w.num_fitted, w.cache_hits) for w in reuse["host"].stats]
          == [(w.num_fitted, w.cache_hits) for w in reuse["device"].stats],
          "[reuse_ml fused] host and device Select differ in num_fitted or cache_hits")
    hits = sum(w.cache_hits for w in reuse["host"].stats)
    check(hits > 0, "[reuse_ml fused] no cache hit in the slice")
    reuse_ref = run(PDFConfig(method="reuse_ml", fit_backend="reference"), "reuse_ml reference", {})
    margin(reuse["host"], reuse_ref, "reuse_ml fused")
    log(f"[reuse_ml fused] {missed} of {W} windows with cache misses, {hits} cache hits; host and "
        f"device Select bitwise equal")

    # ml on the kernels backend: K3 once a window, K4 once a window (not per type).
    ml_k = run(PDFConfig(method="ml", fit_backend="kernels"), "ml kernels",
               {"moments_stats": W, "hist_counts": W})
    margin(ml_k, ml_ref, "ml kernels")

    # sampling: no fitting, K1 on the random subsets (or the whole window
    # for k-means), no K2.
    g = sim.geometry
    ppl = g.points_per_line
    baseline = run(PDFConfig(), "baseline fused (for slice features)", fused_k)
    base_f = baseline.features(dists.TYPES_4)
    for sampler in ("random", "kmeans"):
        cfg = PDFConfig(method="sampling", sampler=sampler, sample_frac=0.1)
        label = f"sampling {sampler}"
        res = run(cfg, label, {"moments_edges_stats": W})
        off = res.type_idx < 0
        check(bool((res.type_idx[off] == -1).all()) and not res.params[off].any()
              and not res.error.any(), f"[{label}] unsampled points carry a type, params or error")
        want = [max(1, round(0.1 * (w.window.line_end - w.window.line_start) * ppl))
                for w in res.stats]
        got_n = [w.num_fitted for w in res.stats]
        if sampler == "random":
            check(got_n == want, f"[{label}] classified {got_n} a window, expected {want}")
            check(int((~off).sum()) == sum(want), f"[{label}] classified points != the draws")
            again = run(cfg, f"{label} serial", {"moments_edges_stats": W}, exec_config=serial)
            check(bitwise_equal(np, res, again), f"[{label}] prefetch on and off differ")
            ref = run(PDFConfig(method="sampling", fit_backend="reference"), f"{label} reference", {})
            margin(res, ref, label)
            check_subset_k1(np, torch, sim, slice_i, cfg, tree, dev)
        else:  # k-means: one point a non-empty cluster, at most k
            check(all(1 <= n <= k for n, k in zip(got_n, want)) and sum(got_n) == int((~off).sum()),
                  f"[{label}] classified {got_n} a window, clusters {want}")
        f = res.features(dists.TYPES_4)
        nums[f"{label} features"] = dict(classified=int((~off).sum()),
                           type_percentage=f.type_percentage.tolist(),
                           distance_to_baseline=type_percentage_distance(
                               f.type_percentage, base_f.type_percentage),
                           avg_mean=f.avg_mean, avg_std=f.avg_std)
        log(f"[{label}] slice features against the baseline slice's (Fig. 17): type percentages "
            f"{f.type_percentage.tolist()} vs {base_f.type_percentage.tolist()}, distance "
            f"{nums[label + ' features']['distance_to_baseline']}; avg mean {f.avg_mean} vs {base_f.avg_mean}, "
            f"avg std {f.avg_std} vs {base_f.avg_std}; {f.num_sampled} points classified")

    # The paper's Set1 configuration (configs/pdf_seismic.py SET1).
    set1 = PDFConfig(method="grouping_ml", num_bins=20)
    paper = run(set1, "set1 grouping_ml L20", fused_k)
    paper_ref = run(PDFConfig(method="grouping_ml", num_bins=20, fit_backend="reference"),
                    "set1 grouping_ml L20 reference", {})
    margin(paper, paper_ref, "set1 grouping_ml L20")
    return launches, walls, nums


# ---------------------------------------------------------------------------
# the executor's load stage, file cubes, faults, scheduler and batches
# ---------------------------------------------------------------------------


def pageable_stage(np, torch, raw, dev):
    """The load stage's copy before the pinned stager: a pageable,
    synchronous ``torch.from_numpy(raw).to(dev)``. Kept here only, as the
    yardstick of ``[staging]``."""
    return torch.from_numpy(np.ascontiguousarray(raw, dtype=np.float32)).to(dev)


def staging_phase(np, torch, sim, slice_i, dev):
    """One Set1 window staged the old pageable way and through the pinned
    stager: the same bits, and each one's ms (median of 10, host clock to a
    synchronize; the pinned stage also until its host call returns, what
    ``load_seconds`` counts). Then a baseline ``fused`` slice, counted,
    bitwise equal to the same slice with ``prefetch=False``. Returns
    (the slice's result, numbers)."""
    from repro_torch.core.pipeline import ExecutorConfig, PDFConfig
    from repro_torch.core.regions import Window
    from repro_torch.data.loader import WindowStager
    from repro_torch.kernels._timing import median

    raw = sim.load_window(Window(slice_i, 0, 25))
    stager = WindowStager(dev)
    old = pageable_stage(np, torch, raw, dev)
    new = stager.ready(stager.stage(raw))
    sync(torch, dev)
    check(torch.equal(old, new), "[staging] the pinned stage differs from the pageable copy")
    times = {"pageable_ms": [], "pinned_ms": [], "pinned_dispatch_ms": []}
    for _ in range(10):
        sync(torch, dev)
        t0 = time.perf_counter()
        pageable_stage(np, torch, raw, dev)
        sync(torch, dev)
        times["pageable_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        staged = stager.stage(raw)
        times["pinned_dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        stager.ready(staged)
        sync(torch, dev)
        times["pinned_ms"].append((time.perf_counter() - t0) * 1e3)
    # The host half of the pinned stage alone: the window into a pinned
    # buffer by one numpy thread (the stager's first design) and by
    # PyTorch's threaded CPU copy (what it does).
    pinned = torch.empty(raw.shape, dtype=torch.float32, pin_memory=dev.type == "cuda")
    src = torch.from_numpy(raw)
    times.update(host_copy_numpy_ms=[], host_copy_torch_ms=[])
    for _ in range(10):
        t0 = time.perf_counter()
        np.copyto(pinned.numpy(), raw)
        times["host_copy_numpy_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        pinned.copy_(src)
        times["host_copy_torch_ms"].append((time.perf_counter() - t0) * 1e3)
    check(torch.equal(pinned, src), "[staging] the pinned host copy differs")
    nums = {k: median(v) for k, v in times.items()}
    nums["window_bytes"] = raw.nbytes
    nums["torch_threads"] = torch.get_num_threads()
    log(f"[staging] one Set1 window {raw.shape} ({raw.nbytes} B): pinned stage bitwise equal to the "
        f"pageable copy; pageable {nums['pageable_ms']} ms, pinned {nums['pinned_ms']} ms (its host "
        f"call returns after {nums['pinned_dispatch_ms']} ms), medians of 10; pool "
        f"{len(stager._slots)} buffer(s), {stager.pool_waits} wait(s); the host copy into a pinned "
        f"buffer alone: numpy (one thread) {nums['host_copy_numpy_ms']} ms, PyTorch "
        f"({nums['torch_threads']} threads) {nums['host_copy_torch_ms']} ms")

    W = SET1_WINDOWS
    fused_k = {"moments_edges_stats": W, "fit_error_counts": W}
    res, launches, wall = drive(np, torch, PDFConfig(), sim, slice_i, dev, "staging baseline fused")
    check_launches(launches, fused_k, "staging baseline fused")
    rep = drive.last_report
    serial, launches_s, wall_s = drive(np, torch, PDFConfig(), sim, slice_i, dev,
                                       "staging baseline fused serial",
                                       exec_config=ExecutorConfig(prefetch=False, async_persist=False))
    check_launches(launches_s, fused_k, "staging baseline fused serial")
    check(bitwise_equal(np, res, serial), "[staging] prefetch on and off differ")
    nums.update(wall_s=wall, serial_wall_s=wall_s, load_s=rep.load_seconds, wait_s=rep.wait_seconds,
                load_hidden_fraction=rep.load_hidden_fraction)
    log(f"[staging] baseline fused slice {slice_i}: prefetch on and off bitwise equal; wall {wall} s "
        f"(serial {wall_s} s), load_s {rep.load_seconds}, wait_s {rep.wait_seconds}, "
        f"load_hidden_fraction {rep.load_hidden_fraction}")
    return res, nums


class SliceView:
    """One slice of a cube as a cube of its own (slice 0 of the view is
    ``slice_i`` of ``source``): what ``[file]`` exports, 0.5 GB for Set1."""

    def __init__(self, source, slice_i):
        from repro_torch.core.regions import CubeGeometry

        g = source.geometry
        self.source, self.slice_i = source, slice_i
        self.geometry = CubeGeometry(1, g.lines_per_slice, g.points_per_line)

    def load_window(self, w):
        from repro_torch.core.regions import Window

        check(w.slice_i == 0, f"SliceView has one slice, asked for {w}")
        return self.source.load_window(Window(self.slice_i, w.line_start, w.line_end))


def file_phase(np, torch, sim, slice_i, dev, clean, tmp):
    """Export slice ``slice_i`` through a one-slice view into ``tmp``, hold
    every window of the cube bitwise against the simulation's, and run the
    slice from the cube (page cache) with verified reads off and on, and
    once through ``ThrottledSource``: each bitwise equal to ``clean`` (the
    simulation's slice), K1/K2 once a window. Returns (cube path, numbers)."""
    from repro_torch.core.pipeline import PDFConfig
    from repro_torch.core.regions import Window, iter_windows
    from repro_torch.data.file_source import FileCubeSource, export_cube
    from repro_torch.data.loader import ThrottledSource

    view = SliceView(sim, slice_i)
    t0 = time.perf_counter()
    fspec = export_cube(view, tmp / "cube")
    export_s = time.perf_counter() - t0
    path = Path(fspec.path)
    cube = FileCubeSource(path)
    check(fspec.kind == "file" and (fspec.num_slices, fspec.observations) == (
        1, sim.config.num_simulations), f"[file] export_cube returned {fspec}")
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    log(f"[file] exported slice {slice_i} of Set1 in {export_s} s: {len(cube.manifest['chunks'])} "
        f"chunks of {cube.manifest['lines_per_chunk']} lines, {nbytes} B on disk, content_sha256 "
        f"{cube.content_sha256}; returned {fspec}")
    t0 = time.perf_counter()
    for w in iter_windows(cube.geometry, 0, 25):
        check(np.array_equal(cube.load_window(w), sim.load_window(Window(slice_i, w.line_start,
                                                                          w.line_end))),
              f"[file] window {tuple(w)} of the cube differs from the simulation's")
    log(f"[file] every window of the cube bitwise equal to the simulation's load_window "
        f"({time.perf_counter() - t0} s for both)")

    W = SET1_WINDOWS
    fused_k = {"moments_edges_stats": W, "fit_error_counts": W}
    nums = dict(export_s=export_s, cube_bytes=nbytes)
    for label, source in (("file", cube), ("file verified", FileCubeSource(path, verify_reads=True)),
                          ("file throttled 2 GB/s", ThrottledSource(cube, 2e9))):
        res, launches, wall = drive(np, torch, PDFConfig(), source, 0, dev, label)
        check_launches(launches, fused_k, label)
        check(bitwise_equal(np, res, clean), f"[{label}] differs from the simulation's slice")
        rep = drive.last_report
        nums[label] = dict(wall_s=wall, load_s=rep.load_seconds, wait_s=rep.wait_seconds,
                           compute_s=rep.compute_seconds,
                           load_hidden_fraction=rep.load_hidden_fraction)
        log(f"[{label}] slice from the cube (read from the page cache: just written) bitwise equal "
            f"to the simulation's; wall {wall} s, load_s {rep.load_seconds}, wait_s "
            f"{rep.wait_seconds}, compute_s {rep.compute_seconds}, load_hidden_fraction "
            f"{rep.load_hidden_fraction}")
    return path, nums


FAULT_LINES = dict(read_error=50, latency=300, corrupt=64, persist_error=100, quarantined=200)


def fault_plan():
    """One plan over the one-slice cube: transient read errors, a straggler
    above ``straggler_grace_s`` (speculation fires), a torn chunk read
    (healed by the re-read), a persist error (absorbed by the persist
    stage) and a window whose reads never succeed (quarantined)."""
    from repro_torch.runtime.faults import FaultPlan, FaultRule

    L = FAULT_LINES
    return FaultPlan(seed=0, rules=(
        FaultRule("read_error", slice_i=0, line_start=L["read_error"], times=1),
        FaultRule("read_error", slice_i=0, rate=0.3, times=1),
        FaultRule("latency", slice_i=0, line_start=L["latency"], seconds=2.0),
        FaultRule("corrupt", slice_i=0, line_start=L["corrupt"], times=1),
        FaultRule("persist_error", slice_i=0, line_start=L["persist_error"], times=1),
        FaultRule("read_error", slice_i=0, line_start=L["quarantined"], times=10_000)))


def faults_phase(np, torch, path, dev, clean, tmp):
    """The fault plan over the cube through ``StagedExecutor(...,
    injector=...)``: every point outside the quarantined window bitwise
    equal to ``clean``, that window at type -1 with zeros, its failed-unit
    manifest on disk; K1/K2 once a computed window (the quarantined one
    launches nothing; retries here are load retries); then with
    ``degraded_mode=False`` the same plan must raise. Returns (numbers, the
    degraded slice)."""
    from repro_torch.core.executor import RESULT_FIELDS, ExecutorConfig, PDFConfig, StagedExecutor
    from repro_torch.data.file_source import FileCubeSource
    from repro_torch.runtime.faults import FaultInjector

    ec = dict(max_retries=2, retry_backoff_s=0.01, speculate=True, straggler_grace_s=0.5)
    inj = FaultInjector(fault_plan())
    ex = StagedExecutor(PDFConfig(), inj.wrap_source(FileCubeSource(path)), dev, injector=inj,
                        out_dir=tmp / "faults", exec_config=ExecutorConfig(**ec))
    sync(torch, dev)
    zero_counts()
    t0 = time.perf_counter()
    res = ex.run_slice(0)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    rep = ex.last_report
    W = SET1_WINDOWS
    check_launches(launches, {"moments_edges_stats": W - 1, "fit_error_counts": W - 1}, "faults")
    ppl = ex.data.geometry.points_per_line
    lo, hi = FAULT_LINES["quarantined"] * ppl, (FAULT_LINES["quarantined"] + 25) * ppl
    check([q["line_start"] for q in res.quarantined] == [FAULT_LINES["quarantined"]]
          and res.quarantined[0]["attempts"] == ec["max_retries"] + 1,
          f"[faults] quarantined {res.quarantined}")
    check(bool((res.type_idx[lo:hi] == -1).all()), "[faults] the quarantined window is not at type -1")
    for f in RESULT_FIELDS:
        got, want = getattr(res, f), getattr(clean, f)
        check(np.array_equal(got[:lo], want[:lo]) and np.array_equal(got[hi:], want[hi:]),
              f"[faults] {f} differs from the clean run outside the quarantined window")
        if f != "type_idx":
            check(not got[lo:hi].any(), f"[faults] {f} not zero in the quarantined window")
    manifest = json.loads((tmp / "faults" / "slice0_failed_units.json").read_text())
    check([e["line_start"] for e in manifest["failed"]] == [FAULT_LINES["quarantined"]],
          f"[faults] failed-unit manifest {manifest}")
    check(rep.speculations >= 1 and rep.speculation_wins >= 1, "[faults] no speculation won")
    check(inj.events.get("corrupt") == 1 and inj.events.get("persist_error") == 1
          and inj.events.get("latency") == 1, f"[faults] events {inj.events}")
    nums = dict(wall_s=wall, retries=rep.retries, speculations=rep.speculations,
                speculation_wins=rep.speculation_wins, quarantined=rep.quarantined,
                events=dict(inj.events), launches=launches)
    log(f"[faults] slice from the cube under the plan ({len(fault_plan().rules)} rules): wall {wall} s; "
        f"retries {rep.retries}, speculations {rep.speculations}, speculation_wins "
        f"{rep.speculation_wins}, quarantined {rep.quarantined}; injector events "
        f"{json.dumps(inj.events)}; every point outside lines {FAULT_LINES['quarantined']}-"
        f"{FAULT_LINES['quarantined'] + 25} bitwise equal to the clean run; failed-unit manifest "
        f"on disk; launches {json.dumps(launches)}")

    inj = FaultInjector(fault_plan())
    strict = StagedExecutor(PDFConfig(), inj.wrap_source(FileCubeSource(path)), dev, injector=inj,
                            out_dir=tmp / "strict",
                            exec_config=ExecutorConfig(**ec, degraded_mode=False))
    try:
        strict.run_slice(0)
    except RuntimeError as e:
        check("failed after 3 attempts" in str(e), f"[faults] degraded_mode=False raised {e!r}")
        log(f"[faults] degraded_mode=False: the same plan raises: {e}")
    else:
        raise SmokeFailure("[faults] degraded_mode=False did not raise")
    return nums, res


def scheduler_phase(np, torch, sim, dev, tmp):
    """``SliceScheduler`` with 2 shards over slices 200 and 201, shard 0
    lost after its first window: its slice re-dealt to shard 1, resumed
    from the window it persisted, the merged results bitwise equal to a
    clean run of both slices. Returns numbers."""
    from repro_torch.core.executor import PDFConfig, StagedExecutor
    from repro_torch.core.pipeline import PDFComputer
    from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultRule
    from repro_torch.runtime.scheduler import SliceScheduler

    slices = [SET1_SLICE - 1, SET1_SLICE]
    clean = PDFComputer(PDFConfig(), sim, device=dev).run(slices)
    inj = FaultInjector(FaultPlan(rules=(FaultRule("shard_death", shard=0, after_units=1),)))
    sched = SliceScheduler(num_shards=2)
    sync(torch, dev)
    zero_counts()
    t0 = time.perf_counter()
    got = sched.run(lambda shard: StagedExecutor(PDFConfig(), inj.wrap_source(sim, shard=shard), dev,
                                                 injector=inj, out_dir=tmp / "sched"), slices)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    W = SET1_WINDOWS
    # slice 201 on shard 1; slice 200's first window on shard 0, its other 20 re-dealt
    expect = 2 * W
    check_launches(launches, {"moments_edges_stats": expect, "fit_error_counts": expect}, "scheduler")
    check(sched.lost_shards == (0,) and sched.last_redeal.slices_for(1) == (SET1_SLICE - 1,),
          f"[scheduler] lost {sched.lost_shards}, redeal {sched.last_redeal}")
    for s in slices:
        check(bitwise_equal(np, got[s], clean[s]), f"[scheduler] slice {s} differs from the clean run")
    nums = dict(wall_s=wall, lost_shards=list(sched.lost_shards),
                redealt_units=sched.last_reports[1].units, launches=launches)
    log(f"[scheduler] 2 shards over slices {slices}, shard 0 lost after 1 window: slice "
        f"{SET1_SLICE - 1} re-dealt to shard 1 ({sched.last_reports[1].units} windows run there, 1 "
        f"restored from disk); merged results bitwise equal to the clean run; wall {wall} s; "
        f"launches {json.dumps(launches)}")
    return nums


def packed_launches(np, ex, windows) -> int:
    """The fit launches ``run_window_batch`` should issue for the grouping
    methods: each window's host groups (found here from its moments), its
    shape class ``padded_size(groups, rep_bucket)``, windows filled greedily
    into launches of that size in batch order."""
    from repro_torch.core import grouping as grp

    sizes = []
    for w in windows:
        x = ex.stager.ready(ex.stager.stage(ex.data.load_window(w)))
        g = grp.group_host(ex._quantized_keys(ex._backend.moments(x))).num_groups
        sizes.append((grp.padded_size(g, ex.config.rep_bucket), g))
    count = 0
    for size in sorted({s for s, _ in sizes}):
        fill = None
        for s, g in sizes:
            if s == size:
                if fill is None or fill + g > size:
                    count, fill = count + 1, 0
                fill += g
    return count


def batch_phase(np, torch, sim, dev, tree):
    """``run_window_batch`` over the 21 windows of slice 201 and over a
    batch mixing windows of slices 200 and 201: baseline and ``ml`` on
    ``fused``, grouping (host Select) on ``fused`` and ``kernels``. Each
    window bitwise equal to ``run_window``; launches counted against the
    packing's prediction; the batch wall against the windows one by one.
    Returns ({label: launches}, {label: numbers})."""
    from repro_torch.core.executor import RESULT_FIELDS, PDFConfig, StagedExecutor
    from repro_torch.core.regions import iter_windows

    g = sim.geometry
    whole = list(iter_windows(g, SET1_SLICE, 25))
    mixed = [w for pair in zip(iter_windows(g, SET1_SLICE - 1, 25), reversed(whole)) for w in pair][:10]
    launches, nums = {}, {}
    for method, backend in (("baseline", "fused"), ("ml", "fused"), ("grouping", "fused"),
                            ("grouping", "kernels")):
        cfg = PDFConfig(method=method, fit_backend=backend)
        for name, windows in (("slice", whole), ("mixed", mixed)):
            label = f"batch {method} {backend} {name}"
            ex = StagedExecutor(cfg, sim, dev, tree=tree if method == "ml" else None)
            n = len(windows)
            fits = packed_launches(np, ex, windows) if method == "grouping" else n
            sync(torch, dev)
            zero_counts()
            t0 = time.perf_counter()
            out = ex.run_window_batch(windows)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            launches[label] = read_counts()
            if backend == "fused":
                expect = {"moments_edges_stats": n, "fit_error_counts": fits}
                if method == "grouping":
                    expect["fit_error_counts_row_indices"] = fits
            else:
                expect = {"moments_stats": n, "hist_counts": fits}
            check_launches(launches[label], expect, label)
            one = StagedExecutor(cfg, sim, dev, tree=tree if method == "ml" else None)
            sync(torch, dev)
            t0 = time.perf_counter()
            singles = [one.run_window(w) for w in windows]
            sync(torch, dev)
            one_wall = time.perf_counter() - t0
            for w, a, b in zip(windows, out, singles):
                check(tuple(a.window) == tuple(w) and all(
                    np.array_equal(getattr(a, f), getattr(b, f)) for f in RESULT_FIELDS),
                      f"[{label}] window {tuple(w)} differs from run_window")
                check(bool((a.type_idx >= 0).all()) and bool(np.isfinite(a.error).all()),
                      f"[{label}] window {tuple(w)}: a type or error out of range")
            load_s = sum(ex.monitors["load"].history)
            nums[label] = dict(windows=n, fit_launches=fits, wall_s=wall, load_s=load_s,
                               run_window_wall_s=one_wall)
            log(f"[{label}] {n} windows: each bitwise equal to run_window; fit launches {fits} as "
                f"the packing predicts; batch wall {wall} s ({load_s} s of it the windows' loads) "
                f"against {one_wall} s one by one; one copy for the batch; launches "
                f"{json.dumps(launches[label])}")
    return launches, nums


# ---------------------------------------------------------------------------
# the declarative API and the PDF query server
# ---------------------------------------------------------------------------


def api_faults_phase(np, torch, path, dev, tmp, wired, wired_res):
    """The fault plan of ``faults_phase`` as a JSON file in
    ``execution.fault_plan`` of a ``PipelineSpec`` over the cube, run by
    ``PDFSession``: the degraded slice bitwise equal to the hand-wired
    phase's, with the same retries, quarantined windows, injector events
    and launches. Returns {label: launches}."""
    from repro_torch.api import ComputeSpec, ExecSpec, PDFSession, PipelineSpec, SourceSpec

    plan = tmp / "fault_plan.json"
    plan.write_text(fault_plan().to_json())
    spec = PipelineSpec(
        source=SourceSpec(kind="file", path=str(path)), compute=ComputeSpec(window_lines=25),
        execution=ExecSpec(slices=(0,), out_dir=str(tmp / "api_faults"), max_retries=2,
                           retry_backoff_s=0.01, speculate=True, straggler_grace_s=0.5,
                           fault_plan=str(plan)))
    sync(torch, dev)
    zero_counts()
    t0 = time.perf_counter()
    session = PDFSession(spec, device=dev)
    res = session.run_all()[0]
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    rep = session.report()
    check(bitwise_equal(np, res, wired_res) and res.quarantined == wired_res.quarantined,
          "[api faults] the session's degraded slice differs from the hand-wired run's")
    check(launches == wired["launches"], f"[api faults] launches {launches} vs {wired['launches']}")
    check((rep.retries, rep.quarantined_units, session.injector.events)
          == (wired["retries"], wired["quarantined"], wired["events"]),
          f"[api faults] retries {rep.retries}, quarantined {rep.quarantined_units}, events "
          f"{session.injector.events} vs the hand-wired {wired}")
    check(rep.speculations >= 1, "[api faults] no speculation")
    log(f"[api faults] PDFSession with execution.fault_plan={plan.name}: bitwise equal to the "
        f"hand-wired [faults] run, retries {rep.retries}, speculations {rep.speculations}, "
        f"quarantined {rep.quarantined_units}, events {json.dumps(session.injector.events)} as "
        f"there; wall {wall} s; launches {json.dumps(launches)}")
    return {"api faults": launches}


def api_phase(np, torch, spec, sim, dev, tree, tmp):
    """``PDFSession`` over ``spec`` (``to_spec(SET1)`` on the card) with the
    tree of ``train_phase``: bitwise equal to ``PDFComputer`` on the same
    configuration and stamped with its spec hash, K1 and K2 once a window;
    the same spec on the ``kernels`` backend (grouping, K3 and K4 once a
    window) against ``PDFComputer``; with a ``cache_dir`` a first session
    misses and stores, a second (no tree given) is served bitwise from the
    cache with no launch, no executor and no tree, and a third with an
    ``out_dir`` too writes the slice's windows and watermark from the hit;
    then ``python -m repro_torch.launch.run_pdf --spec`` in a subprocess
    prints the session's hash. Returns ({label: launches}, numbers)."""
    import dataclasses
    import os

    from repro_torch.api import PDFSession, ResultCache
    from repro_torch.core.pipeline import PDFComputer

    (slice_i,) = spec.execution.slices
    W = -(-spec.source.lines_per_slice // spec.compute.window_lines)
    fused_k = {"moments_edges_stats": W, "fit_error_counts": W}
    launches, nums = {}, {}

    def timed(label, fn):
        sync(torch, dev)
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        sync(torch, dev)
        nums[f"{label} wall_s"] = time.perf_counter() - t0
        launches[label] = read_counts()
        return out

    # Session against PDFComputer, each built and run, in turns, twice:
    # the API's overhead.
    for turn in (1, 2):
        comp = session = None

        def run_computer():
            nonlocal comp
            comp = PDFComputer(spec.pdf_config(), sim, tree=tree, device=dev)
            return comp.run_slice(slice_i)

        def run_session():
            nonlocal session
            t0 = time.perf_counter()
            session = PDFSession(spec, tree=tree, device=dev)
            nums[f"api session {turn} construct_s"] = time.perf_counter() - t0
            return session.run_all()[slice_i]

        want = timed(f"api pdfcomputer {turn}", run_computer)

        got = timed(f"api session {turn}", run_session)
        check_launches(launches[f"api session {turn}"], fused_k, f"api session {turn}")
        check_launches(launches[f"api pdfcomputer {turn}"], fused_k, f"api pdfcomputer {turn}")
        check(bitwise_equal(np, got, want), "[api] the session's slice differs from PDFComputer's")
        check(got.spec_hash == want.spec_hash == comp.spec.content_hash() == session.spec_hash
              == spec.content_hash(), f"[api] spec hashes {got.spec_hash} {want.spec_hash}")
    rep = session.report()
    log(f"[api] PDFSession(to_spec) {spec.method.name} L={spec.compute.num_bins} slice {slice_i}: "
        f"bitwise equal to PDFComputer, spec_hash {got.spec_hash}; walls (built and run) session "
        f"{nums['api session 1 wall_s']} / {nums['api session 2 wall_s']} s (of it built "
        f"{nums['api session 1 construct_s']} / {nums['api session 2 construct_s']} s), "
        f"PDFComputer {nums['api pdfcomputer 1 wall_s']} / {nums['api pdfcomputer 2 wall_s']} s; "
        f"report windows {rep.windows} compiles {rep.compiles} (cache hits "
        f"{rep.compile_cache_hits}, builds {rep.compile_cache_misses}); launches "
        f"{json.dumps(launches['api session 2'])}")

    kspec = dataclasses.replace(spec, method=dataclasses.replace(spec.method, name="grouping"),
                                compute=dataclasses.replace(spec.compute, fit_backend="kernels"))
    kgot = timed("api kernels", lambda: PDFSession(kspec, device=dev).run_all()[slice_i])
    check_launches(launches["api kernels"], {"moments_stats": W, "hist_counts": W}, "api kernels")
    kwant = PDFComputer(kspec.pdf_config(), sim, device=dev).run_slice(slice_i)
    check(bitwise_equal(np, kgot, kwant), "[api kernels] the session differs from PDFComputer")
    log(f"[api kernels] grouping on the kernels backend through the session: bitwise equal to "
        f"PDFComputer; launches {json.dumps(launches['api kernels'])}")

    cache_dir = tmp / "api_cache"
    cspec = dataclasses.replace(spec, execution=dataclasses.replace(
        spec.execution, cache_dir=str(cache_dir)))
    s1 = PDFSession(cspec, tree=tree, device=dev)
    miss = timed("api cache miss", lambda: s1.run_all()[slice_i])
    check_launches(launches["api cache miss"], fused_k, "api cache miss")
    check((s1.report().cache_hits, s1.report().cache_misses) == (0, 1) and not miss.cached,
          "[api cache] the first run did not miss")
    entry = ResultCache(cache_dir).path(cspec.content_hash(), slice_i)
    nums["cache_entry_bytes"] = entry.stat().st_size
    t0 = time.perf_counter()
    ResultCache(tmp / "store_probe").store(miss)  # the store alone, as the miss made it
    nums["cache_store_s"] = time.perf_counter() - t0
    s2 = None

    def hit_session():
        nonlocal s2
        s2 = PDFSession(cspec, device=dev)  # no tree: a hit must not train one
        return s2.run_all()[slice_i]

    hit = timed("api cache hit", hit_session)
    check_launches(launches["api cache hit"], {}, "api cache hit")
    check(hit.cached and hit.stats == [] and bitwise_equal(np, hit, got)
          and hit.spec_hash == got.spec_hash, "[api cache] the hit differs from the computed slice")
    check(not s2._executors and s2._tree is None, "[api cache] the hit built an executor or a tree")
    out_dir = tmp / "api_out"
    ospec = dataclasses.replace(cspec, execution=dataclasses.replace(
        cspec.execution, out_dir=str(out_dir)))
    timed("api cache hit out_dir", lambda: PDFSession(ospec, device=dev).run_all()[slice_i])
    check_launches(launches["api cache hit out_dir"], {}, "api cache hit out_dir")
    windows = sorted(out_dir.glob(f"slice{slice_i}_window_*.npz"))
    mark = json.loads((out_dir / f"slice{slice_i}_watermark.json").read_text())
    check(len(windows) == W and mark["spec_hash"] == got.spec_hash and mark["complete"]
          and all(str(np.load(f)["spec_hash"]) == got.spec_hash for f in windows),
          f"[api cache] out_dir after a hit: {len(windows)} windows, watermark {mark}")
    log(f"[api cache] miss stored {nums['cache_entry_bytes']} B (the slice and its store "
        f"{nums['api cache miss wall_s']} s, a store alone {nums['cache_store_s']} s); a new session served the slice bitwise from the cache in "
        f"{nums['api cache hit wall_s']} s (session built included) with no launch, no executor, "
        f"no tree; with an out_dir too the hit wrote {len(windows)} windows and the watermark "
        f"{json.dumps(mark)} in {nums['api cache hit out_dir wall_s']} s")

    spec_file = tmp / "spec.json"
    spec_file.write_text(spec.to_json())
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run_pdf", "--spec", str(spec_file),
         "--device", str(dev.type)], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    nums["run_pdf_wall_s"] = time.perf_counter() - t0
    check(out.returncode == 0, f"[api run_pdf] exit {out.returncode}: {out.stderr[-2000:]}")
    banner = [line for line in out.stdout.splitlines() if line.startswith("[spec] hash=")]
    check(len(banner) == 1 and banner[0].split()[1] == f"hash={got.spec_hash}",
          f"[api run_pdf] banner {banner}, session hash {got.spec_hash}")
    log(f"[api run_pdf] python -m repro_torch.launch.run_pdf --spec {spec_file.name} --device "
        f"{dev.type}: exit 0 in {nums['run_pdf_wall_s']} s (a process of its own, training its "
        f"tree); its output: " + " | ".join(out.stdout.strip().splitlines()))
    return launches, nums


def serve_queries(np, geom, slices, clients=8, seed=0):
    """Each client's queries, drawn from ``numpy.random.default_rng(seed)``:
    6 points, 2 spans of lines and 1 whole slice, over ``slices``."""
    from repro_torch.serve import PointQuery, RegionQuery, WindowQuery

    rng = np.random.default_rng(seed)
    plans = []
    for _ in range(clients):
        qs = [PointQuery(int(rng.choice(slices)), int(rng.integers(geom.lines_per_slice)),
                         int(rng.integers(geom.points_per_line))) for _ in range(6)]
        for _ in range(2):
            lo = int(rng.integers(geom.lines_per_slice))
            hi = min(geom.lines_per_slice, lo + int(rng.integers(1, 60)))
            qs.append(WindowQuery(int(rng.choice(slices)), lo, hi))
        qs.append(RegionQuery(int(rng.choice(slices))))
        plans.append(qs)
    return plans


def answer_span(q, ppl, points_per_slice):
    """The point span ``[lo, hi)`` of a query within its slice."""
    from repro_torch.serve import PointQuery, WindowQuery

    if isinstance(q, PointQuery):
        lo = q.line * ppl + q.point
        return lo, lo + 1
    if isinstance(q, WindowQuery):
        return q.line_start * ppl, q.line_end * ppl
    return 0, points_per_slice


def pdf_serve_phase(np, torch, spec, dev, tmp, slices, clients=8):
    """``PDFServer`` over ``spec`` (``to_spec(SET1)`` on the card) with the
    method set to baseline, then grouping (host Select), on ``slices``: 8
    client threads, each sending 6 point, 2 window and 1 region query
    (``serve_queries``). Coalesced (with a ``cache_dir``: the completed
    slices are stored) and naive (``serve.coalesce`` off, no hot-window
    LRU, no tick: one launch a window of each query), then a second
    coalesced server over the warm cache. Every answer is bitwise equal
    across the three and to the rows of the session's slices; coalesced K2
    launches at most the distinct windows requested, naive at least as
    many as coalesced, warm none. Returns ({label: launches}, numbers)."""
    import dataclasses
    import threading

    from repro_torch.api import PDFSession, ServeSpec
    from repro_torch.core.executor import RESULT_FIELDS
    from repro_torch.serve import PDFServer

    launches, nums = {}, {}
    for method in ("baseline", "grouping"):
        mspec = dataclasses.replace(spec, method=dataclasses.replace(spec.method, name=method),
                                    execution=dataclasses.replace(spec.execution, slices=None))
        session_slices = PDFSession(mspec, device=dev).run_all(slices)
        probe = PDFServer(mspec, device=dev)  # never started: maps queries to windows
        geom = probe.session.geometry
        plans = serve_queries(np, geom, slices, clients)
        # What the queries need: each query's aligned windows, deduplicated.
        requested = [w for qs in plans for q in qs for w in probe._resolve_span(q).windows]
        distinct = len({(w.slice_i, w.line_start) for w in requested})
        cache_dir = tmp / f"serve_cache_{method}"
        answers = {}
        for mode, serve, cdir in (("coalesced", ServeSpec(), cache_dir),
                                  ("naive", ServeSpec(coalesce=False, window_cache_entries=0,
                                                      tick_seconds=0.0), None),
                                  ("warm", ServeSpec(), cache_dir)):
            sspec = dataclasses.replace(mspec, serve=serve, execution=dataclasses.replace(
                mspec.execution, cache_dir=None if cdir is None else str(cdir)))
            label = f"serve {method} {mode}"
            got, errors = {}, []

            def client(c, srv=None):
                try:
                    for i, q in enumerate(plans[c]):
                        got[(c, i)] = srv.query(q, timeout=600)
                except BaseException as e:  # noqa: BLE001 — raised below, on the main thread
                    errors.append(e)

            sync(torch, dev)
            zero_counts()
            t0 = time.perf_counter()
            with PDFServer(sspec, device=dev) as srv:
                threads = [threading.Thread(target=client, args=(c, srv)) for c in range(clients)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=900)
                check(not any(t.is_alive() for t in threads), f"[{label}] a client hangs")
                st = srv.stats()
            sync(torch, dev)
            wall = time.perf_counter() - t0
            launches[label] = read_counts()
            if errors:
                raise errors[0]
            answers[mode] = got
            n = launches[label]
            k2 = n["fit_error_counts"]
            if mode == "warm":
                check_launches(n, {}, label)
                check(st.windows_computed == 0 and st.windows_from_disk > 0,
                      f"[{label}] computed {st.windows_computed} windows over the warm cache")
            else:
                check(n["moments_edges_stats"] == st.windows_computed and 0 < k2
                      and set(k for k, v in n.items() if v) <= {
                          "moments_edges_stats", "fit_error_counts",
                          "fit_error_counts_row_indices"}, f"[{label}] launches {n}")
            if mode == "coalesced":
                check(k2 <= distinct and st.windows_computed <= distinct
                      and st.slices_stored == len(slices),
                      f"[{label}] K2 {k2}, computed {st.windows_computed}, distinct {distinct}, "
                      f"stored {st.slices_stored}")
                coalesced_k2 = k2
            if mode == "naive":
                check(k2 >= coalesced_k2 and k2 == st.windows_computed,
                      f"[{label}] K2 {k2} vs coalesced {coalesced_k2}")
            nums[label] = dict(
                wall_s=wall, queries=st.queries, windows_requested=st.windows_requested,
                windows_distinct=distinct, windows_computed=st.windows_computed,
                batch_launches=st.launches, k1=n["moments_edges_stats"], k2=k2,
                k2_row_indices=n["fit_error_counts_row_indices"],
                coalesce_ratio=st.coalesce_ratio, batch_occupancy=st.batch_occupancy,
                window_hit_rate=st.window_hit_rate, from_memory=st.windows_from_memory,
                from_disk=st.windows_from_disk, request_ms={k: v * 1e3 for k, v in st.latency.items()},
                launch_ms={k: v * 1e3 for k, v in st.launch_latency.items()},
                ticks=st.ticks, max_queue_depth=st.max_queue_depth)
            log(f"[{label}] {clients} clients x {len(plans[0])} queries over slices {slices}: "
                f"wall {wall} s; {json.dumps(nums[label])}; launches {json.dumps(n)}")
        for key, a in answers["coalesced"].items():
            q = a.query
            lo, hi = answer_span(q, geom.points_per_line, geom.points_per_slice)
            for mode in ("naive", "warm"):
                b = answers[mode][key]
                check(b.query == q and all(np.array_equal(getattr(a, f), getattr(b, f))
                                           for f in RESULT_FIELDS),
                      f"[serve {method}] {mode} answer to {q} differs from the coalesced one")
            check(all(np.array_equal(getattr(a, f), getattr(session_slices[q.slice_i], f)[lo:hi])
                      for f in RESULT_FIELDS),
                  f"[serve {method}] the answer to {q} differs from the session's slice")
        log(f"[serve {method}] every answer bitwise equal across coalesced, naive and warm, and "
            f"to the rows of the session's slices {slices}")
    return launches, nums


# ---------------------------------------------------------------------------
# streaming (appends, sidecars, merges) and multi-process cluster runs
# ---------------------------------------------------------------------------


class CountingCube:
    """A file cube read through a byte counter (``bytes`` read by
    ``load_window`` and ``load_window_obs``): what a run reads."""

    def __init__(self, cube):
        self.cube, self.geometry, self.bytes = cube, cube.geometry, 0

    def load_window(self, w):
        a = self.cube.load_window(w)
        self.bytes += a.nbytes
        return a

    def load_window_obs(self, w, obs_start, obs_end):
        a = self.cube.load_window_obs(w, obs_start, obs_end)
        self.bytes += a.nbytes
        return a

    def slice_observations(self, slice_i):
        return self.cube.slice_observations(slice_i)


STREAM_APPEND = 100  # realizations appended to every point of the cube's slice


def stream_phase(np, torch, path, dev, clean, tmp, file_wall):
    """The streaming path on the ``[file]`` phase's cube (Set1 slice 201 as
    slice 0, baseline on ``fused``, L = 64): a ``PDFSession`` with an
    ``out_dir``, a ``cache_dir`` and ``stream.persist_stats`` (K1 = K2 = K4 =
    21: one sidecar a window, its counts bitwise the plain
    ``histogram_scatter`` of the same window, the slice bitwise ``clean``);
    ``STREAM_APPEND`` realizations appended inside every point's range (the
    slice's own first observations); the merge-mode update (K4 only, no
    executor, the watermark's ``merge_ulp_budget``, nothing cached; each new
    partition's K4 counts bitwise the plain version's); a strict recompute
    of the appended slice (K1 = K2 = K4 = 21), against which the merge's
    counts are bitwise, its moments within ``MERGE_ULP_BUDGET`` ulps and its
    ``type_idx`` equal wherever the strict run's best two types are more
    than the error tolerance apart. Returns ({label: launches}, numbers)."""
    import dataclasses

    from repro_torch.api import (ComputeSpec, ExecSpec, MethodSpec, PDFSession, PipelineSpec,
                                 ResultCache, SourceSpec, StreamSpec)
    from repro_torch.core import distributions as dists
    from repro_torch.core import pdf_error as pe
    from repro_torch.core.regions import iter_windows
    from repro_torch.data.file_source import FileCubeSource
    from repro_torch.kernels.fitpdf.kernel import fit_error_counts_plain
    from repro_torch.streaming import MERGE_ULP_BUDGET, append_realizations, ulp_diff
    from repro_torch.streaming.stats import load_stats

    W = SET1_WINDOWS
    L = 64
    cube = FileCubeSource(path)
    g = cube.geometry
    n0 = cube.slice_observations(0)
    windows = list(iter_windows(g, 0, 25))
    out, cache = tmp / "stream_out", tmp / "stream_cache"
    spec = PipelineSpec(
        source=SourceSpec(kind="file", path=str(path)), method=MethodSpec(name="baseline"),
        compute=ComputeSpec(window_lines=25, num_bins=L),
        execution=ExecSpec(slices=(0,), out_dir=str(out), cache_dir=str(cache)),
        stream=StreamSpec(persist_stats=True))
    launches, nums = {}, {}

    def timed(label, fn):
        sync(torch, dev)
        zero_counts()
        t0 = time.perf_counter()
        res = fn()
        sync(torch, dev)
        nums[f"{label} wall_s"] = time.perf_counter() - t0
        launches[label] = read_counts()
        return res

    def plain_counts(vals, vmin, vmax):
        return np.rint(pe.histogram_scatter(vals, vmin, vmax, L).cpu().numpy()).astype(np.int64)

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    # 1) the first run, writing a sidecar a window
    s1 = PDFSession(spec, device=dev)
    first = timed("stream persist", lambda: s1.run_all()[0])
    check_launches(launches["stream persist"], {"moments_edges_stats": W, "fit_error_counts": W,
                                                "hist_counts": W}, "stream persist")
    check(bitwise_equal(np, first, clean), "[stream persist] the slice differs from the "
          "simulation's: the sidecar hook changed the result")
    rec = s1.executor(0).stats_recorder
    sidecars = sorted(out.glob("slice0_stats_*.npz"))
    sizes = [f.stat().st_size for f in sidecars]
    check(rec.windows_recorded == W and len(sidecars) == W,
          f"[stream persist] {rec.windows_recorded} windows recorded, {len(sidecars)} sidecars")
    old = {}
    for w in windows:
        sc = load_stats(out, 0, w.line_start, spec_hash=s1.spec_hash)
        check(sc is not None and sc["stats"].n == n0 and sc["num_bins"] == L,
              f"[stream persist] sidecar of window {w.line_start}")
        want = plain_counts(on_dev(cube.load_window(w)), on_dev(sc["stats"].vmin),
                            on_dev(sc["stats"].vmax))
        check(np.array_equal(sc["freq"], want),
              f"[stream persist] window {w.line_start}: K4's sidecar counts differ from the "
              "plain histogram_scatter")
        old[w.line_start] = sc
    nums.update(sidecar_bytes_each=sizes[0], sidecar_bytes_total=sum(sizes),
                sidecar_s_per_window=rec.seconds / W, file_run_wall_s=file_wall)
    log(f"[stream persist] {W} windows, K1 = K2 = K4 = {W}: {len(sidecars)} sidecars of "
        f"{min(sizes)}-{max(sizes)} B ({sum(sizes)} B), each window's counts bitwise the plain "
        f"histogram_scatter; the slice bitwise equal to the simulation's; wall "
        f"{nums['stream persist wall_s']} s ([file] run without sidecars {file_wall} s); the "
        f"recorder {rec.seconds} s in all, {rec.seconds / W} s a window")

    # 2) the append: each point's first STREAM_APPEND observations again
    k = STREAM_APPEND
    block = np.empty((g.lines_per_slice, g.points_per_line, k), np.float32)
    for w in windows:
        block[w.line_start:w.line_end] = cube.load_window_obs(w, 0, k).reshape(
            w.line_end - w.line_start, g.points_per_line, k)
    t0 = time.perf_counter()
    version = append_realizations(path, {0: block})
    nums["append_s"] = time.perf_counter() - t0
    nums["append_bytes"] = block.nbytes
    log(f"[stream append] {k} realizations a point ({block.nbytes} B) appended inside every "
        f"point's range in {nums['append_s']} s: manifest version {version}")
    del block

    # 3) the merge-mode update
    src2 = CountingCube(FileCubeSource(path))
    s2 = PDFSession(spec, data_source=src2, device=dev)
    merged = timed("stream merge", lambda: s2.run_all()[0])
    check_launches(launches["stream merge"], {"hist_counts": W}, "stream merge")
    rep = s2.report()
    mark = json.loads((out / "slice0_watermark.json").read_text())
    check(rep.slices_merged == 1 and rep.windows == 0 and not s2._executors,
          f"[stream merge] slices_merged {rep.slices_merged}, windows {rep.windows}, executors "
          f"{list(s2._executors)}")
    check(mark == {"next_line": g.lines_per_slice, "spec_hash": s2.spec_hash,
                   "merge_ulp_budget": MERGE_ULP_BUDGET, "merged_from": s1.spec_hash},
          f"[stream merge] watermark {mark}")
    check(not ResultCache(cache).path(s2.spec_hash, 0).exists(),
          "[stream merge] the merged slice entered the result cache")
    check(src2.bytes == g.points_per_slice * k * 4,
          f"[stream merge] read {src2.bytes} B of observations, expected the append's")
    new_sc = {}
    for w in windows:
        sc = load_stats(out, 0, w.line_start, spec_hash=s2.spec_hash)
        check(sc is not None and sc["stats"].n == n0 + k, f"[stream merge] sidecar {w.line_start}")
        o = old[w.line_start]["stats"]
        part = plain_counts(on_dev(cube.load_window_obs(w, 0, k)), on_dev(o.vmin), on_dev(o.vmax))
        check(np.array_equal(sc["freq"] - old[w.line_start]["freq"], part),
              f"[stream merge] window {w.line_start}: K4's counts of the new partition differ "
              "from the plain histogram_scatter")
        new_sc[w.line_start] = sc["freq"]
    nums["merge_bytes_read"] = src2.bytes + sum(sizes)
    log(f"[stream merge] slices_merged 1, no executor, launches "
        f"{json.dumps(launches['stream merge'])}, wall {nums['stream merge wall_s']} s; read "
        f"{src2.bytes} B of new observations and {sum(sizes)} B of sidecars; watermark "
        f"{json.dumps(mark)}; not in the result cache; each window's new K4 counts bitwise the "
        "plain version's")

    # 4) the strict recompute of the appended slice
    strict_out = tmp / "stream_strict"
    sspec = dataclasses.replace(spec, execution=ExecSpec(slices=(0,), out_dir=str(strict_out)),
                                stream=StreamSpec(persist_stats=True, update_mode="strict"))
    src3 = CountingCube(FileCubeSource(path))
    strict = timed("stream strict", lambda: PDFSession(sspec, data_source=src3,
                                                        device=dev).run_all()[0])
    check_launches(launches["stream strict"], {"moments_edges_stats": W, "fit_error_counts": W,
                                               "hist_counts": W}, "stream strict")
    check(src3.bytes == g.points_per_slice * (n0 + k) * 4,
          f"[stream strict] read {src3.bytes} B")
    for w in windows:
        sc = load_stats(strict_out, 0, w.line_start)
        check(np.array_equal(sc["freq"], new_sc[w.line_start]),
              f"[stream] window {w.line_start}: merged counts differ from the strict run's")
    worst = {}
    for name in ("mean", "std", "skew", "kurt"):
        a, b = getattr(merged, name), getattr(strict, name)
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"[stream] {name} NaN pattern")
        worst[name] = int(ulp_diff(a, b).max())
        check(worst[name] <= MERGE_ULP_BUDGET,
              f"[stream] {name}: merged {worst[name]} ulps from the strict run's")
    decided = differ = 0
    for w in windows:
        vals = on_dev(FileCubeSource(path).load_window(w))
        m = dists.moments_from_values(vals)
        params = dists.fit_all(spec.compute.types, m).reshape(len(vals), -1)
        errs = fit_error_counts_plain(vals, m.vmin, m.vmax, pe.interval_edges(m.vmin, m.vmax, L),
                                      params, spec.compute.types, L).cpu().numpy()
        srt = np.sort(np.where(np.isfinite(errs), errs, 1e30), axis=-1)
        dec = srt[:, 1] - srt[:, 0] > ERR_TOL["atol"] + ERR_TOL["rtol"] * np.abs(srt[:, 0])
        lo = w.line_start * g.points_per_line
        sl = slice(lo, lo + len(vals))
        check(np.array_equal(merged.type_idx[sl][dec], strict.type_idx[sl][dec]),
              f"[stream] window {w.line_start}: merged type_idx differs where the strict run's "
              "best two types are apart")
        decided += int(dec.sum())
        differ += int((merged.type_idx[sl] != strict.type_idx[sl]).sum())
    nums.update(merge_ulps=worst, decided_points=decided, type_idx_ties_differing=differ,
                strict_bytes_read=src3.bytes)
    log(f"[stream strict] {n0 + k} observations, read {src3.bytes} B, launches "
        f"{json.dumps(launches['stream strict'])}, wall {nums['stream strict wall_s']} s. Merge "
        f"against it: counts bitwise in every window; moments within {json.dumps(worst)} ulps "
        f"(budget {MERGE_ULP_BUDGET}); type_idx equal at all {decided} decided points, "
        f"{differ} tied points differ")
    log(f"[summary stream] walls: persist {nums['stream persist wall_s']} s, merge "
        f"{nums['stream merge wall_s']} s, strict {nums['stream strict wall_s']} s; merge read "
        f"{nums['merge_bytes_read']} B; sidecars {nums['sidecar_s_per_window']} s and "
        f"{sizes[0]} B a window")
    return launches, nums


CLUSTER_SLICES = (200, 201, 202, 203)


def worker_lines(text: str) -> dict:
    """``cluster.sh`` output by worker: {i: [its lines, prefix removed]}."""
    by = {}
    for line in text.splitlines():
        if line.startswith("[proc "):
            i, rest = line[6:].split("] ", 1)
            by.setdefault(int(i), []).append(rest)
    return by


def worker_numbers(lines) -> dict:
    """One run_pdf's launches, wall, windows and compile counts."""
    nums = {}
    for line in lines:
        if line.startswith("[launches] "):
            nums["launches"] = json.loads(line[len("[launches] "):])
        elif line.startswith("[total] "):
            kv = dict(f.split("=", 1) for f in line.split()[1:] if "=" in f)
            nums["wall_s"], nums["windows"] = float(kv["wall"].rstrip("s")), int(kv["windows"])
        elif line.startswith("[compile] "):
            kv = dict(f.split("=", 1) for f in line.split()[1:])
            nums.update(cache_misses=int(kv["cache_misses"]), cache_hits=int(kv["cache_hits"]),
                        new_compilations=int(kv["new_compilations"]))
    check({"launches", "wall_s", "new_compilations"} <= set(nums),
          f"[cluster] a run_pdf printed no launches, total or compile line: {lines}")
    return nums


def cluster_phase(np, torch, dev, tmp):
    """``run_pdf`` over the simulated Set1 slices ``CLUSTER_SLICES``
    (baseline on ``fused``, L = 20, 21 windows a slice) with an ``out_dir``
    and a fresh ``--compile-cache-dir``: once serially (a first launch: it
    builds, ``cache_misses`` > 0), then as 1, 2 and 4 worker processes
    through ``src/repro_torch/launch/cluster.sh`` (gloo, a shared out_dir,
    the same cache: ``new_compilations`` = 0 in every worker), each
    bitwise the serial run's (``cluster.sh``'s ``CLUSTER_REF`` check and
    ``verify_outputs``), K1 = K2 = 21 a slice over the workers. Returns
    ({label: summed launches}, numbers)."""
    import dataclasses
    import os
    import socket

    from repro_torch.configs.pdf_seismic import SET1, to_spec
    from repro_torch.api import MethodSpec
    from repro_torch.runtime.cluster import verify_outputs

    spec = to_spec(SET1)
    spec = dataclasses.replace(spec, method=MethodSpec(name="baseline"), execution=dataclasses.replace(
        spec.execution, slices=CLUSTER_SLICES))
    spec_file = tmp / "cluster_spec.json"
    spec_file.write_text(spec.to_json())
    cache = tmp / "compile_cache"
    per_slice = -(-spec.source.lines_per_slice // spec.compute.window_lines)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "PYTHON": sys.executable}
    flags = ["--spec", str(spec_file), "--device", dev.type, "--compile-cache-dir", str(cache)]
    launches, nums = {}, {}

    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.run_pdf", *flags,
                        "--out-dir", str(tmp / "cluster_ref")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600, stdin=subprocess.DEVNULL)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"[cluster serial] exit {p.returncode}: {p.stderr[-3000:]}")
    serial = worker_numbers(p.stdout.splitlines())
    check(serial["cache_misses"] > 0 and serial["new_compilations"] > 0,
          f"[cluster serial] a first launch over a fresh cache built nothing: {serial}")
    check(serial["windows"] == per_slice * len(CLUSTER_SLICES), f"[cluster serial] {serial}")
    launches["cluster serial"] = serial["launches"]
    check_launches(serial["launches"], {"moments_edges_stats": serial["windows"],
                                        "fit_error_counts": serial["windows"]}, "cluster serial")
    nums["serial"] = dict(process_wall_s=wall, **{k: v for k, v in serial.items()
                                                  if k != "launches"})
    log(f"[cluster serial] run_pdf --spec (baseline, Set1 slices {list(CLUSTER_SLICES)}) with a "
        f"fresh --compile-cache-dir: process {wall} s, run {serial['wall_s']} s, "
        f"{serial['windows']} windows, built {serial['cache_misses']} librar(ies) "
        f"(new_compilations={serial['new_compilations']}); launches "
        f"{json.dumps(serial['launches'])}")

    for n in (1, 2, 4):
        label = f"cluster {n}"
        out = tmp / f"cluster_out{n}"
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        p = subprocess.run(["bash", str(ROOT / "src" / "repro_torch" / "launch" / "cluster.sh"),
                            str(n), *flags, "--out-dir", str(out)], cwd=ROOT,
                           env={**env, "COORD_PORT": str(port),
                                "CLUSTER_REF": str(tmp / "cluster_ref")},
                           capture_output=True, text=True, timeout=600, stdin=subprocess.DEVNULL)
        wall = time.perf_counter() - t0
        check(p.returncode == 0, f"[{label}] exit {p.returncode}: {p.stdout[-3000:]} "
              f"{p.stderr[-3000:]}")
        check(f"[cluster] bitwise-identical windows={serial['windows']}" in p.stdout,
              f"[{label}] cluster.sh printed no bitwise check: {p.stdout[-2000:]}")
        check(verify_outputs(tmp / "cluster_ref", out)[0] == serial["windows"],
              f"[{label}] verify_outputs")
        workers = {i: worker_numbers(lines) for i, lines in worker_lines(p.stdout).items()}
        check(sorted(workers) == list(range(n)), f"[{label}] workers {sorted(workers)}")
        for i, w in workers.items():
            check(w["new_compilations"] == 0 and w["cache_misses"] == 0,
                  f"[{label}] worker {i} built over the warm cache: {w}")
            check_launches(w["launches"], {"moments_edges_stats": w["windows"],
                                           "fit_error_counts": w["windows"]},
                           f"{label} worker {i}")
        total = {k: sum(w["launches"][k] for w in workers.values()) for k in serial["launches"]}
        check(total == serial["launches"], f"[{label}] launches {total} vs serial "
              f"{serial['launches']}")
        launches[label] = total
        nums[label] = dict(process_wall_s=wall, workers={
            i: {k: v for k, v in w.items() if k != "launches"} for i, w in workers.items()})
        log(f"[{label}] cluster.sh {n}: {wall} s; bitwise the serial run's "
            f"({serial['windows']} windows); per worker (run wall s, windows, cache hits, "
            f"new_compilations, launches): " + "; ".join(
                f"{i}: {w['wall_s']}, {w['windows']}, {w['cache_hits']}, {w['new_compilations']}, "
                f"{json.dumps({k: v for k, v in w['launches'].items() if v})}"
                for i, w in sorted(workers.items())))
    log(f"[summary cluster] {json.dumps(nums)}")
    return launches, nums


# ---------------------------------------------------------------------------
# timing at the Set1 window shape
# ---------------------------------------------------------------------------


def cuda_times(torch, fn, reps, flush) -> list:
    """ms of ``fn()`` in each of ``reps`` runs after 3 warm-ups, CUDA events
    around each, with L2 flushed before each (the main path's K1 reads a
    freshly copied window)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def time_kernel(fn, flush, reps=50) -> float:
    """Median ms of ``fn()``'s own device work over ``reps`` runs, the
    wrapper's host work queued behind a sleep on the card, L2 flushed clean
    before each (``repro_torch.kernels._timing.kernel_times``): "kernel
    ms"."""
    from repro_torch.kernels._timing import kernel_times, median

    return median(kernel_times(fn, reps, flush))


def time_cuda(torch, fn, reps, flush) -> float:
    """Median ms of ``fn()`` over ``reps`` runs (``cuda_times``): the call's
    time, the wrapper's host work and the card's idle time through it
    included ("call ms")."""
    from repro_torch.kernels._timing import median

    return median(cuda_times(torch, fn, reps, flush))


def bound_ms(bytes_moved: int, f32_ops: int, f64_ops: int = 0) -> tuple[float, str]:
    """The least time for the work: bytes over the HBM rate, float32 and
    float64 operations each over their peak, whichever is largest."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(f32_ops / F32_OPS_PER_S, f64_ops / F64_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def loop_trips(np, count, step, max_iter):
    """Trip counts of a loop run on ``count`` entries at once: ``step(idx,
    i)`` runs trip ``i`` on the entries ``idx`` still looping and says which
    of them break after it."""
    trips = np.zeros(count, np.int64)
    idx = np.arange(count)
    for i in range(1, max_iter + 1):
        if not len(idx):
            break
        trips[idx] += 1
        idx = idx[~step(idx, i)]
    return trips


def special_function_ops(np, params, edges, types) -> int:
    """Float64 operations K2's incomplete gamma and beta do on these inputs.
    Each CDF evaluation's loop is replayed in float64 as csrc/fitpdf.cu runs
    it (gammainc_lower, betacf) to count its trips; a trip, and the set-up
    of an evaluation, count the operations written in the source, a
    division or a transcendental as one."""
    tiny, ops = 1e-300, 0
    for t, name in enumerate(types):
        p0, p1, p2 = (np.broadcast_to(params[:, 3 * t + j, None], edges.shape) for j in range(3))
        with np.errstate(all="ignore"):
            if name == "gamma":  # cdf_eval case 5
                xs = np.maximum(edges, np.float32(0)) / p1
                sel = (edges > 0) & ~(p0 > np.float32(1e4))
                a = np.minimum(p0[sel], np.float32(1e4)).astype(np.float64)
                x = np.minimum(xs[sel], np.float32(2e4)).astype(np.float64)
                keep = ~np.isnan(a) & (x > 0) & np.isfinite(x)
                a, x = a[keep], x[keep]
                ser = x < a + 1.0
                sa, sx = a[ser], x[ser]
                ap, dl = sa.copy(), 1.0 / sa
                sm = dl.copy()

                def series(idx, i):
                    ap[idx] += 1.0
                    dl[idx] *= sx[idx] / ap[idx]
                    sm[idx] += dl[idx]
                    return np.abs(dl[idx]) < np.abs(sm[idx]) * 1e-16

                ca, cx = a[~ser], x[~ser]
                b = cx + 1.0 - ca
                c, d = np.full_like(b, 1.0 / tiny), 1.0 / b

                def fraction(idx, i):
                    an = -i * (i - ca[idx])
                    b[idx] += 2.0
                    dd = an * d[idx] + b[idx]
                    dd = np.where(np.abs(dd) < tiny, tiny, dd)
                    cc = b[idx] + an / c[idx]
                    cc = np.where(np.abs(cc) < tiny, tiny, cc)
                    d[idx], c[idx] = 1.0 / dd, cc
                    return np.abs(d[idx] * cc - 1.0) < 1e-16

                ops += 8 * len(a) + 6 * int(loop_trips(np, len(sa), series, 4000).sum()) \
                    + 15 * int(loop_trips(np, len(ca), fraction, 4000).sum())
            elif name == "student_t":  # cdf_eval case 8, betainc
                tt = (edges - p0) / p1
                xb = (p2 / (p2 + tt * tt)).astype(np.float64)
                a = (np.float32(0.5) * p2).astype(np.float64)
                keep = ~np.isnan(a) & ~np.isnan(xb) & (xb > 0) & (xb < 1)
                a, xb = a[keep], xb[keep]
                swap = xb > (a + 1.0) / (a + 0.5 + 2.0)
                ba, bb = np.where(swap, 0.5, a), np.where(swap, a, 0.5)
                bx = np.where(swap, 1.0 - xb, xb)
                qab, qap, qam = ba + bb, ba + 1.0, ba - 1.0
                d = 1.0 - qab * bx / qap
                d = 1.0 / np.where(np.abs(d) < tiny, tiny, d)
                c = np.ones_like(d)

                def half(idx, aa):
                    dd = 1.0 + aa * d[idx]
                    dd = np.where(np.abs(dd) < tiny, tiny, dd)
                    cc = 1.0 + aa / c[idx]
                    cc = np.where(np.abs(cc) < tiny, tiny, cc)
                    d[idx], c[idx] = 1.0 / dd, cc

                def betacf(idx, m):
                    m2 = 2.0 * m
                    a_, b_, x_ = ba[idx], bb[idx], bx[idx]
                    half(idx, m * (b_ - m) * x_ / ((qam[idx] + m2) * (a_ + m2)))
                    half(idx, -(a_ + m) * (qab[idx] + m) * x_ / ((a_ + m2) * (qap[idx] + m2)))
                    return np.abs(d[idx] * c[idx] - 1.0) < 1e-16

                ops += 14 * len(a) + 37 * int(loop_trips(np, len(a), betacf, 300).sum())
    return ops


def time_kernels(np, torch, x, dev, launches, worst_k1, err_k2):
    """CUDA-event medians of K1 and K2 (and their plain versions) on one
    window; returns the kernel rows of the summary line."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import pdf_error as pe
    from repro_torch.kernels.fitpdf import kernel

    p, n = x.shape
    flush = torch.empty(128 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    L = 64
    k1_call = time_cuda(torch, lambda: kernel.moments_edges_stats(x, L), 50, flush)
    k1 = time_kernel(lambda: kernel.moments_edges_stats(x, L), flush)
    k1_plain = time_cuda(torch, lambda: kernel.moments_edges_stats_plain(x, L), 10, flush)
    # Bytes: the window read once, stats and edges written once. Operations:
    # ~10 per value (shift, three products, four sums, min, max).
    b1, by1 = bound_ms(4 * (p * n + 8 * p + p * (L + 1)), 10 * p * n)
    err_stat = max(worst_k1, key=lambda s: worst_k1[s][0])
    log(f"[time] K1 moments_edges_stats ({p}, {n}) L={L}: call {k1_call} ms, kernel {k1} ms "
        f"({100 * b1 / k1} % of bound), plain {k1_plain} ms, bound {b1} ms by {by1}; no single "
        f"PyTorch call computes this function; its max abs difference from the plain version, "
        f"{worst_k1[err_stat][0]}, is in {err_stat}")
    rows = [dict(name="moments_edges_stats", route="cuda", source="src/repro_torch/csrc/fitpdf.cu",
                 replaces="src/repro/kernels/fitpdf/kernel.py:112",
                 launches=launches["moments_edges_stats"], max_abs_err=worst_k1[err_stat][0],
                 ms=k1_call, kernel_ms=k1, plain_ms=k1_plain, bound_ms=b1, bound_by=by1,
                 library_ms=None)]

    stats, _ = kernel.moments_edges_stats(x, L)
    m = dists.Moments(*(stats[:, i].contiguous() for i in range(6)))
    k2 = {}
    for types, L in ((dists.TYPES_4, 64), (dists.TYPES_10, 20)):
        t = len(types)
        params = dists.fit_all(types, m).reshape(p, -1).contiguous()
        edges = pe.interval_edges(m.vmin, m.vmax, L)
        args = (x, m.vmin, m.vmax, edges, params, types, L)
        call = time_cuda(torch, lambda: kernel.fit_error_counts(*args), 50, flush)
        ms = time_kernel(lambda: kernel.fit_error_counts(*args), flush)
        plain = time_cuda(torch, lambda: kernel.fit_error_counts_plain(*args), 5, flush)
        # Bytes: window, vmin/vmax, edges and params read once, errors written
        # once. Float32 operations: 4 per value for the bin, ~30 per CDF
        # evaluation, 3 per mass term. Float64: the incomplete gamma and beta
        # loops, counted on this window's data.
        f64 = special_function_ops(np, params.cpu().numpy(), edges.cpu().numpy(), types)
        b, by = bound_ms(4 * (p * n + 2 * p + p * (L + 1) + 3 * t * p + t * p),
                         4 * p * n + 30 * p * t * (L + 1) + 3 * p * t * L, f64)
        k2[(t, L)] = dict(ms=call, kernel_ms=ms, plain_ms=plain, bound_ms=b, bound_by=by)
        attrs = kernel.fit_error_attributes(types, L)
        log(f"[time] K2 fit_error_counts ({p}, {n}) T={t} L={L}: call {call} ms, kernel {ms} ms "
            f"({100 * b / ms} % of bound), plain {plain} ms, bound {b} ms by {by} (float64 "
            f"special-function operations {f64}, {f64 / F64_OPS_PER_S * 1e3} ms at the float64 "
            f"peak); {json.dumps(attrs)} (registers a thread, local memory bytes a thread: 0 means "
            f"no spills, dynamic shared memory bytes a block); no single PyTorch call computes this "
            f"function")
    rows.append(dict(name="fit_error_counts", route="cuda", source="src/repro_torch/csrc/fitpdf.cu",
                     replaces="src/repro/kernels/fitpdf/kernel.py:231",
                     launches=launches["fit_error_counts"], max_abs_err=err_k2, **k2[(4, 64)],
                     library_ms=None, at_10types_L20=k2[(10, 20)]))
    return rows


def time_new_kernels(np, torch, x, dev, launches_k, launches_rows, worst_k3, err_rows):
    """CUDA-event medians of K3, K4 (L = 64) and K2 with ``row_indices`` on
    the window's grouped representatives (T = 4, L = 64), beside their
    plain versions and bounds; returns their rows of the summary line."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import pdf_error as pe
    from repro_torch.kernels.fitpdf import kernel
    from repro_torch.kernels.hist import kernel as hk
    from repro_torch.kernels.moments import kernel as mk

    p, n = x.shape
    L = 64
    flush = torch.empty(128 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    rows = []

    k3_call = time_cuda(torch, lambda: mk.moments_stats(x), 50, flush)
    k3 = time_kernel(lambda: mk.moments_stats(x), flush)
    k3_plain = time_cuda(torch, lambda: mk.moments_stats_plain(x), 10, flush)
    # Bytes: the window read once, the stats written once; ~10 float32
    # operations per value, as K1.
    b3, by3 = bound_ms(4 * (p * n + 8 * p), 10 * p * n)
    err_stat = max(worst_k3, key=lambda s: worst_k3[s][0])
    log(f"[time] K3 moments_stats ({p}, {n}): call {k3_call} ms, kernel {k3} ms ({100 * b3 / k3} % "
        f"of bound), plain {k3_plain} ms, bound {b3} ms by {by3}; no single PyTorch call computes "
        f"this function")
    rows.append(dict(name="moments_stats", route="cuda", source="src/repro_torch/csrc/moments.cu",
                     replaces="src/repro/kernels/moments/kernel.py:77",
                     launches=launches_k["moments_stats"], max_abs_err=worst_k3[err_stat][0],
                     ms=k3_call, kernel_ms=k3, plain_ms=k3_plain, bound_ms=b3, bound_by=by3,
                     library_ms=None))

    stats = mk.moments_stats(x)
    vmin, vmax = stats[:, 4].contiguous(), stats[:, 5].contiguous()
    k4_call = time_cuda(torch, lambda: hk.hist_counts(x, vmin, vmax, L), 50, flush)
    k4 = time_kernel(lambda: hk.hist_counts(x, vmin, vmax, L), flush)
    k4_plain = time_cuda(torch, lambda: hk.hist_counts_plain(x, vmin, vmax, L), 10, flush)
    # Bytes: the window, vmin and vmax read once, the counts written once;
    # ~4 float32 operations per value for its bin.
    b4, by4 = bound_ms(4 * (p * n + 2 * p + p * L), 4 * p * n)
    log(f"[time] K4 hist_counts ({p}, {n}) L={L}: call {k4_call} ms, kernel {k4} ms ({100 * b4 / k4} "
        f"% of bound), plain {k4_plain} ms, bound {b4} ms by {by4}; "
        f"{json.dumps(hk.hist_attributes(L))}; no single PyTorch call computes this function")
    rows.append(dict(name="hist_counts", route="cuda", source="src/repro_torch/csrc/hist.cu",
                     replaces="src/repro/kernels/hist/kernel.py:50",
                     launches=launches_k["hist_counts"], max_abs_err=0.0,
                     ms=k4_call, kernel_ms=k4, plain_ms=k4_plain, bound_ms=b4, bound_by=by4,
                     library_ms=None))

    types = dists.TYPES_4
    t = len(types)
    idx = representatives(torch, x)
    g = len(idx)
    m = dists.Moments(*(stats[idx, i].contiguous() for i in range(6)))
    params = dists.fit_all(types, m).reshape(g, -1).contiguous()
    edges = pe.interval_edges(m.vmin, m.vmax, L)
    args = (m.vmin, m.vmax, edges, params, types, L)
    k2r_call = time_cuda(torch, lambda: kernel.fit_error_counts(x, *args, row_indices=idx), 50, flush)
    k2r = time_kernel(lambda: kernel._fit_error_counts_in_range(x, *args, idx), flush)
    k2r_plain = time_cuda(torch, lambda: kernel.fit_error_counts_plain(x[idx], *args), 10, flush)
    # Bytes: the G representative rows, their vmin, vmax, edges, params and
    # indices read once, the errors written once (no float64 work at T = 4).
    b2r, by2r = bound_ms(4 * (g * n + 2 * g + g * (L + 1) + 3 * t * g + t * g) + 8 * g,
                         4 * g * n + 30 * g * t * (L + 1) + 3 * g * t * L,
                         special_function_ops(np, params.cpu().numpy(), edges.cpu().numpy(), types))
    log(f"[time] K2 fit_error_counts with row_indices, {g} representatives of ({p}, {n}) T={t} "
        f"L={L}: call {k2r_call} ms (the public wrapper, its range check included), kernel {k2r} ms "
        f"(device Select's call, no range check; {100 * b2r / k2r} % of bound), plain (gather, then "
        f"plain K2) {k2r_plain} ms, bound {b2r} ms by {by2r}; no single PyTorch call computes this "
        f"function")
    rows.append(dict(name="fit_error_counts_row_indices", route="cuda",
                     source="src/repro_torch/csrc/fitpdf.cu",
                     replaces="src/repro/kernels/fitpdf/ops.py:79",
                     launches=launches_rows["fit_error_counts_row_indices"], max_abs_err=err_rows,
                     ms=k2r_call, kernel_ms=k2r, plain_ms=k2r_plain, bound_ms=b2r, bound_by=by2r,
                     library_ms=None))
    return rows


def time_large_bins(np, torch, x, dev) -> dict:
    """Kernel ms of K2 (4 types) and K4 at L = 1,000, 4,000 and 12,000 on
    the Set1 window, beside their bounds and plain versions, with the route
    each takes (bins a block holds at once, shared memory a block); K2 also
    with the bins a block holds forced to 512, 1,024 and 2,432 (the most
    that fit the default 48 KB) and to all L in one launch where the card's
    opt-in shared memory holds them: the measurement behind K2's route.
    Each is first held against its plain version on the same inputs: K2
    within ERR_TOL, on every forced chunk too and the same bits as its own
    route; K4 exactly. Returns {L: {...}} for the K2 and K4 rows."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import pdf_error as pe
    from repro_torch.kernels.fitpdf import kernel
    from repro_torch.kernels.hist import kernel as hk
    from repro_torch.kernels.moments import kernel as mk

    p, n = x.shape
    flush = torch.empty(128 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    stats = mk.moments_stats(x)
    m = dists.Moments(*(stats[:, i].contiguous() for i in range(6)))
    types = dists.TYPES_4
    t = len(types)
    params = dists.fit_all(types, m).reshape(p, -1).contiguous()
    out = {}
    for L in (1000, 4000, 12000):
        edges = pe.interval_edges(m.vmin, m.vmax, L)
        args = (x, m.vmin, m.vmax, edges, params, types, L)
        optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
        forced = [c for c in (512, 1024, 2432, L) if c <= L and (c < L or 20 * L + 16 <= optin)]
        got = kernel.fit_error_counts(*args)
        close_report(torch, got, kernel.fit_error_counts_plain(*args), **ERR_TOL,
                     what=f"[K2 large L] L={L}")
        for c in forced:
            other = kernel._fit_error_counts_in_range(*args, None, chunk=c)
            check(torch.equal(torch.nan_to_num(other, nan=-1.0), torch.nan_to_num(got, nan=-1.0)),
                  f"[K2 large L] L={L}: chunks of {c} bins differ from the card's route")
        counts = hk.hist_counts(x, m.vmin, m.vmax, L)
        check(torch.equal(counts, hk.hist_counts_plain(x, m.vmin, m.vmax, L)),
              f"[K4 large L] L={L}: counts differ from the plain version's")
        log(f"[large L] L={L}: K2 within ERR_TOL of its plain version, the same bits in chunks of "
            f"{forced} bins; K4 counts exact")
        k2 = time_kernel(lambda: kernel.fit_error_counts(*args), flush, reps=20)
        k2_plain = time_cuda(torch, lambda: kernel.fit_error_counts_plain(*args), 3, flush)
        b2, by2 = bound_ms(4 * (p * n + 2 * p + p * (L + 1) + 3 * t * p + t * p),
                           4 * p * n + 30 * p * t * (L + 1) + 3 * p * t * L)
        a2 = kernel.fit_error_attributes(types, L)
        k4 = time_kernel(lambda: hk.hist_counts(x, m.vmin, m.vmax, L), flush, reps=20)
        k4_plain = time_cuda(torch, lambda: hk.hist_counts_plain(x, m.vmin, m.vmax, L), 3, flush)
        b4, by4 = bound_ms(4 * (p * n + 2 * p + p * L), 4 * p * n)
        a4 = hk.hist_attributes(L)
        row = dict(k2_kernel_ms=k2, k2_plain_ms=k2_plain, k2_bound_ms=b2, k2_bound_by=by2,
                   k2_chunk=a2["chunk"], k2_smem_bytes=a2["smem_bytes"], k4_kernel_ms=k4,
                   k4_plain_ms=k4_plain, k4_bound_ms=b4, k4_bound_by=by4, k4_chunk=a4["chunk"],
                   k4_smem_bytes=a4["smem_bytes"])
        sweep = {c: time_kernel(lambda: kernel._fit_error_counts_in_range(*args, None, chunk=c),
                                flush, reps=20) for c in forced}
        row["k2_forced_chunk_kernel_ms"] = sweep
        extra = f"; K2 with the bins a block holds forced (bins: ms) {json.dumps(sweep)}"
        log(f"[time] large L ({p}, {n}) L={L}: K2 T={t} kernel {k2} ms ({100 * b2 / k2} % of bound), "
            f"plain {k2_plain} ms, bound {b2} ms by {by2}, route {json.dumps(a2)}; K4 kernel {k4} ms "
            f"({100 * b4 / k4} % of bound), plain {k4_plain} ms, bound {b4} ms by {by4}, route "
            f"{json.dumps(a4)}{extra}")
        out[L] = row
    return out


def device_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def device_events(prof) -> list:
    """The profile's device-side rows (kernels, copies), longest first."""
    from torch.autograd import DeviceType

    return sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=device_us, reverse=True)


def copy_overlap(prof) -> dict | None:
    """The host-to-device copies on the profile's device timeline: their
    count, total ms and kinds (pinned or pageable, as the profiler names
    them), and how many ms of them overlap a K1/K3 (``row_moments``) or K2
    (``fit_error``) launch. None when the profiler saw no copy."""
    from torch.autograd import DeviceType

    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "HtoD" in e.name:
            copies.append((*span, e.name))
        elif "row_moments" in e.name or "fit_error" in e.name:
            kernels.append(span)
    if not copies:
        return None
    kernels.sort()
    overlap = 0.0
    for a, b, _ in copies:
        for c, d in kernels:
            if c >= b:
                break
            overlap += max(0.0, min(b, d) - max(a, c))
    return dict(h2d_copies=len(copies), h2d_ms=sum(b - a for a, b, _ in copies) / 1e3,
                h2d_kinds=sorted({n for _, _, n in copies}), overlap_with_k1_k2_ms=overlap / 1e3)


def profile_slice(torch, cfg, label, sim, slice_i, dev, wall_unprofiled, tree=None):
    """One slice of ``cfg`` once more under torch.profiler: device time by
    kernel (in all and a launch, inside the pipeline, with no host work
    between the events), the device's busy share of the unprofiled wall
    time, and the host-to-device copies' total and their overlap with K1
    and K2 on the timeline (``copy_overlap``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.pipeline import PDFComputer

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        PDFComputer(cfg, sim, tree=tree, device=dev).run_slice(slice_i)
        sync(torch, dev)

    kern = device_events(prof)
    dev_us = device_us
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    if not kern or busy_ms == 0:
        log("[profile] the profiler saw no device time: device busy share not measured")
        return
    copies = copy_overlap(prof)
    log(f"[profile {label}] slice {slice_i}: device busy {busy_ms} ms over "
        f"{len(kern)} kernel/copy names; unprofiled wall {wall_unprofiled * 1e3} ms; "
        f"device idle share {1 - busy_ms / (wall_unprofiled * 1e3)}; host-to-device copies "
        + (json.dumps(copies) if copies else "not seen by the profiler"))
    for e in kern[:12]:
        log(f"[profile {label}]   {dev_us(e) / 1e3:10.3f} ms  x{e.count:<5d} "
            f"{dev_us(e) / 1e3 / max(e.count, 1):.4f} ms a launch  {e.key[:80]}")

# ---------------------------------------------------------------------------
# the LM serving path: K5, then gemma3-12b prefill + greedy decode
# ---------------------------------------------------------------------------


def band_pairs(s: int, w: int) -> int:
    """Valid (query, key) pairs of one (b, h): the sum over i of min(i + 1, w)."""
    return s * (s + 1) // 2 if s <= w else w * (w + 1) // 2 + (s - w) * w


def band_inputs(np, torch, dev):
    """bf16 q, k, v at the serving shape, drawn with numpy from a seed as
    the reference's kernel test draws them (q, k ~ 0.5 N(0, 1), v ~ N(0, 1))."""
    b, s, h, kvh, hd, _ = K5_CASES[0]
    rng = np.random.default_rng(0)

    def draw(shape, std):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= std
        return torch.from_numpy(x).to(dev).to(torch.bfloat16)

    return draw((b, s, h, hd), 0.5), draw((b, s, kvh, hd), 0.5), draw((b, s, kvh, hd), 1.0)


def compare_band_attn(np, torch, dev):
    """K5 against its plain version at K5_CASES (each a prefix of one seeded
    draw): its worst row within K5_TOL times that of the plain version with
    the oracle's rounding, a repeat bitwise equal, the launch count up by one
    a launch, and where S > W a window off by one (the plain version at
    W - 1) rejected by the same gate. Returns (the serving inputs, the max
    abs difference from the plain version over the cases)."""
    from repro_torch.kernels.band_attn import kernel as bk
    from repro_torch.kernels.band_attn.ref import banded_attention_ref, row_errors

    qkv = band_inputs(np, torch, dev)
    worst = 0.0
    for case in K5_CASES:
        b, s, h, kvh, hd, w = case
        q, k, v = (t[:, :s].contiguous() for t in qkv)
        before = bk.banded_attention_kernel.launches
        got = bk.banded_attention_kernel(q, k, v, w)
        check(bk.banded_attention_kernel.launches == before + 1, f"[K5] {case}: launch not counted")
        again = bk.banded_attention_kernel(q, k, v, w)
        check(bk.banded_attention_kernel.launches == before + 2, f"[K5] {case}: launch not counted")
        sync(torch, dev)
        check(got.dtype == torch.bfloat16 and got.shape == q.shape, f"[K5] {case}: output {got.dtype} "
              f"{tuple(got.shape)}")
        check(torch.equal(got, again), f"[K5] {case}: repeat launch differs")
        check(bool(torch.isfinite(got).all()), f"[K5] {case}: non-finite output")
        del again
        truth = banded_attention_ref(q.float(), k.float(), v.float(), w)
        e_got = float(row_errors(got, truth).max())
        e_oracle = float(row_errors(banded_attention_ref(q, k, v, w, round_weights=True), truth).max())
        limit = K5_TOL * e_oracle
        check(e_got <= limit, f"[K5] {case}: worst row {e_got} above {K5_TOL} x the oracle "
                              f"rounding's {e_oracle}")
        want = banded_attention_ref(q, k, v, w)
        max_abs = float((got.float() - want.float()).abs().max())
        n_diff = int((got != want).sum())
        del want
        planted = "no window edge at S <= W"
        if s > w:
            e_off = float(row_errors(banded_attention_ref(q, k, v, w - 1), truth).max())
            check(e_off > limit, f"[K5] {case}: the plain version at window W - 1 passes the gate "
                                 f"(worst row {e_off} <= {limit})")
            planted = f"the plain version at W - 1 rejected (worst row {e_off})"
        worst = max(worst, max_abs)
        log(f"[K5] (B, S, H, KV, hd, W) = {case} bf16: worst row |got - truth| / |truth| {e_got}, "
            f"limit {limit} ({K5_TOL} x the oracle rounding's {e_oracle}); max abs from the plain "
            f"version {max_abs} ({n_diff} of {got.numel()} outputs not bitwise equal); repeat bitwise, "
            f"launches counted; {planted}")
        del got, truth
        torch.cuda.empty_cache()
    return qkv, worst


def lm_config():
    from repro_torch.configs import registry

    return registry.get(LM_ARCH).replace(num_layers=LM_LAYERS, block_local_attn=True)


def serve_phase(np, torch, dev, smi):
    """gemma3-12b at full width, 12 layers, random weights from a seeded
    generator on the card; LM_BATCH prompts of LM_PROMPT random tokens.
    Drives ``generate`` (prefill + LM_TOKENS greedy steps) once with the
    counts set to 0 (10 K5 launches); then a prefill alone twice (10 each,
    bitwise equal logits), the decode steps alone (0 launches, generate's
    tokens again), and the same prefill on the plain masked path and in
    float32 compute. Returns the model, config, prompt and numbers."""
    from repro_torch.launch.serve_decode import generate
    from repro_torch.models import transformer as T

    cfg = lm_config()
    check(sum(1 for bd in cfg.layer_defs() if bd.window) == LM_LOCAL_LAYERS, "[lm] local layer count")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = T.init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    sync(torch, dev)
    n_params = T.count_params(model)
    log(f"[lm] {cfg.name} d_model={cfg.d_model} heads={cfg.q_heads}/{cfg.kv_heads} head_dim="
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab}, {cfg.num_layers} of 48 layers "
        f"({LM_LOCAL_LAYERS} local with window {cfg.pattern[0].window}, "
        f"{cfg.num_layers - LM_LOCAL_LAYERS} global), block_local_attn, params {n_params} in "
        f"{cfg.param_dtype} ({n_params * 4} B), compute {cfg.compute_dtype}; init on the card in "
        f"{time.perf_counter() - t0} s; batch {LM_BATCH} x prompt {LM_PROMPT} + {LM_TOKENS} tokens")
    max_len = LM_PROMPT + LM_TOKENS

    T.prefill(model, prompt[:, :2 * cfg.pattern[0].window], cfg)  # warm-up: cuBLAS, allocator
    sync(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    tokens = generate(cfg, model, prompt, LM_TOKENS)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    check_launches(launches, {"banded_attention_kernel": LM_LOCAL_LAYERS}, "lm generate")
    check(tokens.shape == (LM_BATCH, LM_TOKENS) and tokens.dtype == torch.int32, "[lm] tokens shape")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab)).all()), "[lm] token out of range")

    zero_counts()
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, caches = T.prefill(model, prompt, cfg, max_len=max_len)
    sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    check(read_counts()["banded_attention_kernel"] == LM_LOCAL_LAYERS, "[lm] K5 launches per prefill")
    again, _ = T.prefill(model, prompt, cfg, max_len=max_len)
    check(logits.shape == (LM_BATCH, cfg.vocab) and bool(torch.isfinite(logits).all()),
          "[lm] prefill logits shape or finiteness")
    check(torch.equal(logits, again), "[lm] prefill logits do not repeat bitwise")
    del again

    zero_counts()
    tok = torch.argmax(logits, -1).to(torch.int32)
    decoded, steps_ms = [], []
    for i in range(LM_TOKENS):
        decoded.append(tok)
        sync(torch, dev)
        t0 = time.perf_counter()
        step_logits, caches = T.decode_step(model, tok, caches, LM_PROMPT + i, cfg)
        tok = torch.argmax(step_logits, -1).to(torch.int32)
        sync(torch, dev)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(step_logits).all()), f"[lm] decode step {i}: non-finite logits")
    check(read_counts()["banded_attention_kernel"] == 0, "[lm] K5 launched by a decode step")
    check(torch.equal(torch.stack(decoded, 1), tokens), "[lm] decode steps differ from generate's tokens")
    del caches, step_logits
    decode_ms = sorted(steps_ms)[len(steps_ms) // 2]

    # The same prefill on the plain masked path (bf16), and in float32 compute.
    zero_counts()
    plain, _ = T.prefill(model, prompt, cfg.replace(block_local_attn=False), max_len=max_len)
    f32, _ = T.prefill(model, prompt, cfg.replace(block_local_attn=False, compute_dtype=torch.float32),
                       max_len=max_len)
    check(read_counts()["banded_attention_kernel"] == 0, "[lm] K5 launched on the plain path")
    d_band = float((logits - plain).abs().max())
    d_bf16 = float((plain - f32).abs().max())
    # Tolerance: the banded path (K5: bf16 weights, float32 softmax and
    # sum) may move the logits at most twice as far from the plain bf16 path
    # as bf16 compute itself moves them from float32 compute.
    tol = 2.0 * d_bf16
    check(d_band <= tol, f"[lm] banded vs plain prefill logits differ by {d_band}, more than {tol}")
    top2 = torch.topk(plain, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > tol
    same = torch.argmax(logits, -1) == torch.argmax(plain, -1)
    check(bool(same[sure].all()), f"[lm] first greedy token differs from the plain path where its "
                                  f"top-2 margin exceeds {tol}")
    log(f"[lm] prefill logits: banded (K5) vs plain masked path max abs {d_band}; plain bf16 vs "
        f"float32 compute {d_bf16}; tolerance {tol}; max |logit| {float(plain.abs().max())}; first "
        f"token equal in {int(same.sum())}/{LM_BATCH} rows ({int(sure.sum())} with a top-2 margin "
        f"above the tolerance); vs float32 equal in "
        f"{int((torch.argmax(f32, -1) == torch.argmax(plain, -1)).sum())}/{LM_BATCH}")
    del plain, f32, logits
    torch.cuda.empty_cache()

    nums = dict(generate_s=wall, prefill_s=prefill_s, decode_ms_per_token=decode_ms,
                tokens_per_s=LM_BATCH * LM_TOKENS / wall, decode_tokens_per_s=LM_BATCH / decode_ms * 1e3,
                prefill_tokens_per_s=LM_BATCH * LM_PROMPT / prefill_s, max_memory_allocated_bytes=peak,
                logits_band_vs_plain=d_band, logits_bf16_vs_f32=d_bf16)
    log(f"[lm] {smi}: generate {wall} s for {LM_BATCH} x {LM_TOKENS} tokens ({nums['tokens_per_s']} "
        f"tokens/s with the prefill); prefill {prefill_s} s ({nums['prefill_tokens_per_s']} prompt "
        f"tokens/s); decode {decode_ms} ms a step, median of {LM_TOKENS} ({nums['decode_tokens_per_s']} "
        f"tokens/s); max_memory_allocated {peak} B; launches {json.dumps(launches)}; sample "
        f"{tokens[0, :8].tolist()}")
    return model, cfg, prompt, launches, nums


def profile_lm(torch, model, cfg, prompt, dev, prefill_s, decode_ms):
    """One prefill, then one decode step, each under torch.profiler: device
    time by kernel, K5's share of the prefill's, and the device's idle
    share of the unprofiled prefill wall and decode step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as T

    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logits, caches = T.prefill(model, prompt, cfg, max_len=LM_PROMPT + LM_TOKENS)
        sync(torch, dev)
    tok = torch.argmax(logits, -1).to(torch.int32)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_d:
        T.decode_step(model, tok, caches, LM_PROMPT, cfg)
        sync(torch, dev)
    for label, p, wall_ms in (("prefill", prof, prefill_s * 1e3), ("decode step", prof_d, decode_ms)):
        kern = device_events(p)
        busy_ms = sum(device_us(e) for e in kern) / 1e3
        if not kern or busy_ms == 0:
            log(f"[profile lm {label}] the profiler saw no device time: device busy share not measured")
            continue
        k5_ms = sum(device_us(e) for e in kern if "band_attn" in e.key) / 1e3
        out[label] = dict(busy_ms=busy_ms, k5_ms=k5_ms, idle_share=1 - busy_ms / wall_ms)
        log(f"[profile lm {label}] device busy {busy_ms} ms over {len(kern)} kernel/copy names "
            f"({sum(e.count for e in kern)} launches); unprofiled wall {wall_ms} ms; device idle share "
            f"{1 - busy_ms / wall_ms}; K5 {k5_ms} ms, {k5_ms / busy_ms} of the device time")
        for e in kern[:15]:
            log(f"[profile lm {label}]   {device_us(e) / 1e3:10.3f} ms  x{e.count:<5d} "
                f"{device_us(e) / 1e3 / max(e.count, 1):.4f} ms a launch  {e.key[:90]}")
    return out


def sdpa_backends(torch, fn, dev) -> dict:
    """Which SDPA backends take ``fn``'s inputs (each alone through
    ``sdpa_kernel``), and the device kernels three calls of ``fn`` launch
    under torch.profiler, longest first."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    takes = []
    for name in ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "MATH"):
        try:
            with sdpa_kernel(getattr(SDPBackend, name)):
                fn()
                sync(torch, dev)
            takes.append(name)
        except RuntimeError:
            pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        sync(torch, dev)
    return dict(takes=takes, kernels=[e.key[:100] for e in device_events(prof)][:4])


def time_band_attn(np, torch, qkv, dev, launches, max_abs_err):
    """CUDA-event medians of K5, its plain version and SDPA with the band
    as a boolean mask (the yardstick: one PyTorch call computing the same
    function; the port never calls it) at the serving shape, in turns
    (K5, plain, SDPA, then K5 and SDPA again: each median over both turns),
    with K5's share of its bound and useful TFLOP/s, and the kernels SDPA
    launched."""
    import torch.nn.functional as F

    from repro_torch.kernels._timing import median
    from repro_torch.kernels.band_attn import kernel as bk
    from repro_torch.kernels.band_attn.ref import banded_attention_ref

    q, k, v = qkv
    b, s, h, hd = q.shape
    kvh, w = k.shape[2], K5_CASES[0][-1]
    flush = torch.empty(128 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    i = torch.arange(s, device=dev)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - w)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def kernel():
        return bk.banded_attention_kernel(q, k, v, w)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)

    ms_runs = [cuda_times(torch, kernel, 20, flush)]
    plain = time_cuda(torch, lambda: banded_attention_ref(q, k, v, w), 5, flush)
    lib_runs = [cuda_times(torch, sdpa, 20, flush)]
    ms_runs.append(cuda_times(torch, kernel, 20, flush))
    lib_runs.append(cuda_times(torch, sdpa, 20, flush))
    ms, lib = median(ms_runs[0] + ms_runs[1]), median(lib_runs[0] + lib_runs[1])
    lib_err = float((sdpa().transpose(1, 2).float() - kernel().float()).abs().max())
    lib_backends = sdpa_backends(torch, sdpa, dev)
    flops = 4 * hd * band_pairs(s, w) * b * h
    nbytes = q.element_size() * (2 * b * s * h * hd + 2 * b * s * kvh * hd)
    t_ops, t_bytes = flops / BF16_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    tflops = flops / (ms * 1e-3) / 1e12
    attrs = bk.tc_attributes(hd, h, kvh) if dev.type == "cuda" else {}
    log(f"[K5] the bf16 kernel's instantiation for hd {hd}, {h}/{kvh} heads: {json.dumps(attrs)} "
        f"(registers a thread, local memory bytes a thread: 0 means no spills, dynamic shared memory "
        f"bytes a block)")
    log(f"[time] K5 banded_attention_kernel (B, S, H, KV, hd, W) = {(b, s, h, kvh, hd, w)} bf16: "
        f"kernel {ms} ms (medians of its two turns {[median(t) for t in ms_runs]}), plain {plain} ms, "
        f"SDPA with a boolean band mask {lib} ms (turns {[median(t) for t in lib_runs]}; max abs {lib_err} from K5; backends that take it {lib_backends['takes']}, kernels of the default {lib_backends['kernels']}); bound {bound} ms "
        f"by {by} ({flops} FLOPs at the bf16 peak {t_ops} ms, {nbytes} B {t_bytes} ms); "
        f"{100 * bound / ms} % of bound, {tflops} TFLOP/s useful; K5 / SDPA {ms / lib}")
    return dict(name="banded_attention_kernel", route="cuda", source="src/repro_torch/csrc/band_attn.cu",
                replaces="src/repro/kernels/band_attn/kernel.py:28",
                launches=launches["banded_attention_kernel"], max_abs_err=max_abs_err,
                ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, library_ms=lib,
                bound_share=bound / ms, tflops=tflops, library_kernels=lib_backends["kernels"], **attrs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.pdf_seismic import SET1, to_spec
    from repro_torch.core import distributions as dists
    from repro_torch.core.pipeline import PDFConfig
    from repro_torch.data.simulation import SeismicSimulation
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build(*KERNEL_SOURCES)
    log(f"[build] csrc/{{{','.join(KERNEL_SOURCES)}}}.cu, one nvcc each, all at once, with "
        f"{' '.join(_build.NVCC_FLAGS)} into {_build.BUILD_DIR.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0} s")

    sim = SeismicSimulation()  # Set1: CubeGeometry(501, 501, 251), 1,000 observations
    cases = kernel_cases(np, sim, SET1_SLICE)
    worst_k1, err_k2 = compare_kernels(np, torch, cases, dev)
    worst_k3, err_rows = compare_new_kernels(np, torch, cases, dev)

    # The load stage (pinned staging), then a file cube of the slice, a fault
    # plan over it and the scheduler's shard re-deal, in a temporary
    # directory under build/ deleted at the end.
    clean, staging_nums = staging_phase(np, torch, sim, SET1_SLICE, dev)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp_name:
        tmp = Path(tmp_name)
        cube_path, file_nums = file_phase(np, torch, sim, SET1_SLICE, dev, clean, tmp)
        fault_nums, faults_res = faults_phase(np, torch, cube_path, dev, clean, tmp)
        api_launches = api_faults_phase(np, torch, cube_path, dev, tmp, fault_nums, faults_res)
        sched_nums = scheduler_phase(np, torch, sim, dev, tmp)
        # Streaming on the cube (it appends to it, so after every other
        # user), then multi-process cluster runs of run_pdf.
        stream_cluster_launches, stream_nums = stream_phase(
            np, torch, cube_path, dev, clean, tmp, file_nums["file"]["wall_s"])
        cluster_launches, cluster_nums = cluster_phase(np, torch, dev, tmp)
        stream_cluster_launches.update(cluster_launches)
    del clean, faults_res
    exec_launches = {"faults": fault_nums["launches"], "scheduler": sched_nums["launches"]}
    log(f"[summary executor] {smi}: Set1 slice {SET1_SLICE}; staging {json.dumps(staging_nums)}; "
        f"file {json.dumps(file_nums)}; faults {json.dumps(fault_nums)}; scheduler "
        f"{json.dumps(sched_nums)}")

    launches4, wall4 = run_slice_phase(np, torch, sim, SET1_SLICE, dists.TYPES_4, 64, dev,
                                       SET1_WINDOWS)
    launches10, wall10 = run_slice_phase(np, torch, sim, SET1_SLICE, dists.TYPES_10, 20, dev,
                                         SET1_WINDOWS)

    launches_k, launches_rows, walls = grouped_phases(np, torch, sim, SET1_SLICE, dev)

    # Past the bins one block of K2 or K4 held before the chunked route, then
    # past the bins one K2 block holds.
    launches1000, wall1000 = run_slice_phase(np, torch, sim, SET1_SLICE, dists.TYPES_4, 1000, dev,
                                             SET1_WINDOWS)
    walls["baseline_fused_L1000"] = wall1000
    launches2000, walls["baseline_fused_L2000"] = run_slice_phase(
        np, torch, sim, SET1_SLICE, dists.TYPES_4, 2000, dev, SET1_WINDOWS)
    kernels_window_phase(np, torch, torch.from_numpy(cases[0][1]).to(dev), 2000, dev)

    # The ML and sampling methods, with the tree of TreeSpec's defaults.
    tree, tree_nums = train_phase(np, torch, sim, dev)
    ml_launches, ml_walls, ml_nums = ml_phases(np, torch, sim, SET1_SLICE, dev, tree)
    batch_launches, batch_nums = batch_phase(np, torch, sim, dev, tree)
    exec_launches.update(batch_launches)
    log(f"[summary batch] {smi}: {json.dumps(batch_nums)}")

    # The declarative API (PDFSession, the result cache, run_pdf) and the
    # PDF query server over the paper's Set1 spec, in a temporary directory
    # under build/ deleted at the end.
    spec = to_spec(SET1)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp_name:
        tmp = Path(tmp_name)
        launches_api, api_nums = api_phase(np, torch, spec, sim, dev, tree, tmp)
        launches_serve, serve_nums = pdf_serve_phase(np, torch, spec, dev, tmp,
                                                     [SET1_SLICE - 1, SET1_SLICE])
    api_launches.update(launches_api)
    api_launches.update(launches_serve)
    log(f"[summary api] {smi}: {json.dumps(api_nums)}")
    log(f"[summary serve] {smi}: {json.dumps(serve_nums)}")
    profile_slice(torch, PDFConfig(method="grouping_ml", num_bins=20), "set1 grouping_ml L20", sim,
                  SET1_SLICE, dev, ml_walls["set1 grouping_ml L20"], tree=tree)
    log(f"[summary ml] {smi}: Set1 slice {SET1_SLICE}; tree {json.dumps(tree_nums)}; wall_s "
        f"{json.dumps(ml_walls)}; launches {json.dumps(ml_launches)}; {json.dumps(ml_nums)}")

    for label, cfg, wall in (
            ("baseline fused", PDFConfig(), wall4),
            ("grouping kernels", PDFConfig(method="grouping", fit_backend="kernels"),
             walls["grouping_kernels"]),
            ("grouping fused device", PDFConfig(method="grouping", select_backend="device"),
             walls["grouping_fused_device"])):
        profile_slice(torch, cfg, label, sim, SET1_SLICE, dev, wall)

    x = torch.from_numpy(cases[0][1]).to(dev)  # a Set1 window, (6275, 1000)
    rows = time_kernels(np, torch, x, dev, launches4, worst_k1, err_k2)
    rows += time_new_kernels(np, torch, x, dev, launches_k, launches_rows, worst_k3, err_rows)
    large = time_large_bins(np, torch, x, dev)
    for r in rows:
        r["launches_ml_sampling"] = {label: n[r["name"]] for label, n in ml_launches.items()
                                     if n[r["name"]]}
        r["launches_executor_paths"] = {label: n[r["name"]] for label, n in exec_launches.items()
                                        if n[r["name"]]}
        r["launches_api_serve"] = {label: n[r["name"]] for label, n in api_launches.items()
                                   if n[r["name"]]}
        r["launches_stream_cluster"] = {label: n[r["name"]]
                                        for label, n in stream_cluster_launches.items()
                                        if n[r["name"]]}
        if r["name"] in ("fit_error_counts", "hist_counts"):
            k = "k2" if r["name"] == "fit_error_counts" else "k4"
            r["at_large_L"] = {L: {key[3:]: v for key, v in d.items() if key.startswith(k)}
                               for L, d in large.items()}
    log(f"[summary] {smi}: Set1 slice {SET1_SLICE} wall_s 4types_L64={wall4} "
        f"10types_L20={wall10} {json.dumps(walls)}; launches 10types_L20 {json.dumps(launches10)}, "
        f"4types_L1000 {json.dumps(launches1000)}, 4types_L2000 {json.dumps(launches2000)}")
    del x, cases

    # The LM serving path.
    qkv, err_k5 = compare_band_attn(np, torch, dev)
    model, cfg, prompt, launches_lm, lm = serve_phase(np, torch, dev, smi)
    prof = profile_lm(torch, model, cfg, prompt, dev, lm["prefill_s"], lm["decode_ms_per_token"])
    del model
    torch.cuda.empty_cache()
    rows.append(time_band_attn(np, torch, qkv, dev, launches_lm, err_k5))
    log(f"[summary lm] {smi}: {json.dumps(lm)}; profile {json.dumps(prof)}")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
