#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (``fitpdf``,
``moments``, ``hist``, ``band_attn`` and ``ssd_intra``, one ``nvcc`` each, all at once, into
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
  then as 2 and 4 workers through ``src/repro_torch/launch/cluster.sh``
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
  subsets) and with k-means (a 0.02 sample: 125 clusters a window), and
  the paper's Set1 configuration
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
  grouping (host Select), on slices 200-201: 4 client threads of 6 point,
  2 window and 1 region query each (``numpy.random.default_rng(0)``),
  coalesced (storing the completed slices in a ``cache_dir``), naive
  (``serve.coalesce`` off, no hot-window LRU) and a second server over
  the warm cache: every answer bitwise equal across the three and to the
  session's slices; coalesced K2 at most the distinct windows requested,
  naive at least as many, warm none; request and launch p50/p99,
  ``coalesce_ratio``, ``batch_occupancy`` and hit rates logged;
* ``[cli]``: the port's CI sequences (``.github/workflows/ci_torch.yml``)
  as commands on tiny cubes under ``build/``, with no ``--device`` (each
  launcher's own default, cuda): ``run_pdf --cache-dir`` cold then warm,
  ``run_pdf --fault-plan`` (transient read errors, bitwise the clean run),
  ``serve_pdf --clients 4``, and a streaming cube's cold run with
  sidecars, an append and the incremental rerun, then ``run_pdf --watch``
  applying an append made once it polls; three chains side by side, each
  command's wall logged.

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

* K5 against its plain version at gemma3's serving shape (B 4, S 4096,
  H 16, KV 8, hd 256, W 1024, bf16), a ragged S = 4000, an S = 700 < W,
  and hymba-1.5b's (B 4, S 4096, H 25, KV 5, hd 64, W 1024): each output
  row's relative distance from the float32 truth within twice that of the
  plain version with the oracle's bf16 weights, repeats bitwise, launches
  counted, and a window off by one rejected by the same gate;
* ``[lm]``: gemma3-12b at full width cut to 12 layers (10 local, 2
  global), random weights from a seeded generator on the card:
  ``generate`` on 4 prompts of 4,096 tokens and 16 greedy tokens with the
  counts set to 0 (10 K5 launches), a prefill alone twice (bitwise equal
  logits), the decode steps alone (no K5 launch, the same tokens), and the
  prefill's logits and first token held against the plain masked path and
  float32 compute;
* ``[lm ssm]``: mamba2-780m at full width cut to 12 of 48 SSD layers, the
  same way with no kernel launched at all; its bf16 logits against float32
  compute, the decode oracle in float32 compute (4 greedy steps, each
  step's logits against ``forward`` over the extended sequence within the
  reference's rtol = atol = 1e-3) and the decode cache's bytes equal after
  prompts of 1,024 and 4,096 tokens;
* ``[lm hybrid]``: hymba-1.5b at full width cut to 8 of 32 layers (1
  global and 7 windowed hybrid layers) with the banded path on: 7 K5
  launches a prefill, none a decode step (past the 1,024 ring), bitwise repeat, and
  the gemma3 gate against the plain masked path and float32 compute;
* ``[lm encdec]``, ``[lm vlm]``, ``[lm moe]``, ``[lm moe kimi]``
  (``XMODEL_PHASES``): seamless-m4t-medium at full depth (its frames 4 x
  4,096 x 1,024 from the seeded generator), llama-3.2-vision-90b cut to
  one pattern period (4 self + 1 cross layer; patches 4 x 1,601 x 8,192),
  arctic-480b and kimi-k2-1t cut to 2 layers with bf16 parameters and 2
  prompts, all at full width, the same way with no kernel launched; each
  one's decode
  oracle in float32 compute at full width (2 x 16 tokens: prefill within
  1e-4 of ``forward``, 3 greedy steps within 1e-3), and for the MoE each
  layer's capacity and dropped choices in a prefill and a decode step
  (which must drop none);
* ``[train hymba]``: the training path (``repro_torch.launch.train``'s
  ``build_step``) on hymba-1.5b as ``[lm hybrid]`` has it (8 layers) with the banded
  path on and remat "full", AdamW (lr 3e-4, cosine over 6 steps),
  ``TokenPipeline(32,001, 4,096, 4, seed 0)`` (batch 2 if 4 does not fit,
  the refusal logged): 6 steps, each with a finite loss and gnorm (so
  every gradient finite) and exactly 14 K5 launches (7 forward, 7 in
  the remat recompute, none in the backward); step time (median of steps
  2-6), tokens/s, peak memory; the banded backward's device time by CUDA
  events around its calls; one step under ``torch.profiler``; a step
  repeated from a host copy of the state bitwise equal (parameters,
  moments, step);
* ``[train hymba grad]``: hymba at full width cut to 4 layers (the global
  one and 3 windowed): every parameter's gradient with K5 (bf16), on the
  plain masked path (bf16) and in float32 compute; per tensor the
  relative 2-norm distance K5 vs plain at most twice plain bf16 vs
  float32;
* ``[train reduced]``: every registry config's ``reduced()`` from the same
  seed-0 weights and batch on the card and on the CPU: finite gradients,
  the losses within rtol 1e-5, one step on the card; then
  ``examples/train_lm_torch.py``'s flow on granite-3-8b reduced (60 steps,
  the loss falls, a resume from the halfway checkpoint bitwise the
  uninterrupted run);
* for each model one prefill and one decode step under ``torch.profiler``
  (device time by kernel and by operator, K5's share, the device idle
  share) and, for mamba2 and hymba, the SSD's device time in a prefill by
  CUDA events around its calls; then K5's time at both shapes beside its
  bound, its plain version and SDPA with the band as a mask;
* ``[ssd intra]``: K6, the SSD's intra-chunk kernel (``csrc/ssd_intra.cu``),
  at both prefill cells' shapes (``SSD_INTRA_SHAPES``): bitwise repeat, the
  gate against the plain version on float32 operands, kernel ms, call ms
  and the plain version's ms beside its bound (``[time]``, ``[roofline
  kernels]``); mamba2-780m and hymba-1.5b at full depth, one prefill each
  of 4 x 4,096 tokens, timed, with K6 launched 48 and 32 times; a
  training step of mamba2-780m at 2 layers launching none. Every LM
  phase's ``generate`` and prefill launch K6 once a layer with an SSD in
  bf16 (12 in ``[lm ssm]``, 8 in ``[lm hybrid]``), none in decode; the
  training phases none (grad is on).

The accounting layer (``repro_torch.launch.roofline``, ``dryrun``,
``dryrun_pdf``, ``report``) is held against the card:

* ``[roofline kernels]``: every ``[time]`` line's bound comes from
  ``launch/roofline.py``'s work models and must be the float this script's
  inline formulas gave before they moved there (``premove_bound_ms``); each
  measured time (kernel ms for K1-K4, call ms for K5) at most MAX_SHARE of
  its bound;
* ``[roofline lm]``: the meta dry run (``dryrun.run_cell``) of the runs
  measured above (gemma3-12b's 12-layer prefill, mamba2-780m's and
  hymba-1.5b's, hymba-1.5b's training step): each bound beside the
  measured seconds, the share at most MAX_SHARE, the argument bytes equal
  to the live model's and optimizer's;
* ``[dryrun mesh]``: the dry run's sharded step for granite-3-8b
  ``decode_32k`` on 16x16 (``python -m repro_torch.launch.dryrun``),
  arctic-480b and mamba2-780m ``decode_32k`` and granite-3-8b
  ``train_4k`` on 16x16 and hymba-1.5b ``long_500k`` on 2x16x16
  (``run_cell``), ``dryrun_pdf``'s ``grouping_global`` on 16x16 (its
  command line) and ``fused_scatter_shmap`` on 2x16x16: each cell's wall,
  collectives and collective term; a failed cell fails the run. Two
  counts are held to bounds this script computes from the configs'
  shapes: arctic-480b ``decode_32k``'s collective bytes a device below
  what all-gathering each layer's ``wq`` over ``data`` alone would move
  (its decode moves the tokens' rows instead, ``layers._project_rows``);
  granite-3-8b ``train_4k``'s FLOPs a device equal to a 256th of its
  1x1 count (its command line ``--mesh 1x1``) plus the K and V products of the
  KV heads each model rank's own query heads read beyond its share
  (``sharding.own_kv_heads``: 8 KV heads do not divide 16);
* ``[dryrun]``: ``python -m repro_torch.launch.dryrun --arch gemma3-12b
  --mesh 1x1`` (3 cells and one skipped by design; the CPU tests run
  ``--all``), ``dryrun_pdf --all`` and ``report`` as subprocesses, their
  walls and cells; a failed cell fails the run.

The command lines of ``[dryrun]`` and ``[dryrun mesh]`` (host work on meta
tensors, nothing on the card) start together and run beside the meta
passes of ``[roofline lm]`` and ``[dryrun mesh]``'s other cells.

The multi-device half (``launch/mesh.py``, ``models/sharding.py``, the
sharded train step, flash decode, the compressed all-reduce, the split
stager) runs last, on the one card:

* ``[mesh 1x1]``: a one-rank NCCL world in this process and its 1x1
  ``DeviceMesh``: hymba-1.5b at full width cut to 4 layers (the global
  one and 3 windowed; remat full, AdamW, 4 x 4,096 tokens) for 2 steps
  through ``train.build_step`` on DTensor parameters (K5 on each rank's
  heads through ``local_map``: 6 launches a step) and on the one device
  from the same weights and batches: losses and every parameter bitwise
  equal; then gemma3-12b as ``[lm]`` has it, in float32 compute, with
  ``flash_decode`` and the mesh in ``extras``: its 2 global layers decode
  by ``flash_decode_attention`` against caches placed on the mesh, each
  of 16 steps' logits within the decode oracle's 1e-3 of the plain
  decode's, ``generate``'s 16 tokens equal, no K5 launch in decode; then
  arctic-480b as ``[lm moe]`` has it (full width, 2 layers, bf16
  parameters, 2 x 4,096 tokens): a prefill on the one device (its logits
  and each MoE layer's kept set kept on the host), then the same
  parameters placed on the mesh and the prefill again through the
  sharded MoE (``sharding.local_experts``): logits bitwise, the same kept
  set and drops in each layer;
* ``[mesh 2 ranks]``: two processes on the one card with
  ``backend="gloo"`` passed explicitly and logged (NCCL refuses two ranks
  on one device): flash decode at
  gemma3's attention width (float32, a 4 x 4,112 cache split over the
  ranks) within 2e-5 of the one-rank plain decode, each rank's block of
  the cache equal to it and written only by the owner of the position;
  ``pod_allreduce_compressed`` of a tensor of hymba's embedding gradient's
  shape within 1e-6 of the scheme and 0.05 of the mean; Set1 slice 201's
  21 windows split over the ranks by ``ShardedStager`` (K1 and K2 once a
  window on each rank), each window bitwise the one-rank window; one
  arctic-480b MoE layer at full width on a 1x2 mesh (64 experts a rank,
  bf16 parameters, float32 compute, 2 x 4,096 tokens with a shared
  direction, so the capacity drops): the kept set of the one-rank layer
  (computed in this process first), the output within the float32
  oracle's 1e-4 of it, each rank's expert buffer as many rows as its
  slab's largest kept count (only all-reduces cross the ranks); one
  windowed attention layer at 1x2 with gemma3-12b's width, heads, head
  dimension 256 and window but a single KV head (cut from 8, so that it
  does not divide the model axis as gemma3's 8 do not divide 16), float32,
  LM_BATCH // 4 x LM_PROMPT tokens: each rank projects the KV head its 8
  query heads read (``sharding.own_kv_heads``) and K5 runs once on each
  rank on those heads, the output within the float32 oracle's 1e-4 of
  the one-rank layer's (one all-reduce crosses the ranks).

The K1-K4 rows of the kernels line carry ``launches_api_serve``, the
``[api]`` and ``[serve]`` launches, and ``launches_stream_cluster``, those
of ``[stream]`` and ``[cluster]`` (summed over a cluster's workers); the
K5 row carries ``launches_lm_paths`` (each model's ``generate``: 0 on the
enc-dec, VLM and MoE paths), ``at_hymba_shape`` (its numbers at hymba's
shape), ``launches_train`` (a ``[train hymba]`` step's, the grad phase's
K5 way's, ``[train reduced]``'s) and ``train_hymba`` (the step's time,
K5's device time in the profiled step, the banded backward's); K1 and K2
carry ``launches_mesh`` (each rank's in the split stager), K5 a sharded
step's in ``[mesh 1x1]``; the K6 row carries ``at_hymba_shape``,
``launches_lm_paths``, ``launches_train`` and ``full_depth``. Every phase
logs its wall as ``[phase] <label>
<s>``, and a ``[phases]`` line sums them. Any failed check raises, so the
exit code is non-zero. The line before the last is a JSON object of
per-kernel numbers; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
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

# The card's peaks and every kernel's work model live in
# src/repro_torch/launch/roofline.py. [roofline kernels] holds each bound it
# gives to the float this script's inline formulas gave before they moved
# there (premove_bound_ms: the same H100 SXM data-sheet peaks, HBM bytes/s,
# float32, float64 and bf16 op/s), and every measured time to at most
# MAX_SHARE of its bound: a time more than 5 % under its bound means the
# work count is wrong.
PREMOVE_PEAKS = dict(hbm=3.35e12, f32=67e12, f64=34e12, bf16=989e12)
MAX_SHARE = 1.05

SET1_SLICE = 201  # configs/pdf_seismic.py: slice_index
SET1_WINDOWS = 21  # ceil(501 lines / 25 lines per window)
# k-means sampling's fraction: 125 clusters a window of 6,275 points (the
# random sampler keeps the reference's 0.1); host Lloyd's time grows with it.
KMEANS_FRAC = 0.02
KERNEL_SOURCES = ("fitpdf", "moments", "hist", "band_attn", "ssd_intra")  # src/repro_torch/csrc/<name>.cu

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
# (B, S, H, KV, hd, W): gemma3's serving shape, a ragged S and an S < W;
# then hymba-1.5b's (25 / 5 heads: G = 5 is odd, so one warpgroup a block;
# hd 64 is one TMA box).
K5_CASES = ((4, 4096, 16, 8, 256, 1024), (4, 4000, 16, 8, 256, 1024), (4, 700, 16, 8, 256, 1024),
            (4, 4096, 25, 5, 64, 1024))
K5_GEMMA, K5_HYMBA = (4, 16, 8, 256), (4, 25, 5, 64)  # (B, H, KV, hd) of each model's launches
# K6, the SSD's intra-chunk kernel, at the two prefill cells' shapes, (B,
# Nc, Q, H, P, N, G) at 4 x 4,096 tokens: mamba2-780m and hymba-1.5b (P 50:
# no 16-byte row). Its gate against the plain version on float32 operands:
# at most SSD_INTRA_TOL times the plain bf16 path's relative 2-norm distance
# (both round the decay matrix to bf16 and sum in float32; as
# tests/test_torch_kernels_cuda.py holds it).
SSD_INTRA_SHAPES = {"mamba2-780m": (4, 16, 256, 48, 64, 128, 1), "hymba-1.5b": (4, 16, 256, 64, 50, 16, 1)}
SSD_INTRA_TOL = 1.25
# [ssd intra]'s training step: mamba2-780m at full width cut to this many
# layers, one step of batch 2 x LM_PROMPT (no SSD kernel launch: grad is on).
SSD_INTRA_TRAIN_LAYERS = 2
# The SSM and hybrid serving paths at full width (configs/mamba2_780m.py,
# configs/hymba_1_5b.py), cut to SSM_LAYERS of 48 and HYBRID_LAYERS of 32
# layers (hymba: its global layer and 7 windowed ones, which run K5; the
# same depth trains in [train hymba]), random weights from a seeded
# generator, float32 parameters, bf16 compute, the same batch, prompt and
# tokens as [lm].
SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "hymba-1.5b"
SSM_LAYERS = 12
HYBRID_LAYERS = 8
HYBRID_LOCAL_LAYERS = HYBRID_LAYERS - 1
# The reference's decode oracle: decode logits against forward over the
# extended sequence, rtol = atol = 1e-3 (tests/test_models.py:40-42), here
# in float32 compute with TF32 off, after each of ORACLE_STEPS greedy steps.
ORACLE_STEPS = 4
LM_DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
# The cross-attention and MoE serving paths at full width, random weights
# (seed 0), bf16 compute, the same prompt and tokens as [lm]: (label, arch,
# layers kept, parameters in bf16, batch). seamless-m4t-medium at full
# depth (12 encoder + 12 decoder layers, f32 parameters); llama-3.2-vision-90b
# cut to one pattern period (4 self + 1 cross of 100 layers, f32);
# arctic-480b to 2 of 35 layers and kimi-k2-1t to 2 of 61 (its dense layer
# 0 and one MoE layer), both with bf16 parameters (in float32 one arctic
# layer is 53.6 GB) and at batch 2: at batch 4 the plain masked path's
# float32 scores, their softmax and its bf16 cast (37.6 GB at 56 heads,
# 43.0 GB at 64) do not fit beside the weights on an 80 GB H100 (arctic
# stopped at 78.7 GB allocated, asking 14 GiB more; kimi at 74.4 GB, asking
# 8 GiB). Widths, heads, experts, top-k and capacity are never cut.
XMODEL_PHASES = (("lm encdec", "seamless-m4t-medium", None, False, LM_BATCH),
                 ("lm vlm", "llama-3.2-vision-90b", 5, False, LM_BATCH),
                 ("lm moe", "arctic-480b", 2, True, LM_BATCH // 2),
                 ("lm moe kimi", "kimi-k2-1t-a32b", 2, True, LM_BATCH // 2))
# Their decode oracle (tests/test_models.py:28-44), in float32 compute at
# full width: a prompt of ORACLE_PROMPT tokens for ORACLE_BATCH rows (the
# MoE drop-free at T <= 256), prefill's last logits against forward within
# LM_PREFILL_TOL, then ORACLE_DECODE greedy steps within LM_DECODE_TOL.
ORACLE_BATCH, ORACLE_PROMPT, ORACLE_DECODE = 2, 16, 3
LM_PREFILL_TOL = dict(rtol=1e-4, atol=1e-4)
# The training path (launch/train.py): hymba-1.5b at full width cut to
# HYBRID_LAYERS layers with the banded path on and its registry remat
# ("full": each layer after the global prefix keeps only its input and is
# recomputed in the backward), f32 parameters, bf16 compute, AdamW (lr 3e-4, cosine over the
# phase's TRAIN_STEPS), TokenPipeline(32,001, LM_PROMPT, batch, seed 0).
# Batch TRAIN_BATCH (serving's) if it fits, else half. K5 runs in each
# windowed layer's forward and again in its recompute, never in the
# backward (the blocked plain form's gradient): 14 launches a step. K6
# none: grad is on.
TRAIN_STEPS = 6
TRAIN_BATCH = LM_BATCH
TRAIN_LR = 3e-4
TRAIN_K5_PER_STEP = 2 * HYBRID_LOCAL_LAYERS
# [train hymba grad]: hymba at full width cut to the global prefix layer
# and 3 windowed ones; every parameter's gradient with K5, with the plain
# masked path (bf16) and in float32 compute. Per tensor, the relative
# 2-norm distance K5 vs plain bf16 at most TRAIN_GRAD_TOL times plain bf16
# vs float32 (the [lm] logits gate, on gradients).
TRAIN_GRAD_LAYERS = 4
TRAIN_GRAD_TOL = 2.0
# [train reduced]: every registry config's reduced() one step on the card
# and on the CPU from the same weights and batch (float32, TF32 off): the
# losses within float32 tolerance. Then examples/train_lm_torch.py's flow
# on granite-3-8b reduced (EXAMPLE_STEPS, batch 4 x 64 tokens).
TRAIN_REDUCED_SEQ, TRAIN_REDUCED_BATCH = 64, 2
TRAIN_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
EXAMPLE_ARCH, EXAMPLE_STEPS = "granite-3-8b", 60


# The multi-device half ([mesh 1x1], [mesh 2 ranks], [dryrun mesh]). [mesh
# 1x1] trains hymba-1.5b at full width cut to MESH_HYMBA_LAYERS layers (the
# global prefix and 3 windowed ones: K5 twice a windowed layer a step, as
# in [train hymba]) MESH_TRAIN_STEPS steps through the sharded step on a
# one-rank NCCL world, bitwise the one-device step; then gemma3-12b's
# [lm] cut with flash_decode on the 1x1 mesh. [mesh 2 ranks] spawns two
# processes on the one card with gloo; flash decode at gemma3's attention
# width at a position in each half of the cache, and the plain decode on
# split full and ring caches.
MESH_HYMBA_LAYERS = 4
MESH_TRAIN_STEPS = 2
MESH_K5_PER_STEP = 2 * (MESH_HYMBA_LAYERS - 1)
MESH_FLASH_TOL = dict(rtol=0.0, atol=2e-5)  # the reference's (tests/test_mesh_multidevice.py:190)
MESH_TIMEOUT = 300
# The MoE on a mesh: arctic-480b as [lm moe] has it (XMODEL_PHASES) in
# [mesh 1x1]; one of its MoE layers at 1x2 in [mesh 2 ranks], float32
# compute from bf16 parameters (each expert drawn from its own seed, so a
# rank draws only its slab), held to the one-rank layer within the float32
# oracle's LM_PREFILL_TOL. Two copies of the 2-layer model do not fit
# beside each other, so the one-device prefill's logits and kept sets wait
# on the host while the same parameters go onto the mesh.
MESH_MOE_ARCH, MESH_MOE_LAYERS, MESH_MOE_BATCH = "arctic-480b", 2, LM_BATCH // 2
MESH_MOE_SEED = 7
# [mesh 2 ranks]'s windowed layer: gemma3-12b's attention with one KV head
# (cut from 8) on LM_BATCH // 4 x LM_PROMPT tokens, float32.
MESH_BAND_KV_HEADS, MESH_BAND_BATCH = 1, LM_BATCH // 4
# [dryrun mesh]: the LM dry run and the PDF window step's mesh variants on
# the production meshes (fake worlds of 256 and 512 ranks): (arch or
# variant, shape, multi_pod, through the command line or in this process).
DRYRUN_MESH_CELLS = (("granite-3-8b", "decode_32k", False, True), ("arctic-480b", "decode_32k", False, False),
                     ("hymba-1.5b", "long_500k", True, False), ("mamba2-780m", "decode_32k", False, False),
                     ("granite-3-8b", "train_4k", False, False))
DRYRUN_PDF_MESH_CELLS = (("grouping_global", "window_small", False, True),
                         ("fused_scatter_shmap", "window_prod", True, False))
# [dryrun mesh]'s bound on granite-3-8b train_4k at 16x16 starts from its
# 1x1 count, a command line of its own beside the others.
DRYRUN_BOUND_CELL = ("granite-3-8b", "train_4k")
DRYRUN_BOUND_LABEL = "granite-3-8b train_4k 1x1 cli"
# [dryrun]'s command line: one config's cells on 1x1 (train_4k, prefill_32k,
# decode_32k; long_500k skipped by design for full attention). The CPU tests
# run all 40 (tests/test_torch_dryrun.py).
DRYRUN_ARCH = "gemma3-12b"


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
    from repro_torch.kernels.ssd_intra import kernel as sk

    return {"moments_edges_stats": (kernel.moments_edges_stats, "launches"),
            "fit_error_counts": (kernel.fit_error_counts, "launches"),
            "fit_error_counts_row_indices": (kernel.fit_error_counts, "row_index_launches"),
            "moments_stats": (mk.moments_stats, "launches"),
            "hist_counts": (hk.hist_counts, "launches"),
            "banded_attention_kernel": (bk.banded_attention_kernel, "launches"),
            "ssd_intra_kernel": (sk.ssd_intra_kernel, "launches")}


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
    for sampler, frac in (("random", 0.1), ("kmeans", KMEANS_FRAC)):
        cfg = PDFConfig(method="sampling", sampler=sampler, sample_frac=frac)
        label = f"sampling {sampler}"
        res = run(cfg, label, {"moments_edges_stats": W})
        off = res.type_idx < 0
        check(bool((res.type_idx[off] == -1).all()) and not res.params[off].any()
              and not res.error.any(), f"[{label}] unsampled points carry a type, params or error")
        want = [max(1, round(frac * (w.window.line_end - w.window.line_start) * ppl))
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


SERVE_CLIENTS = 4  # client threads of [serve]


def serve_queries(np, geom, slices, clients=SERVE_CLIENTS, seed=0):
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


def pdf_serve_phase(np, torch, spec, dev, tmp, slices, clients=SERVE_CLIENTS):
    """``PDFServer`` over ``spec`` (``to_spec(SET1)`` on the card) with the
    method set to baseline, then grouping (host Select), on ``slices``:
    ``clients`` client threads, each sending 6 point, 2 window and 1 region query
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
CLUSTER_WORKERS = (2, 4)  # one worker is the serial run's path; the CPU tests hold 1, 2 and 4


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

    for n in CLUSTER_WORKERS:
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


# The launchers as commands on a tiny cube, the sequences of the port's CI
# (.github/workflows/ci_torch.yml): 4 slices of 6 x 10 points, 80
# observations, grouping, slices 0-1; the streaming cube 3 slices of 4 x 6
# points, 48 observations, exported in chunks of 2 lines.
CLI_TIMEOUT = 300


def _append_midpoints(np, cube, slice_i: int, n: int = 5) -> None:
    """Append n realizations at each point's mid-range to one slice."""
    from repro_torch.core.regions import Window
    from repro_torch.data.file_source import FileCubeSource
    from repro_torch.streaming import append_realizations

    src = FileCubeSource(cube)
    g = src.geometry
    vals = src.load_window(Window(slice_i, 0, g.lines_per_slice))
    mid = (vals.min(axis=1) + vals.max(axis=1)) / 2.0
    block = np.repeat(mid[:, None], n, axis=1).astype(np.float32)
    append_realizations(cube, {slice_i: block.reshape(g.lines_per_slice, g.points_per_line, n)})


def cli_phase(np, tmp: Path, device: str | None = None) -> dict:
    """``run_pdf --cache-dir`` cold then warm, ``run_pdf --fault-plan``
    (transient read errors, bitwise the clean run), ``serve_pdf --clients
    4``, and the streaming sequence (a cold run with sidecars, an append and
    the incremental rerun, then ``run_pdf --watch`` with an append that
    lands once it polls), each a process of its own on ``device`` (none
    given: each launcher's own default, cuda). The three chains run side by
    side; each command's wall is logged. Returns {command: wall s}."""
    import os
    import re
    import threading

    from repro_torch.api import (ComputeSpec, ExecSpec, MethodSpec, PipelineSpec, SourceSpec,
                                 StreamSpec)
    from repro_torch.data.file_source import export_cube
    from repro_torch.runtime.faults import FaultPlan, FaultRule

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "PYTHONUNBUFFERED": "1"}
    dev_flags = ["--device", device] if device else []
    walls, outs = {}, {}

    def run(label, module, *args, on_line=None):
        argv = [sys.executable, "-m", f"repro_torch.launch.{module}", *map(str, args), *dev_flags]
        t0 = time.perf_counter()
        p = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, stdin=subprocess.DEVNULL)
        lines = []
        timer = threading.Timer(CLI_TIMEOUT, p.kill)
        timer.start()
        try:
            for line in p.stdout:
                lines.append(line)
                if on_line is not None:
                    on_line(line)
            rc = p.wait()
        finally:
            timer.cancel()
            if p.poll() is None:
                p.kill()
                p.wait()
        walls[label] = time.perf_counter() - t0
        outs[label] = "".join(lines)
        check(rc == 0, f"[cli {label}] exit {rc}: {outs[label][-3000:]}")
        return outs[label]

    spec = PipelineSpec(
        source=SourceSpec(num_slices=4, lines_per_slice=6, points_per_line=10, observations=80),
        method=MethodSpec(name="grouping"),
        compute=ComputeSpec(window_lines=3, num_bins=20),
        execution=ExecSpec(slices=(0, 1), retry_backoff_s=0.001))
    spec_file = tmp / "cli_spec.json"
    spec_file.write_text(spec.to_json())
    h = spec.content_hash()
    plan = tmp / "transient.json"
    plan.write_text(FaultPlan(rules=(FaultRule("read_error", times=1),)).to_json())
    want_dev = device or "cuda"

    def cache_and_faults():
        cold = run("run_pdf --cache-dir cold", "run_pdf", "--spec", spec_file, "--cache-dir",
                   tmp / "result_cache", "--out-dir", tmp / "clean")
        check(f"hash={h} " in cold and f"device={want_dev}" in cold
              and "[cache] hits=0 misses=2" in cold, f"[cli cache cold] {cold}")
        launches = worker_numbers(cold.splitlines())["launches"]
        if want_dev == "cuda":  # 2 slices of 2 windows; the CPU's plain versions count nothing
            check(launches["moments_edges_stats"] == 4 and launches["fit_error_counts"] == 4,
                  f"[cli cache cold] launches {launches}")
        warm = run("run_pdf --cache-dir warm", "run_pdf", "--spec", spec_file, "--cache-dir",
                   tmp / "result_cache")
        check("[cache] hits=2 misses=0" in warm and "served from result cache" in warm,
              f"[cli cache warm] {warm}")
        chaos = run("run_pdf --fault-plan", "run_pdf", "--spec", spec_file, "--out-dir",
                    tmp / "chaos", "--fault-plan", plan)
        check("[faults] retries=" in chaos and "[degraded]" not in chaos, f"[cli faults] {chaos}")
        want = sorted((tmp / "clean").glob("slice*_window_*.npz"))
        got = sorted((tmp / "chaos").glob("slice*_window_*.npz"))
        check(want and [f.name for f in want] == [f.name for f in got],
              f"[cli faults] windows {[f.name for f in got]}")
        for a, b in zip(want, got):
            za, zb = np.load(a), np.load(b)
            check(za.files == zb.files and all(np.array_equal(za[k], zb[k]) for k in za.files),
                  f"[cli faults] {a.name} is not bitwise the clean run's")
        return len(want)

    def serve():
        out = run("serve_pdf --clients 4", "serve_pdf", "--spec", spec_file, "--clients", 4)
        check(f"hash={h} " in out and f"device={want_dev}" in out and "[latency]" in out,
              f"[cli serve_pdf] {out}")

    def stream():
        sim = SourceSpec(num_slices=3, lines_per_slice=4, points_per_line=6, observations=48)
        sspec = PipelineSpec(
            source=export_cube(sim, tmp / "cube", lines_per_chunk=2),
            compute=ComputeSpec(window_lines=2, num_bins=16),
            execution=ExecSpec(cache_dir=str(tmp / "stream_cache"), out_dir=str(tmp / "stream_out")),
            stream=StreamSpec(persist_stats=True, poll_interval_s=0.2, max_updates=1))
        f = tmp / "stream_spec.json"
        f.write_text(sspec.to_json())
        cold = run("run_pdf stream cold", "run_pdf", "--spec", f)
        check("[cache] hits=0 misses=3" in cold
              and list((tmp / "stream_out").glob("slice1_stats_*.npz")), f"[cli stream cold] {cold}")
        _append_midpoints(np, tmp / "cube", 1)
        warm = run("run_pdf stream after append", "run_pdf", "--spec", f)
        check("[cache] hits=2 misses=1" in warm and "adopted=2 merged=1 mode=merge" in warm,
              f"[cli stream warm] {warm}")

        def on_line(line):
            if "polling every" in line:
                _append_midpoints(np, tmp / "cube", 2)

        out = run("run_pdf --watch", "run_pdf", "--spec", f, "--watch", on_line=on_line)
        update = out.partition("polling every")[2]
        check(re.search(r"manifest version .* updating", update) is not None
              and "adopted=2 merged=1 mode=merge" in update, f"[cli watch] {out}")

    results, errors = {}, []

    def chain(name, fn):
        try:
            results[name] = fn()
        except BaseException as e:  # noqa: BLE001 — raised on the main thread
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=chain, args=(name, fn))
               for name, fn in (("cache", cache_and_faults), ("serve", serve), ("stream", stream))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    walls["phase"] = time.perf_counter() - t0
    log(f"[cli] on {want_dev}, three chains side by side: run_pdf --cache-dir cold then warm "
        f"(hits=0 misses=2, then hits=2 misses=0 served from the cache), run_pdf --fault-plan "
        f"(transient read errors, {results['cache']} windows bitwise the clean run's), serve_pdf "
        f"--clients 4 (hash and [latency]), the stream's cold run with sidecars, an append to "
        f"slice 1 and the rerun (adopted=2 merged=1 mode=merge), run_pdf --watch applying an "
        f"append to slice 2 made once it polled; wall s {json.dumps(walls)}")
    return walls


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


def premove_bound_ms(bytes_moved: int, f32_ops: int = 0, f64_ops: int = 0, bf16_ops: int = 0) -> float:
    """A bound as this script computed it before the work models moved to
    ``launch/roofline.py``: bytes over the HBM rate, the operations of each
    type over their peak, whichever is largest (K5's bf16 operations alone,
    as its timing took them)."""
    pk = PREMOVE_PEAKS
    t_bytes = bytes_moved / pk["hbm"] * 1e3
    t_ops = bf16_ops / pk["bf16"] * 1e3 if bf16_ops else max(f32_ops / pk["f32"], f64_ops / pk["f64"]) * 1e3
    return t_bytes if t_bytes >= t_ops else t_ops


def roofline_line(label: str, bound: float, premove: float, ms: float) -> float:
    """[roofline kernels]: ``bound`` (``launch/roofline.py``) must be the
    pre-move formula's float, and ``ms`` at most MAX_SHARE of it. Returns
    the share bound / ms."""
    share = bound / ms
    log(f"[roofline kernels] {label}: bound {bound} ms (launch/roofline.py; the pre-move formula "
        f"{premove}), measured {ms} ms, share {share}")
    check(bound == premove, f"[roofline kernels] {label}: bound {bound} differs from the pre-move "
                            f"formula's {premove}")
    check(share <= MAX_SHARE, f"[roofline kernels] {label}: {ms} ms is {share} of its bound {bound} "
                              f"ms, above {MAX_SHARE}: the work count is wrong")
    return share


def time_kernels(np, torch, x, dev, launches, worst_k1, err_k2):
    """CUDA-event medians of K1 and K2 (and their plain versions) on one
    window; returns the kernel rows of the summary line."""
    from repro_torch.core import distributions as dists
    from repro_torch.core import pdf_error as pe
    from repro_torch.kernels.fitpdf import kernel
    from repro_torch.launch import roofline as rl

    p, n = x.shape
    flush = torch.empty(128 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    L = 64
    k1_call = time_cuda(torch, lambda: kernel.moments_edges_stats(x, L), 50, flush)
    k1 = time_kernel(lambda: kernel.moments_edges_stats(x, L), flush)
    k1_plain = time_cuda(torch, lambda: kernel.moments_edges_stats_plain(x, L), 10, flush)
    b1, by1 = rl.bound_ms(*rl.k1_work(p, n, L))
    share1 = roofline_line(f"K1 ({p}, {n}) L={L}", b1,
                           premove_bound_ms(4 * (p * n + 8 * p + p * (L + 1)), 10 * p * n), k1)
    err_stat = max(worst_k1, key=lambda s: worst_k1[s][0])
    log(f"[time] K1 moments_edges_stats ({p}, {n}) L={L}: call {k1_call} ms, kernel {k1} ms "
        f"({100 * b1 / k1} % of bound), plain {k1_plain} ms, bound {b1} ms by {by1}; no single "
        f"PyTorch call computes this function; its max abs difference from the plain version, "
        f"{worst_k1[err_stat][0]}, is in {err_stat}")
    rows = [dict(name="moments_edges_stats", route="cuda", source="src/repro_torch/csrc/fitpdf.cu",
                 replaces="src/repro/kernels/fitpdf/kernel.py:112",
                 launches=launches["moments_edges_stats"], max_abs_err=worst_k1[err_stat][0],
                 ms=k1_call, kernel_ms=k1, plain_ms=k1_plain, bound_ms=b1, bound_by=by1,
                 library_ms=None, bound_share=share1)]

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
        # Float64: the incomplete gamma and beta loops, counted on this
        # window's data.
        f64 = rl.special_function_ops(params.cpu().numpy(), edges.cpu().numpy(), types)
        b, by = rl.bound_ms(*rl.k2_work(p, n, t, L, f64_ops=f64))
        share = roofline_line(f"K2 ({p}, {n}) T={t} L={L}", b, premove_bound_ms(
            4 * (p * n + 2 * p + p * (L + 1) + 3 * t * p + t * p),
            4 * p * n + 30 * p * t * (L + 1) + 3 * p * t * L, f64), ms)
        k2[(t, L)] = dict(ms=call, kernel_ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                          bound_share=share)
        attrs = kernel.fit_error_attributes(types, L)
        log(f"[time] K2 fit_error_counts ({p}, {n}) T={t} L={L}: call {call} ms, kernel {ms} ms "
            f"({100 * b / ms} % of bound), plain {plain} ms, bound {b} ms by {by} (float64 "
            f"special-function operations {f64}, {f64 / rl.F64_FLOPS * 1e3} ms at the float64 "
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
    from repro_torch.launch import roofline as rl

    p, n = x.shape
    L = 64
    flush = torch.empty(128 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)
    rows = []

    k3_call = time_cuda(torch, lambda: mk.moments_stats(x), 50, flush)
    k3 = time_kernel(lambda: mk.moments_stats(x), flush)
    k3_plain = time_cuda(torch, lambda: mk.moments_stats_plain(x), 10, flush)
    b3, by3 = rl.bound_ms(*rl.k3_work(p, n))
    share3 = roofline_line(f"K3 ({p}, {n})", b3, premove_bound_ms(4 * (p * n + 8 * p), 10 * p * n), k3)
    err_stat = max(worst_k3, key=lambda s: worst_k3[s][0])
    log(f"[time] K3 moments_stats ({p}, {n}): call {k3_call} ms, kernel {k3} ms ({100 * b3 / k3} % "
        f"of bound), plain {k3_plain} ms, bound {b3} ms by {by3}; no single PyTorch call computes "
        f"this function")
    rows.append(dict(name="moments_stats", route="cuda", source="src/repro_torch/csrc/moments.cu",
                     replaces="src/repro/kernels/moments/kernel.py:77",
                     launches=launches_k["moments_stats"], max_abs_err=worst_k3[err_stat][0],
                     ms=k3_call, kernel_ms=k3, plain_ms=k3_plain, bound_ms=b3, bound_by=by3,
                     library_ms=None, bound_share=share3))

    stats = mk.moments_stats(x)
    vmin, vmax = stats[:, 4].contiguous(), stats[:, 5].contiguous()
    k4_call = time_cuda(torch, lambda: hk.hist_counts(x, vmin, vmax, L), 50, flush)
    k4 = time_kernel(lambda: hk.hist_counts(x, vmin, vmax, L), flush)
    k4_plain = time_cuda(torch, lambda: hk.hist_counts_plain(x, vmin, vmax, L), 10, flush)
    b4, by4 = rl.bound_ms(*rl.k4_work(p, n, L))
    share4 = roofline_line(f"K4 ({p}, {n}) L={L}", b4,
                           premove_bound_ms(4 * (p * n + 2 * p + p * L), 4 * p * n), k4)
    log(f"[time] K4 hist_counts ({p}, {n}) L={L}: call {k4_call} ms, kernel {k4} ms ({100 * b4 / k4} "
        f"% of bound), plain {k4_plain} ms, bound {b4} ms by {by4}; "
        f"{json.dumps(hk.hist_attributes(L))}; no single PyTorch call computes this function")
    rows.append(dict(name="hist_counts", route="cuda", source="src/repro_torch/csrc/hist.cu",
                     replaces="src/repro/kernels/hist/kernel.py:50",
                     launches=launches_k["hist_counts"], max_abs_err=0.0,
                     ms=k4_call, kernel_ms=k4, plain_ms=k4_plain, bound_ms=b4, bound_by=by4,
                     library_ms=None, bound_share=share4))

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
    f64 = rl.special_function_ops(params.cpu().numpy(), edges.cpu().numpy(), types)
    b2r, by2r = rl.bound_ms(*rl.k2_work(p, n, t, L, rows=g, f64_ops=f64))
    share2r = roofline_line(f"K2 row_indices {g} of ({p}, {n}) T={t} L={L}", b2r, premove_bound_ms(
        4 * (g * n + 2 * g + g * (L + 1) + 3 * t * g + t * g) + 8 * g,
        4 * g * n + 30 * g * t * (L + 1) + 3 * g * t * L, f64), k2r)
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
                     library_ms=None, bound_share=share2r))
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
    from repro_torch.launch import roofline as rl

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
        b2, by2 = rl.bound_ms(*rl.k2_work(p, n, t, L))
        share2 = roofline_line(f"K2 ({p}, {n}) T={t} L={L}", b2, premove_bound_ms(
            4 * (p * n + 2 * p + p * (L + 1) + 3 * t * p + t * p),
            4 * p * n + 30 * p * t * (L + 1) + 3 * p * t * L), k2)
        a2 = kernel.fit_error_attributes(types, L)
        k4 = time_kernel(lambda: hk.hist_counts(x, m.vmin, m.vmax, L), flush, reps=20)
        k4_plain = time_cuda(torch, lambda: hk.hist_counts_plain(x, m.vmin, m.vmax, L), 3, flush)
        b4, by4 = rl.bound_ms(*rl.k4_work(p, n, L))
        share4 = roofline_line(f"K4 ({p}, {n}) L={L}", b4,
                               premove_bound_ms(4 * (p * n + 2 * p + p * L), 4 * p * n), k4)
        a4 = hk.hist_attributes(L)
        row = dict(k2_kernel_ms=k2, k2_plain_ms=k2_plain, k2_bound_ms=b2, k2_bound_by=by2,
                   k2_bound_share=share2, k4_bound_share=share4,
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


def device_total_us(e) -> float:
    """A profile row's device time with its children's: the kernels an
    operator launched, those of the operators it called included."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def device_busy_ms(prof) -> float:
    """The union of the profile's device intervals (kernels, copies, sets)
    in ms, as ``portbench/trace.py`` takes it: where launches overlap their
    time counts once. A host range's annotation on the device's timeline
    (a ``record_function``) is not device work and is left out."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = {e.name for e in events if e.device_type != DeviceType.CUDA}
    busy, end = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and e.name not in ranges):
        if end is None or s > end:
            busy, end = busy + (e - s), e
        elif e > end:
            busy, end = busy + (e - end), e
    return busy / 1e3


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


def band_inputs(np, torch, dev, case):
    """bf16 q, k, v at ``case``'s shape, drawn with numpy from a seed as the
    reference's kernel test draws them (q, k ~ 0.5 N(0, 1), v ~ N(0, 1))."""
    b, s, h, kvh, hd, _ = case
    rng = np.random.default_rng(0)

    def draw(shape, std):
        x = rng.standard_normal(shape, dtype=np.float32)
        x *= std
        return torch.from_numpy(x).to(dev).to(torch.bfloat16)

    return draw((b, s, h, hd), 0.5), draw((b, s, kvh, hd), 0.5), draw((b, s, kvh, hd), 1.0)


def head_shape(case) -> tuple:
    """(B, H, KV, hd) of a K5 case."""
    return (case[0],) + tuple(case[2:5])


def compare_band_attn(np, torch, dev):
    """K5 against its plain version at K5_CASES (each a prefix of one seeded
    draw a head shape, made at that shape's longest S): its worst row within
    K5_TOL times that of the plain version with the oracle's rounding, a
    repeat bitwise equal, the launch count up by one a launch, and where
    S > W a window off by one (the plain version at W - 1) rejected by the
    same gate. Returns ({(B, H, KV, hd): that draw}, {(B, H, KV, hd): the max
    abs difference from the plain version over its cases})."""
    from repro_torch.kernels.band_attn import kernel as bk
    from repro_torch.kernels.band_attn.ref import banded_attention_ref, row_errors

    draws, worst = {}, {}
    for case in K5_CASES:
        b, s, h, kvh, hd, w = case
        key = head_shape(case)
        if key not in draws:
            longest = max((c for c in K5_CASES if head_shape(c) == key), key=lambda c: c[1])
            draws[key] = band_inputs(np, torch, dev, longest)
        q, k, v = (t[:, :s].contiguous() for t in draws[key])
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
        worst[key] = max(worst.get(key, 0.0), max_abs)
        log(f"[K5] (B, S, H, KV, hd, W) = {case} bf16: worst row |got - truth| / |truth| {e_got}, "
            f"limit {limit} ({K5_TOL} x the oracle rounding's {e_oracle}); max abs from the plain "
            f"version {max_abs} ({n_diff} of {got.numel()} outputs not bitwise equal); repeat bitwise, "
            f"launches counted; {planted}")
        del got, truth
        torch.cuda.empty_cache()
    return draws, worst


def lm_config():
    from repro_torch.configs import registry

    return registry.get(LM_ARCH).replace(num_layers=LM_LAYERS, block_local_attn=True)


def ssm_config():
    from repro_torch.configs import registry

    return registry.get(SSM_ARCH).replace(num_layers=SSM_LAYERS)


def hybrid_config():
    from repro_torch.configs import registry

    return registry.get(HYBRID_ARCH).replace(num_layers=HYBRID_LAYERS, block_local_attn=True)


def cache_bytes(caches) -> int:
    """Bytes of every tensor in a cache tree (lists and dicts of tensors)."""
    if isinstance(caches, dict):
        return sum(cache_bytes(c) for c in caches.values())
    if isinstance(caches, (list, tuple)):
        return sum(cache_bytes(c) for c in caches)
    return caches.numel() * caches.element_size()


def trim_extras(extras, s: int):
    """``extras`` for a prompt cut to ``s`` tokens: the enc-dec's frames
    cut with it, the VLM's memory as it is."""
    if not extras:
        return extras
    return {k: (v[:, :s] if k == "frames" else v) for k, v in extras.items()}


def ssd_layers(cfg) -> int:
    """Layers with an SSD (``ssm`` or ``hybrid`` mixers)."""
    if cfg.family == "encdec":
        return 0
    return sum(bd.mixer in ("ssm", "hybrid") for bd in cfg.layer_defs())


def ssd_intra_per_prefill(cfg) -> int:
    """The SSD kernel's launches a prefill on the card: one a layer with an
    SSD, where the SSD takes the kernel (``ssd_intra.ops.kernel_takes``)."""
    from repro_torch.kernels.ssd_intra.ops import kernel_takes

    return ssd_layers(cfg) if kernel_takes(cfg.compute_dtype, cfg.ssm_chunk) else 0


def lm_generate(np, torch, dev, smi, cfg, label, k5_per_prefill, shape_note, batch=LM_BATCH):
    """``cfg`` with random weights from a seeded generator on the card (seed
    0), ``batch`` prompts of LM_PROMPT random tokens and the stub frontend's
    input (``serve_decode.stub_extras``: the VLM's patches, the enc-dec's
    frames). Drives ``generate`` (prefill + LM_TOKENS greedy steps) once
    with the counts set to 0 (``k5_per_prefill`` K5 launches, one SSD
    kernel launch a layer with an SSD, nothing else); then a prefill alone
    twice (as many launches, bitwise equal logits) and the decode steps
    alone (no launch, generate's tokens again), each step timed. Returns
    the model, the prompt, the extras, the prefill's logits, generate's
    launches and the numbers."""
    from repro_torch.launch import serve_decode as sd

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = sd.init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (batch, LM_PROMPT), generator=gen, device=dev)
    extras = sd.stub_extras(cfg, batch, LM_PROMPT, gen, dev)
    sync(torch, dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"[{label}] {cfg.name} {shape_note}; params {n_params} in {cfg.param_dtype} ({n_bytes} B), "
        f"compute {cfg.compute_dtype}; init on the card in {time.perf_counter() - t0} s; batch "
        f"{batch} x prompt {LM_PROMPT} + {LM_TOKENS} tokens"
        + "".join(f"; {k} {tuple(v.shape)}" for k, v in (extras or {}).items()))
    max_len = LM_PROMPT + LM_TOKENS

    # warm-up: cuBLAS, allocator
    sd.prefill(cfg, model, prompt[:, :LM_PROMPT // 2], trim_extras(extras, LM_PROMPT // 2))
    sync(torch, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    tokens = sd.generate(cfg, model, prompt, LM_TOKENS, extras)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    ssd_per_prefill = ssd_intra_per_prefill(cfg)
    check_launches(launches, {"banded_attention_kernel": k5_per_prefill, "ssd_intra_kernel": ssd_per_prefill},
                   f"{label} generate")
    check(tokens.shape == (batch, LM_TOKENS) and tokens.dtype == torch.int32, f"[{label}] tokens shape")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab)).all()), f"[{label}] token out of range")

    zero_counts()
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, caches = sd.prefill(cfg, model, prompt, extras, max_len)
    sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    check(read_counts()["banded_attention_kernel"] == k5_per_prefill, f"[{label}] K5 launches per prefill")
    check(read_counts()["ssd_intra_kernel"] == ssd_per_prefill, f"[{label}] SSD kernel launches per prefill")
    again, _ = sd.prefill(cfg, model, prompt, extras, max_len)
    check(logits.shape == (batch, cfg.vocab) and bool(torch.isfinite(logits).all()),
          f"[{label}] prefill logits shape or finiteness")
    check(torch.equal(logits, again), f"[{label}] prefill logits do not repeat bitwise")
    del again

    zero_counts()
    tok = torch.argmax(logits, -1).to(torch.int32)
    decoded, steps_ms = [], []
    for i in range(LM_TOKENS):
        decoded.append(tok)
        sync(torch, dev)
        t0 = time.perf_counter()
        step_logits, caches = sd.decode_step(cfg, model, tok, caches, LM_PROMPT + i)
        tok = torch.argmax(step_logits, -1).to(torch.int32)
        sync(torch, dev)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(step_logits).all()), f"[{label}] decode step {i}: non-finite logits")
    check(read_counts()["banded_attention_kernel"] == 0 and read_counts()["ssd_intra_kernel"] == 0,
          f"[{label}] K5 or the SSD kernel launched by a decode step")
    check(torch.equal(torch.stack(decoded, 1), tokens), f"[{label}] decode steps differ from generate's "
                                                        f"tokens")
    n_cache = cache_bytes(caches)
    del caches, step_logits
    decode_ms = sorted(steps_ms)[len(steps_ms) // 2]
    nums = dict(batch=batch, param_bytes=n_bytes, generate_s=wall, prefill_s=prefill_s,
                decode_ms_per_token=decode_ms,
                tokens_per_s=batch * LM_TOKENS / wall, decode_tokens_per_s=batch / decode_ms * 1e3,
                prefill_tokens_per_s=batch * LM_PROMPT / prefill_s, max_memory_allocated_bytes=peak,
                cache_bytes=n_cache)
    log(f"[{label}] {smi}: generate {wall} s for {batch} x {LM_TOKENS} tokens ({nums['tokens_per_s']} "
        f"tokens/s with the prefill); prefill {prefill_s} s ({nums['prefill_tokens_per_s']} prompt "
        f"tokens/s); decode {decode_ms} ms a step, median of {LM_TOKENS} ({nums['decode_tokens_per_s']} "
        f"tokens/s); max_memory_allocated {peak} B; decode cache {n_cache} B; launches "
        f"{json.dumps(launches)}; sample {tokens[0, :8].tolist()}")
    return model, prompt, extras, logits, launches, nums


def plain_path_gate(torch, model, prompt, cfg, logits, label) -> dict:
    """The same prefill on the plain masked path (bf16) and in float32
    compute, neither launching K5. Tolerance: the banded path (K5: bf16
    weights, float32 softmax and sum) may move the logits at most twice as
    far from the plain bf16 path as bf16 compute itself moves them from
    float32 compute; the first greedy token must equal the plain path's
    wherever its top-2 margin exceeds that."""
    from repro_torch.models import transformer as T

    max_len = LM_PROMPT + LM_TOKENS
    zero_counts()
    plain, _ = T.prefill(model, prompt, cfg.replace(block_local_attn=False), max_len=max_len)
    f32, _ = T.prefill(model, prompt, cfg.replace(block_local_attn=False, compute_dtype=torch.float32),
                       max_len=max_len)
    check(read_counts()["banded_attention_kernel"] == 0, f"[{label}] K5 launched on the plain path")
    d_band = float((logits - plain).abs().max())
    d_bf16 = float((plain - f32).abs().max())
    tol = 2.0 * d_bf16
    check(d_band <= tol, f"[{label}] banded vs plain prefill logits differ by {d_band}, more than {tol}")
    top2 = torch.topk(plain, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > tol
    same = torch.argmax(logits, -1) == torch.argmax(plain, -1)
    check(bool(same[sure].all()), f"[{label}] first greedy token differs from the plain path where its "
                                  f"top-2 margin exceeds {tol}")
    log(f"[{label}] prefill logits: banded (K5) vs plain masked path max abs {d_band}; plain bf16 vs "
        f"float32 compute {d_bf16}; tolerance {tol}; max |logit| {float(plain.abs().max())}; first "
        f"token equal in {int(same.sum())}/{LM_BATCH} rows ({int(sure.sum())} with a top-2 margin "
        f"above the tolerance); vs float32 equal in "
        f"{int((torch.argmax(f32, -1) == torch.argmax(plain, -1)).sum())}/{LM_BATCH}")
    del plain, f32
    torch.cuda.empty_cache()
    return dict(logits_band_vs_plain=d_band, logits_bf16_vs_f32=d_bf16)


def serve_phase(np, torch, dev, smi):
    """[lm]: gemma3-12b at full width, 12 layers (10 K5 launches a
    prefill), through ``lm_generate`` and ``plain_path_gate``. Returns the
    model, config, prompt, generate's launches and the numbers."""
    cfg = lm_config()
    check(sum(1 for bd in cfg.layer_defs() if bd.window) == LM_LOCAL_LAYERS, "[lm] local layer count")
    note = (f"d_model={cfg.d_model} heads={cfg.q_heads}/{cfg.kv_heads} head_dim={cfg.head_dim} "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab}, {cfg.num_layers} of 48 layers ({LM_LOCAL_LAYERS} local "
            f"with window {cfg.pattern[0].window}, {cfg.num_layers - LM_LOCAL_LAYERS} global), "
            f"block_local_attn")
    model, prompt, _, logits, launches, nums = lm_generate(np, torch, dev, smi, cfg, "lm",
                                                           LM_LOCAL_LAYERS, note)
    nums.update(plain_path_gate(torch, model, prompt, cfg, logits, "lm"))
    return model, cfg, prompt, None, launches, nums


def ssm_phase(np, torch, dev, smi):
    """[lm ssm]: mamba2-780m at full width, SSM_LAYERS SSD layers (no
    attention: no kernel launches), through ``lm_generate``; then its bf16
    prefill logits against float32 compute (the spread logged, the first
    token equal wherever the float32 top-2 margin exceeds it), the decode
    oracle in float32 compute (after each of ORACLE_STEPS greedy steps the
    decode logits against ``forward`` over the extended sequence, within
    LM_DECODE_TOL) and the decode cache's bytes after prompts of 1,024 and
    LM_PROMPT tokens (equal: the SSD's state does not grow)."""
    from repro_torch.models import ssm as S
    from repro_torch.models import transformer as T

    cfg = ssm_config()
    d_inner, heads = S.ssm_dims(cfg)
    note = (f"d_model={cfg.d_model} d_inner={d_inner} ssm heads={heads} x {cfg.ssm_head_dim} "
            f"state={cfg.ssm_state} chunk={cfg.ssm_chunk} conv={cfg.ssm_conv} vocab={cfg.vocab}, "
            f"{cfg.num_layers} of 48 layers (SSD, no FFN)")
    model, prompt, _, logits, launches, nums = lm_generate(np, torch, dev, smi, cfg, "lm ssm", 0, note)

    zero_counts()
    cfg32 = cfg.replace(compute_dtype=torch.float32)
    f32, caches = T.prefill(model, prompt, cfg32, max_len=LM_PROMPT + ORACLE_STEPS)
    spread = float((logits - f32).abs().max())
    top2 = torch.topk(f32, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > spread
    same = torch.argmax(logits, -1) == torch.argmax(f32, -1)
    check(bool(same[sure].all()), f"[lm ssm] first greedy token differs from float32 compute where its "
                                  f"top-2 margin exceeds the bf16 spread {spread}")
    log(f"[lm ssm] prefill logits: bf16 vs float32 compute max abs {spread}; max |logit| "
        f"{float(f32.abs().max())}; first token equal in {int(same.sum())}/{LM_BATCH} rows "
        f"({int(sure.sum())} with a float32 top-2 margin above the spread)")
    del logits

    seq, errs = prompt, []
    for i in range(ORACLE_STEPS):
        nxt = torch.argmax(f32, -1).to(torch.int32)
        f32, caches = T.decode_step(model, nxt, caches, LM_PROMPT + i, cfg32)
        seq = torch.cat([seq, nxt[:, None].to(seq.dtype)], 1)
        want = T.forward(model, seq, cfg32)[:, -1]
        errs.append(close_report(torch, f32, want, what=f"[lm ssm] float32 decode step {i} vs forward",
                                 **LM_DECODE_TOL))
        del want
    del caches, f32
    log(f"[lm ssm] decode oracle, float32 compute, TF32 off: {ORACLE_STEPS} greedy steps, decode logits "
        f"vs forward over the extended sequence within rtol = atol = {LM_DECODE_TOL['rtol']}; max abs "
        f"{errs}")

    sizes = {}
    for s in (1024, LM_PROMPT):
        _, c = T.prefill(model, prompt[:, :s], cfg, max_len=s + LM_TOKENS)
        sizes[s] = cache_bytes(c)
        del c
    check(read_counts()["banded_attention_kernel"] == 0, "[lm ssm] K5 launched")
    check(len(set(sizes.values())) == 1 and sizes[LM_PROMPT] == nums["cache_bytes"],
          f"[lm ssm] decode cache bytes depend on the prompt: {sizes}")
    log(f"[lm ssm] decode cache bytes after prompts of {list(sizes)} tokens: {list(sizes.values())}")
    torch.cuda.empty_cache()
    nums.update(logits_bf16_vs_f32=spread, decode_oracle_max_abs=max(errs),
                cache_bytes_by_prompt=sizes)
    return model, cfg, prompt, None, launches, nums


def hybrid_phase(np, torch, dev, smi):
    """[lm hybrid]: hymba-1.5b at full width, HYBRID_LAYERS layers (one
    global hybrid layer, the rest with a 1,024 window) with
    ``block_local_attn``: a K5 launch a windowed layer a prefill at (4,
    4096, 25, 5, 64, 1024), none a decode step (the decode runs past the
    window's ring), through ``lm_generate`` and ``plain_path_gate``."""
    from repro_torch.models import ssm as S

    cfg = hybrid_config()
    windows = [bd.window for bd in cfg.layer_defs() if bd.window]
    check(len(windows) == HYBRID_LOCAL_LAYERS and LM_PROMPT > windows[0], "[lm hybrid] local layers")
    d_inner, heads = S.ssm_dims(cfg)
    note = (f"d_model={cfg.d_model} heads={cfg.q_heads}/{cfg.kv_heads} head_dim={cfg.head_dim} "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab}, ssm heads={heads} x {cfg.ssm_head_dim} "
            f"state={cfg.ssm_state}, {cfg.num_layers} of 32 layers (hybrid: 1 global, "
            f"{HYBRID_LOCAL_LAYERS} with window {windows[0]}), block_local_attn")
    model, prompt, _, logits, launches, nums = lm_generate(np, torch, dev, smi, cfg, "lm hybrid",
                                                           HYBRID_LOCAL_LAYERS, note)
    nums.update(plain_path_gate(torch, model, prompt, cfg, logits, "lm hybrid"))
    return model, cfg, prompt, None, launches, nums


def xmodel_config(torch, arch, layers, bf16_params):
    """An XMODEL_PHASES config: the registry's at full width, ``layers``
    kept (the enc-dec: all), bf16 parameters where asked."""
    from repro_torch.configs import registry

    cfg = registry.get(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    return cfg.replace(param_dtype=torch.bfloat16) if bf16_params else cfg


def xmodel_note(cfg, arch) -> str:
    from repro_torch.configs import registry

    full = registry.get(arch)
    note = (f"d_model={cfg.d_model} heads={cfg.q_heads}/{cfg.kv_heads} head_dim={cfg.head_dim} "
            f"d_ff={cfg.d_ff} vocab={cfg.vocab}")
    if cfg.family == "encdec":
        return note + f", all {cfg.enc_layers} encoder + {cfg.dec_layers} decoder layers"
    defs = cfg.layer_defs()
    note += (f", {cfg.num_layers} of {full.num_layers} layers "
             f"({', '.join(f'{bd.mixer}/{bd.ffn}' for bd in defs)})")
    if cfg.family == "vlm":
        note += f", {cfg.num_patches} image patches"
    if cfg.num_experts:
        note += (f", {cfg.num_experts} experts top-{cfg.moe_top_k}"
                 + (f", shared expert {cfg.moe_shared_ff}" if cfg.moe_shared_ff else ""))
    return note


def decode_oracle(torch, model, cfg, prompt, extras, label) -> dict:
    """The reference's decode oracle in float32 compute, TF32 off, on the
    full-width model: ORACLE_BATCH x ORACLE_PROMPT tokens of the phase's
    prompt (and extras), prefill's last logits against ``forward`` within
    LM_PREFILL_TOL, then each of ORACLE_DECODE greedy steps against
    ``forward`` over the extended sequence within LM_DECODE_TOL. At T <=
    256 the MoE keeps every choice, so the two paths compute the same
    function."""
    from repro_torch.launch import serve_decode as sd
    from repro_torch.models import encdec as ED
    from repro_torch.models import transformer as T

    cfg32 = cfg.replace(compute_dtype=torch.float32)
    seq = prompt[:ORACLE_BATCH, :ORACLE_PROMPT]
    ext = trim_extras({k: v[:ORACLE_BATCH] for k, v in extras.items()} if extras else None,
                      ORACLE_PROMPT)

    def forward(tokens):
        if cfg.family == "encdec":
            return ED.forward(model, ext["frames"], tokens, cfg32)[:, -1]
        return T.forward(model, tokens, cfg32, ext)[:, -1]

    logits, caches = sd.prefill(cfg32, model, seq, ext, ORACLE_PROMPT + ORACLE_DECODE)
    errs = [close_report(torch, logits, forward(seq), what=f"[{label}] float32 prefill vs forward",
                         **LM_PREFILL_TOL)]
    for i in range(ORACLE_DECODE):
        nxt = torch.argmax(logits, -1).to(torch.int32)
        logits, caches = sd.decode_step(cfg32, model, nxt, caches, ORACLE_PROMPT + i)
        seq = torch.cat([seq, nxt[:, None].to(seq.dtype)], 1)
        errs.append(close_report(torch, logits, forward(seq),
                                 what=f"[{label}] float32 decode step {i} vs forward", **LM_DECODE_TOL))
    del caches, logits
    torch.cuda.empty_cache()
    log(f"[{label}] decode oracle, float32 compute, TF32 off, full width: {ORACLE_BATCH} x "
        f"{ORACLE_PROMPT} tokens, prefill vs forward within rtol = atol = {LM_PREFILL_TOL['rtol']}, "
        f"{ORACLE_DECODE} greedy steps within {LM_DECODE_TOL['rtol']}; max abs {errs}")
    return dict(oracle_prefill_max_abs=errs[0], decode_oracle_max_abs=max(errs[1:]))


@contextlib.contextmanager
def recording_moe(torch, calls: list, keep_masks: list | None = None):
    """``layers.moe`` wrapped while the block runs: each call appends its
    token count, capacity and dropped (token, choice) pairs to ``calls``,
    from its own ``moe_route`` (on DTensors, the whole batch's positions),
    and its kept mask on the host to ``keep_masks`` when given."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    saved = L.moe

    def counted(p, x, cfg_, capacity_factor=None):
        t = x.shape[0] * x.shape[1]
        cap = L.moe_capacity(t, cfg_.num_experts, cfg_.moe_top_k, capacity_factor)
        pos = L.moe_route(p, x.reshape(t, -1).to(cfg_.compute_dtype), cfg_)[2]
        keep = (pos < cap).full_tensor() if sh.is_dtensor(pos) else pos < cap
        calls.append(dict(tokens=t, capacity=cap, dropped=int((~keep).sum())))
        if keep_masks is not None:
            keep_masks.append(keep.cpu())
        return saved(p, x, cfg_, capacity_factor)

    L.moe = counted
    try:
        yield
    finally:
        L.moe = saved


def moe_drops(torch, model, cfg, prompt, label) -> dict:
    """Each MoE layer's capacity and dropped (token, choice) pairs in one
    prefill of the phase's prompt and in one decode step after it (none
    may drop there: T = batch <= 256), by ``recording_moe``."""
    from repro_torch.launch import serve_decode as sd

    calls = []
    with recording_moe(torch, calls):
        logits, caches = sd.prefill(cfg, model, prompt, None, LM_PROMPT + 1)
        n_prefill = len(calls)
        sd.decode_step(cfg, model, torch.argmax(logits, -1).to(torch.int32), caches, LM_PROMPT)
    del caches, logits
    prefill, decode = calls[:n_prefill], calls[n_prefill:]
    n_moe = sum(bd.ffn in ("moe", "moe_dense") for bd in cfg.layer_defs())
    check(len(prefill) == len(decode) == n_moe, f"[{label}] MoE calls {len(prefill)}/{len(decode)}, "
                                                f"expected {n_moe} each")
    check(all(c["dropped"] == 0 for c in decode), f"[{label}] a decode step dropped choices: {decode}")
    log(f"[{label}] MoE dispatch, each MoE layer: prefill {json.dumps(prefill)} ({cfg.moe_top_k} choices "
        f"a token); decode step {json.dumps(decode)}")
    return dict(moe_prefill=prefill, moe_decode=decode)


def xmodel_phase(np, torch, dev, smi, label, arch, layers, bf16_params, batch):
    """One XMODEL_PHASES entry: ``lm_generate`` (no K5 launch: none of these
    configs has a windowed layer), the float32 decode oracle and, for the
    MoE, each layer's capacity and drops."""
    cfg = xmodel_config(torch, arch, layers, bf16_params)
    model, prompt, extras, _, launches, nums = lm_generate(
        np, torch, dev, smi, cfg, label, 0, xmodel_note(cfg, arch), batch)
    nums.update(decode_oracle(torch, model, cfg, prompt, extras, label))
    if cfg.num_experts:
        nums.update(moe_drops(torch, model, cfg, prompt, label))
    return model, cfg, prompt, extras, launches, nums


def ssd_event_times(torch, model, cfg, prompt, dev) -> dict:
    """The SSD's device time in one prefill, by the program's own spans
    (``runtime.trace``, on for this prefill only): ``ssd`` around each
    call and ``ssd.scan`` around its inter-chunk scan, each a pair of CUDA
    events. The host runs ahead of the card in a prefill (the profile's
    idle share ~0), so each pair brackets that call's kernels."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime import trace

    sync(torch, dev)
    trace.enable(dev)
    try:
        t0 = time.perf_counter()
        T.prefill(model, prompt, cfg, max_len=LM_PROMPT + LM_TOKENS)
        sync(torch, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        trace.disable()
        spans = trace.drain()
    ms = {k: sum(s.ms for s in spans if s.name == k) for k in ("ssd", "ssd.scan")}
    return dict(prefill_ms=wall_ms, ssd_calls=sum(s.name == "ssd" for s in spans), ssd_ms=ms["ssd"],
                scan_ms=ms["ssd.scan"], ssd_share=ms["ssd"] / wall_ms)


def profile_lm(torch, model, cfg, prompt, dev, prefill_s, decode_ms, label="lm", extras=None):
    """One prefill, then one decode step, each under torch.profiler: device
    time by kernel and by operator (inclusive: an operator's row counts
    the kernels of the operators it calls too), K5's share and the device's
    idle share of the unprofiled prefill wall and decode step; for a model
    with SSD layers, their device time in a prefill (``ssd_event_times``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve_decode as sd

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        logits, caches = sd.prefill(cfg, model, prompt, extras, LM_PROMPT + LM_TOKENS)
        sync(torch, dev)
    tok = torch.argmax(logits, -1).to(torch.int32)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_d:
        sd.decode_step(cfg, model, tok, caches, LM_PROMPT)
        sync(torch, dev)
    del caches, logits
    out = {}
    for what, p, wall_ms in (("prefill", prof, prefill_s * 1e3), ("decode step", prof_d, decode_ms)):
        tag = f"[profile {label} {what}]"
        kern = device_events(p)
        busy_ms = device_busy_ms(p)
        if not kern or busy_ms == 0:
            log(f"{tag} the profiler saw no device time: device busy share not measured")
            continue
        k5_ms = sum(device_us(e) for e in kern if "band_attn" in e.key) / 1e3
        out[what] = dict(busy_ms=busy_ms, k5_ms=k5_ms, idle_share=1 - busy_ms / wall_ms)
        log(f"{tag} device busy {busy_ms} ms over {len(kern)} kernel/copy names "
            f"({sum(e.count for e in kern)} launches); unprofiled wall {wall_ms} ms; device idle share "
            f"{1 - busy_ms / wall_ms}; K5 {k5_ms} ms, {k5_ms / busy_ms} of the device time")
        for e in kern[:15]:
            log(f"{tag}   {device_us(e) / 1e3:10.3f} ms  x{e.count:<5d} "
                f"{device_us(e) / 1e3 / max(e.count, 1):.4f} ms a launch  {e.key[:90]}")
        ops = sorted((e for e in p.key_averages() if e.device_type == DeviceType.CPU
                      and e.key.startswith("aten::") and device_total_us(e) > 0),
                     key=device_total_us, reverse=True)
        for e in ops[:12]:
            log(f"{tag} op  {device_total_us(e) / 1e3:10.3f} ms inclusive  x{e.count:<5d} {e.key[:60]}")
    if cfg.family != "encdec" and any(bd.mixer in ("ssm", "hybrid") for bd in cfg.layer_defs()):
        out["ssd"] = ssd_event_times(torch, model, cfg, prompt, dev)
        log(f"[profile {label} prefill] the SSD by CUDA events around its {out['ssd']['ssd_calls']} "
            f"calls: {out['ssd']['ssd_ms']} ms of a {out['ssd']['prefill_ms']} ms prefill (share "
            f"{out['ssd']['ssd_share']}), its inter-chunk scan {out['ssd']['scan_ms']} ms")
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
    from repro_torch.launch import roofline as rl

    q, k, v = qkv
    b, s, h, hd = q.shape
    kvh, w = k.shape[2], K5_CASES[0][-1]  # every case's window
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
    work = rl.k5_work(b, s, h, kvh, hd, w, q.dtype)
    flops, nbytes = work.bf16_ops, work.bytes
    t_ops, t_bytes = flops / rl.PEAK_FLOPS * 1e3, nbytes / rl.HBM_BW * 1e3
    bound, by = rl.bound_ms(*work)
    roofline_line(f"K5 {(b, s, h, kvh, hd, w)} bf16", bound, premove_bound_ms(
        q.element_size() * (2 * b * s * h * hd + 2 * b * s * kvh * hd),
        bf16_ops=4 * hd * rl.band_pairs(s, w) * b * h), ms)
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


def ssd_intra_inputs(torch, dev, shape, seed=0):
    """K6's operands at ``shape`` (B, Nc, Q, H, P, N, G), drawn on the card
    from ``seed``: cb from C and B as ``ssd.intra`` makes it (a bf16
    einsum), ca the cumulative sums of log-decays -0.05 dt with dt in
    [0.01, 1), xdt = dt x."""
    b, nc, q, h, p, n, g = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    cm = (torch.randn(b, nc, q, g, n, generator=gen, device=dev) * n ** -0.5).bfloat16()
    bm = torch.randn(b, nc, q, g, n, generator=gen, device=dev).bfloat16()
    cb = torch.einsum("bcqgn,bckgn->bcgqk", cm, bm).contiguous()
    dt = torch.rand(b, nc, q, h, generator=gen, device=dev) * 0.99 + 0.01
    ca = torch.cumsum(-0.05 * dt, 2)
    xdt = (torch.randn(b, nc, q, h, p, generator=gen, device=dev) * dt[..., None]).bfloat16()
    return cb, ca, xdt


def time_ssd_intra(torch, dev, arch) -> dict:
    """K6 at ``arch``'s prefill shape (SSD_INTRA_SHAPES): two launches
    counted and bitwise equal, the gate against the plain version on float32
    operands, then kernel ms (``_timing.kernel_times``), call ms and the
    plain version's ms beside the bound of ``roofline.ssd_intra_work``
    ([time], [roofline kernels]) and the instantiation's registers."""
    from repro_torch.kernels.ssd_intra import kernel as sk
    from repro_torch.kernels.ssd_intra.ref import ssd_intra_ref
    from repro_torch.launch import roofline as rl

    shape = SSD_INTRA_SHAPES[arch]
    b, nc, q, h, p, n, g = shape
    cb, ca, xdt = ssd_intra_inputs(torch, dev, shape)
    before = sk.ssd_intra_kernel.launches
    got = sk.ssd_intra_kernel(cb, ca, xdt)
    again = sk.ssd_intra_kernel(cb, ca, xdt)
    sync(torch, dev)
    check(sk.ssd_intra_kernel.launches == before + 2, f"[K6] {arch}: launches not counted")
    check(torch.equal(got, again), f"[K6] {arch}: a repeat differs")
    truth = ssd_intra_ref(cb.float(), ca, xdt.float())
    plain = ssd_intra_ref(cb, ca, xdt)
    err, err_plain = (float((t.float() - truth).norm() / truth.norm()) for t in (got, plain))
    limit = SSD_INTRA_TOL * err_plain
    check(err <= limit, f"[K6] {arch}: relative error {err} above {SSD_INTRA_TOL} x the plain bf16 path's "
                        f"{err_plain}")
    max_abs = float((got.float() - plain.float()).abs().max())
    del truth, plain, again, got
    flush = torch.empty(128 * 1024 * 1024 // 4, dtype=torch.float32, device=dev)

    def kernel():
        return sk.ssd_intra_kernel(cb, ca, xdt)

    ms = time_kernel(kernel, flush)
    call = time_cuda(torch, kernel, 20, flush)
    plain_ms = time_cuda(torch, lambda: ssd_intra_ref(cb, ca, xdt), 5, flush)
    work = rl.ssd_intra_work(b, nc, q, h, p, g)
    bound, by = rl.bound_ms(*work)
    share = roofline_line(f"K6 {arch} (B, Nc, Q, H, P, G) = {(b, nc, q, h, p, g)} bf16", bound,
                          premove_bound_ms(work.bytes, bf16_ops=work.bf16_ops), ms)
    attrs = sk.attributes(p, q)
    log(f"[time] K6 ssd_intra_kernel {arch} (B, Nc, Q, H, P, G) = {(b, nc, q, h, p, g)} bf16: kernel {ms} ms, "
        f"call {call} ms, plain {plain_ms} ms; bound {bound} ms by {by} ({work.bytes} B, {work.bf16_ops} "
        f"FLOPs); {100 * share} % of bound; relative error against float32 operands {err} (plain bf16 "
        f"{err_plain}, limit {limit}); max abs from the plain bf16 path {max_abs}; instantiation "
        f"{json.dumps(attrs)} (registers a thread, local memory bytes a thread: 0 means no spills, "
        f"dynamic shared memory bytes a block)")
    return dict(ms=call, kernel_ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, bound_share=share,
                rel_err=err, rel_err_plain=err_plain, max_abs_vs_plain=max_abs, **attrs)


def ssd_intra_phase(np, torch, dev, smi, launches_lm, launches_train) -> dict:
    """[ssd intra]: K6 at both prefill cells' shapes (``time_ssd_intra``);
    then mamba2-780m and hymba-1.5b at full depth and width, as the
    benchmark's prefill cells run them: one prefill of LM_BATCH x LM_PROMPT
    each, after a warm-up, launching K6 once a layer with an SSD (48 and 32)
    and timed; then a training step of mamba2-780m cut to
    SSD_INTRA_TRAIN_LAYERS layers, which launches none. Returns the kernels
    line's row."""
    import math

    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import serve_decode as sd
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig

    row = dict(name="ssd_intra_kernel", route="cuda", source="src/repro_torch/csrc/ssd_intra.cu",
               replaces="none (the einsums of src/repro/models/ssm.py)")
    row.update(time_ssd_intra(torch, dev, SSM_ARCH))
    row["at_hymba_shape"] = time_ssd_intra(torch, dev, HYBRID_ARCH)
    torch.cuda.empty_cache()

    full = {}
    for arch, cfg in ((SSM_ARCH, registry.get(SSM_ARCH)),
                      (HYBRID_ARCH, registry.get(HYBRID_ARCH).replace(block_local_attn=True))):
        gen = torch.Generator(device=dev).manual_seed(0)
        model = sd.init_params(cfg, gen, dev)
        prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
        sd.prefill(cfg, model, prompt[:, :LM_PROMPT // 2], None)
        sync(torch, dev)
        zero_counts()
        t0 = time.perf_counter()
        logits, _ = sd.prefill(cfg, model, prompt, None, LM_PROMPT + LM_TOKENS)
        sync(torch, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        want = ssd_layers(cfg)
        check(want == cfg.num_layers and bool(torch.isfinite(logits).all()), f"[ssd intra] {arch} prefill")
        check_launches(launches, {"ssd_intra_kernel": want,
                                  "banded_attention_kernel": sum(bool(bd.window) for bd in cfg.layer_defs())},
                       f"ssd intra {arch} full depth")
        full[arch] = dict(layers=cfg.num_layers, prefill_ms=wall_ms, launches=launches["ssd_intra_kernel"])
        log(f"[ssd intra] {arch} at full depth ({cfg.num_layers} layers), one prefill of {LM_BATCH} x "
            f"{LM_PROMPT} tokens: {wall_ms} ms, {launches['ssd_intra_kernel']} SSD kernel launches; {smi}")
        del model, prompt, logits
        torch.cuda.empty_cache()

    cfg = registry.get(SSM_ARCH).replace(num_layers=SSD_INTRA_TRAIN_LAYERS)
    model = train.init_model(cfg, dev)
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
    step_fn = train.build_step(cfg, opt_cfg, 1)
    tokens, targets = TokenPipeline(cfg.vocab, LM_PROMPT, 2, seed=0).next_batch()
    batch = train.make_batch(cfg, tokens, targets, 0, dev)
    zero_counts()
    model, opt, loss, _ = step_fn(model, opt, batch)
    sync(torch, dev)
    check(math.isfinite(float(loss)), f"[ssd intra] training step loss {float(loss)}")
    check_launches(read_counts(), {}, "ssd intra training step")
    log(f"[ssd intra] {SSM_ARCH} at {SSD_INTRA_TRAIN_LAYERS} layers, a training step of 2 x {LM_PROMPT} "
        f"tokens (grad on): loss {float(loss)}, no SSD kernel launch")
    del model, opt, batch
    torch.cuda.empty_cache()
    row["launches"] = launches_lm["lm ssm"]["ssd_intra_kernel"]
    row["launches_lm_paths"] = {label: n["ssd_intra_kernel"] for label, n in launches_lm.items()}
    row["launches_train"] = {label: n["ssd_intra_kernel"] for label, n in launches_train.items()}
    row["full_depth"] = full
    return row


def hymba_train_config():
    """hymba-1.5b as [lm hybrid] has it (HYBRID_LAYERS layers, the
    registry's remat "full", the banded path on)."""
    return hybrid_config()


def state_bytes(model, opt) -> int:
    """Bytes of the parameters and the optimizer's moments."""
    tensors = list(model.parameters()) + list(opt.mu.values()) + list(opt.nu.values())
    return sum(t.numel() * t.element_size() for t in tensors)


def host_state(model, opt) -> dict:
    """A host copy of every parameter, both moments and the step."""
    out = {f"p.{n}": p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    out.update({f"m.{n}": t.to("cpu", copy=True) for n, t in opt.mu.items()})
    out.update({f"v.{n}": t.to("cpu", copy=True) for n, t in opt.nu.items()})
    out["step"] = opt.step.to("cpu", copy=True)
    return out


def live_state(model, opt) -> dict:
    out = {f"p.{n}": p for n, p in model.named_parameters()}
    out.update({f"m.{n}": t for n, t in opt.mu.items()})
    out.update({f"v.{n}": t for n, t in opt.nu.items()})
    out["step"] = opt.step
    return out


def banded_backward_times(torch, fn):
    """Run ``fn()`` with the program's spans on (``runtime.trace``) and
    read its ``band_bwd`` spans, CUDA events around each call of K5's
    backward (``band_attn.ops.BandedAttention.backward``); returns (fn's
    result, the backward's calls, its device ms)."""
    from repro_torch.runtime import trace

    trace.enable()
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        trace.disable()
        spans = [s for s in trace.drain() if s.name == "band_bwd"]
    return out, len(spans), sum(s.ms for s in spans)


def profile_train_step(torch, fn, step_ms, label):
    """One training step under torch.profiler: device busy and idle share
    of the unprofiled step, K5's device time, the longest kernels and
    operators. Returns (fn's result, the numbers)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    tag = f"[profile {label} step]"
    kern = device_events(prof)
    busy_ms = device_busy_ms(prof)
    if not kern or busy_ms == 0:
        log(f"{tag} the profiler saw no device time: device busy share not measured")
        return result, {}
    k5_ms = sum(device_us(e) for e in kern if "band_attn" in e.key) / 1e3
    # The backward's scatters (the embedding gather's index_put_ with
    # accumulate, a sort-based kernel on CUDA, and the loss's gather).
    scatter = [e for e in kern if any(w in e.key.lower() for w in ("index", "sort", "scatter"))]
    out = dict(busy_ms=busy_ms, k5_ms=k5_ms, idle_share=1 - busy_ms / step_ms,
               launches=sum(e.count for e in kern),
               scatter_ms=sum(device_us(e) for e in scatter) / 1e3)
    log(f"{tag} device busy {busy_ms} ms over {len(kern)} kernel/copy names ({out['launches']} "
        f"launches); unprofiled step {step_ms} ms; device idle share {out['idle_share']}; K5 {k5_ms} ms, "
        f"{k5_ms / busy_ms} of the device time; index/sort/scatter kernels {out['scatter_ms']} ms "
        f"({[e.key[:60] for e in scatter[:6]]})")
    for e in kern[:15]:
        log(f"{tag}   {device_us(e) / 1e3:10.3f} ms  x{e.count:<5d} "
            f"{device_us(e) / 1e3 / max(e.count, 1):.4f} ms a launch  {e.key[:90]}")
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::") and device_total_us(e) > 0),
                 key=device_total_us, reverse=True)
    for e in ops[:15]:
        log(f"{tag} op  {device_total_us(e) / 1e3:10.3f} ms inclusive  x{e.count:<5d} {e.key[:60]}")
    return result, out


def _train_hymba(np, torch, dev, smi, cfg, batch_size):
    import math

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels._timing import median
    from repro_torch.launch import dryrun, train
    from repro_torch.launch import roofline as rl
    from repro_torch.optim import AdamWConfig

    t0 = time.perf_counter()
    model = train.init_model(cfg, dev)
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
    step_fn = train.build_step(cfg, opt_cfg, TRAIN_STEPS)
    pipe = TokenPipeline(cfg.vocab, LM_PROMPT, batch_size, seed=0)
    sync(torch, dev)
    n_params = sum(p.numel() for p in model.parameters())
    n_state = state_bytes(model, opt)
    log(f"[train hymba] {cfg.name}: {cfg.num_layers} of 32 layers at full width (1 global, "
        f"{HYBRID_LOCAL_LAYERS} with window {cfg.pattern[0].window}), block_local_attn, remat "
        f"{cfg.remat}; params {n_params} in {cfg.param_dtype}, compute {cfg.compute_dtype}; parameters "
        f"and moments {n_state} B (+ {n_state // 3} B of gradients); AdamW lr {TRAIN_LR}, cosine over "
        f"{TRAIN_STEPS} steps; batch {batch_size} x {LM_PROMPT} tokens; init {time.perf_counter() - t0} s")

    def batch_at(i):
        tokens, targets = pipe.next_batch()
        return train.make_batch(cfg, tokens, targets, i, dev)

    torch.cuda.reset_peak_memory_stats(dev)
    records, launches = [], None
    for i in range(TRAIN_STEPS):
        batch = batch_at(i)
        zero_counts()
        sync(torch, dev)
        t0 = time.perf_counter()
        model, opt, loss, gnorm = step_fn(model, opt, batch)
        sync(torch, dev)
        dt = time.perf_counter() - t0
        launches = read_counts()
        loss, gnorm = float(loss), float(gnorm)
        # gnorm is the square root of every gradient entry's square summed:
        # finite only if every gradient is.
        check(math.isfinite(loss) and math.isfinite(gnorm), f"[train hymba] step {i}: loss {loss}, "
                                                            f"gnorm {gnorm}")
        check_launches(launches, {"banded_attention_kernel": TRAIN_K5_PER_STEP}, f"train hymba step {i}")
        records.append(dict(s=dt, loss=loss, gnorm=gnorm))
        log(f"[train hymba] step {i}: {dt} s, loss {loss}, gnorm {gnorm}, launches {json.dumps(launches)}")
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(bool(torch.isfinite(p).all()) for p in model.parameters()), "[train hymba] non-finite "
                                                                          "parameter after the steps")
    step_s = median([r["s"] for r in records[1:]])
    tokens = batch_size * LM_PROMPT
    flops = 6 * n_params * tokens
    nums = dict(batch=batch_size, seq=LM_PROMPT, step_s=step_s, tokens_per_s=tokens / step_s,
                max_memory_allocated_bytes=peak, state_bytes=n_state, params=n_params,
                param_bytes=dryrun.tensor_bytes(model), optimizer_bytes=dryrun.tensor_bytes(opt),
                model_flops_per_step=flops, model_flops_share_of_bf16_peak=flops / step_s / rl.PEAK_FLOPS,
                losses=[r["loss"] for r in records], gnorms=[r["gnorm"] for r in records],
                step_seconds=[r["s"] for r in records], k5_launches_per_step=launches["banded_attention_kernel"])
    log(f"[train hymba] {smi}: step {step_s} s (median of steps 2-{TRAIN_STEPS}), {nums['tokens_per_s']} "
        f"tokens/s, max_memory_allocated {peak} B; loss {nums['losses'][0]} -> {nums['losses'][-1]}; "
        f"6 N T = {flops} FLOPs a step, {nums['model_flops_share_of_bf16_peak']} of the bf16 peak; K5 "
        f"{TRAIN_K5_PER_STEP} launches a step, K6 none")

    # The banded backward's share of a step, by CUDA events around its calls.
    batch = batch_at(TRAIN_STEPS)
    sync(torch, dev)
    t0 = time.perf_counter()
    (model, opt, _, _), calls, bwd_ms = banded_backward_times(torch, lambda: step_fn(model, opt, batch))
    ev_step_ms = (time.perf_counter() - t0) * 1e3
    check(calls == HYBRID_LOCAL_LAYERS, f"[train hymba] K5's backward ran {calls} times, expected "
                                        f"{HYBRID_LOCAL_LAYERS}")
    nums.update(banded_backward_ms=bwd_ms, banded_backward_share=bwd_ms / ev_step_ms)
    log(f"[train hymba] the banded backward (blocked plain form, autograd) by CUDA events around its "
        f"{calls} calls: {bwd_ms} ms of a {ev_step_ms} ms step (share {bwd_ms / ev_step_ms})")

    # A profile of one step.
    batch = batch_at(TRAIN_STEPS + 1)
    (model, opt, _, _), nums["profile"] = profile_train_step(
        torch, lambda: step_fn(model, opt, batch), step_s * 1e3, "train hymba")

    # A step repeated from a saved state: bitwise the same state after it.
    batch = batch_at(TRAIN_STEPS + 2)
    saved = host_state(model, opt)
    model, opt, loss_a, _ = step_fn(model, opt, batch)
    after = host_state(model, opt)
    with torch.no_grad():
        for name, t in live_state(model, opt).items():
            t.copy_(saved[name])
    del saved
    model, opt, loss_b, _ = step_fn(model, opt, batch)
    sync(torch, dev)
    differ = [n for n, t in live_state(model, opt).items() if not torch.equal(t.cpu(), after[n])]
    check(not differ and float(loss_a) == float(loss_b),
          f"[train hymba] a step repeated from a saved state differs: {differ[:5]} "
          f"({len(differ)} tensors), loss {float(loss_a)} vs {float(loss_b)}")
    log(f"[train hymba] a step repeated from a saved state: all {len(after)} tensors (parameters, "
        f"moments, step) bitwise equal, loss {float(loss_a)}")
    del after, model, opt
    return launches, nums


def train_hymba_phase(np, torch, dev, smi):
    """[train hymba]: ``build_step`` on hymba-1.5b at full width,
    HYBRID_LAYERS layers (TRAIN_STEPS steps: finite loss, gnorm and parameters, TRAIN_K5_PER_STEP
    K5 launches each), the step time, tokens/s and peak memory, the banded
    backward's share of a step, a profiled step, and a step repeated from a
    saved state bitwise. At TRAIN_BATCH if it fits, else at half of it
    (the failure logged). Returns one step's launches and the numbers."""
    import gc

    cfg = hymba_train_config()
    check(sum(1 for bd in cfg.layer_defs() if bd.window) == HYBRID_LOCAL_LAYERS and cfg.remat == "full",
          "[train hymba] config")
    refused = None
    for batch_size in (TRAIN_BATCH, TRAIN_BATCH // 2):
        try:
            launches, nums = _train_hymba(np, torch, dev, smi, cfg, batch_size)
            nums["batch_refused"] = refused
            return launches, nums
        except torch.OutOfMemoryError as e:
            if batch_size != TRAIN_BATCH:
                raise
            refused = dict(batch=batch_size, max_memory_allocated_bytes=torch.cuda.max_memory_allocated(dev),
                           error=str(e).splitlines()[0])
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[train hymba] batch {TRAIN_BATCH} does not fit: {json.dumps(refused)}; at batch "
            f"{TRAIN_BATCH // 2}")
    raise SmokeFailure("unreachable")


def train_grad_phase(np, torch, dev, smi, batch_size):
    """[train hymba grad]: hymba at full width cut to TRAIN_GRAD_LAYERS
    layers (the global prefix + windowed ones), one batch of LM_PROMPT
    tokens: every parameter's gradient with K5 (bf16), on the plain masked
    path (bf16) and in float32 compute on the plain path; per tensor the
    K5 distance at most TRAIN_GRAD_TOL times the bf16 one. Returns the K5
    way's launches and the numbers."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train

    cfg = hymba_train_config().replace(num_layers=TRAIN_GRAD_LAYERS)
    local = sum(1 for bd in cfg.layer_defs() if bd.window)
    model = train.init_model(cfg, dev)
    tokens, targets = TokenPipeline(cfg.vocab, LM_PROMPT, batch_size, seed=0).next_batch()
    batch = train.make_batch(cfg, tokens, targets, 0, dev)
    ways, launches = {}, {}
    for way, c in (("k5", cfg), ("plain_bf16", cfg.replace(block_local_attn=False)),
                   ("plain_f32", cfg.replace(block_local_attn=False, compute_dtype=torch.float32))):
        zero_counts()
        loss, grads = train.value_and_grad(model, batch, c)
        sync(torch, dev)
        launches[way] = read_counts()
        ways[way] = (float(loss), {n: g.float() for n, g in grads.items()})
        del grads
        torch.cuda.empty_cache()
    check_launches(launches["k5"], {"banded_attention_kernel": 2 * local}, "train hymba grad k5")
    check_launches(launches["plain_bf16"], {}, "train hymba grad plain")
    check_launches(launches["plain_f32"], {}, "train hymba grad float32")
    worst, ratios = 0.0, {}
    for n in ways["k5"][1]:
        k5, plain, f32 = (ways[w][1][n] for w in ("k5", "plain_bf16", "plain_f32"))
        check(bool(torch.isfinite(k5).all()), f"[train hymba grad] {n}: non-finite gradient")
        d_k5 = float((k5 - plain).norm() / plain.norm())
        d_bf16 = float((plain - f32).norm() / f32.norm())
        check(d_k5 <= TRAIN_GRAD_TOL * d_bf16, f"[train hymba grad] {n}: K5 vs plain {d_k5} above "
                                               f"{TRAIN_GRAD_TOL} x plain bf16 vs float32 {d_bf16}")
        ratios[n] = d_k5 / d_bf16
        worst = max(worst, ratios[n])
    top = sorted(ratios.items(), key=lambda kv: -kv[1])[:5]
    nums = dict(layers=cfg.num_layers, batch=batch_size, losses={w: v[0] for w, v in ways.items()},
                tensors=len(ratios), worst_ratio=worst, worst_tensors=top)
    log(f"[train hymba grad] {smi}: {cfg.num_layers} layers (1 global, {local} windowed) at full width, "
        f"batch {batch_size} x {LM_PROMPT}; losses {json.dumps(nums['losses'])}; per tensor |g_K5 - "
        f"g_plain| / |g_plain| at most {worst} x |g_plain - g_f32| / |g_f32| (limit {TRAIN_GRAD_TOL}) over "
        f"{len(ratios)} tensors; largest ratios {top}; K5 launches {launches['k5']['banded_attention_kernel']}"
        f" (forward + recompute)")
    del ways, model
    torch.cuda.empty_cache()
    return launches["k5"], nums


def train_reduced_phase(np, torch, dev, smi):
    """[train reduced]: each registry config's ``reduced()`` (float32),
    seed-0 weights made on the CPU and copied to the card, one batch of
    the token pipeline (and the family's stub input) made on the CPU: the
    loss and gradients on the card (finite) against the CPU's (the loss
    within TRAIN_LOSS_TOL), then one ``build_step`` step on the card
    (finite gnorm). Then examples/train_lm_torch.py's flow on
    EXAMPLE_ARCH reduced on the card: the loss falls over EXAMPLE_STEPS
    steps, and the run resumed from its halfway checkpoint ends on the
    uninterrupted run's bits."""
    import copy
    import math
    import runpy

    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.optim import AdamWConfig

    cpu = torch.device("cpu")
    nums = {}
    zero_counts()
    for name in registry.names():
        cfg = registry.get(name).reduced()
        model_cpu = train.init_model(cfg, cpu)
        model = copy.deepcopy(model_cpu).to(dev)
        tokens, targets = TokenPipeline(cfg.vocab, TRAIN_REDUCED_SEQ, TRAIN_REDUCED_BATCH).next_batch()
        batch_cpu = train.make_batch(cfg, tokens, targets, 0, cpu)
        batch = {k: v.to(dev) for k, v in batch_cpu.items()}
        loss_cpu, grads_cpu = train.value_and_grad(model_cpu, batch_cpu, cfg)
        loss, grads = train.value_and_grad(model, batch, cfg)
        check(all(bool(torch.isfinite(g).all()) for g in grads.values()), f"[train reduced] {name}: "
                                                                          f"non-finite gradient")
        close_report(torch, loss.cpu(), loss_cpu, what=f"[train reduced] {name} loss card vs CPU",
                     **TRAIN_LOSS_TOL)
        grad_rel = max(float((grads[n].cpu() - g).norm() / g.norm().clamp_min(1e-30))
                       for n, g in grads_cpu.items())
        opt_cfg = AdamWConfig(lr=1e-3)
        opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
        _, _, step_loss, gnorm = train.build_step(cfg, opt_cfg, 10)(model, opt, batch)
        check(math.isfinite(float(gnorm)) and float(step_loss) == float(loss),
              f"[train reduced] {name}: step loss {float(step_loss)} vs {float(loss)}, gnorm {float(gnorm)}")
        nums[name] = dict(loss_card=float(loss), loss_cpu=float(loss_cpu), grad_rel_max=grad_rel,
                          gnorm=float(gnorm))
        log(f"[train reduced] {name}: loss card {float(loss)} vs CPU {float(loss_cpu)}; largest relative "
            f"gradient distance card vs CPU {grad_rel}; one step on the card, gnorm {float(gnorm)}")
    launches = read_counts()
    check_launches(launches, {}, "train reduced")

    example = runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        flow = example["run"](EXAMPLE_ARCH, EXAMPLE_STEPS, 4, 64, dev, Path(tmp))
        flow["wall_s"] = time.perf_counter() - t0
    check(flow["resumed_bitwise"] and flow["final_loss"] < flow["first_loss"],
          f"[train reduced] example flow: {json.dumps(flow)}")
    nums["example"] = flow
    log(f"[train reduced] {smi}: examples/train_lm_torch.py on {EXAMPLE_ARCH} reduced: loss "
        f"{flow['first_loss']} -> {flow['final_loss']} over {EXAMPLE_STEPS} steps, resumed from step "
        f"{flow['resumed_from']} bitwise the uninterrupted run ({flow['leaves']} leaves), 10 more steps "
        f"{flow['loss_after_10_more']}; {flow['wall_s']} s")
    return launches, nums


# ---------------------------------------------------------------------------
# the accounting layer on the card: dry runs of the measured runs, and the CLIs
# ---------------------------------------------------------------------------


def roofline_lm_phase(smi, nums_lm, nums_train) -> dict:
    """[roofline lm]: ``launch/dryrun.run_cell`` (on meta, nothing
    allocated) of the runs the LM phases measured: gemma3-12b at LM_LAYERS
    layers, mamba2-780m and hymba-1.5b at SSM_LAYERS and HYBRID_LAYERS, each the prefill of
    LM_BATCH x LM_PROMPT tokens with caches for LM_TOKENS more, and
    hymba-1.5b's training step at its batch x LM_PROMPT. Each bound beside
    the measured seconds: the share may be at most MAX_SHARE. The dry
    run's parameter bytes must equal the live model's, and for the step its
    optimizer bytes the live optimizer's (with them, ``state_bytes``).
    Returns the numbers a run."""
    from repro_torch.configs.shapes import ShapeDef
    from repro_torch.launch import dryrun

    hymba = nums_train["train hymba"]
    runs = (("lm", lm_config(), "prefill", LM_BATCH, nums_lm["lm"]),
            ("lm ssm", ssm_config(), "prefill", LM_BATCH, nums_lm["lm ssm"]),
            ("lm hybrid", hybrid_config(), "prefill", LM_BATCH, nums_lm["lm hybrid"]),
            ("train hymba", hymba_train_config(), "train", hymba["batch"], hymba))
    out = {}
    for label, cfg, kind, batch, nums in runs:
        measured = nums["prefill_s"] if kind == "prefill" else nums["step_s"]
        t0 = time.perf_counter()
        rec = dryrun.run_cell(cfg, ShapeDef(label, kind, LM_PROMPT, batch), verbose=False,
                              max_len=LM_PROMPT + LM_TOKENS)
        count_s = time.perf_counter() - t0
        mem, t = rec["memory_analysis"], rec["terms_seconds"]
        args = mem["arguments"]
        share = rec["bound_seconds"] / measured
        peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        log(f"[roofline lm] {label}: {cfg.name} {cfg.num_layers} layers, {kind} {batch} x {LM_PROMPT}: "
            f"bound {rec['bound_seconds']} s by {rec['dominant']} (compute {t['compute']} s: "
            f"{rec['flops_per_device']} FLOPs; memory {t['memory']} s: {rec['bytes_per_device']} B op "
            f"by op; kernels {json.dumps(rec['kernels'])}), measured {measured} s, share {share}; "
            f"argument bytes {json.dumps(args)}; predicted peak (arguments + temporaries) {peak} B, "
            f"measured max_memory_allocated {nums['max_memory_allocated_bytes']} B; {smi}; counted on "
            f"meta in {count_s} s")
        check(args["params"] == nums["param_bytes"], f"[roofline lm] {label}: the dry run's parameter "
                                                     f"bytes {args['params']}, the live model's "
                                                     f"{nums['param_bytes']}")
        if kind == "train":
            check(args["optimizer"] == nums["optimizer_bytes"],
                  f"[roofline lm] {label}: the dry run's optimizer bytes {args['optimizer']}, the live "
                  f"optimizer's {nums['optimizer_bytes']}")
            log(f"[roofline lm] {label}: parameters and optimizer state {args['params'] + args['optimizer']} "
                f"B on meta = state_bytes(model, opt) {nums['state_bytes']} B + the step counter's "
                f"{nums['optimizer_bytes'] + nums['param_bytes'] - nums['state_bytes']} B")
        check(share <= MAX_SHARE, f"[roofline lm] {label}: measured {measured} s is {share} of its bound "
                                  f"{rec['bound_seconds']} s, above {MAX_SHARE}: the count is wrong")
        out[label] = dict(bound_s=rec["bound_seconds"], dominant=rec["dominant"], measured_s=measured,
                          share=share, terms_seconds=t, flops=rec["flops_per_device"],
                          bytes=rec["bytes_per_device"], kernels=rec["kernels"], arguments=args,
                          predicted_peak_bytes=peak, count_s=count_s)
    return out


def cell_counts(out_dir: Path) -> dict:
    """ok / skipped by design / failed records of a dry run's output."""
    recs = [json.loads(f.read_text()) for f in sorted(out_dir.glob("*.json"))]
    ok = sum(1 for r in recs if r.get("ok"))
    skipped = sum(1 for r in recs if r.get("skipped"))
    return dict(ok=ok, skipped=skipped, failed=len(recs) - ok - skipped)


def start_dryruns(tmp: Path) -> dict:
    """Start [dryrun]'s and [dryrun mesh]'s command lines, each a
    subprocess on this machine's host (meta tensors: nothing reaches the
    card) in a thread of its own, so they run beside each other and beside
    the meta passes this process makes meanwhile. Returns {label: future of
    (stdout, wall s)}; a non-zero exit fails the run where it is read."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import make_production_mesh

    cmds = {"dryrun": ["repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH, "--mesh", "1x1"],
            "dryrun_pdf --all": ["repro_torch.launch.dryrun_pdf", "--all"]}
    for arch, shape, multi_pod, through_cli in DRYRUN_MESH_CELLS:
        if through_cli:
            text = "x".join(map(str, make_production_mesh(multi_pod=multi_pod).shape))
            cmds[f"{arch} {shape} {text} cli"] = ["repro_torch.launch.dryrun", "--arch", arch,
                                                  "--shape", shape, "--mesh", text]
    cmds[DRYRUN_BOUND_LABEL] = ["repro_torch.launch.dryrun", "--arch", DRYRUN_BOUND_CELL[0], "--shape",
                                DRYRUN_BOUND_CELL[1], "--mesh", "1x1"]
    for variant, shape, multi_pod, through_cli in DRYRUN_PDF_MESH_CELLS:
        if through_cli:
            text = "x".join(map(str, make_production_mesh(multi_pod=multi_pod).shape))
            cmds[f"pdf {variant} {shape} {text} cli"] = (
                ["repro_torch.launch.dryrun_pdf", "--variant", variant, "--pdf-shape", shape]
                + (["--multi-pod"] if multi_pod else []))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def run(label, argv):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", *argv, "--out", str(dryrun_dir(tmp, label))],
                           cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
                           stdin=subprocess.DEVNULL)
        check(p.returncode == 0, f"[dryrun] {label} exited {p.returncode}: {p.stderr[-2000:]}")
        return p.stdout, time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(cmds))
    runs = {label: pool.submit(run, label, argv) for label, argv in cmds.items()}
    pool.shutdown(wait=False)
    return runs


def dryrun_dir(tmp: Path, label: str) -> Path:
    """The records of one of ``start_dryruns``'s command lines."""
    return tmp / label.replace(" ", "_")


def dryrun_phase(smi, tmp: Path, runs: dict) -> dict:
    """[dryrun]: ``python -m repro_torch.launch.dryrun --arch DRYRUN_ARCH
    --mesh 1x1`` (its four cells, one skipped by design; the CPU tests run
    ``--all``), ``python -m repro_torch.launch.dryrun_pdf --all`` (started
    by ``start_dryruns``) and then ``python -m repro_torch.launch.report`` over
    the LM records, each a subprocess on this machine: each one's wall,
    exit code and its cells ok, skipped by design and failed. A failed
    cell fails the phase."""
    import os

    lm_dir = dryrun_dir(tmp, "dryrun")
    out = {}
    for kind in ("dryrun", "dryrun_pdf --all"):
        out[kind] = dict(wall_s=runs[kind].result()[1], **cell_counts(dryrun_dir(tmp, kind)))
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.report", "--dir", str(lm_dir),
                        "--mesh", "1x1"], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"[dryrun] report exited {p.returncode}: {p.stderr[-2000:]}")
    table = p.stdout
    out["report"] = dict(wall_s=wall)
    log(f"[dryrun] python -m repro_torch.launch.dryrun --arch {DRYRUN_ARCH} --mesh 1x1: "
        f"{json.dumps(out['dryrun'])}; python -m repro_torch.launch.dryrun_pdf --all: "
        f"{json.dumps(out['dryrun_pdf --all'])} (wall s beside the other dry runs, cells ok, skipped "
        f"by design, failed)")
    for kind in ("dryrun", "dryrun_pdf --all"):
        check(out[kind]["failed"] == 0 and out[kind]["ok"] > 0,
              f"[dryrun] {kind}: {out[kind]['failed']} failed cells of {out[kind]}")
    check(out["dryrun"]["skipped"] > 0, f"[dryrun] {DRYRUN_ARCH}: no cell skipped by design")
    log(f"[dryrun] python -m repro_torch.launch.report in {wall} s:\n{table}")
    reported = table.strip().splitlines()[-1]
    want = (f"cells: {out['dryrun']['ok']} ok, {out['dryrun']['skipped']} skipped-by-design, "
            f"0 failed")
    check(reported == want, f"[dryrun] report says {reported!r}, the records {want!r}")
    log(f"[summary dryrun] {smi}: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# the multi-device half: meshes, collectives, the sharded step
# ---------------------------------------------------------------------------


def mesh_train_1x1(np, torch, dev, smi, dmesh) -> dict:
    """hymba-1.5b at full width, MESH_HYMBA_LAYERS layers, MESH_TRAIN_STEPS
    steps of ``train.build_step`` on the same batches twice from the same
    seed-0 weights: on the one device, and on DTensor parameters placed on
    the 1x1 mesh (``sharding.distribute_params``, the batch by
    ``shard_batch``; K5 on each rank's heads through ``local_heads``). The
    losses and every parameter after the steps bitwise equal; K5
    MESH_K5_PER_STEP launches a step on both."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import sharding as sh
    from repro_torch.optim import AdamWConfig

    cfg = hymba_train_config().replace(num_layers=MESH_HYMBA_LAYERS)
    check(sum(1 for bd in cfg.layer_defs() if bd.window) == MESH_HYMBA_LAYERS - 1, "[mesh 1x1] config")
    pipe = TokenPipeline(cfg.vocab, LM_PROMPT, TRAIN_BATCH, seed=0)
    batches = [train.make_batch(cfg, *pipe.next_batch(), i, dev) for i in range(MESH_TRAIN_STEPS)]
    opt_cfg = AdamWConfig(lr=TRAIN_LR)

    def run(label, sharded):
        model = train.init_model(cfg, dev)
        if sharded:
            sh.distribute_params(cfg, dmesh, model)
        opt = train.init_optimizer(cfg, dict(model.named_parameters()), opt_cfg)
        step_fn = train.build_step(cfg, opt_cfg, MESH_TRAIN_STEPS)
        losses, secs, launches = [], [], None
        for i, batch in enumerate(batches):
            if sharded:
                batch = sh.shard_batch(batch, dmesh)
            zero_counts()
            sync(torch, dev)
            t0 = time.perf_counter()
            model, opt, loss, _ = step_fn(model, opt, batch)
            sync(torch, dev)
            secs.append(time.perf_counter() - t0)
            launches = read_counts()
            check_launches(launches, {"banded_attention_kernel": MESH_K5_PER_STEP},
                           f"mesh 1x1 {label} step {i}")
            losses.append(float(loss))
        params = {n: (p.to_local() if sh.is_dtensor(p) else p).detach()
                  for n, p in model.named_parameters()}
        kinds = sorted({type(p).__name__ for p in model.parameters()})
        log(f"[mesh 1x1] {label}: hymba-1.5b, {cfg.num_layers} layers at full width, batch "
            f"{TRAIN_BATCH} x {LM_PROMPT}: losses {losses}, step seconds {secs}, parameters {kinds}, "
            f"launches a step {json.dumps(launches)}")
        return losses, params, secs, launches

    one = run("one device", False)
    mesh = run("sharded step", True)
    differ = [n for n, p in one[1].items() if not torch.equal(p, mesh[1][n])]
    check(one[0] == mesh[0] and not differ,
          f"[mesh 1x1] the sharded step differs from the one-device step: losses {one[0]} vs {mesh[0]}, "
          f"parameters {differ[:5]} ({len(differ)})")
    log(f"[mesh 1x1] {smi}: the sharded step on the 1x1 mesh is bitwise the one-device step over "
        f"{MESH_TRAIN_STEPS} steps (losses and all {len(one[1])} parameters); step seconds one device "
        f"{one[2]}, sharded {mesh[2]}")
    k5 = mesh[3]["banded_attention_kernel"]
    del one, mesh, batches
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, steps=MESH_TRAIN_STEPS, k5_per_step=k5, bitwise=True)


def mesh_flash_1x1(np, torch, dev, smi, dmesh) -> dict:
    """gemma3-12b as [lm] has it (full width, 12 layers) in float32 compute
    (the decode oracle's; TF32 off) with ``flash_decode`` and the 1x1 mesh
    in ``extras``: its two global layers decode by
    ``flash_decode_attention`` against caches placed on the mesh
    (``shard_decode_caches``). Each of LM_TOKENS steps' logits against the
    plain decode's on the same tokens within LM_DECODE_TOL, no K5 launch in
    decode; ``generate``'s tokens equal the plain path's. (In bf16 compute
    the two round differently: flash decode casts the unnormalised
    weights, as the reference's does, the plain path the normalised ones.)"""
    from repro_torch.launch import serve_decode as sd
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as T

    cfg = lm_config().replace(compute_dtype=torch.float32)
    flash = cfg.replace(flash_decode=True)
    extras = {"mesh": dmesh}
    gen = torch.Generator(device=dev).manual_seed(0)
    model = sd.init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    max_len = LM_PROMPT + LM_TOKENS
    logits, plain = sd.prefill(cfg, model, prompt, None, max_len)
    flogits, caches = sd.prefill(flash, model, prompt, extras, max_len)
    check(torch.equal(logits, flogits), "[mesh 1x1] flash decode's prefill differs from the plain one")
    caches = T.shard_decode_caches(flash, caches, extras)
    placed = sum(1 for c in caches if "attn" in c and sh.is_dtensor(c["attn"]["k"]))
    check(placed == LM_LAYERS - LM_LOCAL_LAYERS, f"[mesh 1x1] {placed} caches on the mesh, expected "
                                                 f"the {LM_LAYERS - LM_LOCAL_LAYERS} global layers'")
    tok = torch.argmax(logits, -1).to(torch.int32)
    errs, steps_ms = [], []
    zero_counts()
    for i in range(LM_TOKENS):
        want, plain = sd.decode_step(cfg, model, tok, plain, LM_PROMPT + i)
        sync(torch, dev)
        t0 = time.perf_counter()
        got, caches = sd.decode_step(flash, model, tok, caches, LM_PROMPT + i, extras)
        sync(torch, dev)
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        errs.append(close_report(torch, got, want, what=f"[mesh 1x1] flash decode step {i} vs the plain "
                                                         f"decode", **LM_DECODE_TOL))
        tok = torch.argmax(want, -1).to(torch.int32)
    check(read_counts()["banded_attention_kernel"] == 0, "[mesh 1x1] K5 launched in a decode step")
    tokens = sd.generate(flash, model, prompt, LM_TOKENS, extras)
    check(torch.equal(tokens, sd.generate(cfg, model, prompt, LM_TOKENS)),
          "[mesh 1x1] flash decode's greedy tokens differ from the plain decode's")
    nums = dict(flash_layers=placed, max_abs_vs_plain=max(errs),
                flash_decode_ms_per_token=sorted(steps_ms)[len(steps_ms) // 2])
    log(f"[mesh 1x1] {smi}: gemma3-12b, {LM_LAYERS} layers, float32 compute, flash_decode on the "
        f"1x1 mesh ({placed} global layers by flash_decode_attention): {LM_TOKENS} greedy tokens "
        f"equal to the plain "
        f"decode's; logits max abs {max(errs)} from the plain decode's (tolerance rtol = atol = "
        f"{LM_DECODE_TOL['rtol']}); {nums['flash_decode_ms_per_token']} ms a step (median)")
    del model, plain, caches
    torch.cuda.empty_cache()
    return nums


def mesh_moe_1x1(np, torch, dev, smi, dmesh) -> dict:
    """arctic-480b as [lm moe] has it (full width, MESH_MOE_LAYERS layers,
    bf16 parameters, seed 0): a prefill of MESH_MOE_BATCH x LM_PROMPT
    tokens on the one device, its logits and each MoE layer's kept set to
    the host; then the same parameters placed on the 1x1 mesh
    (``sharding.distribute_params``: no second copy) and the prefill twice
    on DTensors, the MoE through ``sharding.local_experts``. Logits bitwise
    equal, the same kept set and drops in every MoE layer; the second mesh
    prefill times the mesh path once DTensor has cached its rules."""
    from repro_torch.launch import serve_decode as sd
    from repro_torch.models import sharding as sh

    cfg = xmodel_config(torch, MESH_MOE_ARCH, MESH_MOE_LAYERS, True)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = sd.init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (MESH_MOE_BATCH, LM_PROMPT), generator=gen, device=dev)

    def run(tokens):
        calls, keeps = [], []
        sync(torch, dev)
        t0 = time.perf_counter()
        with recording_moe(torch, calls, keeps):
            logits, caches = sd.prefill(cfg, model, tokens, None, LM_PROMPT)
        logits = logits.full_tensor() if sh.is_dtensor(logits) else logits
        sync(torch, dev)
        secs = time.perf_counter() - t0
        out = logits.cpu()
        del logits, caches
        torch.cuda.empty_cache()
        return out, calls, keeps, secs

    one = run(prompt)
    sh.distribute_params(cfg, dmesh, model)
    kinds = sorted({type(p).__name__ for p in model.parameters()})
    placed = sh.place(prompt, sh.batch_sharding(dmesh, 2))
    mesh = run(placed)
    again = run(placed)  # DTensor's sharding rules cached: the mesh prefill's own time
    check(torch.equal(again[0], mesh[0]), "[mesh 1x1] arctic: the mesh prefill does not repeat bitwise")
    n_moe = sum(bd.ffn in ("moe", "moe_dense") for bd in cfg.layer_defs())
    check(len(one[1]) == len(mesh[1]) == n_moe, f"[mesh 1x1] MoE calls {len(one[1])} / {len(mesh[1])}, "
                                                 f"expected {n_moe} each")
    check(bool(torch.isfinite(one[0]).all()) and one[0].shape == (MESH_MOE_BATCH, cfg.vocab),
          "[mesh 1x1] arctic prefill logits shape or finiteness")
    differ = [i for i, (a, b) in enumerate(zip(one[2], mesh[2])) if not torch.equal(a, b)]
    check(not differ and one[1] == mesh[1], f"[mesh 1x1] arctic: the mesh's kept set differs in MoE "
                                            f"layers {differ}: {one[1]} vs {mesh[1]}")
    check(torch.equal(one[0], mesh[0]), f"[mesh 1x1] arctic: the mesh's prefill logits differ from the "
                                        f"one device's (max abs {float((one[0] - mesh[0]).abs().max())})")
    nums = dict(arch=cfg.name, layers=cfg.num_layers, batch=MESH_MOE_BATCH, prompt=LM_PROMPT,
                moe_layers=mesh[1], prefill_s_one_device=one[3], prefill_s_mesh_first=mesh[3],
                prefill_s_mesh=again[3], bitwise=True)
    log(f"[mesh 1x1] {smi}: {cfg.name}, {xmodel_note(cfg, MESH_MOE_ARCH)}, bf16 parameters: prefill of "
        f"{MESH_MOE_BATCH} x {LM_PROMPT} tokens on the 1x1 mesh (parameters {kinds}) bitwise the one "
        f"device's; each MoE layer's capacity and drops, the same kept set on both: {json.dumps(mesh[1])}; "
        f"prefill s one device {one[3]}, mesh {mesh[3]} (first), {again[3]} (again, bitwise)")
    del model, prompt
    torch.cuda.empty_cache()
    return nums


def mesh_1x1_phase(np, torch, dev, smi, tmp: Path) -> dict:
    """[mesh 1x1]: a one-rank NCCL world in this process (its FileStore
    under ``tmp``), its 1x1 ``DeviceMesh``, then ``mesh_train_1x1``,
    ``mesh_flash_1x1`` and ``mesh_moe_1x1``; the world is left at the end."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    t0 = time.perf_counter()
    backend = M.backend_for(dev)
    dist.init_process_group(backend, store=dist.FileStore(str(tmp / "store_1x1"), 1), rank=0,
                            world_size=1)
    try:
        dmesh = M.device_mesh(M.make_mesh((1, 1), ("data", "model")), dev.type)
        log(f"[mesh 1x1] a one-rank {dist.get_backend()} world, mesh {dmesh}")
        nums = {"backend": dist.get_backend(), "train": mesh_train_1x1(np, torch, dev, smi, dmesh),
                "flash": mesh_flash_1x1(np, torch, dev, smi, dmesh),
                "moe": mesh_moe_1x1(np, torch, dev, smi, dmesh)}
    finally:
        dist.destroy_process_group()
    nums["wall_s"] = time.perf_counter() - t0
    log(f"[summary mesh 1x1] {smi}: {json.dumps(nums)}")
    return nums


def _flash_2rank(np, torch, dev, dmesh) -> dict:
    """Flash decode at gemma3's attention width in float32 (d 3840, 16
    heads, 8 KV heads, hd 256, qk-norm), batch LM_BATCH against a cache of
    LM_PROMPT + LM_TOKENS positions split over the two ranks' ``model``
    axis, at a position in each rank's half: the output against the
    one-rank plain decode on the whole cache within MESH_FLASH_TOL, this
    rank's block of the written cache equal to the plain cache's block,
    changed only on the rank that owns the position."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    cfg = lm_config().replace(compute_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = L.Attention(cfg, dev)
    p.reset_parameters(gen)
    s = LM_PROMPT + LM_TOKENS
    x = torch.randn((LM_BATCH, 1, cfg.d_model), generator=gen, device=dev)
    ck = torch.randn((LM_BATCH, s, cfg.kv_heads, cfg.head_dim), generator=gen, device=dev)
    cv = torch.randn((LM_BATCH, s, cfg.kv_heads, cfg.head_dim), generator=gen, device=dev)
    where = sh.Sharding(dmesh, sh.to_placements(("data", "model", None, None), dmesh))
    idx, shard_len = dmesh.get_local_rank("model"), s // 2
    out = {}
    for pos in (s // 4, 3 * s // 4):
        cache = {"k": sh.place(ck.clone(), where), "v": sh.place(cv.clone(), where)}
        before = cache["k"].to_local().clone()
        whole = {"k": ck.clone(), "v": cv.clone()}
        with torch.no_grad():
            y, c = L.flash_decode_attention(p, x, cache, pos, cfg=cfg, mesh=dmesh)
            want, whole = L.decode_attention(p, x, whole, pos, cfg=cfg)
        err = float((y - want).abs().max())
        check(bool(torch.allclose(y, want, **MESH_FLASH_TOL)),
              f"[mesh 2 ranks] flash decode at pos {pos}: max abs {err} from the plain decode")
        block = slice(idx * shard_len, (idx + 1) * shard_len)
        check(torch.equal(c["k"].to_local(), whole["k"][:, block])
              and torch.equal(c["v"].to_local(), whole["v"][:, block]),
              f"[mesh 2 ranks] flash decode at pos {pos}: rank {idx}'s cache block differs")
        changed = not torch.equal(before, c["k"].to_local())
        check(changed == (pos // shard_len == idx), f"[mesh 2 ranks] the new K/V at pos {pos} landed "
                                                    f"{'on' if changed else 'off'} rank {idx}")
        out[pos] = dict(max_abs=err, wrote_here=changed)
    return out


def _decode_2rank(np, torch, dev, dmesh) -> dict:
    """Plain decode on caches split over the two ranks' ``model`` axis
    (placed as ``cache_pspecs`` says), each rank on its own block:
    gemma3-12b's attention at full width in float32 (d 3840, 16 heads, 8
    KV heads, hd 256, qk-norm), batch LM_BATCH, against a full cache of
    LM_PROMPT + LM_TOKENS positions at the two positions beside the shard
    boundary and a ring of its window at two positions past the wrap
    beside the boundary: the output against the one-rank decode on the
    whole cache within MESH_FLASH_TOL, this rank's block of the written
    cache equal to the whole cache's. The parameters are whole on each
    rank, so only all-reduces run: gloo carries those on the card's
    tensors. Its ``all_gather_into_tensor`` of a CUDA tensor kills the
    process, so the decode with DTensor parameters (the query's heads
    gathered over ``model``) and mamba2-780m's SSD decode (its
    convolution's output gathered over ``model``) are held on the CPU
    (``tests/test_torch_decode_mesh.py``); ``mesh_2rank_phase`` logs so."""
    from repro_torch.launch import mesh as M
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    def placed(whole: dict) -> dict:
        specs = sh.cache_pspecs(M.describe(dmesh), whole, LM_BATCH)
        return {k: sh.place(t.clone(), sh.Sharding(dmesh, sh.to_placements(specs[k], dmesh)))
                for k, t in whole.items()}

    def block(t, split, dim):
        idx, n = dmesh.get_local_rank("model"), t.shape[dim] // 2
        return t.narrow(dim, idx * n, n) if split else t

    cfg = lm_config().replace(compute_dtype=torch.float32)
    window = next(bd.window for bd in cfg.layer_defs() if bd.window)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = L.Attention(cfg, dev)
    p.reset_parameters(gen)
    x = torch.randn((LM_BATCH, 1, cfg.d_model), generator=gen, device=dev)
    s = LM_PROMPT + LM_TOKENS
    layers = {"full": (None, s, (s // 2 - 1, s // 2)),
              "ring": (window, window, (window + window // 2 - 1, window + window // 2))}
    out = {}
    for layer, (w, length, positions) in layers.items():
        shape = (LM_BATCH, length, cfg.kv_heads, cfg.head_dim)
        ck = torch.randn(shape, generator=gen, device=dev)
        cv = torch.randn(shape, generator=gen, device=dev)
        for pos in positions:
            cache, whole = placed({"k": ck, "v": cv}), {"k": ck.clone(), "v": cv.clone()}
            with torch.no_grad(), sh.implicit_replication():
                y, c = L.decode_attention(p, x, cache, pos, cfg=cfg, window=w)
                want, whole = L.decode_attention(p, x, whole, pos, cfg=cfg, window=w)
                y = y.full_tensor() if sh.is_dtensor(y) else y
            err = float((y - want).abs().max())
            what = f"[mesh 2 ranks] plain decode ({layer} cache) at pos {pos}"
            check(bool(torch.allclose(y, want, **MESH_FLASH_TOL)), f"{what}: max abs {err} from the "
                                                                  f"one-rank decode")
            check(c["k"].placements[1].is_shard(1), f"{what}: cache placed {c['k'].placements}")
            check(torch.equal(c["k"].to_local(), block(whole["k"], True, 1))
                  and torch.equal(c["v"].to_local(), block(whole["v"], True, 1)),
                  f"{what}: this rank's cache block differs from the whole cache's")
            out[f"{layer} pos {pos}"] = err
    return out


def _allreduce_2rank(np, torch, dev, rank) -> dict:
    """``pod_allreduce_compressed`` of a tensor of hymba-1.5b's largest
    gradient (its embedding's), a standard normal from seed ``rank`` on
    each rank: every rank's result equal to the scheme computed here from
    both inputs within 1e-6, and within 0.05 of the mean."""
    from repro_torch.configs import registry
    from repro_torch.optim import compress_int8, pod_allreduce_compressed

    cfg = registry.get(HYBRID_ARCH)
    shape = (cfg.padded_vocab, cfg.d_model)
    xs = [torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(r), device=dev)
          for r in range(2)]
    sync(torch, dev)
    t0 = time.perf_counter()
    got = pod_allreduce_compressed(xs[rank])
    sync(torch, dev)
    ms = (time.perf_counter() - t0) * 1e3
    qs = [compress_int8(x) for x in xs]
    top = torch.maximum(qs[0][1], qs[1][1])
    want = (qs[0][0].float() * (qs[0][1] / top) + qs[1][0].float() * (qs[1][1] / top)) * top / 2
    err = float((got - want).abs().max())
    err_mean = float((got - (xs[0] + xs[1]) / 2).abs().max())
    check(err <= 1e-6 and err_mean <= 0.05, f"[mesh 2 ranks] compressed all-reduce: {err} from the "
                                            f"scheme, {err_mean} from the mean")
    return dict(shape=list(shape), bytes=xs[0].numel() * 4, ms=ms, max_abs_vs_scheme=err,
                max_abs_vs_mean=err_mean)


def _stager_2rank(np, torch, dev, dmesh) -> dict:
    """Set1 slice SET1_SLICE's windows split over the two ranks by
    ``ShardedStager`` and ``run_window_sharded`` on the fused backend: K1
    and K2 once a window on each rank, each window's results bitwise the
    one-rank ``run_window``'s."""
    from repro_torch.core import regions
    from repro_torch.core.executor import RESULT_FIELDS
    from repro_torch.core.pipeline import PDFConfig, StagedExecutor
    from repro_torch.data.loader import ShardedStager
    from repro_torch.data.simulation import SeismicSimulation

    sim = SeismicSimulation()
    cfg = PDFConfig()
    ex = StagedExecutor(cfg, sim, dev)
    sharded = ShardedStager(ex.stager, mesh=dmesh, axes=("data",))
    windows = list(regions.iter_windows(sim.geometry, SET1_SLICE, cfg.window_lines))[:SET1_WINDOWS]
    launches = {name: 0 for name in launch_counters()}
    t0 = time.perf_counter()
    for w in windows:
        zero_counts()
        got = ex.run_window_sharded(w, sharded)
        for name, n in read_counts().items():
            launches[name] += n
        want = ex.run_window(w)
        differ = [f for f in RESULT_FIELDS
                  if not np.array_equal(getattr(got, f), getattr(want, f), equal_nan=True)]
        check(not differ, f"[mesh 2 ranks] window {w}: the split window differs from the one-rank "
                          f"window in {differ}")
    check_launches(launches, {"moments_edges_stats": len(windows), "fit_error_counts": len(windows)},
                   "mesh 2 ranks stager")
    staged, valid = sharded.stage(sim.load_window(windows[0]))
    return dict(windows=len(windows), points=valid, rows_here=int(staged.values.shape[0]),
                wall_s=time.perf_counter() - t0, launches=launches)


def moe_layer_cfg(torch):
    """[mesh 2 ranks]'s MoE layer: MESH_MOE_ARCH at full width, bf16
    parameters, float32 compute."""
    return xmodel_config(torch, MESH_MOE_ARCH, MESH_MOE_LAYERS, True).replace(
        compute_dtype=torch.float32)


def moe_layer(torch, cfg, dev, dmesh=None):
    """A MoE layer of ``cfg`` with experts drawn one at a time, each from its
    own generator (seed MESH_MOE_SEED and its index), so the one-rank
    layer and every rank's slab hold the same experts: ``MoE`` on meta
    with plain parameters, or with ``dmesh`` (data x model) DTensor
    parameters, the router replicated and each stack this rank's slab
    (``Shard(0)`` on ``model``, as ``make_pspecs`` places it); and its
    input x, (MESH_MOE_BATCH, LM_PROMPT, d) normals plus one shared
    direction (the router then prefers some experts, and the capacity
    drops choices)."""
    from repro_torch.models import layers as L

    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    gen = torch.Generator(device=dev).manual_seed(MESH_MOE_SEED)
    router = torch.randn((d, e), generator=gen, device=dev) * d**-0.5
    x = (torch.randn((MESH_MOE_BATCH, LM_PROMPT, d), generator=gen, device=dev)
         + 1.5 * torch.randn((d,), generator=gen, device=dev))
    m = dmesh.size(dmesh.mesh_dim_names.index("model")) if dmesh is not None else 1
    first = dmesh.get_local_rank("model") * (e // m) if dmesh is not None else 0
    stacks = {}
    for j, (name, shape, scale) in enumerate((("w_gate", (d, ff), e**-0.5), ("w_in", (d, ff), e**-0.5),
                                               ("w_out", (ff, d), ff**-0.5))):
        w = torch.empty((e // m,) + shape, dtype=cfg.param_dtype, device=dev)
        for i in range(e // m):
            g = torch.Generator(device=dev).manual_seed(MESH_MOE_SEED * 10_000 + 3 * (first + i) + j)
            w[i] = torch.randn(shape, generator=g, device=dev) * scale
        stacks[name] = w
    p = L.MoE(cfg, device="meta")
    if dmesh is None:
        tensors = dict(router=router, **stacks)
    else:
        from torch.distributed.tensor import DTensor, Replicate, Shard

        whole, slab = (Replicate(), Replicate()), (Replicate(), Shard(0))
        tensors = {n: DTensor.from_local(t, dmesh, whole if n == "router" else slab, run_check=False)
                   for n, t in dict(router=router, **stacks).items()}
    for n, t in tensors.items():
        setattr(p, n, torch.nn.Parameter(t, requires_grad=False))
    return p, x


def moe_one_rank(np, torch, dev, path: Path) -> dict:
    """The one-rank layer of [mesh 2 ranks], in this process before the
    ranks start: its output (to ``path``, an .npy the ranks read) and kept
    mask (to ``path`` with ``.keep``), its capacity and drops."""
    from repro_torch.models import layers as L

    cfg = moe_layer_cfg(torch)
    p, x = moe_layer(torch, cfg, dev)
    t = x.shape[0] * x.shape[1]
    cap = L.moe_capacity(t, cfg.num_experts, cfg.moe_top_k)
    sync(torch, dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        y = L.moe(p, x, cfg)
        keep = L.moe_route(p, x.reshape(t, -1), cfg)[2] < cap
    sync(torch, dev)
    secs = time.perf_counter() - t0
    np.save(path, y.cpu().numpy())
    np.save(path.with_suffix(".keep.npy"), keep.cpu().numpy())
    nums = dict(tokens=t, capacity=cap, dropped=int((~keep).sum()), seconds=secs,
                param_bytes=sum(q.numel() * q.element_size() for q in p.parameters()))
    del p, x, y
    torch.cuda.empty_cache()
    return nums


def _moe_2rank(np, torch, dev, dmesh, ref: Path) -> dict:
    """This rank's slab of the [mesh 2 ranks] MoE layer (E / 2 experts): the
    sharded ``moe`` on it, every rank's output against the one-rank
    layer's (``moe_one_rank``) within LM_PREFILL_TOL, the kept set equal,
    and this rank's three expert products on a buffer of as many rows as
    the largest kept count among its slab's experts."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    class BmmShapes(TorchDispatchMode):
        """The first operand's shape of each ``bmm`` on this rank's tensors."""

        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func is torch.ops.aten.bmm.default:
                self.shapes.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    cfg = moe_layer_cfg(torch)
    p, x = moe_layer(torch, cfg, dev, dmesh)
    t = x.shape[0] * x.shape[1]
    cap = L.moe_capacity(t, cfg.num_experts, cfg.moe_top_k)
    xd = sh.place(x, sh.batch_sharding(dmesh, 3))
    sync(torch, dev)
    t0 = time.perf_counter()
    with torch.no_grad(), sh.implicit_replication():
        with BmmShapes() as rec:
            y = L.moe(p, xd, cfg)
        sync(torch, dev)
        secs = time.perf_counter() - t0
        _, experts, pos = L.moe_route(p, xd.reshape(t, -1), cfg)
    experts, keep = experts.full_tensor().reshape(-1), pos.full_tensor() < cap
    want = torch.from_numpy(np.load(ref)).to(dev)
    want_keep = torch.from_numpy(np.load(ref.with_suffix(".keep.npy"))).to(dev)
    check(all(not pl.is_partial() and not pl.is_shard() for pl in y.placements),
          f"[mesh 2 ranks] MoE output placed {y.placements}")
    check(torch.equal(keep, want_keep), f"[mesh 2 ranks] MoE: {int((keep != want_keep).sum())} choices "
                                        f"kept differently from the one-rank layer")
    err = close_report(torch, y.to_local(), want, what="[mesh 2 ranks] MoE layer at 1x2 vs the one-rank "
                                                       "layer", **LM_PREFILL_TOL)
    n = cfg.num_experts // dmesh.size(dmesh.mesh_dim_names.index("model"))
    first = dmesh.get_local_rank("model") * n
    here = experts[keep & (experts >= first) & (experts < first + n)] - first
    rows = int(torch.bincount(here, minlength=n).max())
    check(len(rec.shapes) == 3 and all(shp[:2] == (n, rows) for shp in rec.shapes),
          f"[mesh 2 ranks] MoE products on {rec.shapes}, expected ({n}, {rows}, ...)")
    return dict(experts_here=[first, first + n], buffer_rows=rows, capacity=cap,
                dropped=int((~keep).sum()), max_abs_vs_one_rank=err, seconds=secs,
                slab_bytes=sum(q.to_local().numel() * q.to_local().element_size()
                               for q in (p.w_gate, p.w_in, p.w_out)))


def band_layer_cfg(torch):
    """[mesh 2 ranks]'s windowed attention layer: LM_ARCH's attention at full
    width with ``block_local_attn`` and MESH_BAND_KV_HEADS KV heads,
    float32 compute."""
    return lm_config().replace(kv_heads=MESH_BAND_KV_HEADS, compute_dtype=torch.float32)


def _band_2rank(np, torch, dev, dmesh) -> dict:
    """One windowed attention layer (``band_layer_cfg``) on the same seed-0
    weights and input on this rank alone and with its parameters placed
    on the 1x2 mesh: there the query heads split over ``model`` and the
    one KV head is whole, so each rank projects the KV head its own query
    heads read (``sharding.own_kv_heads``) and K5 runs once on each rank
    on its 8 heads with that head's keys and values; the output (one
    all-reduce of the row-parallel product) within LM_PREFILL_TOL of the
    one-rank layer's."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as sh

    cfg = band_layer_cfg(torch)
    window = next(bd.window for bd in cfg.layer_defs() if bd.window)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = L.Attention(cfg, dev)
    p.reset_parameters(gen)
    x = torch.randn((MESH_BAND_BATCH, LM_PROMPT, cfg.d_model), generator=gen, device=dev)
    pos = torch.arange(LM_PROMPT, dtype=torch.int32, device=dev).expand(MESH_BAND_BATCH, LM_PROMPT)
    calls, own, saved = [], [], (L.banded_attention, sh.own_kv_heads)

    def recorded(q, k, v, w):
        calls.append([list(q.shape), list(k.shape)])
        return saved[0](q, k, v, w)

    def counted(*args):
        out = saved[1](*args)
        own.append(list(out.to_local().shape))
        return out

    with torch.no_grad():
        zero_counts()
        want = L.attention(p, x, cfg=cfg, positions=pos, window=window)
        one_rank = read_counts()["banded_attention_kernel"]
        sh.distribute_params(cfg, dmesh, p)
        xd = sh.place(x, sh.batch_sharding(dmesh, 3))
        L.banded_attention, sh.own_kv_heads = recorded, counted
        try:
            zero_counts()
            sync(torch, dev)
            t0 = time.perf_counter()
            with sh.implicit_replication():
                y = L.attention(p, xd, cfg=cfg, positions=pos, window=window).full_tensor()
            sync(torch, dev)
            secs = time.perf_counter() - t0
        finally:
            L.banded_attention, sh.own_kv_heads = saved
        launches = read_counts()["banded_attention_kernel"]
    heads = cfg.q_heads // dmesh.size(dmesh.mesh_dim_names.index("model"))
    local = [MESH_BAND_BATCH, LM_PROMPT, heads, cfg.head_dim]
    check(one_rank == 1 and launches == 1, f"[mesh 2 ranks] windowed layer: K5 launched {one_rank} times "
                                           f"on one rank, {launches} on the mesh")
    check(calls == [[local, local]], f"[mesh 2 ranks] windowed layer: K5 on local q, k {calls}")
    check(own == [local, local], f"[mesh 2 ranks] windowed layer: own_kv_heads gave {own}")
    err = close_report(torch, y, want, what="[mesh 2 ranks] windowed layer at 1x2 vs the one-rank layer",
                       **LM_PREFILL_TOL)
    return dict(kv_heads=cfg.kv_heads, local_q_k=calls[0], k5_launches=launches, window=window,
                max_abs_vs_one_rank=err, seconds=secs)


def _mesh_rank(rank, world_size, device_type, moe_ref):
    """One rank of [mesh 2 ranks]: on the card both ranks use CUDA device 0.
    ``moe_ref``: the one-rank MoE layer's output (``moe_one_rank``)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as M

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out = {"backend": dist.get_backend()}
    seq = M.device_mesh(M.make_mesh((1, 2), ("data", "model")), dev.type)
    out["flash"] = _flash_2rank(np, torch, dev, seq)
    out["decode"] = _decode_2rank(np, torch, dev, seq)
    out["moe"] = _moe_2rank(np, torch, dev, seq, Path(moe_ref))
    out["band"] = _band_2rank(np, torch, dev, seq)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["allreduce"] = _allreduce_2rank(np, torch, dev, rank)
    data = M.device_mesh(M.make_mesh((2, 1), ("data", "model")), dev.type)
    out["stager"] = _stager_2rank(np, torch, dev, data)
    return out


def mesh_2rank_phase(np, torch, smi, tmp: Path, device_type: str = "cuda", rank_fn=_mesh_rank) -> dict:
    """[mesh 2 ranks]: two gloo ranks on the one card, the backend passed
    explicitly (NCCL refuses two ranks on one device; gloo carries CUDA
    tensors for all_reduce, which flash decode, the plain decode with
    whole parameters, the MoE at 1x2 and the compressed all-reduce use;
    the split stager gathers its results on the host; its all-gather of a
    CUDA tensor kills the process, so the paths that need one are held on
    the CPU and logged so): ``_flash_2rank``, ``_decode_2rank``, ``_moe_2rank`` (against
    ``moe_one_rank``, run here first), ``_allreduce_2rank`` and
    ``_stager_2rank`` on each rank. Returns the numbers and each rank's
    launches."""
    from repro_torch.launch import mesh as M

    log("[mesh 2 ranks] the decode with DTensor parameters (the query's heads gathered over model), "
        "mamba2-780m's SSD decode (its convolution's output gathered over model) and the FSDP decode's "
        "row exchange (all-to-all, reduce-scatter, all-gather over data) need collectives other than "
        "all_reduce, and all_gather_into_tensor kills a gloo rank on a CUDA tensor (signal 11): they "
        "are held on the CPU in tests/test_torch_decode_mesh.py and tests/test_torch_fsdp_decode.py, "
        "not here")
    dev = torch.device(device_type, 0) if device_type == "cuda" else torch.device(device_type)
    moe_ref = tmp / "moe_one_rank.npy"
    one_rank = moe_one_rank(np, torch, dev, moe_ref)
    note = xmodel_note(moe_layer_cfg(torch), MESH_MOE_ARCH)
    log(f"[mesh 2 ranks] the one-rank MoE layer: {MESH_MOE_ARCH} at full width ({note}), bf16 "
        f"parameters, float32 compute, {MESH_MOE_BATCH} x {LM_PROMPT} tokens: {json.dumps(one_rank)}")
    t1 = time.perf_counter()
    ranks = M.run_world(rank_fn, 2, "gloo", tmp / "gloo", args=(device_type, str(moe_ref)),
                        timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t1
    for r, out in enumerate(ranks):
        check(out["backend"] == "gloo", f"[mesh 2 ranks] rank {r} ran on {out['backend']}")
        log(f"[mesh 2 ranks] rank {r} (backend {out['backend']}, passed explicitly): flash decode "
            f"{json.dumps(out['flash'])}; plain decode on split caches {json.dumps(out['decode'])}; "
            f"MoE at 1x2 {json.dumps(out['moe'])}; windowed layer at 1x2 with "
            f"{MESH_BAND_KV_HEADS} KV head (cut from 8) {json.dumps(out['band'])}; compressed all-reduce "
            f"{json.dumps(out['allreduce'])}; split stager {json.dumps(out['stager'])}")
    nums = dict(gloo_all_gather="held on the CPU", backend="gloo", wall_s=wall,
                moe_one_rank=one_rank, ranks=ranks)
    log(f"[summary mesh 2 ranks] {smi}: two gloo ranks on one card in {wall} s; flash decode, plain "
        f"decode on split caches, the MoE layer at 1x2, the windowed layer on own KV heads, the "
        f"compressed all-reduce and the split stager held on both")
    return nums


def dryrun_mesh_phase(smi, tmp: Path, runs: dict) -> dict:
    """[dryrun mesh]: the dry run's sharded step on DRYRUN_MESH_CELLS and
    the PDF window step on DRYRUN_PDF_MESH_CELLS, each in a fake world of
    the mesh's size: one of each through its command line (``python -m
    repro_torch.launch.dryrun`` / ``dryrun_pdf``, started by ``start_dryruns``),
    the other through ``run_cell`` / ``run_pdf_cell`` here meanwhile. Each
    one's wall, its collectives and collective term. A failed cell fails
    the phase."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun, dryrun_pdf
    from repro_torch.launch.mesh import make_production_mesh

    out = {}

    def cli(label):
        _, wall = runs[label].result()
        recs = [json.loads(f.read_text()) for f in sorted(dryrun_dir(tmp, label).glob("*.json"))]
        check(len(recs) == 1 and recs[0].get("ok"), f"[dryrun mesh] {label}: {recs}")
        return recs[0], wall

    def in_process(run):
        t0 = time.perf_counter()
        rec = run()
        return rec, time.perf_counter() - t0

    def record(label, rec, wall):
        out[label] = dict(wall_s=wall, mesh=rec["mesh"], collective_ops=rec["collective_ops"],
                          collective_traffic_per_device=rec["collective_traffic_per_device"],
                          terms_seconds=rec["terms_seconds"], flops_per_device=rec["flops_per_device"],
                          bytes_per_device=rec["bytes_per_device"])
        if "moe_dispatch" in rec:
            out[label]["moe_dispatch"] = rec["moe_dispatch"]
        log(f"[dryrun mesh] {label}: {json.dumps(out[label])}")

    through_cli = []
    for arch, shape, multi_pod, by_cli in DRYRUN_MESH_CELLS:
        mesh = make_production_mesh(multi_pod=multi_pod)
        label = f"{arch} {shape} {'x'.join(map(str, mesh.shape))} {'cli' if by_cli else 'run_cell'}"
        if by_cli:
            through_cli.append(label)
        else:
            record(label, *in_process(lambda: dryrun.run_cell(registry.get(arch), SHAPES[shape], mesh,
                                                               verbose=False)))
    for variant, shape, multi_pod, by_cli in DRYRUN_PDF_MESH_CELLS:
        mesh = make_production_mesh(multi_pod=multi_pod)
        label = (f"pdf {variant} {shape} {'x'.join(map(str, mesh.shape))} "
                 f"{'cli' if by_cli else 'run_pdf_cell'}")
        if by_cli:
            through_cli.append(label)
        else:
            record(label, *in_process(lambda: dryrun_pdf.run_pdf_cell(variant, shape, verbose=False,
                                                                       mesh=mesh)))
    for label in through_cli:
        record(label, *cli(label))
    one, wall = cli(DRYRUN_BOUND_LABEL)
    out["bounds"] = dryrun_mesh_bounds(out, one["flops_per_device"], wall)
    log(f"[summary dryrun mesh] {smi}: {json.dumps(out)}")
    return out


def wq_gather_bytes(cfg, mesh) -> float:
    """The collective bytes a device of ``mesh`` would move all-gathering
    every attention layer's ``wq`` over ``data`` (FSDP's gather), its
    heads as ``make_pspecs`` places them over ``model`` (whole where they
    do not divide): the ring model of ``roofline.collective_traffic``."""
    from repro_torch.launch import roofline as rl

    m = mesh.axis_sizes["model"]
    heads = cfg.q_heads // m if cfg.q_heads % m == 0 else cfg.q_heads
    layers = sum(1 for bd in cfg.layer_defs() if bd.mixer in ("attn", "hybrid", "cross_attn"))
    whole = cfg.d_model * heads * cfg.head_dim * cfg.param_dtype.itemsize
    return layers * rl.collective_traffic("all-gather", whole, mesh.axis_sizes["data"])


def own_kv_flops(cfg, shape, mesh) -> float:
    """The FLOPs a device of ``mesh`` spends in a training step on K and V
    products beyond its share of them when the KV heads do not divide
    ``model``: each model rank projects the KV heads its own query heads
    read (query head h reads KV head h // (H / KV)), own / KV of its data
    shard's K and V products against the share 1 / model, in each of the
    step's passes (the forward, its recompute under remat ``full``, the
    backward's dx and dW)."""
    m = mesh.axis_sizes["model"]
    tokens = shape.global_batch // mesh.axis_sizes["data"] * shape.seq_len
    own = len({h // (cfg.q_heads // cfg.kv_heads) for h in range(cfg.q_heads // m)})
    passes = 4 if cfg.remat == "full" else 3
    layers = sum(1 for bd in cfg.layer_defs() if bd.mixer in ("attn", "hybrid"))
    products = 2 * 2 * tokens * cfg.d_model * cfg.kv_heads * cfg.head_dim  # K and V, 2 FLOPs a MAC
    return layers * passes * products * (own / cfg.kv_heads - 1 / m)


def dryrun_mesh_bounds(out: dict, one: int, wall: float) -> dict:
    """[dryrun mesh]'s two counts against bounds from the configs' shapes:
    arctic-480b ``decode_32k``'s collective bytes a device below
    ``wq_gather_bytes`` (its decode moves the tokens' rows, not the FSDP
    blocks), and granite-3-8b ``train_4k``'s FLOPs a device equal to
    ``one``, its count on one card (DRYRUN_BOUND_LABEL's command line,
    ``wall`` s), over the mesh's size plus ``own_kv_flops``."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=False)
    text = "x".join(map(str, mesh.shape))
    arctic = out[f"arctic-480b decode_32k {text} run_cell"]["collective_traffic_per_device"]
    bound = wq_gather_bytes(registry.get("arctic-480b"), mesh)
    check(arctic < bound, f"[dryrun mesh] arctic-480b decode_32k moves {arctic} B a device, not below "
                          f"the {bound} B of gathering wq over data")
    cfg, shape = registry.get(DRYRUN_BOUND_CELL[0]), SHAPES[DRYRUN_BOUND_CELL[1]]
    want = one / mesh.size + own_kv_flops(cfg, shape, mesh)
    got = out[f"{cfg.name} {shape.name} {text} run_cell"]["flops_per_device"]
    check(abs(got - want) <= 1e-9 * want, f"[dryrun mesh] granite-3-8b train_4k: {got} FLOPs a device, "
                                          f"the share and own KV heads' term give {want}")
    nums = dict(arctic_decode_bytes=arctic, arctic_wq_gather_bytes=bound, granite_train_flops=got,
                granite_1x1_flops=one, granite_own_kv_flops=own_kv_flops(cfg, shape, mesh),
                granite_1x1_wall_s=wall)
    log(f"[dryrun mesh] bounds from the configs' shapes: {json.dumps(nums)}")
    return nums


# Every phase's wall, in the order run ([phase] lines, the [phases] summary).
T_START = time.perf_counter()
PHASE_WALLS: dict[str, float] = {}


def phase(label: str, fn, *args, **kwargs):
    """Run one phase of ``main`` and log its wall as ``[phase] <label> <s>``
    (also when it fails)."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        PHASE_WALLS[label] = time.perf_counter() - t0
        log(f"[phase] {label} {PHASE_WALLS[label]}")


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
    phase("build", _build.build, *KERNEL_SOURCES)
    log(f"[build] csrc/{{{','.join(KERNEL_SOURCES)}}}.cu, one nvcc each, all at once, with "
        f"{' '.join(_build.NVCC_FLAGS)} into {_build.BUILD_DIR.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0} s")

    sim = SeismicSimulation()  # Set1: CubeGeometry(501, 501, 251), 1,000 observations
    cases = phase("kernel cases", kernel_cases, np, sim, SET1_SLICE)
    worst_k1, err_k2 = phase("compare K1 K2", compare_kernels, np, torch, cases, dev)
    worst_k3, err_rows = phase("compare K3 K4 rows", compare_new_kernels, np, torch, cases, dev)

    # The load stage (pinned staging), then a file cube of the slice, a fault
    # plan over it and the scheduler's shard re-deal, in a temporary
    # directory under build/ deleted at the end.
    clean, staging_nums = phase("staging", staging_phase, np, torch, sim, SET1_SLICE, dev)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp_name:
        tmp = Path(tmp_name)
        cube_path, file_nums = phase("file", file_phase, np, torch, sim, SET1_SLICE, dev, clean,
                                     tmp)
        fault_nums, faults_res = phase("faults", faults_phase, np, torch, cube_path, dev, clean,
                                       tmp)
        api_launches = phase("api faults", api_faults_phase, np, torch, cube_path, dev, tmp,
                             fault_nums, faults_res)
        sched_nums = phase("scheduler", scheduler_phase, np, torch, sim, dev, tmp)
        # Streaming on the cube (it appends to it, so after every other
        # user), then multi-process cluster runs of run_pdf.
        stream_cluster_launches, stream_nums = phase(
            "stream", stream_phase, np, torch, cube_path, dev, clean, tmp,
            file_nums["file"]["wall_s"])
        cluster_launches, cluster_nums = phase("cluster", cluster_phase, np, torch, dev, tmp)
        stream_cluster_launches.update(cluster_launches)
    del clean, faults_res
    exec_launches = {"faults": fault_nums["launches"], "scheduler": sched_nums["launches"]}
    log(f"[summary executor] {smi}: Set1 slice {SET1_SLICE}; staging {json.dumps(staging_nums)}; "
        f"file {json.dumps(file_nums)}; faults {json.dumps(fault_nums)}; scheduler "
        f"{json.dumps(sched_nums)}")

    launches4, wall4 = phase("slice 4 types L64", run_slice_phase, np, torch, sim, SET1_SLICE,
                             dists.TYPES_4, 64, dev, SET1_WINDOWS)
    launches10, wall10 = phase("slice 10 types L20", run_slice_phase, np, torch, sim, SET1_SLICE,
                               dists.TYPES_10, 20, dev, SET1_WINDOWS)

    launches_k, launches_rows, walls = phase("grouped", grouped_phases, np, torch, sim,
                                             SET1_SLICE, dev)

    # Past the bins one block of K2 or K4 held before the chunked route, then
    # past the bins one K2 block holds.
    launches1000, wall1000 = phase("slice 4 types L1000", run_slice_phase, np, torch, sim,
                                   SET1_SLICE, dists.TYPES_4, 1000, dev, SET1_WINDOWS)
    walls["baseline_fused_L1000"] = wall1000
    launches2000, walls["baseline_fused_L2000"] = phase(
        "slice 4 types L2000", run_slice_phase, np, torch, sim, SET1_SLICE, dists.TYPES_4, 2000,
        dev, SET1_WINDOWS)
    phase("kernels window L2000", kernels_window_phase, np, torch,
          torch.from_numpy(cases[0][1]).to(dev), 2000, dev)

    # The ML and sampling methods, with the tree of TreeSpec's defaults.
    tree, tree_nums = phase("tree", train_phase, np, torch, sim, dev)
    ml_launches, ml_walls, ml_nums = phase("ml sampling", ml_phases, np, torch, sim, SET1_SLICE,
                                           dev, tree)
    batch_launches, batch_nums = phase("batch", batch_phase, np, torch, sim, dev, tree)
    exec_launches.update(batch_launches)
    log(f"[summary batch] {smi}: {json.dumps(batch_nums)}")

    # The declarative API (PDFSession, the result cache, run_pdf) and the
    # PDF query server over the paper's Set1 spec, in a temporary directory
    # under build/ deleted at the end.
    spec = to_spec(SET1)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp_name:
        tmp = Path(tmp_name)
        launches_api, api_nums = phase("api", api_phase, np, torch, spec, sim, dev, tree, tmp)
        launches_serve, serve_nums = phase("serve", pdf_serve_phase, np, torch, spec, dev, tmp,
                                           [SET1_SLICE - 1, SET1_SLICE])
    # The launchers as commands, the port's CI sequences, each on cuda by
    # the launcher's own default.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp_name:
        phase("cli", cli_phase, np, Path(tmp_name))
    api_launches.update(launches_api)
    api_launches.update(launches_serve)
    log(f"[summary api] {smi}: {json.dumps(api_nums)}")
    log(f"[summary serve] {smi}: {json.dumps(serve_nums)}")
    phase("profile grouping_ml", profile_slice, torch, PDFConfig(method="grouping_ml", num_bins=20),
          "set1 grouping_ml L20", sim, SET1_SLICE, dev, ml_walls["set1 grouping_ml L20"], tree=tree)
    log(f"[summary ml] {smi}: Set1 slice {SET1_SLICE}; tree {json.dumps(tree_nums)}; wall_s "
        f"{json.dumps(ml_walls)}; launches {json.dumps(ml_launches)}; {json.dumps(ml_nums)}")

    for label, cfg, wall in (
            ("baseline fused", PDFConfig(), wall4),
            ("grouping kernels", PDFConfig(method="grouping", fit_backend="kernels"),
             walls["grouping_kernels"]),
            ("grouping fused device", PDFConfig(method="grouping", select_backend="device"),
             walls["grouping_fused_device"])):
        phase(f"profile {label}", profile_slice, torch, cfg, label, sim, SET1_SLICE, dev, wall)

    x = torch.from_numpy(cases[0][1]).to(dev)  # a Set1 window, (6275, 1000)
    rows = phase("time K1 K2", time_kernels, np, torch, x, dev, launches4, worst_k1, err_k2)
    rows += phase("time K3 K4 rows", time_new_kernels, np, torch, x, dev, launches_k, launches_rows,
                  worst_k3, err_rows)
    large = phase("time large L", time_large_bins, np, torch, x, dev)
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

    # The LM serving path: gemma3-12b (dense), then mamba2-780m (SSM),
    # hymba-1.5b (hybrid), seamless-m4t-medium (enc-dec), llama-3.2-vision-90b
    # (VLM), arctic-480b and kimi-k2-1t (MoE), each model freed before the
    # next.
    draws, err_k5 = phase("compare K5", compare_band_attn, np, torch, dev)
    launches_lm, nums_lm, profs = {}, {}, {}
    phases = [(label, lambda fn=fn: fn(np, torch, dev, smi))
              for label, fn in (("lm", serve_phase), ("lm ssm", ssm_phase),
                                ("lm hybrid", hybrid_phase))]
    phases += [(spec[0], lambda spec=spec: xmodel_phase(np, torch, dev, smi, *spec))
               for spec in XMODEL_PHASES]
    for label, run in phases:
        model, cfg, prompt, extras, launches_lm[label], nums_lm[label] = phase(label, run)
        profs[label] = phase(f"profile {label}", profile_lm, torch, model, cfg, prompt, dev,
                             nums_lm[label]["prefill_s"], nums_lm[label]["decode_ms_per_token"],
                             label, extras)
        del model, prompt, extras
        torch.cuda.empty_cache()
        log(f"[summary {label}] {smi}: {cfg.name}: {json.dumps(nums_lm[label])}; profile "
            f"{json.dumps(profs[label])}")
    # The training path: hymba-1.5b at full width and 8 layers, its gradients
    # against the plain path, every reduced config on the card.
    launches_train, nums_train = {}, {}
    launches_train["train hymba"], nums_train["train hymba"] = phase(
        "train hymba", train_hymba_phase, np, torch, dev, smi)
    torch.cuda.empty_cache()
    launches_train["train hymba grad"], nums_train["train hymba grad"] = phase(
        "train hymba grad", train_grad_phase, np, torch, dev, smi, nums_train["train hymba"]["batch"])
    launches_train["train reduced"], nums_train["train reduced"] = phase(
        "train reduced", train_reduced_phase, np, torch, dev, smi)
    for label, n in nums_train.items():
        log(f"[summary {label}] {smi}: {json.dumps(n)}")
    # The accounting layer, on the host only: its command lines started at
    # once, then, beside them, the dry run of the measured LM runs and the
    # production meshes' cells that run in this process.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp_name:
        tmp = Path(tmp_name)
        runs = start_dryruns(tmp)
        nums_roofline = phase("roofline lm", roofline_lm_phase, smi, nums_lm, nums_train)
        log(f"[summary roofline lm] {smi}: {json.dumps(nums_roofline)}")
        phase("dryrun mesh", dryrun_mesh_phase, smi, tmp, runs)
        phase("dryrun", dryrun_phase, smi, tmp, runs)

    # The multi-device half: a one-rank NCCL world, two gloo ranks on the
    # card.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp_name:
        tmp = Path(tmp_name)
        nums_mesh = {"mesh 1x1": phase("mesh 1x1", mesh_1x1_phase, np, torch, dev, smi, tmp),
                     "mesh 2 ranks": phase("mesh 2 ranks", mesh_2rank_phase, np, torch, smi, tmp)}
    for r in rows:  # K1-K4: each rank's launches in the split stager's windows
        r["launches_mesh"] = {f"mesh 2 ranks stager rank {i}": out["stager"]["launches"][r["name"]]
                              for i, out in enumerate(nums_mesh["mesh 2 ranks"]["ranks"])
                              if out["stager"]["launches"][r["name"]]}

    row = phase("time K5", time_band_attn, np, torch, draws[K5_GEMMA], dev, launches_lm["lm"],
                err_k5[K5_GEMMA])
    at_hymba = phase("time K5 hymba", time_band_attn, np, torch, draws[K5_HYMBA], dev,
                     launches_lm["lm hybrid"], err_k5[K5_HYMBA])
    row["at_hymba_shape"] = {k: v for k, v in at_hymba.items()
                             if k not in ("name", "route", "source", "replaces")}
    row["launches_lm_paths"] = {label: n["banded_attention_kernel"] for label, n in launches_lm.items()}
    row["launches_train"] = {label: n["banded_attention_kernel"] for label, n in launches_train.items()}
    row["launches_mesh"] = {"mesh 1x1 sharded step": nums_mesh["mesh 1x1"]["train"]["k5_per_step"]}
    hymba_train = nums_train["train hymba"]
    row["train_hymba"] = dict(batch=hymba_train["batch"], step_s=hymba_train["step_s"],
                              k5_ms_in_step=hymba_train["profile"].get("k5_ms"),
                              banded_backward_ms=hymba_train["banded_backward_ms"])
    rows.append(row)
    rows.append(phase("ssd intra", ssd_intra_phase, np, torch, dev, smi, launches_lm, launches_train))

    log(f"[phases] {smi}: {len(PHASE_WALLS)} phases {sum(PHASE_WALLS.values())} s of "
        f"{time.perf_counter() - T_START} s since the script started; wall s "
        f"{json.dumps(PHASE_WALLS)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
