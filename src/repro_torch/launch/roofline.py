"""Roofline accounting for one NVIDIA H100: the card's peaks, the step terms
and every work count the port's bounds are taken from.

Port of ``repro.launch.roofline``. The reference carries TPU v5e constants
and reads collective traffic out of XLA's post-SPMD HLO text; the port has
no HLO. What it keeps:

* the H100's published peaks (below);
* ``Roofline`` / ``make_roofline`` and the model-FLOP counts
  (``model_flops_{train,prefill,decode}``, ``active_param_count``,
  ``total_param_count``, ``_full_attn_layers``), copied unchanged;
* ``CollectiveStats`` and the ring model's per-device traffic of one
  collective (``collective_traffic``), which prices the collectives the
  dry run counts in a sharded step (``launch/dryrun.py``'s ``LocalMeter``
  beside DTensor's ``CommDebugMode``);
* the work models of the hand-written kernels K1-K6, as functions of shapes
  (``k1_work`` ... ``k5_work``, ``ssd_intra_work``; ``special_function_ops``
  counts K2's float64 work on given data) and ``bound_ms``: the least time the card
  could take for that work. ``chip_smoke.py`` prints each kernel's time
  beside this bound, and ``launch/dryrun.py`` charges a kernel launched on
  meta tensors by its work model.

Terms (seconds, per step), as in the reference:
  compute    = FLOPs / (chips x peak)
  memory     = bytes / (chips x HBM rate)
  collective = per-device link traffic / link rate
               (ring model: all-gather (n-1)/n x result, all-reduce
                2(n-1)/n x, reduce-scatter (n-1) x the scattered shard,
                all-to-all (n-1)/n x, collective-permute 1x)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

# NVIDIA H100 SXM5 80 GB data sheet: dense rates (no sparsity) at the full
# 700 W power limit.
PEAK_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
F32_FLOPS = 67e12  # float32 outside the tensor cores
F64_FLOPS = 34e12  # float64 outside the tensor cores
HBM_BW = 3.35e12  # HBM3, bytes/s
HBM_BYTES = 80e9  # device memory
LINK_BW = 450e9  # NVLink 4: 900 GB/s per card in both directions, bytes/s one way


@dataclass
class CollectiveStats:
    per_device_traffic_bytes: float = 0.0
    op_counts: dict = field(default_factory=dict)
    op_traffic: dict = field(default_factory=dict)

    def add(self, op: str, traffic: float):
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        self.op_traffic[op] = self.op_traffic.get(op, 0.0) + traffic
        self.per_device_traffic_bytes += traffic


def collective_traffic(op: str, result_bytes: float, group_size: int) -> float:
    """Per-device link traffic of one collective from its result's bytes on
    one device (the gathered buffer of an all-gather, the scattered shard of
    a reduce-scatter), ring model:

      all-gather          result x (n-1)/n
      all-reduce          2 x result x (n-1)/n
      reduce-scatter      result x (n-1)
      all-to-all          result x (n-1)/n
      collective-permute  result

    A group of one device or an empty result moves nothing."""
    n = max(group_size, 1)
    if n == 1 or result_bytes == 0:
        return 0.0
    if op == "all-gather":
        return result_bytes * (n - 1) / n
    if op == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if op == "reduce-scatter":
        return float(result_bytes) * (n - 1)
    if op == "all-to-all":
        return result_bytes * (n - 1) / n
    if op == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {op!r}")


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_global: float
    bytes_global: float
    collective_traffic_per_device: float
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / counted FLOPs

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful compute time / achievable step time: how close the step is
        to the compute roofline if perfectly overlapped."""
        if self.bound_s <= 0:
            return 0.0
        ideal = self.model_flops / (PEAK_FLOPS * self._chips)
        return ideal / self.bound_s

    _chips: int = 1


def make_roofline(
    flops_per_device: float,
    bytes_per_device: float,
    coll: CollectiveStats,
    chips: int,
    model_flops: float,
) -> Roofline:
    flops_global = flops_per_device * chips
    bytes_global = bytes_per_device * chips
    r = Roofline(
        compute_s=flops_global / (chips * PEAK_FLOPS),
        memory_s=bytes_global / (chips * HBM_BW),
        collective_s=coll.per_device_traffic_bytes / LINK_BW,
        flops_global=flops_global,
        bytes_global=bytes_global,
        collective_traffic_per_device=coll.per_device_traffic_bytes,
        model_flops=model_flops,
        useful_ratio=model_flops / flops_global if flops_global else 0.0,
    )
    r._chips = chips
    return r


def model_flops_train(cfg, tokens: int) -> float:
    """6*N_active*D for one training step (fwd+bwd)."""
    n = active_param_count(cfg)
    return 6.0 * n * tokens


def model_flops_decode(cfg, batch: int, context: int) -> float:
    """2*N_active per token forward + attention reads over the context."""
    n = active_param_count(cfg)
    flops = 2.0 * n * batch
    # attention over cached context (full-attn layers only)
    attn_layers = _full_attn_layers(cfg)
    flops += 4.0 * attn_layers * batch * context * cfg.kv_heads * cfg.head_dim
    return flops


def model_flops_prefill(cfg, batch: int, seq: int) -> float:
    n = active_param_count(cfg)
    return 2.0 * n * batch * seq


def _full_attn_layers(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.dec_layers * 2
    total = 0
    for bd in cfg.prefix:
        if bd.mixer in ("attn", "hybrid", "cross_attn") and bd.window is None:
            total += 1
    reps = cfg.num_repeats
    for bd in cfg.pattern:
        if bd.mixer in ("attn", "hybrid", "cross_attn") and bd.window is None:
            total += reps
    return total


def active_param_count(cfg) -> float:
    """Active (per-token) parameter count: MoE counts top_k of num_experts."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    attn = d * (cfg.q_heads + 2 * cfg.kv_heads) * cfg.head_dim + cfg.q_heads * cfg.head_dim * d

    def ssm_params():
        d_inner = cfg.ssm_expand * d
        h = d_inner // cfg.ssm_head_dim if cfg.ssm_head_dim else 0
        gn = cfg.ssm_groups * cfg.ssm_state
        return d * (2 * d_inner + 2 * gn + h) + d_inner * d

    def block_params(bd) -> float:
        p = 0.0
        if bd.mixer in ("attn", "cross_attn"):
            p += attn
        elif bd.mixer == "ssm":
            p += ssm_params()
        elif bd.mixer == "hybrid":
            p += attn + ssm_params()
        if bd.ffn == "dense":
            p += 3 * d * ff
        elif bd.ffn == "moe":
            p += cfg.moe_top_k * 3 * d * ff + d * cfg.num_experts
            p += 3 * d * cfg.moe_shared_ff
        elif bd.ffn == "moe_dense":
            p += cfg.moe_top_k * 3 * d * ff + d * cfg.num_experts + 3 * d * ff
        return p

    if cfg.family == "encdec":
        enc = cfg.enc_layers * (attn + 3 * d * ff)
        dec = cfg.dec_layers * (2 * attn + 3 * d * ff)
        return enc + dec + 2 * d * v
    total = sum(block_params(bd) for bd in cfg.prefix)
    total += cfg.num_repeats * sum(block_params(bd) for bd in cfg.pattern)
    return total + 2 * d * v


def total_param_count(cfg) -> float:
    """Total stored parameters (MoE counts all experts)."""
    if not cfg.num_experts:
        return active_param_count(cfg)
    extra = (cfg.num_experts - cfg.moe_top_k) * 3 * cfg.d_model * cfg.d_ff
    per_moe_layer_extra = extra
    moe_layers = sum(1 for bd in cfg.pattern if bd.ffn in ("moe", "moe_dense"))
    return active_param_count(cfg) + cfg.num_repeats * moe_layers * per_moe_layer_extra


# ---------------------------------------------------------------------------
# The hand-written kernels' work and its bound
# ---------------------------------------------------------------------------


class Work(NamedTuple):
    """What one kernel call must do: bytes moved (each input read once,
    each output written once) and operations by the units that run them."""

    bytes: int
    f32_ops: int = 0  # float32, CUDA cores
    f64_ops: int = 0  # float64, CUDA cores
    bf16_ops: int = 0  # bf16, tensor cores


def bound_ms(bytes_moved: int, f32_ops: int = 0, f64_ops: int = 0,
             bf16_ops: int = 0) -> tuple[float, str]:
    """The least time for the work, in ms: bytes over the HBM rate, or the
    operations of each type over their peak, whichever is largest; and
    which of the two bounds it. ``bound_ms(*work)`` takes a ``Work``."""
    t_bytes = bytes_moved / HBM_BW * 1e3
    t_ops = max(f32_ops / F32_FLOPS, f64_ops / F64_FLOPS, bf16_ops / PEAK_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(p: int, n: int, num_bins: int) -> Work:
    """K1 ``moments_edges_stats``: the (P, n) float32 window read once, the
    (P, 8) stats and (P, L+1) edges written once; ~10 float32 operations a
    value (shift, three products, four sums, min, max)."""
    return Work(4 * (p * n + 8 * p + p * (num_bins + 1)), 10 * p * n)


def k2_work(p: int, n: int, types: int, num_bins: int, rows: int | None = None,
            f64_ops: int = 0) -> Work:
    """K2 ``fit_error_counts`` over G = ``rows`` rows of a (P, n) window (G =
    P without ``row_indices``): the G rows, their vmin, vmax, edges and
    params read once (and the int64 indices with ``rows``), the (G, T)
    errors written once. float32: 4 a value for its bin, ~30 a CDF
    evaluation, 3 a mass term. float64: the incomplete gamma and beta's
    loops, which depend on the data (``special_function_ops``)."""
    g, t, L = (p if rows is None else rows), types, num_bins
    nbytes = 4 * (g * n + 2 * g + g * (L + 1) + 3 * t * g + t * g)
    if rows is not None:
        nbytes += 8 * g
    return Work(nbytes, 4 * g * n + 30 * g * t * (L + 1) + 3 * g * t * L, f64_ops)


def k3_work(p: int, n: int) -> Work:
    """K3 ``moments_stats``: the window read once, the (P, 8) stats written
    once; ~10 float32 operations a value, as K1."""
    return Work(4 * (p * n + 8 * p), 10 * p * n)


def k4_work(p: int, n: int, num_bins: int) -> Work:
    """K4 ``hist_counts``: the window, vmin and vmax read once, the (P, L)
    counts written once; ~4 float32 operations a value for its bin."""
    return Work(4 * (p * n + 2 * p + p * num_bins), 4 * p * n)


def band_pairs(s: int, w: int) -> int:
    """Valid (query, key) pairs of one (b, h): the sum over i of min(i + 1, w)."""
    return s * (s + 1) // 2 if s <= w else w * (w + 1) // 2 + (s - w) * w


def k5_work(b: int, s: int, h: int, kv: int, hd: int, window: int, dtype) -> Work:
    """K5 ``banded_attention_kernel``: q, k, v read once and the output
    written once, in ``dtype`` (a torch or numpy dtype); 4 hd useful
    operations a valid (query, key) pair (Q K^T and P V), on the tensor
    cores in bf16, on the CUDA cores in float32."""
    itemsize = dtype.itemsize
    nbytes = itemsize * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    ops = 4 * hd * band_pairs(s, window) * b * h
    return Work(nbytes, bf16_ops=ops) if itemsize == 2 else Work(nbytes, f32_ops=ops)


def ssd_intra_work(b: int, nc: int, q: int, h: int, p: int, g: int) -> Work:
    """``ssd_intra_kernel``: xdt (B, Nc, Q, H, P) bf16 read and y_intra of
    the same shape written once, C.B (B, Nc, G, Q, Q) bf16 and the
    log-decays (B, Nc, Q, H) float32 read once; 2 P bf16 tensor-core
    operations a (i, j) pair of the 64 x 64 tiles on and below each
    chunk's diagonal, the tiles the kernel computes."""
    tiles = q // 64
    pairs = tiles * (tiles + 1) // 2 * 64 * 64
    nbytes = 2 * 2 * b * nc * q * h * p + 2 * b * nc * g * q * q + 4 * b * nc * q * h
    return Work(nbytes, bf16_ops=2 * p * pairs * b * nc * h)


# Each wrapper's name -> its work model (launch/dryrun.py's meter).
KERNEL_WORK = {
    "moments_edges_stats": k1_work,
    "fit_error_counts": k2_work,
    "moments_stats": k3_work,
    "hist_counts": k4_work,
    "banded_attention_kernel": k5_work,
    "ssd_intra_kernel": ssd_intra_work,
}


def loop_trips(count, step, max_iter):
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


def special_function_ops(params, edges, types) -> int:
    """Float64 operations K2's incomplete gamma and beta do on these inputs
    (numpy arrays: params (G, 3T), edges (G, L+1)). Each CDF evaluation's
    loop is replayed in float64 as csrc/fitpdf.cu runs it (gammainc_lower,
    betacf) to count its trips; a trip, and the set-up of an evaluation,
    count the operations written in the source, a division or a
    transcendental as one."""
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

                ops += 8 * len(a) + 6 * int(loop_trips(len(sa), series, 4000).sum()) \
                    + 15 * int(loop_trips(len(ca), fraction, 4000).sum())
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

                ops += 14 * len(a) + 37 * int(loop_trips(len(a), betacf, 300).sum())
    return ops
