"""The yardstick: the H100's peaks, K5's work and bound, and the model FLOP
count of a configuration, all from shapes alone.

The peaks, ``band_pairs``, ``k5_work`` and ``bound_ms`` are copies of
``repro_torch/launch/roofline.py`` (kept here so that a change to the
program cannot move the yardstick). ``roofline.model_flops_prefill`` and
``model_flops_train`` count only 2 N D and 6 N D, which leaves out the SSD
and attention; the count here does not:

* every parameter product, 2 FLOPs a multiply-add a token, the LM head
  included (the embedding is a lookup, no product);
* attention over the causal band each query attends: 4 hd FLOPs a (query,
  key) pair and query head (Q K^T and P V);
* the SSD as its recurrence, a token and a head: the state update
  h = exp(dt A) h + (dt x) B^T (a multiply and a multiply-add an entry,
  3 N P) and the read-out y = C h (a multiply-add an entry, 2 N P); the
  chunked form's Q x Q terms depend on a chunk the program picks and are
  not counted;
* the causal convolution, 2 K FLOPs a channel and token;
* training counts 3 x the forward; recomputation under remat is not
  counted.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM5 80 GB data sheet: dense rates (no sparsity) at the full
# 700 W power limit.
PEAK_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
F32_FLOPS = 67e12  # float32 outside the tensor cores
F64_FLOPS = 34e12  # float64 outside the tensor cores
HBM_BW = 3.35e12  # HBM3, bytes/s


class Work(NamedTuple):
    bytes: int
    f32_ops: int = 0
    f64_ops: int = 0
    bf16_ops: int = 0


def bound_ms(bytes_moved: int, f32_ops: int = 0, f64_ops: int = 0,
             bf16_ops: int = 0) -> tuple[float, str]:
    """The least time for the work, in ms: bytes over the HBM rate, or the
    operations of each type over their peak, whichever is largest; and
    which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BW * 1e3
    t_ops = max(f32_ops / F32_FLOPS, f64_ops / F64_FLOPS, bf16_ops / PEAK_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def band_pairs(s: int, w: int | None) -> int:
    """Valid (query, key) pairs of one (b, h): the sum over i of
    min(i + 1, w); causal (s (s + 1) / 2) without a window."""
    if w is None or s <= w:
        return s * (s + 1) // 2
    return w * (w + 1) // 2 + (s - w) * w


def k5_work(b: int, s: int, h: int, kv: int, hd: int, window: int, itemsize: int) -> Work:
    """K5 ``banded_attention_kernel``: q, k, v read once and the output
    written once, ``itemsize`` bytes an entry; 4 hd useful operations a
    valid (query, key) pair, on the tensor cores in bf16 (itemsize 2), on
    the CUDA cores in float32."""
    nbytes = itemsize * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    ops = 4 * hd * band_pairs(s, window) * b * h
    return Work(nbytes, bf16_ops=ops) if itemsize == 2 else Work(nbytes, f32_ops=ops)


def layer_defs(config: dict) -> list[dict]:
    """Every layer's definition in order: ``prefix``, then ``pattern``
    repeated to ``num_layers``."""
    prefix, pattern = config.get("prefix", []), config["pattern"]
    body = config["num_layers"] - len(prefix)
    if body % len(pattern):
        raise ValueError(f"{body} body layers do not divide into the pattern of {len(pattern)}")
    return list(prefix) + list(pattern) * (body // len(pattern))


def ssm_dims(config: dict) -> tuple[int, int, int]:
    """(d_inner, SSM heads, conv channels)."""
    d_inner = config["ssm_expand"] * config["d_model"]
    heads = d_inner // config["ssm_head_dim"]
    return d_inner, heads, d_inner + 2 * config["ssm_groups"] * config["ssm_state"]


def layer_params_matmul(config: dict, layer: dict) -> int:
    """Parameters of one layer that enter a product with every token."""
    d = config["d_model"]
    n = 0
    if layer["mixer"] in ("attn", "hybrid"):
        h, kv, hd = config["q_heads"], config["kv_heads"], config["head_dim"]
        n += d * (h + 2 * kv) * hd + h * hd * d
    if layer["mixer"] in ("ssm", "hybrid"):
        d_inner, heads, _ = ssm_dims(config)
        gn = config["ssm_groups"] * config["ssm_state"]
        n += d * (2 * d_inner + 2 * gn + heads) + d_inner * d
    if layer["ffn"] == "dense":
        n += 3 * d * config["d_ff"]
    elif layer["ffn"] != "none":
        raise ValueError(f"ffn {layer['ffn']!r} is not counted")
    return n


def forward_flops(config: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one forward pass over (batch, seq) tokens."""
    tokens = batch * seq
    total = 2.0 * config["d_model"] * config["vocab"] * tokens  # LM head
    for layer in layer_defs(config):
        total += 2.0 * layer_params_matmul(config, layer) * tokens
        if layer["mixer"] in ("attn", "hybrid"):
            h, hd = config["q_heads"], config["head_dim"]
            total += 4.0 * hd * band_pairs(seq, layer.get("window")) * batch * h
        if layer["mixer"] in ("ssm", "hybrid"):
            _, heads, conv = ssm_dims(config)
            n, p = config["ssm_state"], config["ssm_head_dim"]
            total += 5.0 * n * p * heads * tokens + 2.0 * config["ssm_conv"] * conv * tokens
    return total


def train_flops(config: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 3 x the forward."""
    return 3.0 * forward_flops(config, batch, seq)


def k5_bound_ms(config: dict, batch: int, seq: int, window: int, itemsize: int = 2) -> float:
    """K5's bound for one windowed layer of ``config`` at (batch, seq)."""
    work = k5_work(batch, seq, config["q_heads"], config["kv_heads"], config["head_dim"], window,
                   itemsize)
    return bound_ms(*work)[0]
