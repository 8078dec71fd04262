"""Weights drawn from ``--seed`` on the device, by the parameter names and
shapes a configuration states.

The layout below follows the configuration's keys alone (no module of the
program is read); its names are the state-dict names the port's
``Transformer`` gives the same parameters, so ``system.build_model`` can
check them one by one. The same tensors go into the program and into the
reference (``reference/model.py``).

Each group (``embed``, ``final_norm``, ``lm_head``, ``layers.<i>``) has a
generator of its own, seeded from (seed, group), and is drawn in two calls:
one ``randn`` for all its matrices, one ``rand`` for all its vectors. So a
group is drawn alone (the training check draws the initial parameters
again one group at a time) and the bits never depend on the
device's other work. Distributions:

* a matrix: normal, standard deviation ``fan_in ** -0.5`` (the embedding 1);
* a norm's scale (the norm multiplies by 1 + scale), ``conv_b``: uniform in
  [-0.1, 0.1];
* ``a_log``: log of uniform [1, 16] (A = -exp(a_log), Mamba-2's range);
* ``dt_bias``: the inverse softplus of dt, log-uniform in [1e-3, 1e-1]
  (Mamba-2's range);
* ``d_skip``: uniform in [0.5, 1.5].
"""

from __future__ import annotations

import hashlib
import math

import torch

from portbench.flops import layer_defs, ssm_dims

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def _norm(name, d):
    return (name, (d,), "norm", None)


def layout(config: dict) -> list[tuple[str, list[tuple]]]:
    """[(group, [(name, shape, kind, fan_in)])] in the order drawn."""
    d, v = config["d_model"], config["vocab"]
    groups = [("embed", [("embed", (v, d), "matrix", 1)]),
              ("final_norm", [_norm("final_norm.scale", d)]),
              ("lm_head", [("lm_head", (d, v), "matrix", d)])]
    for i, layer in enumerate(layer_defs(config)):
        pre = f"layers.{i}."
        leaves = [_norm(pre + "ln1.scale", d)]
        if layer["mixer"] in ("attn", "hybrid"):
            h, kv, hd = config["q_heads"], config["kv_heads"], config["head_dim"]
            leaves += [(pre + "attn.wq", (d, h, hd), "matrix", d),
                       (pre + "attn.wk", (d, kv, hd), "matrix", d),
                       (pre + "attn.wv", (d, kv, hd), "matrix", d),
                       (pre + "attn.wo", (h, hd, d), "matrix", h * hd)]
            if config.get("qk_norm"):
                leaves += [_norm(pre + "attn.q_norm.scale", hd), _norm(pre + "attn.k_norm.scale", hd)]
        if layer["mixer"] in ("ssm", "hybrid"):
            d_inner, heads, conv = ssm_dims(config)
            k, gn = config["ssm_conv"], config["ssm_groups"] * config["ssm_state"]
            leaves += [(pre + "ssm.in_proj", (d, 2 * d_inner + 2 * gn + heads), "matrix", d),
                       (pre + "ssm.conv_w", (k, conv), "matrix", k),
                       (pre + "ssm.conv_b", (conv,), "conv_b", None),
                       (pre + "ssm.a_log", (heads,), "a_log", None),
                       (pre + "ssm.d_skip", (heads,), "d_skip", None),
                       (pre + "ssm.dt_bias", (heads,), "dt_bias", None),
                       _norm(pre + "ssm.norm.scale", d_inner),
                       (pre + "ssm.out_proj", (d_inner, d), "matrix", d_inner)]
        if layer["mixer"] == "hybrid":
            leaves += [_norm(pre + "norm_attn.scale", d), _norm(pre + "norm_ssm.scale", d)]
        if layer["ffn"] == "dense":
            f = config["d_ff"]
            leaves += [_norm(pre + "ln2.scale", d),
                       (pre + "mlp.w_gate", (d, f), "matrix", d),
                       (pre + "mlp.w_in", (d, f), "matrix", d),
                       (pre + "mlp.w_out", (f, d), "matrix", f)]
        elif layer["ffn"] != "none":
            raise ValueError(f"ffn {layer['ffn']!r} has no layout")
        groups.append((f"layers.{i}", leaves))
    return groups


_FLOAT32_ALWAYS = {"a_log", "d_skip", "dt_bias"}


def _vector(kind: str, u: torch.Tensor) -> torch.Tensor:
    """A vector of ``kind`` from uniforms u in [0, 1)."""
    if kind in ("norm", "conv_b"):
        return (u - 0.5) * 0.2
    if kind == "a_log":
        return torch.log(1.0 + 15.0 * u)
    if kind == "dt_bias":
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    if kind == "d_skip":
        return 0.5 + u
    raise ValueError(kind)


def draw_group(config: dict, seed: int, group: str, leaves: list[tuple], device) -> dict:
    """{name: tensor} of one group, in the parameter type (``a_log``,
    ``d_skip`` and ``dt_bias`` float32 whatever it is)."""
    pdt = dtype(config["param_dtype"])
    gen = generator(seed, f"weights/{group}", device)
    mats = [leaf for leaf in leaves if leaf[2] == "matrix"]
    vecs = [leaf for leaf in leaves if leaf[2] != "matrix"]
    out = {}
    if mats:
        flat = torch.randn(sum(math.prod(s) for _, s, _, _ in mats), generator=gen, device=device)
        at = 0
        for name, shape, _, fan_in in mats:
            n = math.prod(shape)
            out[name] = (flat[at:at + n].view(shape) * fan_in**-0.5).to(pdt)
            at += n
        del flat
    if vecs:
        flat = torch.rand(sum(math.prod(s) for _, s, _, _ in vecs), generator=gen, device=device)
        at = 0
        for name, shape, kind, _ in vecs:
            n = math.prod(shape)
            t = _vector(kind, flat[at:at + n]).view(shape)
            out[name] = t if kind in _FLOAT32_ALWAYS else t.to(pdt)
            at += n
    return out


def draw(config: dict, seed: int, device):
    """Yield (group, {name: tensor}) for every group of the layout, one at
    a time."""
    for group, leaves in layout(config):
        yield group, draw_group(config, seed, group, leaves, device)


def draw_all(config: dict, seed: int, device) -> dict:
    out = {}
    for _, tensors in draw(config, seed, device):
        out.update(tensors)
    return out

