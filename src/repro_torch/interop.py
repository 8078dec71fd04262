"""Carry the reference package's state into the port.

The PDF pipeline's state is data, configuration, fit results and the
decision tree of the ML and sampling methods: the data is regenerated
bitwise from the same source (``data/simulation``), and
``pdf_config_from_dict``, ``moments_from_numpy`` and ``tree_from_numpy``
carry the rest. The LM
serving path's state is its weights: ``lm_params_from_numpy`` carries the
reference's parameter tree into the port's ``Transformer`` and
``encdec_params_from_numpy`` into its ``EncDec``. All take plain
Python and numpy values, so neither package imports the other.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.distributions import Moments
from repro_torch.core.executor import PDFConfig
from repro_torch.core.ml_predict import DecisionTree


def pdf_config_from_dict(d: Mapping) -> PDFConfig:
    """The port's ``PDFConfig`` from ``dataclasses.asdict`` of the
    reference's; raises on any field the port lacks."""
    known = {f.name for f in dataclasses.fields(PDFConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"PDFConfig fields the port lacks: {unknown}")
    kw = dict(d)
    if "types" in kw:
        kw["types"] = tuple(kw["types"])
    return PDFConfig(**kw)


def moments_from_numpy(fields: Sequence, device: torch.device | str) -> Moments:
    """The port's ``Moments`` from the reference's six arrays, in its field
    order (mean, var, skew, kurt, vmin, vmax; a reference ``Moments`` is
    such a sequence), as float32 tensors on ``device``."""
    arrays = list(fields)
    if len(arrays) != len(Moments._fields):
        raise ValueError(f"expected {len(Moments._fields)} moment arrays, got {len(arrays)}")
    return Moments(*(
        torch.tensor(np.asarray(a, dtype=np.float32), device=device) for a in arrays
    ))


def tree_from_numpy(depth: int, feature, threshold, leaf_label) -> DecisionTree:
    """The port's ``DecisionTree`` from the reference's four fields (a tree
    ``repro.core.ml_predict.train_tree`` trained); raises on a shape that
    is not the complete tree of ``depth``."""
    tree = DecisionTree(int(depth), np.asarray(feature, dtype=np.int32),
                        np.asarray(threshold, dtype=np.float32),
                        np.asarray(leaf_label, dtype=np.int32))
    n_internal = 2**tree.depth - 1
    shapes = (tree.feature.shape, tree.threshold.shape, tree.leaf_label.shape)
    if tree.depth < 1 or shapes != ((n_internal,), (n_internal,), (n_internal + 1,)):
        raise ValueError(f"a tree of depth {depth} has {n_internal} internal nodes and "
                         f"{n_internal + 1} leaves; got shapes {shapes}")
    return tree


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, Mapping):
        for key, sub in tree.items():
            _flatten(sub, f"{prefix}.{key}" if prefix else str(key), out)
    else:
        out[prefix] = tree


def _unstack(tree, name: str, n: int, layer_name, flat: dict) -> None:
    """Each leaf of ``tree`` is stacked over ``n`` layers (``jax.vmap`` or
    ``lax.scan`` of the reference); its slice r goes into ``flat`` under
    ``layer_name(r)`` + the leaf's path."""
    stacked: dict[str, np.ndarray] = {}
    _flatten(tree, "", stacked)
    for leaf, arr in stacked.items():
        arr = np.asarray(arr)
        if arr.ndim == 0 or arr.shape[0] != n:
            raise ValueError(f"{name}.{leaf}: shape {arr.shape} is not stacked over {n} layers")
        for r in range(n):
            flat[f"{layer_name(r)}.{leaf}"] = arr[r]


def _fill(model, flat: dict):
    """Copy ``flat`` into ``model``'s parameters of the same names, each
    keeping its parameter's type; raises on a missing or unexpected leaf
    and on a shape that differs."""
    params = dict(model.named_parameters())
    missing, extra = sorted(set(params) - set(flat)), sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            arr = np.asarray(flat[name])
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape}, the port expects {tuple(p.shape)}")
            if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:  # bfloat16 has no numpy type
                arr = arr.astype(np.float32)
            p.copy_(torch.tensor(arr))
    return model


def lm_params_from_numpy(tree: Mapping, cfg: ArchConfig, device: torch.device | str):
    """The port's ``Transformer`` for ``cfg`` on ``device``, holding the
    reference's parameters ``tree`` (``jax.tree.map(np.asarray, params)``
    of ``repro.models.transformer.init_params``).

    ``tree["prefix"][i]`` becomes layer i; each leaf of
    ``tree["groups"][j]`` is stacked over the repeats, and its slice r
    becomes layer ``len(cfg.prefix) + r * len(cfg.pattern) + j``. Each
    value is copied into the port's parameter of the same name and keeps
    that parameter's type: the SSD's ``a_log``, ``d_skip`` and ``dt_bias``
    and the MoE's ``router`` are float32 under any ``param_dtype``, as in
    the reference. The MoE's leaves (``moe.router``, the expert stacks
    ``moe.w_gate|w_in|w_out`` with E first, ``moe.shared.*``) and a cross
    block's (``attn.*``, as a self-attention block's) come through under
    their names. Raises on a missing or unexpected leaf and on a shape that
    differs."""
    from repro_torch.models.transformer import Transformer

    flat: dict[str, np.ndarray] = {}
    top = {k: v for k, v in tree.items() if k not in ("prefix", "groups")}
    _flatten(top, "", flat)
    prefix, groups = list(tree.get("prefix", [])), list(tree.get("groups", []))
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    if len(prefix) != n_pre or len(groups) != n_pat:
        raise ValueError(f"tree has {len(prefix)} prefix blocks and {len(groups)} pattern groups; "
                         f"{cfg.name} has {n_pre} and {n_pat}")
    for i, blk in enumerate(prefix):
        _flatten(blk, f"layers.{i}", flat)
    for j, grp in enumerate(groups):
        _unstack(grp, f"groups[{j}]", cfg.num_repeats,
                 lambda r, j=j: f"layers.{n_pre + r * n_pat + j}", flat)
    return _fill(Transformer(cfg, device), flat)


def encdec_params_from_numpy(tree: Mapping, cfg: ArchConfig, device: torch.device | str):
    """The port's ``EncDec`` for ``cfg`` on ``device``, holding the
    reference's parameters ``tree`` (``jax.tree.map(np.asarray, params)``
    of ``repro.models.encdec.init_params``): each leaf of
    ``tree["encoder"]`` and ``tree["decoder"]`` is stacked over
    ``cfg.enc_layers`` / ``cfg.dec_layers``, and its slice i becomes block
    i of ``encoder`` / ``decoder``. Raises as ``lm_params_from_numpy``."""
    from repro_torch.models.encdec import EncDec

    flat: dict[str, np.ndarray] = {}
    _flatten({k: v for k, v in tree.items() if k not in ("encoder", "decoder")}, "", flat)
    for stack, n in (("encoder", cfg.enc_layers), ("decoder", cfg.dec_layers)):
        if stack not in tree:
            raise ValueError(f"tree has no {stack!r}")
        _unstack(tree[stack], stack, n, lambda r, stack=stack: f"{stack}.{r}", flat)
    return _fill(EncDec(cfg, device), flat)
