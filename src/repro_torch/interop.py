"""Carry the reference package's state into the port.

The PDF pipeline's state is data, configuration, fit results and the
decision tree of the ML and sampling methods: the data is regenerated
bitwise from the same source (``data/simulation``), and
``pdf_config_from_dict``, ``moments_from_numpy`` and ``tree_from_numpy``
carry the rest. The LM
serving path's state is its weights: ``lm_params_from_numpy`` carries the
reference's parameter tree into the port's ``Transformer`` and
``encdec_params_from_numpy`` into its ``EncDec``. Training adds the way
back, ``params_to_numpy`` (a model's parameters, or gradients under their
names, as the reference's stacked tree, so the two can be compared leaf
by leaf), and ``adamw_state_from_numpy`` for the reference's AdamW state.
All take and give plain Python and numpy values, so neither package
imports the other.
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


def _lm_flat(tree: Mapping, cfg: ArchConfig) -> dict:
    """The reference's LM tree as ``{port parameter name: array}``."""
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
    return flat


def _encdec_flat(tree: Mapping, cfg: ArchConfig) -> dict:
    """The reference's enc-dec tree as ``{port parameter name: array}``."""
    flat: dict[str, np.ndarray] = {}
    _flatten({k: v for k, v in tree.items() if k not in ("encoder", "decoder")}, "", flat)
    for stack, n in (("encoder", cfg.enc_layers), ("decoder", cfg.dec_layers)):
        if stack not in tree:
            raise ValueError(f"tree has no {stack!r}")
        _unstack(tree[stack], stack, n, lambda r, stack=stack: f"{stack}.{r}", flat)
    return flat


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

    return _fill(Transformer(cfg, device), _lm_flat(tree, cfg))


def encdec_params_from_numpy(tree: Mapping, cfg: ArchConfig, device: torch.device | str):
    """The port's ``EncDec`` for ``cfg`` on ``device``, holding the
    reference's parameters ``tree`` (``jax.tree.map(np.asarray, params)``
    of ``repro.models.encdec.init_params``): each leaf of
    ``tree["encoder"]`` and ``tree["decoder"]`` is stacked over
    ``cfg.enc_layers`` / ``cfg.dec_layers``, and its slice i becomes block
    i of ``encoder`` / ``decoder``. Raises as ``lm_params_from_numpy``."""
    from repro_torch.models.encdec import EncDec

    return _fill(EncDec(cfg, device), _encdec_flat(tree, cfg))


def _to_numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _nest(tree: dict, path: list[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def params_to_numpy(model, cfg: ArchConfig, tensors: Mapping | None = None) -> dict:
    """``model``'s parameters (or ``tensors``, e.g. their gradients, under
    the parameter names) as the reference's tree of float32 numpy arrays:
    for the enc-dec family ``encoder``/``decoder`` stacked over their
    blocks, for the others ``prefix`` blocks and ``groups`` stacked over
    the repeats, the inverse of ``lm_params_from_numpy`` /
    ``encdec_params_from_numpy``."""
    values = dict(model.named_parameters()) if tensors is None else dict(tensors)
    params = dict(model.named_parameters())
    if set(values) != set(params):
        raise ValueError(f"names differ from the model's: missing {sorted(set(params) - set(values))}, "
                         f"unexpected {sorted(set(values) - set(params))}")
    n_pre, n_pat = len(cfg.prefix), len(cfg.pattern)
    tree: dict = {} if cfg.family == "encdec" else {"prefix": [{} for _ in range(n_pre)],
                                                    "groups": [{} for _ in range(n_pat)]}
    stacks: dict[tuple, dict[int, np.ndarray]] = {}
    for name in params:
        head, *rest = name.split(".")
        arr = _to_numpy(values[name])
        if head in ("encoder", "decoder"):
            stacks.setdefault((head, None, tuple(rest[1:])), {})[int(rest[0])] = arr
        elif head == "layers":
            i, leaf = int(rest[0]), rest[1:]
            if i < n_pre:
                _nest(tree["prefix"][i], leaf, arr)
            else:
                r, j = divmod(i - n_pre, n_pat)
                stacks.setdefault(("groups", j, tuple(leaf)), {})[r] = arr
        else:
            _nest(tree, [head, *rest], arr)
    for (head, j, leaf), by_index in stacks.items():
        stacked = np.stack([by_index[i] for i in sorted(by_index)])
        _nest(tree[head][j] if head == "groups" else tree.setdefault(head, {}), list(leaf), stacked)
    return tree


def adamw_state_from_numpy(step, mu: Mapping, nu: Mapping, cfg: ArchConfig,
                           device: torch.device | str):
    """The port's ``optim.OptState`` from the reference's (``step``, ``mu``
    and ``nu``, each a tree of numpy arrays in the reference's parameter
    layout), on ``device``; the moments keep their type (bfloat16 ones
    arrive as ml_dtypes arrays and become torch bfloat16)."""
    from repro_torch.optim import OptState

    flat = _encdec_flat if cfg.family == "encdec" else _lm_flat

    def moments(tree):
        out = {}
        for name, arr in flat(tree, cfg).items():
            arr = np.asarray(arr)
            dtype = torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32
            out[name] = torch.tensor(arr.astype(np.float32), device=device).to(dtype)
        return out

    return OptState(torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device),
                    moments(mu), moments(nu))
