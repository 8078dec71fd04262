"""Assigned input shapes x applicability, and meta-tensor input specs.

Port of ``repro.configs.shapes``. Shapes (identical set for every LM arch):
  train_4k     seq 4,096   global_batch 256   -> train step
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   seq 32,768  global_batch 128   -> decode step (1 new token, KV cache of seq)
  long_500k    seq 524,288 global_batch 1     -> decode step; SSM/hybrid only

``input_specs`` returns (kwargs of ``meta`` tensors, matching placements)
for the step the shape chooses: the reference's shapes and dtypes, nothing
allocated. The meta device is the port's ``jax.ShapeDtypeStruct``. A
decode step's caches come from the port's own ``init_cache`` on ``meta``
(one dict a layer, where the reference stacks the repeats).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models import sharding as sh


@dataclasses.dataclass(frozen=True)
class ShapeDef:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeDef] = {
    "train_4k": ShapeDef("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeDef("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeDef("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeDef("long_500k", "decode", 524_288, 1),
}

# Encoder-decoder prefill uses a short decoder prompt against the long
# encoder memory (the 32k is the audio-frame sequence).
ENCDEC_PROMPT = 128


def applicable(cfg: ArchConfig, shape: ShapeDef) -> tuple[bool, str]:
    """(runs?, reason-if-skip). long_500k needs sub-quadratic attention:
    only the SSM/hybrid families qualify (DESIGN.md §5)."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "skip(full-attn)"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeDef, mesh: Mesh):
    """Returns (args: dict[str, meta tensor or cache tree], placements: the
    same keys, a placement tuple at each tensor).

    Keys depend on (family, shape.kind):
      train:   tokens, targets [, memory | frames]
      prefill: tokens [, memory | frames]
      decode:  token, caches [, memory]
    """
    b, s = shape.global_batch, shape.seq_len
    ba = sh._batch_axes(mesh)
    tok_p = (ba, None)
    i32, f32 = torch.int32, torch.float32

    if shape.kind == "train":
        args = {"tokens": _meta((b, s), i32), "targets": _meta((b, s), i32)}
        specs = {"tokens": tok_p, "targets": tok_p}
        if cfg.family == "vlm":
            args["memory"] = _meta((b, cfg.num_patches, cfg.d_model), f32)
            specs["memory"] = (ba, None, None)
        if cfg.family == "encdec":
            args["frames"] = _meta((b, s, cfg.d_model), f32)
            specs["frames"] = (ba, None, None)
        return args, specs

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            args = {"frames": _meta((b, s, cfg.d_model), f32),
                    "tokens": _meta((b, ENCDEC_PROMPT), i32)}
            return args, {"frames": (ba, None, None), "tokens": tok_p}
        args = {"tokens": _meta((b, s), i32)}
        specs = {"tokens": tok_p}
        if cfg.family == "vlm":
            args["memory"] = _meta((b, cfg.num_patches, cfg.d_model), f32)
            specs["memory"] = (ba, None, None)
        return args, specs

    if shape.kind == "decode":
        from repro_torch.models import encdec as ED
        from repro_torch.models import transformer as T

        cdt = cfg.compute_dtype
        dprod = math.prod(n for a, n in mesh.axis_sizes.items() if a != sh.MODEL_AXIS)
        tok_ba = ba if b % dprod == 0 else None
        if cfg.family == "encdec":
            cache = ED.init_cache(cfg, b, s, mem_len=s, dtype=cdt, device="meta")
        else:
            cache = T.init_cache(cfg, b, s, dtype=cdt, device="meta")
        args = {"token": _meta((b,), i32), "caches": cache}
        specs = {"token": (tok_ba,), "caches": sh.cache_pspecs(mesh, cache, b)}
        if cfg.family == "vlm":
            args["memory"] = _meta((b, cfg.num_patches, cfg.d_model), f32)
            specs["memory"] = (tok_ba, None, None)
        return args, specs

    raise ValueError(shape.kind)
