"""Architecture config schema of the LM serving path.

Port of ``repro.configs.base``: ``BlockDef`` and ``ArchConfig`` with every
field of the reference, dtypes as torch dtypes. ``reduced()`` derives the
small CPU variant exactly as the reference does.

Fields that only shape XLA compilation or sharding have no effect on one
card: ``scan_unroll``, ``fsdp``, ``sequence_parallel`` and
``gqa_repeat_kv`` (the reference repeats K/V to the query heads only so
that its partitioner can shard the score einsum by head; the grouped
einsum computes the same values). ``moe_scan_dispatch`` has none either:
the reference's blocked prefix sum and a plain ``cumsum`` give the MoE
the same integer positions, so the port computes them one way. ``remat``
acts in training (``models/transformer._remat``): it is what lets
hymba-1.5b train at full width on one card; serving ignores it.
``adam_moments_bf16`` and ``use_adafactor`` choose the trainer's optimizer
(``launch/train.py``). ``flash_decode`` acts in decode when a mesh is
given (``models/transformer.decode_step``). ``unported(cfg)`` names what
the port does not run, today nothing; the model's entry points would
refuse such a config through ``check_ported``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One layer's shape inside the repeating pattern."""

    mixer: str = "attn"  # attn | ssm | hybrid | cross_attn
    window: int | None = None  # sliding-window size for attn mixers
    ffn: str = "dense"  # dense | moe | moe_dense (MoE + parallel dense) | none


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    q_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # layer structure: `prefix` layers first, then `pattern` repeats
    # (num_layers - len(prefix)) / len(pattern) times.
    pattern: tuple[BlockDef, ...] = (BlockDef(),)
    prefix: tuple[BlockDef, ...] = ()

    # MoE
    num_experts: int = 0
    moe_top_k: int = 0
    moe_shared_ff: int = 0

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # VLM / enc-dec
    num_patches: int = 0
    enc_layers: int = 0
    dec_layers: int = 0

    rope_theta: float = 10_000.0
    qk_norm: bool = False
    norm_eps: float = 1e-6
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"  # training only: full | dots | none
    scan_unroll: int = 1  # no effect: the repeats are a Python loop
    fsdp: bool = False  # no effect on one card

    # -- optimization knobs of the reference ---------------------------------
    block_local_attn: bool = False  # windowed layers through the banded kernel (K5)
    moe_scan_dispatch: bool = False  # no effect: the same positions as cumsum
    pad_vocab_to_multiple: int = 0
    gqa_repeat_kv: bool = False  # no effect on one card
    adam_moments_bf16: bool = False
    use_adafactor: bool = False
    flash_decode: bool = False
    sequence_parallel: bool = False  # no effect on one card
    notes: str = ""

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_to_multiple
        if m <= 0:
            return self.vocab
        return -(-self.vocab // m) * m

    @property
    def num_repeats(self) -> int:
        body = self.num_layers - len(self.prefix)
        if body % len(self.pattern):
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by pattern "
                f"of {len(self.pattern)}"
            )
        return body // len(self.pattern)

    def layer_defs(self) -> tuple[BlockDef, ...]:
        """Every layer's ``BlockDef`` in order: the prefix, then the pattern
        repeated ``num_repeats`` times."""
        return self.prefix + self.pattern * self.num_repeats

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dims."""
        kv = min(self.kv_heads, 2)
        q = max(kv * 2, 4) if self.q_heads else 0
        pat_len = len(self.pattern)
        return self.replace(
            num_layers=len(self.prefix) + 2 * pat_len,
            d_model=64,
            q_heads=q,
            kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab=512,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            moe_shared_ff=64 if self.moe_shared_ff else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 256,
            num_patches=16 if self.num_patches else 0,
            enc_layers=2 if self.enc_layers else 0,
            dec_layers=2 if self.dec_layers else 0,
            param_dtype=torch.float32,
            compute_dtype=torch.float32,
            remat="none",
        )


def unported(cfg: ArchConfig) -> list[str]:
    """What ``cfg`` asks for that the port does not run: nothing since
    flash decode was ported (a knob that lands in the reference before the
    port goes here)."""
    return []


def check_ported(cfg: ArchConfig) -> None:
    missing = unported(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: {', '.join(missing)}")
