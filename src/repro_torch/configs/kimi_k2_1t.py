"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per
expert) vocab=163840, MoE 384 experts top-8, first layer dense, one shared
expert (DeepSeek-V3-lineage design). [arXiv:2501.kimi2; unverified]

~1T total params, ~32B active. FSDP + EP; memory iterations for this config
are the §Perf kimi hillclimb (bf16 params + Adafactor vs f32 + Adam)."""

from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    q_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab=163840,
    prefix=(BlockDef(mixer="attn", ffn="dense"),),  # layer 0 dense
    pattern=(BlockDef(mixer="attn", ffn="moe"),),
    num_experts=384,
    moe_top_k=8,
    moe_shared_ff=2048,  # one shared expert
    rope_theta=50_000.0,
    fsdp=True,
    notes=(
        "trillion-param MoE; first layer dense + shared expert. Dense layer-0 "
        "d_ff uses the expert width x top_k scale via the dense prefix block "
        "(see registry note). Full attention (long_500k skipped)."
    ),
)
