"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual branch in parallel (Snowflake Arctic's
dense-MoE hybrid). [hf:Snowflake/snowflake-arctic-base; hf]"""

from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    q_heads=56,
    kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    pattern=(BlockDef(mixer="attn", ffn="moe_dense"),),  # MoE + parallel dense
    num_experts=128,
    moe_top_k=2,
    rope_theta=10_000.0,
    fsdp=True,
    notes="dense-MoE hybrid residual; EP over model axis; full attention (long_500k skipped).",
)
