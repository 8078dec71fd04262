"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; cross-attn image layers. [hf:meta-llama/Llama-3.2-11B-Vision;
unverified]

100 layers = 20 repeats of (4 self-attn + 1 cross-attn); the vision tower is
a stub — input_specs() provides (batch, num_patches, d_model) patch
embeddings. FSDP on (90B dense-scale params)."""

from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    q_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    pattern=(
        BlockDef(mixer="attn"),
        BlockDef(mixer="attn"),
        BlockDef(mixer="attn"),
        BlockDef(mixer="attn"),
        BlockDef(mixer="cross_attn"),
    ),
    num_patches=1601,  # 1 tile x (40x40 + 1 cls), llama-3.2 vision geometry
    rope_theta=500_000.0,
    fsdp=True,
    notes="vision frontend stubbed; full attention (long_500k skipped).",
)
