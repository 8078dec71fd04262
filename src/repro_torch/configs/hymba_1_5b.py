"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + mamba heads fused per block.
[arXiv:2411.13676; hf]

Attention path uses a 1024 sliding window on all scanned layers (Hymba keeps
3 global layers; we keep the scanned pattern uniform-SWA and make the first
prefix layer global, giving bounded decode caches => long_500k runs).
head_dim 64 (25 x 64 = 1600); meta-tokens are not modeled (stub note)."""

from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    q_heads=25,
    kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    prefix=(BlockDef(mixer="hybrid", window=None, ffn="dense"),),  # global layer
    pattern=(BlockDef(mixer="hybrid", window=1024, ffn="dense"),),
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=50,  # d_inner 3200 = 64 heads x 50
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    notes=(
        "parallel attn+SSM heads; SWA window 1024 + SSM state => bounded "
        "decode cache; single global prefix layer is O(S) per decode step "
        "(linear, sub-quadratic) so long_500k runs."
    ),
)
