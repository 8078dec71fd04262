"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144; 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

head_dim is 256 (gemma3 family uses wider heads than d_model/q_heads);
qk-norm on; sliding window 1024 on the 5 local layers of each 6-layer
pattern. The 1-in-6 global layers are full attention, so long_500k is
skipped per the spec (needs sub-quadratic attention throughout)."""

from repro_torch.configs.base import ArchConfig, BlockDef

_W = 1024  # local sliding window

CONFIG = ArchConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    q_heads=16,
    kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    pattern=(
        BlockDef(mixer="attn", window=_W),
        BlockDef(mixer="attn", window=_W),
        BlockDef(mixer="attn", window=_W),
        BlockDef(mixer="attn", window=_W),
        BlockDef(mixer="attn", window=_W),
        BlockDef(mixer="attn", window=None),  # global layer
    ),
    qk_norm=True,
    rope_theta=1_000_000.0,
    notes="5:1 local:global; global layers are full attention -> long_500k skipped.",
)
