"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base; hf]"""

from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    q_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab=49155,
    pattern=(BlockDef(mixer="attn", ffn="dense"),),
    rope_theta=10_000.0,
    notes="GQA dense decoder; full attention (long_500k skipped).",
)
