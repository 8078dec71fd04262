"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    q_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    pattern=(BlockDef(mixer="attn", ffn="dense"),),
    rope_theta=1_000_000.0,
    notes="GQA dense, 128k-ctx rope base; full attention (long_500k skipped).",
)
