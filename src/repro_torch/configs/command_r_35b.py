"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000; GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]

All linear layers are bias-free (the zoo's layers are bias-free throughout,
matching this config natively). ``fsdp`` is set as in the reference config;
it has no effect on one card."""

from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    q_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab=256000,
    pattern=(BlockDef(mixer="attn", ffn="dense"),),
    rope_theta=10_000.0,
    fsdp=True,
    notes="no-bias GQA dense; full attention (long_500k skipped); fsdp for memory.",
)
