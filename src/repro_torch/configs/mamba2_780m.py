"""mamba2-780m [ssm] — 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality). [arXiv:2405.21060; unverified]

d_inner = 2*d_model = 3072, 48 SSD heads of dim 64, chunked scan (Q=256).
Attention-free => O(1)-state decode; long_500k runs for this arch."""

from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    q_heads=0,
    kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    pattern=(BlockDef(mixer="ssm", ffn="none"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
    ssm_chunk=256,
    notes="pure SSD stack; runs long_500k (state size independent of seq).",
)
