"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16 => MHA)
d_ff=4096 vocab=256206; enc-dec, multimodal. [arXiv:2308.11596; hf]

Backbone only per spec: 12 encoder + 12 decoder layers; the audio frontend
is a stub — input_specs() provides precomputed frame embeddings at d_model.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=24,  # 12 enc + 12 dec
    d_model=1024,
    q_heads=16,
    kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    enc_layers=12,
    dec_layers=12,
    rope_theta=10_000.0,
    notes=(
        "enc-dec; audio frontend stubbed (frame embeddings in input_specs). "
        "Full attention -> long_500k skipped. decode shapes lower the decoder "
        "step against a precomputed encoder memory."
    ),
)
