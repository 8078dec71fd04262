"""Architecture registry of the port: ``--arch <id>`` lookup, the
reference's ten configs in its order."""

from __future__ import annotations

from repro_torch.configs import (
    arctic_480b,
    command_r_35b,
    gemma3_12b,
    granite_3_8b,
    hymba_1_5b,
    kimi_k2_1t,
    llama32_vision_90b,
    mamba2_780m,
    mistral_nemo_12b,
    seamless_m4t_medium,
)
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        granite_3_8b.CONFIG,
        gemma3_12b.CONFIG,
        command_r_35b.CONFIG,
        mistral_nemo_12b.CONFIG,
        seamless_m4t_medium.CONFIG,
        llama32_vision_90b.CONFIG,
        arctic_480b.CONFIG,
        kimi_k2_1t.CONFIG,
        mamba2_780m.CONFIG,
        hymba_1_5b.CONFIG,
    ]
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def names() -> list[str]:
    return list(ARCHS)
