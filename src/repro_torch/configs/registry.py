"""Architecture registry of the port: ``--arch <id>`` lookup. It lists only
the configs the port runs (the dense attention-only models)."""

from __future__ import annotations

from repro_torch.configs import command_r_35b, gemma3_12b, granite_3_8b, mistral_nemo_12b
from repro_torch.configs.base import ArchConfig

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        granite_3_8b.CONFIG,
        gemma3_12b.CONFIG,
        command_r_35b.CONFIG,
        mistral_nemo_12b.CONFIG,
    ]
}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


def names() -> list[str]:
    return list(ARCHS)
