"""Int8 gradient compression: a symmetric per-tensor scheme.

Port of ``repro.optim.compression``'s ``compress_int8`` and
``decompress_int8``. Its ``pod_allreduce_compressed`` is a collective over
a mesh axis and waits with the port's other multi-device pieces (ROADMAP
queue 1, item 18)."""

from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32/bf16 -> (int8 values, float32 scale)."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
