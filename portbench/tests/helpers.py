"""Shared pieces of the benchmark's CPU tests: the port on the path, and
tiny versions of the cells (every width cut, the same layer kinds)."""

from __future__ import annotations

import sys

from portbench import manifest as M

SRC = str(M.ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

TINY = {
    "mamba2-780m": dict(num_layers=2, d_model=64, vocab=256, ssm_state=8, ssm_head_dim=16, ssm_chunk=16),
    "hymba-1.5b": dict(num_layers=3, d_model=64, vocab=256, q_heads=4, kv_heads=2, head_dim=16, d_ff=128,
                       ssm_state=8, ssm_head_dim=16, ssm_chunk=16,
                       pattern=[{"mixer": "hybrid", "window": 16, "ffn": "dense"},
                                {"mixer": "hybrid", "window": None, "ffn": "dense"}]),
}
CELLS = ["mamba2-prefill-4k", "hymba-train-4k", "hymba-prefill-4k", "mamba2-train-4k"]


def tiny(name: str, deep: bool = False, **config) -> M.Cell:
    """Cell ``name`` with its configuration cut to CPU size (64 wide, 2 or 3
    layers, a window of 16 under a sequence of 64; hymba keeps a global
    layer after its windowed one, as the published layout does) and a
    batch of 2; with ``deep``, 8 or 9 layers 128 wide under a sequence of
    128, where rounding piles up as in the cells' depth (the control's
    test)."""
    cell = M.Cell(M.load(), name)
    cell.config.update(TINY[cell.config["name"]], **config)
    cell.traffic.update(batch=2, seq_len=64)
    if deep:
        prefix, pattern = len(cell.config.get("prefix", [])), len(cell.config["pattern"])
        cell.config.update(num_layers=prefix + pattern * -(-(8 - prefix) // pattern), d_model=128)
        cell.traffic.update(seq_len=128)
    return cell
