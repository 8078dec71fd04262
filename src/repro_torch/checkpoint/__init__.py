"""Port of ``repro.checkpoint``."""

from repro_torch.checkpoint.manager import CheckpointManager, restore_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree"]
