"""Port of ``repro.checkpoint``."""

from repro_torch.checkpoint.manager import CheckpointManager, restore_pytree, save_pytree, shardings_of

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree", "shardings_of"]
