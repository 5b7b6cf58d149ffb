"""Sharded checkpoints of the port, in the reference's on-disk layout."""
from repro_torch.ckpt.manager import (CheckpointManager, restore_checkpoint,
                                      save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
