from repro_torch.checkpoint.checkpoint import (
    CheckpointManager, latest_step, read_checkpoint, restore_checkpoint, save_checkpoint,
)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint", "read_checkpoint",
           "latest_step"]
