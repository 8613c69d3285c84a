from .manager import CheckpointManager, reshard_restore

__all__ = ["CheckpointManager", "reshard_restore"]
