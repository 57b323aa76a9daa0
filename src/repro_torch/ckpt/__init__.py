"""Checkpoints of the port (counterpart of ``repro/ckpt``)."""
from .checkpoint import CheckpointManager, latest_step, restore, save

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
