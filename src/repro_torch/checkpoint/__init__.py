"""Checkpoints of the port (``repro.checkpoint``), in the reference's
on-disk layout."""
from .manager import CheckpointManager, latest_step, restore, save

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
