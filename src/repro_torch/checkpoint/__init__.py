"""Checkpoints of the port (see ``manager.py``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
