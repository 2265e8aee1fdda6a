"""Checkpointing on the PyTorch port: atomic, keep-k, verified restore
(``manager.CheckpointManager``, ``manager.AsyncWriter``)."""
from .manager import AsyncWriter, CheckpointManager

__all__ = ["AsyncWriter", "CheckpointManager"]
