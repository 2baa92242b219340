"""Fault-tolerant checkpointing (port of ``repro.checkpoint``)."""
from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
