"""Checkpoints in the JAX package's ``repro-ckpt-v1`` layout."""
from .store import (CheckpointManager, save_pytree, load_pytree,
                    latest_step, AsyncCheckpointer)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree", "latest_step",
           "AsyncCheckpointer"]
