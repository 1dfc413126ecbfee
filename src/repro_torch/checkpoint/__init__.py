"""Checkpoints in the reference's npz + JSON format (counterpart of
``repro.checkpoint``)."""
from .checkpoint import (load_metadata, load_pytree, restore_sharded,
                         save_pytree)

__all__ = ["save_pytree", "load_pytree", "load_metadata", "restore_sharded"]
