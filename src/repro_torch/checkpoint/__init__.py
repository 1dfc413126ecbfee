"""Checkpoints in the reference's npz + JSON format (counterpart of
``repro.checkpoint``)."""
from .checkpoint import load_metadata, load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree", "load_metadata"]
