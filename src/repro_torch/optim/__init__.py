"""Optimizers of the port (counterpart of ``repro.optim``): Adam."""
from .optimizers import AdamState, GradientTransformation, adam, apply_updates

__all__ = ["AdamState", "GradientTransformation", "adam", "apply_updates"]
