"""PyTorch/CUDA port of the FEEL reproduction (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
sub-package layout module for module (``repro_torch/core/matching.py``
is the counterpart of ``repro/core/matching.py``) and imports nothing
from it.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.

Ported so far: the paper's main path (Algorithm 1 as
``fed.rounds.FEELTrainer.run_round``) with the closed-form power
evaluator, faithful/exact selection, the §VI-A CNN, IPW aggregation and
Adam, and the row-norm sigma kernel in CUDA C++
(``kernels/csrc/gradnorm.cu``).
"""
from .device import resolve_device  # noqa: F401
