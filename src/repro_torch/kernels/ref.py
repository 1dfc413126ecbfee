"""Plain PyTorch oracles for the port's kernels (the allclose targets).

Counterpart of ``repro/kernels/ref.py``.  The oracles are the plain
versions kept beside each kernel in its own module; this module gives
them the reference's names.
"""
from __future__ import annotations

from .flash_attention import flash_attention_plain as flash_attention_ref  # noqa: F401
from .gradnorm import gradnorm_sigma_plain as gradnorm_sigma_ref  # noqa: F401
from .gradnorm import rownorm2_plain as rownorm2_ref  # noqa: F401
from .lru_scan import lru_scan_plain as lru_scan_ref  # noqa: F401
