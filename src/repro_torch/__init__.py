"""PyTorch/CUDA port of the FEEL reproduction (``repro``), for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
sub-package layout module for module (``repro_torch/core/matching.py``
is the counterpart of ``repro/core/matching.py``) and imports nothing
from it.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.

Ported so far: the paper's main path (Algorithm 1 as
``fed.rounds.FEELTrainer.run_round``) with every option of the
reference's ``FEELConfig`` (the five schemes, closed-form or CCP power,
faithful/exact and chunked selection, FedSGD or FedAvg local steps,
adam/sgd/momentum/adafactor, warmup, the three sigma methods), the
§VI-A CNN, IPW aggregation, the row-norm sigma kernel in CUDA C++
(``kernels/csrc/gradnorm.cu``), and the LLM zoo's serving paths
(``launch/serve.py``; ROADMAP.md lists what is left).
"""
from .device import resolve_device  # noqa: F401
