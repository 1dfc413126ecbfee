"""Models of the port (counterpart of ``repro.models``): the §VI-A CNN
and the text decoder of the LLM zoo (global and sliding-window
attention blocks and RG-LRU blocks, ``rglru.py``, each with a dense
FFN, and ``"mamba"`` blocks, ``ssm.py``) with its prefill and decode
steps."""
from . import cnn  # noqa: F401
from .config import ArchConfig
from .model import (Model, init_model, make_cache, make_decode_step,
                    make_prefill_step, param_count, params_from_numpy)

__all__ = ["ArchConfig", "Model", "cnn", "init_model", "make_cache",
           "make_decode_step", "make_prefill_step", "param_count",
           "params_from_numpy"]
