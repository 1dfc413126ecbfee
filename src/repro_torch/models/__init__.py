"""Models of the port (counterpart of ``repro.models``): the §VI-A CNN
and the text decoder of the LLM zoo (global and sliding-window
attention blocks, multi-head latent attention blocks, ``mla.py``, and
RG-LRU blocks, ``rglru.py``, each with a dense or a mixture-of-experts
FFN, ``moe.py``, and ``"mamba"`` blocks, ``ssm.py``) with its train
(FEEL selection inside), prefill and decode steps."""
from . import cnn  # noqa: F401
from .config import ArchConfig
from .model import (FeelIntegration, Model, init_model, make_cache,
                    make_decode_step, make_forward, make_prefill_step,
                    make_train_step, param_count, params_from_numpy,
                    trainable)

__all__ = ["ArchConfig", "FeelIntegration", "Model", "cnn", "init_model",
           "make_cache", "make_decode_step", "make_forward",
           "make_prefill_step", "make_train_step", "param_count",
           "params_from_numpy", "trainable"]
