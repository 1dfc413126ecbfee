"""Models of the port (counterpart of ``repro.models``): the §VI-A CNN
and the decoder of the LLM zoo (global and sliding-window attention
blocks, with M-RoPE for the vlm, multi-head latent attention blocks,
``mla.py``, and RG-LRU blocks, ``rglru.py``, each with a dense or a
mixture-of-experts FFN, ``moe.py``, and ``"mamba"`` blocks, ``ssm.py``)
over text, vlm (embeddings in) and audio (codebook tokens in, a head
per codebook) inputs, with its train (FEEL selection inside), prefill
and decode steps, and the reference's stacked body groups
(``stacked_groups``) that adafactor steps as one leaf each."""
from . import cnn  # noqa: F401
from .config import ArchConfig
from .model import (FeelIntegration, Model, init_model, make_cache,
                    make_decode_step, make_forward, make_prefill_step,
                    make_train_step, param_count, params_from_numpy,
                    stacked_groups, trainable)

__all__ = ["ArchConfig", "FeelIntegration", "Model", "cnn", "init_model",
           "make_cache", "make_decode_step", "make_forward",
           "make_prefill_step", "make_train_step", "param_count",
           "params_from_numpy", "stacked_groups", "trainable"]
