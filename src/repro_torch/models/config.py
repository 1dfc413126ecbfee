"""Architecture configuration.

One frozen dataclass describes every assigned architecture; the
decoder in ``transformer.py`` is driven entirely by it.  Layer layout
is expressed as a repeating ``layer_pattern`` of block kinds:

    "attn"        global causal attention + (dense or MoE) FFN
    "attn_local"  sliding-window attention + FFN
    "mla"         multi-head latent attention (DeepSeek) + FFN
    "mamba"       Mamba-1 selective-SSM mixer (no separate FFN)
    "rglru"       RG-LRU recurrent mixer + FFN

The pattern repeats floor(L / len(pattern)) times; the
L % len(pattern) remainder layers follow from the pattern prefix.

Counterpart of ``repro/models/config.py``: the same fields and
properties, so a config of either package describes the same model.
``act_dtype`` is a ``torch.dtype``.  The port's decoder runs
``"attn"``, ``"attn_local"`` and ``"rglru"`` blocks with a dense FFN
and ``"mamba"`` blocks so far (``transformer.py`` raises on the
others); the fields of the other kinds are kept so that configs carry
over unchanged.  The lowering fields (``unroll_layers``,
``scan_unroll``) steer the reference's XLA scan and have no effect here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- layer layout -------------------------------------------------
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0               # sliding window for attn_local
    ffn_in_pattern: bool = True   # mamba blocks have no FFN

    # --- attention ----------------------------------------------------
    head_dim: Optional[int] = None    # default d_model // n_heads
    rope_theta: float = 1e4
    rope_theta_local: Optional[float] = None  # gemma3 local layers
    rope_fraction: float = 1.0        # stablelm partial rotary
    qk_norm: bool = False             # gemma3
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) split
    attn_logit_softcap: float = 0.0

    # --- MoE ------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0
    first_dense: int = 0          # leading dense layers (DeepSeek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-3

    # --- MLA ------------------------------------------------------------
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (mamba-1) ----------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_dt_rank: int = 0          # default ceil(d_model / 16)

    # --- RG-LRU -----------------------------------------------------------
    lru_width: int = 0            # default d_model

    # --- modality ---------------------------------------------------------
    modality: str = "text"        # text | vlm | audio
    n_codebooks: int = 4          # audio codebooks (musicgen)

    # --- lowering (the reference's XLA scan; no effect in the port) ---------
    unroll_layers: bool = False
    scan_unroll: int = 1

    # --- numerics / training ----------------------------------------------
    dtype: str = "bfloat16"
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    remat: bool = True
    use_bias: bool = False
    norm: str = "rmsnorm"
    act: str = "silu"             # silu (gated) | gelu (gated)
    tie_embeddings: bool = False
    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_dt_rank_(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    @property
    def n_pattern_repeats(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def n_tail_layers(self) -> int:
        return self.n_layers % len(self.layer_pattern)

    @property
    def act_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced variant of the same family (smoke tests)."""
        return dataclasses.replace(self, **overrides)

    def validate(self) -> None:
        """The reference's consistency checks, raised as ``ValueError``."""
        checks = [
            (self.n_layers >= 1, "n_layers >= 1"),
            ("mla" not in self.layer_pattern or self.kv_lora > 0,
             "mla blocks need kv_lora > 0"),
            (not self.n_experts or (self.topk > 0 and self.moe_d_ff > 0),
             "MoE needs topk > 0 and moe_d_ff > 0"),
            ("attn_local" not in self.layer_pattern or self.window > 0,
             "attn_local blocks need window > 0"),
            (self.modality != "vlm" or len(self.mrope_sections) == 3,
             "vlm needs three mrope_sections"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"{self.name}: {what}")
