"""Gemma-3-12B [hf:google/gemma-3-12b family card].

48L, d_model=3840, 16 heads (GQA kv=8, head_dim 256), d_ff=15360,
vocab=262144, untied head.  5 local (1024-window, theta 1e4) : 1 global
(theta 1e6) interleave; qk-norm.  The same dims as the reference's
``repro/configs/gemma3_12b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", arch_type="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, head_dim=256,
    layer_pattern=("attn_local",) * 5 + ("attn",), window=1024,
    rope_theta=1e6, rope_theta_local=1e4, qk_norm=True,
    optimizer="adamw", citation="hf:google/gemma-3-1b-pt",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=6, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512, head_dim=32, window=32)
