"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B family card].

28L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=128256.
rope theta 500000 (llama3 long-context base).  The same dims as the
reference's ``repro/configs/llama3_2_3b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", arch_type="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256,
    layer_pattern=("attn",), rope_theta=5e5,
    optimizer="adamw", citation="hf:meta-llama/Llama-3.2-1B",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=96, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512)
