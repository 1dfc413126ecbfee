"""StableLM-2-12B [hf:stabilityai/stablelm-2-1_6b family card].

40L, d_model=5120, 32 heads (GQA kv=8, head_dim 160), d_ff=13824,
vocab=100352.  Partial rotary embeddings (25% of head_dim), no biases.
The same dims as the reference's ``repro/configs/stablelm_12b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", arch_type="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352,
    layer_pattern=("attn",), rope_fraction=0.25, rope_theta=1e4,
    optimizer="adamw", citation="hf:stabilityai/stablelm-2-12b",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512)
