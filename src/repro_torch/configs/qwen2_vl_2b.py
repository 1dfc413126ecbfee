"""Qwen2-VL-2B language backbone [arXiv:2409.12191].

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
M-RoPE with (temporal, height, width) = (16, 24, 24) frequency-pair
sections over head_dim=128; dynamic-resolution patches arrive as
precomputed embeddings (the ViT frontend is the allowed stub).
The same dims as the reference's ``repro/configs/qwen2_vl_2b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", arch_type="vlm", modality="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936, head_dim=128,
    layer_pattern=("attn",), rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    optimizer="adamw", citation="arXiv:2409.12191",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512, head_dim=32,
                         mrope_sections=(4, 6, 6))
