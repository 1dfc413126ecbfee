"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

38L, d_model=4096, 16 heads (MQA kv=1, head_dim 256), d_ff=12288,
vocab=256000, untied head.  Pattern: (RG-LRU, RG-LRU, local-attention),
local window 2048: 12 full patterns + 2 remaining recurrent layers = 38
(26 rglru, 12 attn_local).  lru_width follows d_model.  The same dims as
the reference's ``repro/configs/recurrentgemma_9b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    layer_pattern=("rglru", "rglru", "attn_local"), window=2048,
    ssm_conv=4, rope_theta=1e4,
    optimizer="adamw", citation="arXiv:2402.19427",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=5, d_model=128, n_heads=4, n_kv_heads=1,
                         d_ff=256, vocab=512, head_dim=32, window=64)
