"""DeepSeek-V2 236B [arXiv:2405.04434].

60L, d_model=5120, 128 heads, MLA (q_lora=3072, kv_lora=512), vocab=102400.
MoE: 2 shared + 160 routed experts, top-6, per-expert d_ff=1536;
first layer dense (d_ff=12288).  The same dims as the reference's
``repro/configs/deepseek_v2_236b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b", arch_type="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400,
    layer_pattern=("mla",), first_dense=1,
    n_experts=160, n_shared_experts=2, topk=6, moe_d_ff=1536,
    q_lora=3072, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    optimizer="adafactor", citation="arXiv:2405.04434",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                         d_ff=256, vocab=512, first_dense=1,
                         n_experts=4, topk=2, moe_d_ff=64,
                         q_lora=48, kv_lora=32, qk_nope_dim=16,
                         qk_rope_dim=8, v_head_dim=16,
                         n_shared_experts=1, capacity_factor=8.0)
