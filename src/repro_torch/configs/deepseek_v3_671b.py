"""DeepSeek-V3 671B [arXiv:2412.19437].

61L, d_model=7168, 128 heads, MLA (q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v_head=128), vocab=129280.
MoE: 1 shared + 256 routed experts, top-8, per-expert d_ff=2048;
first 3 layers dense (d_ff=18432).  The multi-token-prediction head is
not reproduced, as in the reference's ``repro/configs/deepseek_v3_671b.py``,
whose dims these are.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", arch_type="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280,
    layer_pattern=("mla",), first_dense=3,
    n_experts=256, n_shared_experts=1, topk=8, moe_d_ff=2048,
    q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    optimizer="adafactor", citation="arXiv:2412.19437",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                         d_ff=256, vocab=512, first_dense=1,
                         n_experts=4, topk=2, moe_d_ff=64,
                         q_lora=48, kv_lora=32, qk_nope_dim=16,
                         qk_rope_dim=8, v_head_dim=16,
                         capacity_factor=8.0)
