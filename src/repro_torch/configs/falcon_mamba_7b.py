"""Falcon-Mamba-7B [arXiv:2410.05355].

64 attention-free Mamba-1 layers, d_model=4096, ssm_state=16,
expand=2 (d_inner=8192), conv=4, dt_rank=256, vocab=65024, untied
head.  The same dims as the reference's
``repro/configs/falcon_mamba_7b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024,
    layer_pattern=("mamba",), ffn_in_pattern=False,
    ssm_state=16, ssm_expand=2, ssm_conv=4,
    optimizer="adamw", citation="arXiv:2410.05355",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=128, vocab=512, ssm_state=8)
