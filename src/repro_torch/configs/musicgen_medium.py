"""MusicGen-medium decoder [arXiv:2306.05284].

48L, d_model=1536, 24 heads (MHA kv=24, head_dim 64), d_ff=6144,
4 EnCodec codebooks of vocab 2048 (sum-embedding in, 4 LM heads out).
The conv codec frontend is the allowed stub; the token-space decoder
(incl. the delay-pattern training loss over 4 codebooks) is real.
Gated-GELU FFN replaces the original plain GELU (noted in DESIGN.md).
The same dims as the reference's ``repro/configs/musicgen_medium.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", arch_type="audio", modality="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048, n_codebooks=4,
    layer_pattern=("attn",), act="gelu", rope_theta=1e4,
    optimizer="adamw", citation="arXiv:2306.05284",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                         d_ff=256, vocab=128, n_codebooks=2)
