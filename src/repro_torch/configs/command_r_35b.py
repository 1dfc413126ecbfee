"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

40L, d_model=8192, 64 heads (GQA kv=8), d_ff=22528, vocab=256000,
untied head.  No biases; rope theta 8e6 (long-context tuned).  The same
dims as the reference's ``repro/configs/command_r_35b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", arch_type="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000,
    layer_pattern=("attn",), rope_theta=8e6,
    optimizer="adamw", citation="hf:CohereForAI/c4ai-command-r-v01",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                         d_ff=256, vocab=512)
