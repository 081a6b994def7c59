"""qwen3-8b — dense, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    grad_accum=4,
    source="hf:Qwen/Qwen3-8B",
)
