"""phi3-mini-3.8b — dense, RoPE SwiGLU, kv=32 (MHA-equal GQA).
[arXiv:2404.14219; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    grad_accum=4,
    source="arXiv:2404.14219",
)
