"""rwkv6-3b — Finch: attention-free, data-dependent decay time-mix.
[arXiv:2404.05892; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    attn_free=True,
    grad_accum=4,
    rwkv_head_dim=64,         # 2560 / 64 = 40 wkv heads
    source="arXiv:2404.05892",
)
