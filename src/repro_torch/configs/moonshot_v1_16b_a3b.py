"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,            # GQA kv=16 (== n_heads: effectively MHA)
    d_ff=1408,                # per-expert FFN width
    vocab_size=163840,
    n_experts=64,
    experts_per_token=6,
    grad_accum=4,
    source="hf:moonshotai/Moonlight-16B-A3B",
)
