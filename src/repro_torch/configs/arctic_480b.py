"""arctic-480b — Snowflake Arctic: 128 experts top-2 + parallel dense
residual FFN. [hf:Snowflake/snowflake-arctic-base; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
    grad_accum=8,             # activation-memory bound at 1M tokens/step
    optimizer="adafactor",    # Adam states for 480B params exceed v5e HBM
    source="hf:Snowflake/snowflake-arctic-base",
)
