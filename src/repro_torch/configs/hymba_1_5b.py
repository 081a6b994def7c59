"""hymba-1.5b — hybrid: parallel attention + mamba heads in each layer,
ssm_state=16, sliding-window attention on most layers.
[arXiv:2411.13676; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    hybrid_ssm=True,
    ssm_state=16,
    grad_accum=2,
    sliding_window=1024,      # hymba uses SWA + meta tokens; window 1k
    source="arXiv:2411.13676",
)
