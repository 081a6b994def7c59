"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    grad_accum=2,      # SWA: KV bounded by the window => long_500k ok
    source="arXiv:2401.16818",
)
