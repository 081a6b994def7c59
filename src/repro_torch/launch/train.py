"""Training presets, copied from ``repro.launch.train``. The training loop
itself (``run_training``) is the next slice of the port (ROADMAP.md queue
1, item 1)."""

from __future__ import annotations

from ..configs.base import ArchConfig

PRESETS = {
    "tiny": ArchConfig(
        name="tiny-12m", family="dense", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=4096,
        grad_accum=1, param_dtype="float32"),
    "100m": ArchConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2304, vocab_size=32000,
        grad_accum=1, param_dtype="float32"),
}
