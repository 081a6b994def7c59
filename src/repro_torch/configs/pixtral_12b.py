"""pixtral-12b — Pixtral-ViT + mistral-nemo decoder backbone. The vision
frontend is a STUB: input_specs() provides precomputed patch embeddings.
[hf:mistralai/Pixtral-12B-2409; unverified]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    embedding_stub=True,      # patch embeddings supplied by the frontend stub
    grad_accum=8,    # f32 patch-embed inputs + d=5120 stash: fits HBM at 8
    source="hf:mistralai/Pixtral-12B-2409",
)
