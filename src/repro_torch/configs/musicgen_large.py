"""musicgen-large — decoder-only transformer over EnCodec tokens. The
EnCodec frontend is a STUB: input_specs() provides precomputed frame
embeddings. [arXiv:2306.05284; hf]"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    embedding_stub=True,
    grad_accum=4,      # EnCodec frame embeddings from the stub
    source="arXiv:2306.05284",
)
