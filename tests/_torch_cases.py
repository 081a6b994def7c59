"""Shapes and seeded numpy inputs shared by the port's kernel tests (on the
CPU against JAX, and on the card against the plain versions)."""

import numpy as np

# the rows of FA_CASES and DECODE_CASES in tests/test_kernels.py
FA_CASES = [
    # (BH, BHkv, S, hd, window, block_q, block_k, dtype)
    (4, 4, 128, 64, None, 64, 64, "float32"),      # MHA
    (8, 2, 256, 64, None, 64, 64, "float32"),      # GQA 4x
    (6, 2, 192, 32, None, 64, 64, "float32"),      # ragged: S % block != 0
    (4, 4, 256, 64, 64, 64, 64, "float32"),        # sliding window
    (4, 2, 256, 128, None, 128, 128, "float32"),   # 128-wide hd
    (4, 4, 128, 64, None, 32, 128, "float32"),     # bq != bk
    (4, 2, 128, 64, None, 64, 64, "bfloat16"),     # bf16 io
    (2, 1, 512, 64, 128, 128, 64, "bfloat16"),     # window + bf16
]
DECODE_CASES = [
    # (B, Hkv, grp, S, hd, block_s, dtype)
    (2, 2, 4, 256, 64, 64, "float32"),      # GQA 4x
    (1, 4, 1, 512, 128, 128, "float32"),    # one query per kv head
    (2, 2, 8, 384, 64, 128, "float32"),     # ragged S vs block
    (2, 2, 4, 256, 64, 64, "bfloat16"),     # bf16 io
]


def rand(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def fa_inputs(bh, bhkv, s, hd, seed):
    """q (BH, S, hd), k/v (BHkv, S, hd), float32."""
    rng = np.random.default_rng(seed)
    return (rand(rng, (bh, s, hd)), rand(rng, (bhkv, s, hd)),
            rand(rng, (bhkv, s, hd), 1.0))


def decode_inputs(b, hkv, grp, s, hd, seed):
    """q (B, 1, H, hd), caches (B, S, Hkv, hd) float32, cache_len (B,)."""
    rng = np.random.default_rng(seed)
    q = rand(rng, (b, 1, hkv * grp, hd))
    kc = rand(rng, (b, s, hkv, hd))
    vc = rand(rng, (b, s, hkv, hd), 1.0)
    cache_len = np.array([s // 2, s][:b] if b > 1 else [s // 2], np.int32)
    return q, kc, vc, cache_len
