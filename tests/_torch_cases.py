"""Shapes and seeded numpy inputs shared by the port's tests (on the CPU
against JAX, and on the card against the plain versions). Nothing here
imports JAX at import time: the card's tests import this module without
it."""

import numpy as np

# the rows of FA_CASES, DECODE_CASES and WKV_CASES in tests/test_kernels.py,
# then the head dims of phi3-mini-3.8b (96, MHA), h2o-danube-1.8b (80, GQA
# 4x, a window shorter than S) and pixtral-12b (160, GQA 4x), then
# hymba-1.5b's query group of 5 (25 heads over 5 KV heads, windowed)
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
    (4, 4, 128, 96, None, 64, 64, "float32"),      # hd 96, MHA
    (8, 2, 192, 80, 64, 64, 64, "float32"),        # hd 80, GQA, window
    (8, 2, 160, 160, None, 64, 32, "float32"),     # hd 160, GQA, ragged
    (8, 2, 256, 80, 96, 64, 64, "bfloat16"),       # hd 80 + window + bf16
    (8, 2, 128, 160, None, 64, 64, "bfloat16"),    # hd 160 + bf16
    (10, 2, 256, 64, 96, 64, 64, "float32"),       # GQA 5x (hymba), window
    (10, 2, 192, 64, 64, 64, 64, "bfloat16"),      # GQA 5x + window + bf16
]
DECODE_CASES = [
    # (B, Hkv, grp, S, hd, block_s, dtype)
    (2, 2, 4, 256, 64, 64, "float32"),      # GQA 4x
    (1, 4, 1, 512, 128, 128, "float32"),    # one query per kv head
    (2, 2, 8, 384, 64, 128, "float32"),     # ragged S vs block
    (2, 2, 4, 256, 64, 64, "bfloat16"),     # bf16 io
    (2, 4, 1, 256, 96, 64, "float32"),      # hd 96, one query per kv head
    (2, 2, 4, 320, 80, 64, "float32"),      # hd 80, GQA 4x
    (2, 2, 4, 192, 160, 64, "float32"),     # hd 160, GQA 4x
    (2, 2, 4, 256, 80, 128, "bfloat16"),    # hd 80 + bf16
    (1, 2, 4, 128, 160, 64, "bfloat16"),    # hd 160 + bf16
    (2, 1, 5, 256, 64, 64, "float32"),      # grp 5 (hymba)
    (2, 2, 5, 192, 64, 64, "bfloat16"),     # grp 5 + bf16
]
WKV_CASES = [
    # (BH, S, hd, chunk)
    (4, 64, 16, 16),
    (2, 128, 32, 32),
    (8, 128, 64, 64),
    (3, 96, 16, 32),
    (2, 256, 64, 128),
]


# Mamba scans: (B, S, di, n, carried state); S = 1 is a decode step, 64 the
# kernel's time tile (its chunked body from there on, its token body
# below), 130 = 2 x 64 + 2 a ragged last tile, 512 steps JAX's
# chunked_time_scan in rematerialised 256-step chunks; di 40 and 24 are
# not multiples of the token body's channels a block (32 at n 16, 64 at
# n 8)
MAMBA_CASES = [
    (2, 1, 32, 16, True),
    (4, 2, 40, 16, True),
    (1, 15, 24, 8, True),
    (2, 63, 48, 16, False),
    (2, 64, 32, 16, True),
    (1, 65, 16, 8, True),
    (3, 130, 40, 8, False),
    (2, 130, 32, 16, True),
    (2, 40, 24, 8, True),
    (1, 70, 16, 16, True),
    (2, 512, 16, 16, True),
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


def wkv_inputs(shape, seed):
    """r, k, v, w of ``shape`` (..., hd) and u of ``shape[-2:]`` (the heads
    and hd of the model layout, or (BH, hd) of the 3-D one), float32. The
    decay is in (0, 0.98), like exp(-exp(x))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rand(rng, shape) for _ in range(3))
    w = 0.98 / (1.0 + np.exp(-rand(rng, shape, 2.0)))
    u = rand(rng, shape[-2:] if len(shape) == 4 else (shape[0], shape[-1]))
    return r, k, v, w.astype(np.float32), u


def mamba_inputs(b, s, di, n, seed, carried=True):
    """The fused scan's inputs, float32: dt_raw (B, S, di) with dt_bias (di)
    such that softplus(dt_raw + dt_bias) spans ~0.005 (a decay near 1, the
    state kept for hundreds of steps) to ~6, and a few entries past
    softplus's threshold of 20; b and c as the two halves of one (B, S, 2n)
    projection; x (B, S, di); zz (B, S, 2 di), whose second half is z, as
    in ``in_proj``'s output; a_log (di, n) near JAX's log(1..n); d_skip
    (di) near its init of 1; a start state h (B, di, n) or None."""
    rng = np.random.default_rng(seed)
    dt_raw = rand(rng, (b, s, di), 1.5) - 1.5
    dt_raw.flat[::97] = 25.0
    dt_bias = rand(rng, (di,), 0.5) - 0.5
    bc = rand(rng, (b, s, 2 * n), 1.0)
    x = rand(rng, (b, s, di), 1.0)
    zz = rand(rng, (b, s, 2 * di), 1.0)
    a_log = (np.log(np.arange(1, n + 1))[None, :]
             + rand(rng, (di, n), 0.3)).astype(np.float32)
    d_skip = 1.0 + rand(rng, (di,), 0.5)
    h = rand(rng, (b, di, n), 1.0) if carried else None
    return dt_raw, dt_bias, bc, x, zz, a_log, d_skip, h


def randomise_norms_and_biases(params, seed):
    """JAX params with norm weights (init 1) and biases (init 0) -> random
    values; so are RWKV's shift mixes (init 0.5) and decay bias (init -6),
    and Mamba's conv bias and dt bias (init 0) and skip (init 1), so that
    each is really exercised."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = str(path[-1].key)
        if name in ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "ln_w"):
            return jnp.asarray(1.0 + rand(rng, leaf.shape, 0.2), leaf.dtype)
        if name == "d_skip":
            return jnp.asarray(1.0 + rand(rng, leaf.shape, 0.5), leaf.dtype)
        if name in ("bq", "bk", "bv", "ln_b", "conv_b", "dt_bias"):
            return jnp.asarray(rand(rng, leaf.shape, 0.2), leaf.dtype)
        if name == "mu":
            return jnp.asarray(rng.uniform(0, 1, leaf.shape), leaf.dtype)
        if name == "w0":
            return jnp.asarray(-6.0 + rand(rng, leaf.shape, 2.0), leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(one, params)
