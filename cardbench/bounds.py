"""The yardstick's arithmetic: the least time the card could take for a
training step or a prefill, the flops of the kernels the per-layer
metrics judge, and the table of the card's peaks.

Frozen copies of the hand bounds of ``chip_smoke.py`` (``train_work``,
``train_bound``, the prefill part of ``serve_bounds``, ``mamba_flops``,
``visible_pairs``, ``bound_ms``, ``typed_flops``, ``KINDS``) and of
``ArchConfig.param_count``, taking the model's sizes (``spec.Model``) and
the shapes as arguments instead of module constants. They count: 6 flops a
matmul parameter a trained token (2 a served one), causal attention's pairs
inside the window (its backward twice the forward), the recurrences' fp32
flops; a step's bytes are the bf16 parameters read and written, the fp32
gradient accumulator read and AdamW's m and v read and written, once each;
a prefill reads every weight but the embedding table once and writes a
hybrid's Mamba states once. Recomputation is not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: HBM3 bytes/s, flops/s by dtype name
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
FP32_PARTS = ("wkv6", "mamba_scan", "Wkv6FnBackward", "MambaScanFnBackward",
              "router")
DT_RANK = 64            # the port's Mamba dt projection rank
CONV_K = 4              # the port's Mamba conv taps

# kernel kinds by a fragment of the kernel's name, first match wins
KINDS = (("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
         ("flash attention kernel", ("fa_hopper", "fa_f32")),
         ("flash attention backward kernels", ("fa_bwd",)),
         ("flash decode kernel", ("fd_split", "fd_merge")),
         ("Mamba scan kernel", ("mamba_scan",)),
         ("WKV6 kernel", ("wkv6_",)),
         ("softmax", ("softmax",)),
         ("reductions", ("reduce",)),
         ("elementwise and copies", ("elementwise", "copy", "fill",
                                     "index", "scatter", "gather")))


def kind_of(kernel: str) -> str:
    return next((k for k, keys in KINDS if any(x in kernel for x in keys)),
                "other")


def bound_s(n_bytes: float, flops: dict) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations,
    ``{dtype name: flops}``, over each type's peak rate, in seconds."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[dt] for dt, n in flops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def typed_flops(parts: dict) -> dict:
    """{part: flops} -> {dtype name: flops}: the recurrences in fp32, the
    matrix products and attention in bf16."""
    fp32 = sum(v for k, v in parts.items() if k in FP32_PARTS)
    return {"bfloat16": sum(parts.values()) - fp32, "float32": fp32}


def visible_pairs(s: int, window) -> int:
    """Causal (query, key) pairs of an S-token sequence inside the window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def mamba_flops(tokens: int, di: int, n: int) -> tuple[int, int]:
    """fp32 flops of the fused Mamba scan, (forward, backward): 7 a (token,
    channel, state) and 10 a (token, channel) forward; 14 and 15 backward."""
    return (7 * n + 10) * di * tokens, (14 * n + 15) * di * tokens


def wkv6_flops(tokens: int, heads: int, hd: int) -> tuple[int, int]:
    """fp32 flops of the WKV6 recurrence, (forward, backward)."""
    return 5 * hd * hd * heads * tokens, 11 * hd * hd * heads * tokens


def param_count(m) -> int:
    """The model's parameters, as ``ArchConfig.param_count`` counts them."""
    d, f, v = m.d_model, m.d_ff, m.vocab_size
    per_layer = 0
    if not m.attn_free:
        per_layer += d * m.n_heads * m.hd + 2 * d * m.n_kv_heads * m.hd \
            + m.n_heads * m.hd * d
    if m.attn_free:
        per_layer += 5 * d * d + 2 * d * 64 + 2 * d * f // 2 + d * f
    elif m.hybrid_ssm:
        di = m.n_heads * m.hd
        per_layer += 2 * d * di + di * (2 * m.ssm_state + 2) + di * d
    if m.n_experts:
        per_layer += m.n_experts * 3 * d * f + d * m.n_experts
        if m.moe_dense_residual:
            per_layer += 3 * d * f
    elif not m.attn_free:
        per_layer += 3 * d * f
    per_layer += 2 * d
    total = m.n_layers * per_layer + v * d + 2 * d
    if not m.tie_embeddings:
        total += v * d
    return total


def train_work(m, seqs: int, seq_len: int) -> dict:
    """Flops of a train step over ``seqs`` sequences of ``seq_len`` tokens,
    by part: "dense" (the bf16 matrix products), a kernel's name for its
    forward, its Function's backward."""
    d, hd, f = m.d_model, m.hd, m.d_ff
    tokens = seqs * seq_len
    parts = {}
    router = 0
    if m.attn_free:
        per_layer = 6 * d * d + 2 * d * f + 2 * d * 64
        fwd, bwd = wkv6_flops(tokens, d // m.rwkv_head_dim, m.rwkv_head_dim)
        parts.update(wkv6=fwd, Wkv6FnBackward=bwd)
    else:
        ffn = 3 * d * f * (m.experts_per_token + m.moe_dense_residual) \
            if m.n_experts else 3 * d * f
        per_layer = d * (m.n_heads + 2 * m.n_kv_heads) * hd \
            + m.n_heads * hd * d + ffn
        if m.n_experts:
            router = 6 * d * m.n_experts * tokens
        attn = 4 * m.n_heads * hd * visible_pairs(
            seq_len, m.sliding_window) * seqs
        parts.update(flash_attention=attn, FlashAttentionFnBackward=2 * attn)
    if m.hybrid_ssm:
        di, n = m.n_heads * hd, m.ssm_state
        per_layer += 3 * d * di + 2 * di * DT_RANK + 2 * di * n
        fwd, bwd = mamba_flops(tokens, di, n)
        parts.update(mamba_scan=fwd, MambaScanFnBackward=bwd)
    if router:
        parts["router"] = router
    parts = {k: v * m.n_layers for k, v in parts.items()}
    parts["dense"] = 6 * (m.n_layers * per_layer + d * m.vocab_size) * tokens
    return parts


def train_bound(m, seqs: int, seq_len: int) -> tuple[float, str]:
    """Least seconds of one train step, and what bounds it."""
    return bound_s(param_count(m) * (2 * 2 + 4 + 2 * 8),
                   typed_flops(train_work(m, seqs, seq_len)))


def prefill_work(m, weights: dict, requests: int, prompt_len: int) -> dict:
    """Flops by part and bytes of one prefill of ``requests`` prompts of
    ``prompt_len`` tokens and its last token's LM head. ``weights``:
    {"layer_params", "layer_bytes", "head_params", "head_bytes"}, counted
    from the parameter tree (``weights.census``)."""
    L, tokens = m.n_layers, requests * prompt_len
    layer_flop_params = weights["layer_params"] - L * (
        m.n_experts - m.experts_per_token) * 3 * m.d_model * m.d_ff
    if m.attn_free:
        hd = m.rwkv_head_dim
        seq = {"wkv6": L * wkv6_flops(tokens, m.d_model // hd, hd)[0]}
    else:
        seq = {"flash_attention": 4 * requests * m.n_heads * m.hd * L
               * visible_pairs(prompt_len, m.sliding_window)}
    state_bytes = 0
    if m.hybrid_ssm:
        di = m.n_heads * m.hd
        seq["mamba_scan"] = L * mamba_flops(tokens, di, m.ssm_state)[0]
        state_bytes = 4 * L * requests * di * m.ssm_state \
            + L * requests * (CONV_K - 1) * di * weights["head_bytes"] \
            // weights["head_params"]
    flops = {"dense": 2 * layer_flop_params * tokens
             + 2 * weights["head_params"] * requests, **seq}
    return {"flops": flops, "bytes": weights["layer_bytes"]
            + weights["head_bytes"] + state_bytes}


def prefill_bound(m, weights: dict, requests: int,
                  prompt_len: int) -> tuple[float, str]:
    """Least seconds of one prefill, and what bounds it."""
    work = prefill_work(m, weights, requests, prompt_len)
    return bound_s(work["bytes"], typed_flops(work["flops"]))


def attention_call_bound(op: str, shapes: list, sizes: list,
                         window) -> float:
    """Least seconds of one call of a flash-attention operator, from its
    operands' shapes and element sizes: each input read once and each
    output written once; the forward's flops 4 hd a visible (query, key)
    pair a head, the backward's twice that. ``op``: "forward", "train"
    (the forward that also writes the rows' log-sum-exp) or "backward"."""
    (b, sq, h, hd), (_, sk, hkv, _) = shapes[0], shapes[1]
    width = min(sk, window or sk)
    pairs = sq * (sq + 1) // 2 if sq <= width \
        else width * (width + 1) // 2 + (sq - width) * width
    flops = 4 * b * h * hd * pairs
    q_bytes = b * sq * h * hd * sizes[0]
    kv_bytes = 2 * b * sk * hkv * hd * sizes[1]
    lse_bytes = 4 * b * h * sq
    if op == "forward":
        n_bytes = 2 * q_bytes + kv_bytes
    elif op == "train":
        n_bytes = 2 * q_bytes + kv_bytes + lse_bytes
    else:   # q, k, v, out, lse, dout read; dq, dk, dv written
        n_bytes = 3 * q_bytes + lse_bytes + kv_bytes + q_bytes + kv_bytes
        flops *= 2
    return bound_s(n_bytes, {"bfloat16": flops})[0]


def scan_call_bound(op: str, shapes: list, sizes: list) -> float:
    """Least seconds of one call of a Mamba scan operator from its
    operands' shapes and element sizes, ``mamba_flops`` in fp32. Bytes:
    dt, x, z (B, S, di), b, c (B, S, n), dt_bias, d_skip (di) and a_log
    (di, n) read once, out (B, S, di) written once; serving's forward also
    reads and writes the state (B, di, n) fp32, the training forward
    writes it; the backward reads dout and writes every input's gradient.
    The chunk starts that training keeps are not counted, so the bound is
    a little low. ``op``: "forward", "train" or "backward"."""
    bsz, s, di = shapes[0]
    n = shapes[6][1]
    seq, bc = bsz * s * di * sizes[0], bsz * s * n * sizes[2]
    inputs = 3 * seq + 2 * bc + di * 4 * 2 + di * n * 4
    state = bsz * di * n * 4
    fwd, bwd = mamba_flops(bsz * s, di, n)
    if op == "forward":
        return bound_s(inputs + seq + 2 * state, {"float32": fwd})[0]
    if op == "train":
        return bound_s(inputs + seq + state, {"float32": fwd})[0]
    return bound_s(2 * inputs + seq, {"float32": bwd})[0]
