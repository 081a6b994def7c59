"""Decoder stack, ported from ``repro.models.transformer``: the dense
family (serving and training) and the attention-free RWKV6 family
(serving).

Parameters are a nested dict of tensors with the JAX tree's keys and its
layer-stacked ``(L, ...)`` leaves; a Python loop over layers takes the
place of ``lax.scan``. Attention goes through ``kernels.ops`` on
un-repeated K/V: the kernels index the shared KV head themselves. RWKV
layers run ``models.ssm``, whose recurrence is ``kernels.ops.wkv6``.

Entry points:
  forward_train  tokens, labels -> mean next-token cross-entropy, chunked
                 over the sequence so the full (B, S, V) logits never exist;
                 each layer (with ``cfg.remat``) and each loss chunk is
                 recomputed in the backward (``torch.utils.checkpoint``)
  prefill      tokens -> (last-token logits, caches, positions)
  decode_step  one token per row + caches -> (logits, caches); the new
               token's K/V, or the new RWKV states, are written into the
               caches in place
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels import ops
from .layers import (apply_rope, dense_init, rms_norm, rope_tables, swiglu)
from .ssm import (apply_rwkv_cmix, apply_rwkv_tmix, init_rwkv_cmix,
                  init_rwkv_tmix)

# config flags this slice does not cover, with the ROADMAP item that will
UNPORTED = {
    "is_moe": "MoE family (ROADMAP.md queue 1, item 3)",
    "hybrid_ssm": "hybrid family (ROADMAP.md queue 1, item 3)",
    "embedding_stub": "stub-frontend family (ROADMAP.md queue 1, item 3)",
}


LOSS_CHUNK = 1024
# training of RWKV6 runs through the WKV6 kernel, which has no gradient yet
RWKV_TRAINING = "RWKV6 training needs a gradient for the WKV6 kernel " \
    "(ROADMAP.md queue 1, item 1)"


def _check_ported(cfg: ArchConfig) -> None:
    for flag, item in UNPORTED.items():
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{cfg.name}: {flag} is not ported yet: {item}")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ================================================================= init
def init_params(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random parameters on ``gen``'s device, in the JAX tree's layout.
    The values differ from JAX's for the same seed; parity tests bring
    weights over with ``bridge.params_from_numpy``."""
    _check_ported(cfg)
    dtype, dev = _dtype(cfg), gen.device
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.attn_free:
        layers = {"ln1": ones(L, d), "ln2": ones(L, d),
                  "tmix": init_rwkv_tmix(gen, cfg, dtype),
                  "cmix": init_rwkv_cmix(gen, cfg, dtype)}
    else:
        attn = {
            "wq": dense_init(gen, (L, d, h * hd), dtype),
            "wk": dense_init(gen, (L, d, hkv * hd), dtype),
            "wv": dense_init(gen, (L, d, hkv * hd), dtype),
            "wo": dense_init(gen, (L, h * hd, d), dtype),
        }
        if cfg.qkv_bias:
            attn.update(bq=zeros(L, h * hd), bk=zeros(L, hkv * hd),
                        bv=zeros(L, hkv * hd))
        if cfg.qk_norm:
            attn.update(q_norm=ones(L, hd), k_norm=ones(L, hd))
        layers = {"ln1": ones(L, d), "ln2": ones(L, d), "attn": attn}
    params = {
        "embed": dense_init(gen, (cfg.vocab_size, d), dtype),
        "layers": layers,
        "final_norm": ones(d),
    }
    if not cfg.attn_free:
        layers["mlp"] = {
            "w_gate": dense_init(gen, (L, d, f), dtype),
            "w_up": dense_init(gen, (L, d, f), dtype),
            "w_down": dense_init(gen, (L, f, d), dtype),
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype)
    return params


def _layer(tree: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ============================================================ attention
def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.view(b, s, cfg.n_heads, cfg.hd)
    k = k.view(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.view(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def apply_attn_seq(p: dict, x: torch.Tensor, cfg: ArchConfig, rope: tuple,
                   impl: str = "kernel") -> tuple[torch.Tensor, dict]:
    """Full-sequence attention; returns the output and (k, v) to cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    out = ops.flash_attention(q, k, v, window=cfg.sliding_window, impl=impl)
    out = out.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]
    return out, {"k": k, "v": v}


def apply_attn_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
                      pos: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
    """One-token decode against a (possibly ring-buffered) KV cache.

    cache: {"k": (B, C, Hkv, hd), "v": ...}, written in place at slot
    ``pos % C``. pos: (B,) absolute position of the new token.
    """
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    rope = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    cache_size = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    slot = (pos % cache_size).long()
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    cache_len = torch.clamp(pos + 1, max=cache_size).to(torch.int32)
    # the ring holds exactly the window: mask by valid slot count only
    grp = cfg.n_heads // cfg.n_kv_heads
    out = ops.decode_attention(q.view(b, cfg.n_kv_heads, grp, cfg.hd),
                               cache["k"], cache["v"], cache_len, impl=impl)
    return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]


# =============================================================== blocks
def apply_block_seq(lp: dict, x: torch.Tensor, cfg: ArchConfig, rope: tuple,
                    impl: str = "kernel") -> tuple[torch.Tensor, dict]:
    """One layer over a full sequence. Returns (x, kv cache)."""
    attn_out, kv = apply_attn_seq(lp["attn"], rms_norm(x, lp["ln1"],
                                                       cfg.norm_eps),
                                  cfg, rope, impl)
    x = x + attn_out
    m = lp["mlp"]
    x = x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), m["w_gate"],
                   m["w_up"], m["w_down"])
    return x, kv


def apply_block_decode(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                       cache: dict, pos: torch.Tensor,
                       impl: str = "kernel") -> torch.Tensor:
    """One layer for one decode token; writes its K/V into ``cache``."""
    x = x + apply_attn_decode(lp["attn"], rms_norm(x, lp["ln1"],
                                                   cfg.norm_eps),
                              cfg, cache, pos, impl)
    m = lp["mlp"]
    return x + swiglu(rms_norm(x, lp["ln2"], cfg.norm_eps), m["w_gate"],
                      m["w_up"], m["w_down"])


def apply_rwkv_block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                     cache: dict, impl: str = "kernel") -> torch.Tensor:
    """One RWKV layer over a sequence or one decode token: JAX's attn_free
    branch of ``apply_block_seq`` and ``apply_block_decode``. It starts from
    the layer's states in ``cache`` ({"tmix": {"shift", "wkv"}, "cmix"};
    zeros before a prefill) and writes the new ones there in place."""
    normed = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h, tstate = apply_rwkv_tmix(lp["tmix"], normed, cfg, cache["tmix"], impl)
    x = x + h
    cache["tmix"]["shift"].copy_(tstate["shift"])   # wkv: already in place
    normed = rms_norm(x, lp["ln2"], cfg.norm_eps)
    h, cstate = apply_rwkv_cmix(lp["cmix"], normed, cfg, cache["cmix"])
    cache["cmix"].copy_(cstate)
    return x + h


# ============================================================= training
def _block_train(x: torch.Tensor, lp: dict, cfg: ArchConfig, rope: tuple,
                 impl: str) -> torch.Tensor:
    return apply_block_seq(lp, x, cfg, rope, impl)[0]


def hidden_states(params: dict, cfg: ArchConfig, batch: dict,
                  remat: Optional[bool] = None, impl: str = "kernel"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward to the final hidden states (pre-head), and the
    auxiliary loss (0 for the dense family). With remat (``cfg.remat`` unless
    given) each layer runs again in the backward, as under JAX's
    ``jax.checkpoint``, so only its input is kept. ``params["layers"]`` is
    the stacked tree or a list of per-layer trees (the train step passes
    those, so that each layer's gradient lands in its slice in place)."""
    _check_ported(cfg)
    if cfg.attn_free:
        raise NotImplementedError(f"{cfg.name}: {RWKV_TRAINING}")
    x = params["embed"][batch["tokens"]]
    s = x.shape[1]
    rope = rope_tables(torch.arange(s, device=x.device), cfg.hd,
                       cfg.rope_theta)
    layers = params["layers"]
    use_remat = cfg.remat if remat is None else remat
    for i in range(cfg.n_layers):
        lp = layers[i] if isinstance(layers, list) else _layer(layers, i)
        if use_remat:
            x = checkpoint(_block_train, x, lp, cfg, rope, impl,
                           use_reentrant=False)
        else:
            x = _block_train(x, lp, cfg, rope, impl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _chunk_ce(h: torch.Tensor, w: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: fp32 logits of the head's product,
    as JAX casts them."""
    logits = (h @ w).float()
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def forward_train(params: dict, cfg: ArchConfig, batch: dict,
                  impl: str = "kernel") -> torch.Tensor:
    """Mean next-token cross-entropy plus 0.01 x the auxiliary loss.
    batch: {"tokens", "labels"}, (B, S) integer tensors. The sequence is cut
    into chunks as JAX's ``forward_train`` cuts it, ``max(1, S // min(1024,
    S))`` chunks of ``S // n`` tokens, and like JAX it accepts no S those
    chunks do not cover (S = 2049 raises; 1500 and 2500 do not). Each
    chunk's (B, chunk, V) fp32 logits are recomputed in the backward, so
    only one chunk's exist at a time."""
    h, aux = hidden_states(params, cfg, batch, impl=impl)
    labels = batch["labels"].long()
    w = lm_head_weight(params, cfg)
    b, s, _ = h.shape
    n_chunks = max(1, s // min(LOSS_CHUNK, s))
    chunk = s // n_chunks
    if n_chunks * chunk != s:
        raise ValueError(
            f"sequence length {s}: the chunked loss takes {n_chunks} chunks "
            f"of {chunk} tokens (max(1, S // min({LOSS_CHUNK}, S)) chunks of "
            f"S // n_chunks, as the JAX package's forward_train), which do "
            f"not cover it")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s, chunk):
        total = total + checkpoint(_chunk_ce, h[:, c:c + chunk], w,
                                   labels[:, c:c + chunk],
                                   use_reentrant=False)
    return total / (b * s) + 0.01 * aux


# ============================================================== forward
def lm_head_weight(params: dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def prefill(params: dict, cfg: ArchConfig, batch: dict,
            impl: str = "kernel"):
    """Returns (last-token logits (B, V) fp32, caches, positions (B,)).
    caches, as in JAX: {"kv": {"k": (L, B, S, Hkv, hd), "v": ...}}, or for
    RWKV {"tmix": {"shift": (L, B, D), "wkv": (L, B, H, hd, hd) fp32},
    "cmix": (L, B, D)}, which already have their decode size."""
    _check_ported(cfg)
    x = params["embed"][batch["tokens"]]
    b, s, _ = x.shape
    if cfg.attn_free:
        caches = init_decode_cache(cfg, b, s, device=x.device)
        for i in range(cfg.n_layers):
            x = apply_rwkv_block(_layer(params["layers"], i), x, cfg,
                                 _layer(caches, i), impl)
    else:
        rope = rope_tables(torch.arange(s, device=x.device), cfg.hd,
                           cfg.rope_theta)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, kv = apply_block_seq(_layer(params["layers"], i), x, cfg,
                                    rope, impl)
            ks.append(kv["k"])
            vs.append(kv["v"])
        caches = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return _logits(params, cfg, x[:, -1]), caches, \
        torch.full((b,), s, dtype=torch.int32, device=x.device)


def init_decode_cache(cfg: ArchConfig, batch_size: int, max_len: int,
                      device=None) -> dict:
    """Blank decode caches; a sliding-window config gets a ring of
    ``min(max_len, window)`` slots. RWKV's states do not grow with
    ``max_len``."""
    _check_ported(cfg)
    L, dtype = cfg.n_layers, _dtype(cfg)
    if cfg.attn_free:
        hd = cfg.rwkv_head_dim
        h = cfg.d_model // hd
        return {
            "tmix": {"shift": torch.zeros((L, batch_size, cfg.d_model),
                                          dtype=dtype, device=device),
                     "wkv": torch.zeros((L, batch_size, h, hd, hd),
                                        dtype=torch.float32, device=device)},
            "cmix": torch.zeros((L, batch_size, cfg.d_model), dtype=dtype,
                                device=device),
        }
    size = max_len if cfg.sliding_window is None \
        else min(max_len, cfg.sliding_window)
    shape = (L, batch_size, size, cfg.n_kv_heads, cfg.hd)
    return {"kv": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }}


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                caches: dict, pos: torch.Tensor, impl: str = "kernel"):
    """One decoding step. tokens: (B,) ids; pos: (B,) absolute positions
    (RWKV does not read them). Unlike JAX, which returns new caches, this
    writes the token's K/V, or the new RWKV states, into ``caches`` in place
    (no per-step copy of the cache) and returns them."""
    _check_ported(cfg)
    x = params["embed"][tokens][:, None, :]
    for i in range(cfg.n_layers):
        lp, cache = _layer(params["layers"], i), _layer(caches, i)
        if cfg.attn_free:
            x = apply_rwkv_block(lp, x, cfg, cache, impl)
        else:
            x = apply_block_decode(lp, x, cfg, cache["kv"], pos, impl)
    return _logits(params, cfg, x[:, 0]), caches


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head of the last hidden state (B, D): fp32 (B, V)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ lm_head_weight(params, cfg)).float()
