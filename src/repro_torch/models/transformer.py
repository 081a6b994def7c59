"""Decoder stack, ported from ``repro.models.transformer``: the dense and
MoE families, the stub-frontend family (vlm, audio: precomputed
embeddings in place of token ids), the attention-free RWKV6 family and
the hybrid family (hymba: attention and Mamba heads side by side in each
layer), serving and training.

Parameters are a nested dict of tensors with the JAX tree's keys and its
layer-stacked ``(L, ...)`` leaves; a Python loop over layers takes the
place of ``lax.scan``. Attention goes through ``kernels.ops`` on
un-repeated K/V: the kernels index the shared KV head themselves. RWKV
layers run ``models.ssm``, whose recurrence is ``kernels.ops.wkv6``; a
hybrid layer's Mamba heads run ``models.ssm.apply_mamba``, whose scan is
``kernels.ops.mamba_scan``; MoE layers run ``models.moe``.

Entry points (a stub-frontend config takes ``embeds`` (B, S, D) in place
of ``tokens``, and (B, D) embeds per decode step):
  forward_train  tokens, labels -> mean next-token cross-entropy, chunked
                 over the sequence so the full (B, S, V) logits never exist;
                 each layer (with ``cfg.remat``) and each loss chunk is
                 recomputed in the backward (``torch.utils.checkpoint``)
  prefill      tokens -> (last-token logits, caches, positions)
  decode_step  one token per row + caches -> (logits, caches); the new
               token's K/V, and the new RWKV or Mamba states, are written
               into the caches in place
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..kernels import ops
from ..sharding.ctx import (assign, constrain, replicated_like, sharded,
                            unflatten)
from ..sharding.rules import cache_specs, shard_tree, to_placements
from .layers import apply_rope, dense_init, rms_norm, rope_tables
from .moe import apply_moe, init_moe
from .ssm import (CONV_K, apply_mamba, apply_rwkv_cmix, apply_rwkv_tmix,
                  init_mamba, init_rwkv_cmix, init_rwkv_tmix)

LOSS_CHUNK = 1024


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ================================================================= init
def init_params(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """Random parameters on ``device`` (``gen``'s unless given: a CPU
    generator builds a meta tree, which allocates nothing), in the JAX
    tree's layout. The values differ from JAX's for the same seed; parity
    tests bring weights over with ``bridge.params_from_numpy``."""
    dtype = _dtype(cfg)
    dev = gen.device if device is None else device
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.attn_free:
        layers = {"ln1": ones(L, d), "ln2": ones(L, d),
                  "tmix": init_rwkv_tmix(gen, cfg, dtype, dev),
                  "cmix": init_rwkv_cmix(gen, cfg, dtype, dev)}
    else:
        attn = {
            "wq": dense_init(gen, (L, d, h * hd), dtype, device=dev),
            "wk": dense_init(gen, (L, d, hkv * hd), dtype, device=dev),
            "wv": dense_init(gen, (L, d, hkv * hd), dtype, device=dev),
            "wo": dense_init(gen, (L, h * hd, d), dtype, device=dev),
        }
        if cfg.qkv_bias:
            attn.update(bq=zeros(L, h * hd), bk=zeros(L, hkv * hd),
                        bv=zeros(L, hkv * hd))
        if cfg.qk_norm:
            attn.update(q_norm=ones(L, hd), k_norm=ones(L, hd))
        layers = {"ln1": ones(L, d), "ln2": ones(L, d), "attn": attn}
        if cfg.hybrid_ssm:
            layers["mamba"] = init_mamba(gen, cfg, dtype, dev)
    params = {
        "embed": dense_init(gen, (cfg.vocab_size, d), dtype, device=dev),
        "layers": layers,
        "final_norm": ones(d),
    }
    if cfg.is_moe:
        layers["moe"] = init_moe(gen, cfg, dtype, dev)
    elif not cfg.attn_free:
        layers["mlp"] = {
            "w_gate": dense_init(gen, (L, d, f), dtype, device=dev),
            "w_up": dense_init(gen, (L, d, f), dtype, device=dev),
            "w_down": dense_init(gen, (L, f, d), dtype, device=dev),
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dtype,
                                       device=dev)
    return params


def _layer(tree: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ============================================================ attention
def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig):
    b, s, _ = x.shape
    q, k, v = (constrain(x @ p[w], "dp", None, "tp") for w in
               ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    # per-head sharding after the reshape, as JAX re-constrains it
    q = constrain(unflatten(q, 2, (cfg.n_heads, cfg.hd)),
                  "dp", None, "tp", None)
    k = constrain(unflatten(k, 2, (cfg.n_kv_heads, cfg.hd)),
                  "dp", None, "tp", None)
    v = constrain(unflatten(v, 2, (cfg.n_kv_heads, cfg.hd)),
                  "dp", None, "tp", None)
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
    out = constrain(out.reshape(b, s, cfg.n_heads * cfg.hd), "dp", None, "tp")
    out = constrain(out @ p["wo"], "dp", "sp", None)
    return out, {"k": k, "v": v}


def apply_attn_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: dict,
                      pos: torch.Tensor, impl: str = "kernel") -> torch.Tensor:
    """One-token decode against a (possibly ring-buffered) KV cache.

    cache: {"k": (B, C, Hkv, hd), "v": ...}, written in place at slot
    ``pos % C``. pos: (B,) absolute position of the new token.
    """
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    rope = _rope(pos[:, None], cfg, x)
    q = apply_rope(q, rope)
    k = apply_rope(k, rope)
    cache_size = cache["k"].shape[1]
    _write_kv(cache, k, v, pos % cache_size)
    cache_len = replicated_like(
        torch.clamp(pos + 1, max=cache_size).to(torch.int32), x)
    # the ring holds exactly the window: mask by valid slot count only
    grp = cfg.n_heads // cfg.n_kv_heads
    out = ops.decode_attention(unflatten(q[:, 0], 1, (cfg.n_kv_heads, grp)),
                               cache["k"], cache["v"], cache_len, impl=impl)
    return out.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]


def _write_kv(cache: dict, k: torch.Tensor, v: torch.Tensor,
              slot: torch.Tensor) -> None:
    """Write the new token's K/V (B, 1, Hkv, hd) into slot ``slot[b]`` of
    row b of the (B, C, Hkv, hd) caches, in place; under a mesh, each rank
    writes its own rows and heads of its local shard."""
    if sharded(cache["k"]):
        from torch.distributed.tensor import Replicate, Shard
        mesh, placements = cache["k"].device_mesh, cache["k"].placements
        k, v = (t.redistribute(mesh, placements).to_local() for t in (k, v))
        rows = [p if p == Shard(0) else Replicate() for p in placements]
        slot = replicated_like(slot, cache["k"]).redistribute(
            mesh, rows).to_local()
        cache = {name: c.to_local() for name, c in cache.items()}
    rows = torch.arange(k.shape[0], device=k.device)
    cache["k"][rows, slot.long()] = k[:, 0]
    cache["v"][rows, slot.long()] = v[:, 0]


def _rope(positions: torch.Tensor, cfg: ArchConfig, x: torch.Tensor
          ) -> tuple:
    """RoPE tables of ``positions``: (S,) or, in decode, (B, 1). On ``x``'s
    mesh if it has one: replicated, or for batch-sharded DTensor
    positions, the tables of each rank's rows laid out as they are. RWKV
    has no positions to rotate (JAX's ``_rope_for``)."""
    if cfg.attn_free:
        return ()
    if sharded(positions):
        from torch.distributed.tensor import DTensor
        return tuple(DTensor.from_local(t, positions.device_mesh,
                                        positions.placements, run_check=False)
                     for t in rope_tables(positions.to_local(), cfg.hd,
                                          cfg.rope_theta))
    return tuple(replicated_like(t, x) for t in rope_tables(
        positions, cfg.hd, cfg.rope_theta))


# =============================================================== blocks
def _ffn(lp: dict, x: torch.Tensor, cfg: ArchConfig
         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's feed-forward half on its normed input (B, S, D): SwiGLU,
    or the MoE layer over the B x S tokens flattened, as JAX flattens them.
    Returns (out, the MoE's aux loss or None)."""
    if cfg.is_moe:
        b, s, d = x.shape
        out, aux = apply_moe(lp["moe"], x.reshape(b * s, d), cfg)
        return constrain(out.view(b, s, d), "dp", "sp", None), aux
    m = lp["mlp"]
    g = constrain(x @ m["w_gate"], "dp", None, "tp")
    u = constrain(x @ m["w_up"], "dp", None, "tp")
    return constrain((F.silu(g) * u) @ m["w_down"], "dp", "sp", None), None


def _mixer_out(lp: dict, normed: torch.Tensor, attn_out: torch.Tensor,
               cfg: ArchConfig, mamba: Optional[dict],
               impl: str) -> torch.Tensor:
    """What the block adds to its residual after the first norm: the
    attention output, or for a hybrid layer 0.5 (attn + ssm), its Mamba
    heads reading the same normed input from ``mamba`` (the layer's
    {"conv", "h"} states, written in place)."""
    if not cfg.hybrid_ssm:
        return constrain(attn_out, "dp", "sp", None)
    ssm_out, _ = apply_mamba(lp["mamba"], normed, cfg, mamba, impl)
    return 0.5 * (attn_out + ssm_out)


def apply_block_seq(lp: dict, x: torch.Tensor, cfg: ArchConfig, rope: tuple,
                    impl: str = "kernel", mamba: Optional[dict] = None):
    """One layer over a full sequence. Returns (x, kv cache, aux loss or
    None). A hybrid layer starts its Mamba heads from ``mamba`` (zeros
    before a prefill) and writes the final states there."""
    x = constrain(x, "dp", "sp", None)   # seq-parallel residual stream
    normed = rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out, kv = apply_attn_seq(lp["attn"], normed, cfg, rope, impl)
    x = x + _mixer_out(lp, normed, attn_out, cfg, mamba, impl)
    out, aux = _ffn(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x + out, kv, aux


def apply_block_decode(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                       cache: dict, pos: torch.Tensor,
                       impl: str = "kernel") -> torch.Tensor:
    """One layer for one decode token; writes its K/V into ``cache["kv"]``
    and, for a hybrid layer, its Mamba states into ``cache["mamba"]``."""
    normed = rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn_out = apply_attn_decode(lp["attn"], normed, cfg, cache["kv"], pos,
                                 impl)
    x = x + _mixer_out(lp, normed, attn_out, cfg, cache.get("mamba"), impl)
    return x + _ffn(lp, rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)[0]


def apply_rwkv_block(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                     cache: Optional[dict], impl: str = "kernel"
                     ) -> torch.Tensor:
    """One RWKV layer over a sequence or one decode token: JAX's attn_free
    branch of ``apply_block_seq`` and ``apply_block_decode``. It starts from
    the layer's states in ``cache`` ({"tmix": {"shift", "wkv"}, "cmix"};
    zeros before a prefill) and writes the new ones there in place; with no
    cache (training) it starts from zeros and writes nothing."""
    normed = rms_norm(x, lp["ln1"], cfg.norm_eps)
    h, tstate = apply_rwkv_tmix(lp["tmix"], normed, cfg,
                                None if cache is None else cache["tmix"],
                                impl)
    x = x + h
    normed = rms_norm(x, lp["ln2"], cfg.norm_eps)
    h, cstate = apply_rwkv_cmix(lp["cmix"], normed, cfg,
                                None if cache is None else cache["cmix"])
    if cache is not None:
        assign(cache["tmix"]["shift"], tstate["shift"])  # wkv: in place
        assign(cache["cmix"], cstate)
    return x + h


# ============================================================= training
def _block_train(x: torch.Tensor, lp: dict, cfg: ArchConfig, rope: tuple,
                 impl: str):
    """One layer of training from zero recurrent states: (x, aux loss or
    None)."""
    if cfg.attn_free:
        return apply_rwkv_block(lp, x, cfg, None, impl), None
    x, _, aux = apply_block_seq(lp, x, cfg, rope, impl)
    return x, aux


def hidden_states(params: dict, cfg: ArchConfig, batch: dict,
                  remat: Optional[bool] = None, impl: str = "kernel"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward to the final hidden states (pre-head), and the
    auxiliary loss summed over layers (0 but for MoE). With remat
    (``cfg.remat`` unless given) each layer runs again in the backward, as
    under JAX's ``jax.checkpoint``, so only its input is kept; a layer's aux
    loss leaves the checkpoint beside its output. ``params["layers"]`` is
    the stacked tree or a list of per-layer trees (the train step passes
    those, so that each layer's gradient lands in its slice in place)."""
    x = _embed_inputs(params, cfg, batch)
    rope = _rope(torch.arange(x.shape[1], device=x.device), cfg, x)
    layers = params["layers"]
    use_remat = cfg.remat if remat is None else remat
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        lp = layers[i] if isinstance(layers, list) else _layer(layers, i)
        if use_remat:
            x, a = checkpoint(_block_train, x, lp, cfg, rope, impl,
                              use_reentrant=False)
        else:
            x, a = _block_train(x, lp, cfg, rope, impl)
        if a is not None:
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def _chunk_ce(h: torch.Tensor, w: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: fp32 logits of the head's product,
    as JAX casts them, vocab-sharded as JAX constrains them. Under a mesh
    the vocab dim is then gathered for the loss: DTensor's vocab-parallel
    gather (a masked partial) fails to reduce a (B, chunk) index."""
    logits = constrain((h @ w).float(), "dp", None, "tp")
    logits = constrain(logits, "dp", None, None)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def forward_train(params: dict, cfg: ArchConfig, batch: dict,
                  impl: str = "kernel") -> torch.Tensor:
    """Mean next-token cross-entropy plus 0.01 x the auxiliary loss.
    batch: {"tokens", "labels"}, (B, S) integer tensors (a stub-frontend
    config: "embeds" (B, S, D) in place of "tokens"). The sequence is cut
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
def _embed_inputs(params: dict, cfg: ArchConfig, batch: dict
                  ) -> torch.Tensor:
    """(B, S, D) inputs: the embedded tokens, or a stub frontend's
    precomputed patch or frame embeddings, cast to the model's dtype."""
    if cfg.embedding_stub:
        return constrain(batch["embeds"].to(_dtype(cfg)), "dp", None, None)
    return constrain(params["embed"][batch["tokens"]], "dp", None, None)


def lm_head_weight(params: dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def prefill(params: dict, cfg: ArchConfig, batch: dict,
            impl: str = "kernel"):
    """Returns (last-token logits (B, V) fp32, caches, positions (B,)).
    caches, as in JAX: {"kv": {"k": (L, B, S, Hkv, hd), "v": ...}}, with
    {"mamba": {"conv": (L, B, K-1, di), "h": (L, B, di, n) fp32}} beside
    it for the hybrid family, or for RWKV {"tmix": {"shift": (L, B, D),
    "wkv": (L, B, H, hd, hd) fp32}, "cmix": (L, B, D)}. RWKV's and Mamba's
    states already have their decode size: each layer writes its final
    states in place into buffers that start at zero, laid out by
    ``cache_specs`` on the input's mesh when it is a DTensor."""
    x = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    mesh = x.device_mesh if sharded(x) else None
    if cfg.attn_free:
        caches = init_decode_cache(cfg, b, s, device=x.device, mesh=mesh)
        for i in range(cfg.n_layers):
            x = apply_rwkv_block(_layer(params["layers"], i), x, cfg,
                                 _layer(caches, i), impl)
    else:
        rope = _rope(torch.arange(s, device=x.device), cfg, x)
        mamba = _mamba_states(cfg, b, x.device, mesh) if cfg.hybrid_ssm \
            else None
        ks, vs = [], []
        for i in range(cfg.n_layers):
            x, kv, _ = apply_block_seq(
                _layer(params["layers"], i), x, cfg, rope, impl,
                None if mamba is None else _layer(mamba, i))
            ks.append(kv["k"])
            vs.append(kv["v"])
        caches = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        if mamba is not None:
            caches["mamba"] = mamba
    return _logits(params, cfg, x[:, -1]), caches, \
        torch.full((b,), s, dtype=torch.int32, device=x.device)


def _mamba_states(cfg: ArchConfig, batch_size: int, device=None,
                  mesh=None) -> dict:
    """Zeroed Mamba states of every layer: {"conv": (L, B, K-1, di) in the
    model's dtype, "h": (L, B, di, n) fp32}; with a ``mesh``, laid out on
    it as ``init_decode_cache`` lays them out."""
    if mesh is not None:
        return _on_mesh(_mamba_states(cfg, batch_size, "meta"), mesh, device)
    L, di = cfg.n_layers, cfg.n_heads * cfg.hd
    return {"conv": torch.zeros((L, batch_size, CONV_K - 1, di),
                                dtype=_dtype(cfg), device=device),
            "h": torch.zeros((L, batch_size, di, cfg.ssm_state),
                             dtype=torch.float32, device=device)}


def _on_mesh(tree: dict, mesh, device=None) -> dict:
    """Zeros of the shapes and dtypes of ``tree`` (blank caches or states
    built on the meta device) laid out on ``mesh`` by ``cache_specs``,
    each rank allocating only its shard; for a meta ``device``, meta
    shards, which allocate nothing (the dry run)."""
    from torch.distributed.tensor import zeros
    if device is not None and torch.device(device).type == "meta":
        return shard_tree(tree, cache_specs(tree, mesh), mesh)

    def place(t, spec):
        if isinstance(t, dict):
            return {k: place(v, spec[k]) for k, v in t.items()}
        return zeros(t.shape, dtype=t.dtype, device_mesh=mesh,
                     placements=to_placements(spec, mesh))

    return place(tree, cache_specs(tree, mesh))


def init_decode_cache(cfg: ArchConfig, batch_size: int, max_len: int,
                      device=None, mesh=None) -> dict:
    """Blank decode caches; a sliding-window config gets a ring of
    ``min(max_len, window)`` slots. RWKV's and Mamba's states do not grow
    with ``max_len``. With a ``mesh`` (a ``DeviceMesh``), DTensors laid out
    by ``sharding.rules.cache_specs`` on it."""
    if mesh is not None:
        return _on_mesh(init_decode_cache(cfg, batch_size, max_len,
                                          device="meta"), mesh, device)
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
    caches = {"kv": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }}
    if cfg.hybrid_ssm:
        caches["mamba"] = _mamba_states(cfg, batch_size, device)
    return caches


def decode_step(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                caches: dict, pos: torch.Tensor, impl: str = "kernel"):
    """One decoding step. tokens: (B,) ids, or (B, D) embeds for a
    stub-frontend config; pos: (B,) absolute positions (RWKV does not read
    them). Unlike JAX, which returns new caches, this writes the token's
    K/V, and the new RWKV or Mamba states, into ``caches`` in place (no
    per-step copy of the cache) and returns them."""
    if cfg.embedding_stub:
        x = tokens.to(_dtype(cfg))[:, None, :]
    else:
        x = params["embed"][tokens][:, None, :]
    for i in range(cfg.n_layers):
        lp, cache = _layer(params["layers"], i), _layer(caches, i)
        if cfg.attn_free:
            x = apply_rwkv_block(lp, x, cfg, cache, impl)
        else:
            x = apply_block_decode(lp, x, cfg, cache, pos, impl)
    return _logits(params, cfg, x[:, 0]), caches


def _logits(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head of the last hidden state (B, D): fp32 (B, V)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ lm_head_weight(params, cfg)).float()
