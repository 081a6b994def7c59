"""Attention-free sequence mixers, ported from ``repro.models.ssm``.

* RWKV6 ("Finch") time-mix and channel-mix: token shift, a data-dependent
  per-channel decay and a (hd x hd) WKV state per head, so decode carries
  O(1) state. The recurrence goes through ``kernels.ops.wkv6`` where JAX
  runs its ``vmemkernel_wkv6`` scan.
* Mamba-style selective SSM, hymba's SSM heads (beside attention in each
  hybrid layer): a depthwise causal conv, then a scan over a (di, n) state
  that goes through ``kernels.ops.mamba_scan`` where JAX runs its
  ``vmemkernel_mamba_scan`` scan; the same call takes dt's softplus, the
  ``d_skip`` term and the gating by ``silu(z)``.

JAX returns new states; here a given state is updated in place. Training
passes no state: each recurrence then runs from zeros through its
``torch.autograd.Function`` (``kernels.ops`` routes it so), and nothing is
written in place while autograd records.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from ..sharding.ctx import assign, constrain
from .layers import dense_init, group_norm_heads

DECAY_LORA = 64
DT_RANK = 64
CONV_K = 4


# ================================================================= init
def init_rwkv_tmix(gen: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype) -> dict:
    """Time-mix parameters of all layers, stacked (L, ...) as in JAX."""
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
    f32, dev = torch.float32, gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=dev)

    return {
        "mu": full((L, 5, d), 0.5),          # r, k, v, w, g shift mixes
        "w_r": dense_init(gen, (L, d, d), dtype),
        "w_k": dense_init(gen, (L, d, d), dtype),
        "w_v": dense_init(gen, (L, d, d), dtype),
        "w_g": dense_init(gen, (L, d, d), dtype),
        "w_o": dense_init(gen, (L, d, d), dtype),
        "w0": full((L, d), -6.0),            # decay bias
        "w_lora_a": dense_init(gen, (L, d, DECAY_LORA), f32),
        "w_lora_b": dense_init(gen, (L, DECAY_LORA, d), f32, 0.1),
        "bonus_u": dense_init(gen, (L, d // hd, hd), f32),
        "ln_w": full((L, hd), 1.0),
        "ln_b": full((L, hd), 0.0),
    }


def init_rwkv_cmix(gen: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype) -> dict:
    """Channel-mix parameters of all layers, stacked (L, ...)."""
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    return {
        "mu": torch.full((L, 2, d), 0.5, dtype=torch.float32,
                         device=gen.device),  # k, r shift mixes
        "w_k": dense_init(gen, (L, d, f), dtype),
        "w_v": dense_init(gen, (L, f, d), dtype),
        "w_r": dense_init(gen, (L, d, d), dtype),
    }


# ================================================================ apply
def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: y_t = x_{t-1}; y_0 = prev. x: (B,S,D), prev: (B,D)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def rwkv_decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0,1): exp(-exp(w0 + lora(x))), fp32."""
    w = p["w0"] + torch.tanh(xw.float() @ p["w_lora_a"]) @ p["w_lora_b"]
    return torch.exp(-torch.exp(w))


def apply_rwkv_tmix(p: dict, x: torch.Tensor, cfg: ArchConfig,
                    state: Optional[dict] = None, impl: str = "kernel"
                    ) -> tuple[torch.Tensor, dict]:
    """x: (B,S,D). state: {"shift": (B,D), "wkv": (B,H,hd,hd) fp32} or None
    (zeros; training). Returns (out, {"shift": x's last row, "wkv": final
    state}); a given ``state["wkv"]`` is that final state, written in
    place."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    prev = state["shift"] if state is not None else torch.zeros_like(x[:, 0])
    xx = _shift(x, prev)

    def mix(i):
        return x + (xx - x) * p["mu"][i].to(x.dtype)

    def proj(i, w):
        return constrain(mix(i) @ w, "dp", None, "tp")

    r = proj(0, p["w_r"]).view(b, s, h, hd)
    k = proj(1, p["w_k"]).view(b, s, h, hd)
    v = proj(2, p["w_v"]).view(b, s, h, hd)
    g = proj(4, p["w_g"])
    decay = rwkv_decay(p, mix(3)).view(b, s, h, hd)
    # JAX's vmemkernel_wkv6 scope: the recurrence in fp32
    y, wkv = ops.wkv6(r.float(), k.float(), v.float(), decay, p["bonus_u"],
                      None if state is None else state["wkv"], impl=impl)
    y = group_norm_heads(y, p["ln_w"], p["ln_b"]).reshape(b, s, d)
    out = (y * F.silu(g).to(y.dtype)).to(x.dtype) @ p["w_o"]
    out = constrain(out, "dp", "sp", None)
    return out, {"shift": x[:, -1, :], "wkv": wkv}


def apply_rwkv_cmix(p: dict, x: torch.Tensor, cfg: ArchConfig,
                    state: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D), state: the previous token's (B,D) or None (zeros).
    Returns (out, x's last row)."""
    prev = state if state is not None else torch.zeros_like(x[:, 0])
    xx = _shift(x, prev)

    def mix(i):
        return x + (xx - x) * p["mu"][i].to(x.dtype)

    k = torch.square(F.relu(constrain(mix(0) @ p["w_k"], "dp", None, "tp")))
    v = constrain(k @ p["w_v"], "dp", "sp", None)
    r = torch.sigmoid(mix(1) @ p["w_r"])
    return (r * v).to(x.dtype), x[:, -1, :]


# ====================================================== Mamba (hymba)
def init_mamba(gen: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype) -> dict:
    """Mamba parameters of all layers, stacked (L, ...) as in JAX; the SSM
    heads mirror the attention heads, di = n_heads x hd."""
    L, d, n = cfg.n_layers, cfg.d_model, cfg.ssm_state
    di = cfg.n_heads * cfg.hd
    f32, dev = torch.float32, gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=dev))
    return {
        "in_proj": dense_init(gen, (L, d, 2 * di), dtype),
        "conv_w": dense_init(gen, (L, CONV_K, di), dtype),
        "conv_b": torch.zeros((L, di), dtype=dtype, device=dev),
        "dt_a": dense_init(gen, (L, di, DT_RANK), dtype),
        "dt_b": dense_init(gen, (L, DT_RANK, di), dtype),
        "dt_bias": torch.zeros((L, di), dtype=f32, device=dev),
        "w_bc": dense_init(gen, (L, di, 2 * n), dtype),
        "a_log": a_log.expand(L, di, n).contiguous(),
        "d_skip": torch.ones((L, di), dtype=f32, device=dev),
        "out_proj": dense_init(gen, (L, di, d), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x: (B,S,di); w: (K,di); conv_state: the
    previous K-1 inputs (B,K-1,di) or None (zeros). Summed tap by tap in
    the model's dtype, in JAX's order (not ``F.conv1d``, which sums in
    another). Returns (out, the last K-1 inputs)."""
    s = x.shape[1]
    # zeros made from x, so that under a mesh they are a DTensor like x
    start = [conv_state] if conv_state is not None \
        else [torch.zeros_like(x[:, :1])] * (CONV_K - 1)
    xp = torch.cat(start + [x], dim=1)                 # (B, S+K-1, di)
    out = xp[:, :s] * w[0]
    for i in range(1, CONV_K):
        out = out + xp[:, i:i + s] * w[i]
    return out + b, xp[:, -(CONV_K - 1):]


def apply_mamba(p: dict, x: torch.Tensor, cfg: ArchConfig,
                state: Optional[dict] = None, impl: str = "kernel"
                ) -> tuple[torch.Tensor, dict]:
    """Selective SSM. x: (B,S,D). state: {"conv": (B,K-1,di), "h": (B,di,n)
    fp32} or None (zeros; training). Returns (out, {"conv", "h"}); a given
    state is overwritten with the new one in place."""
    n = cfg.ssm_state
    x_in, z = constrain(x @ p["in_proj"], "dp", None, None).chunk(2, dim=-1)
    x_c, new_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                 None if state is None else state["conv"])
    x_c = F.silu(x_c)
    bc = x_c @ p["w_bc"]                               # (B,S,2n): b_t, c_t
    # dt's softplus, JAX's vmemkernel_mamba_scan scope (the recurrence in
    # fp32), the d_skip term and the gating by silu(z), in one kernel
    y, h = ops.mamba_scan(x_c @ p["dt_a"] @ p["dt_b"], p["dt_bias"],
                          bc[..., :n], bc[..., n:], x_c, z, p["a_log"],
                          p["d_skip"], None if state is None else state["h"],
                          impl=impl)
    out = constrain(y @ p["out_proj"], "dp", "sp", None)
    if state is not None:
        new_conv = assign(state["conv"], new_conv)
    return out, {"conv": new_conv, "h": h}
