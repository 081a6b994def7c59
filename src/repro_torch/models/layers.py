"""Core NN building blocks, ported from ``repro.models.layers``.

Conventions kept from the JAX package:
* parameters are plain dicts of tensors; weights are stored (in, out) and
  applied as ``x @ W``;
* norms, RoPE and softmax compute in float32 and return the input dtype;
* attention projections stay flat, ``(d_model, n_heads * head_dim)``.

The attention references here are the model-level oracles
(forward only). The model itself calls ``kernels.ops``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def group_norm_heads(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm (RWKV's group_norm over heads). x: (..., H, hd)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w + b).to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), shaped (..., 1, hd/2). positions: (S,) or (B, S)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor,
               rope: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Half-split rotation. x: (B, S, H, hd); rope from ``rope_tables``."""
    cos, sin = rope
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------- attention
def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*n_rep, hd); head h reads kv head
    h // n_rep."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def causal_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: Optional[int] = None, q_offset: int = 0,
                         chunk: int = 512) -> torch.Tensor:
    """Chunked causal attention, forward only. q: (B, Sq, H, hd);
    k/v: (B, Sk, H, hd). ``q_offset`` is the absolute position of q[0]
    relative to k[0]. Scores are never held for more than ``chunk`` queries
    at once. As in JAX, the probabilities are cast to ``v.dtype`` before
    the PV product."""
    sq, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    kpos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for c0 in range(0, sq, chunk):
        qc = q[:, c0:c0 + chunk]
        qpos = q_offset + torch.arange(c0, c0 + qc.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), k.float()) * scale
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """Single-step GQA decode. q: (B, 1, H, hd); caches (B, Smax, Hkv, hd),
    not repeated: query heads are grouped onto their shared KV head.
    ``cache_len``: (B,) valid entries including the new token."""
    b, _, h, hd = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    grp = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q[:, 0].reshape(b, hkv, grp, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    kpos = torch.arange(smax, device=q.device)
    mask = kpos[None, :] < cache_len[:, None]
    if window is not None:
        mask &= kpos[None, :] >= cache_len[:, None] - window
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ------------------------------------------------------------- MLP
def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


# ------------------------------------------------------------- init
def dense_init(gen: torch.Generator, shape: tuple, dtype: torch.dtype,
               scale: float = 1.0,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal(0, scale / sqrt(fan_in)) on ``gen``'s device. fan_in is
    ``shape[-2]`` unless given: leading axes are layer stacks, so a stacked
    ``(L, d_in, d_out)`` weight gets the same scale as one ``(d_in, d_out)``
    layer."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) > 1 else 1
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale / math.sqrt(fan_in)).to(dtype)
