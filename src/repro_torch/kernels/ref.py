"""Dense oracles for the attention kernels, in the JAX kernels' layouts
(ported from ``repro.kernels.ref``). O(S^2) memory: small shapes only."""

from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (BH, Sq, hd); k/v: (BHkv, Sk, hd). Dense causal attention with
    GQA by explicit repeat, in float32."""
    bh, sq, hd = q.shape
    bhkv, sk, _ = k.shape
    n_rep = bh // bhkv
    k = k.repeat_interleave(n_rep, dim=0)
    v = v.repeat_interleave(n_rep, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    p = torch.softmax(s.masked_fill(~mask[None], float("-inf")), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """q: (BHkv, grp, hd); caches: (BHkv, S, hd); cache_len: (BHkv,).
    Dense masked softmax in float32, output in ``q.dtype``."""
    hd, s = q.shape[-1], k_cache.shape[1]
    scores = torch.einsum("bgd,bsd->bgs", q.float(),
                          k_cache.float()) / math.sqrt(hd)
    valid = torch.arange(s, device=q.device)[None, :] < cache_len[:, None]
    p = torch.softmax(scores.masked_fill(~valid[:, None, :], float("-inf")),
                      dim=-1)
    return torch.einsum("bgs,bsd->bgd", p, v_cache.float()).to(q.dtype)
