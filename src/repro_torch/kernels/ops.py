"""Dispatch for the kernels, mirroring ``repro.kernels.ops``.

``impl`` selects the path:
  * "kernel"     the CUDA kernel for a CUDA tensor (it launches or raises;
                 nothing falls back), the kernel's plain version for a CPU
                 tensor. The model always uses this. With grad mode on,
                 flash attention goes through ``FlashAttentionFn``, whose
                 backward is ``flash_attention_bwd``.
  * "reference"  the plain version on any device, only when a caller asks
                 for it by name (``chip_smoke.py`` does, to hold the kernels
                 against it on the card).

Each function takes the JAX kernel's 3-D layout, or the model's 4-D
layout, which the kernel reads in place through its strides. A 3-D input
becomes a 4-D view with no copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import wkv6 as _wkv6

IMPLS = ("kernel", "reference")
# every kernel's wrapper by name; each counts its launches in ``.launches``
KERNELS = {"flash_attention": _flash.flash_attention,
           "decode_attention": _decode.decode_attention,
           "wkv6": _wkv6.wkv6}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last ``reset_launches``}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    impl: str = "kernel") -> torch.Tensor:
    """q: (BH, Sq, hd) with k/v: (BHkv, Sk, hd), as in ``repro``; or
    q: (B, Sq, H, hd) with k/v: (B, Sk, Hkv, hd). Causal, GQA-native."""
    _check_impl(impl)
    if q.dim() == 3:
        # (BH, S, hd) -> (1, S, BH, hd): head h reads kv head h // n_rep,
        # which is row b // n_rep of the 3-D layout
        out = flash_attention(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                              v.transpose(0, 1)[None], window=window,
                              impl=impl)
        return out[0].transpose(0, 1)
    if impl == "reference":
        return _flash.flash_attention_plain(q, k, v, window)
    if torch.is_grad_enabled():
        # training: the kernel's forward under autograd, on either device,
        # so its backward (flash_attention_bwd) is the one that runs
        return _flash.FlashAttentionFn.apply(q, k, v, window)
    return _flash.flash_attention(q, k, v, window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     impl: str = "kernel") -> torch.Tensor:
    """q: (BHkv, grp, hd), caches: (BHkv, S, hd), cache_len: (BHkv,), as in
    ``repro``; or q: (B, Hkv, grp, hd), caches: (B, S, Hkv, hd),
    cache_len: (B,)."""
    _check_impl(impl)
    if q.dim() == 3:
        out = decode_attention(q[:, None], k_cache[:, :, None],
                               v_cache[:, :, None], cache_len, impl=impl)
        return out[:, 0]
    if impl == "reference":
        return _decode.decode_attention_plain(q, k_cache, v_cache, cache_len)
    return _decode.decode_attention(q, k_cache, v_cache, cache_len)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None, *,
         impl: str = "kernel"):
    """r, k, v, w: (BH, S, hd), u: (BH, hd), as in ``repro``; returns y.
    Or r, k, v, w: (B, S, H, hd), u: (H, hd), state: (B, H, hd, hd) or None
    (zeros); returns (y, final state), and a given state is overwritten
    with the final one in place. Computes in fp32 whatever the inputs'
    dtype, as the JAX ``wkv6`` does."""
    _check_impl(impl)
    if r.dim() == 3:
        # (BH, S, hd) -> (1, S, BH, hd): each row is a head of one batch row
        y, _ = wkv6(*(t.transpose(0, 1)[None] for t in (r, k, v, w)), u,
                    None if state is None else state[None], impl=impl)
        return y[0].transpose(0, 1)
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    if impl == "reference":
        return _wkv6.wkv6_plain(r, k, v, w, u, state)
    return _wkv6.wkv6(r, k, v, w, u, state)
