"""Dispatch for the attention kernels, mirroring ``repro.kernels.ops``.

``impl`` selects the path:
  * "kernel"     the CUDA kernel for a CUDA tensor (it launches or raises;
                 nothing falls back), the kernel's plain version for a CPU
                 tensor. The model always uses this.
  * "reference"  the plain version on any device, only when a caller asks
                 for it by name (``chip_smoke.py`` does, to hold the kernels
                 against it on the card).

Both functions take the JAX kernels' 3-D layouts, or the model's 4-D
layouts, which the kernels read in place through their strides. A 3-D
input becomes a 4-D view with no copy.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash

IMPLS = ("kernel", "reference")


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
