"""Dispatch for the kernels, mirroring ``repro.kernels.ops``.

``impl`` selects the path:
  * "kernel"     the CUDA kernel for a CUDA tensor (it launches or raises;
                 nothing falls back), the kernel's plain version for a CPU
                 tensor. The model always uses this. With grad mode on,
                 flash attention goes through ``FlashAttentionFn``, whose
                 backward is ``flash_attention_bwd``; WKV6 and the Mamba
                 scan go through ``Wkv6Fn`` and ``MambaScanFn`` (backward
                 ``wkv6_bwd``, ``mamba_scan_bwd``) when an input also
                 requires grad. Those train from a zero state: a state
                 given under autograd raises.
  * "reference"  the plain version on any device, only when a caller asks
                 for it by name (``chip_smoke.py`` does, to hold the kernels
                 against it on the card).

Each attention and WKV6 function takes the JAX kernel's 3-D layout, or
the model's 4-D layout, which the kernel reads in place through its
strides. A 3-D input becomes a 4-D view with no copy. ``mamba_scan`` has
no JAX kernel: it takes the model's (B, S, ...) layout only.

Each wrapper counts its launches in ``.launches``; ``mamba_scan`` also
counts in ``.token_launches`` those that ran its token body (decode).

Under a mesh (``sharding.ctx``) the attention functions take DTensors:
batch on the data-parallel axes, heads (query and KV alike) on
``model``. They run the kernel, or on the CPU its plain version, on each
rank's local heads through ``local_map``, which moves the inputs to those
placements first; ``FlashAttentionFn``'s backward runs inside the same
map. A dim the mesh does not divide stays whole on every rank (the
rules' fallback), and so do a GQA model's heads unless both head counts
divide.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sharding import ctx as _ctx
from ..sharding.rules import to_placements
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import wkv6 as _wkv6

IMPLS = ("kernel", "reference")
# every kernel's wrapper by name; each counts its launches in ``.launches``
KERNELS = {"flash_attention": _flash.flash_attention,
           "decode_attention": _decode.decode_attention,
           "wkv6": _wkv6.wkv6,
           "mamba_scan": _mamba.mamba_scan}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _mamba.mamba_scan.token_launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last ``reset_launches``}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


# roles of the attention operands under a mesh: the model's layout,
# (B, S, H, hd) and decode's q (B, Hkv, grp, hd), cache_len (B,)
SEQ_ROLES = ("dp", None, "tp", None)
DECODE_Q_ROLES = ("dp", "tp", None, None)


def _on_local_heads(fn, args: tuple, roles: tuple, heads: tuple):
    """``fn(*args)`` on each rank's shards of DTensor ``args`` (a None role
    passes its argument as it is), the output laid out as ``args[0]``.
    ``heads``: (arg index, dim) of each head count; ``model`` shards them
    only if it divides them all."""
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    if not all(_ctx.fitted_spec((args[i].shape[d],), ("tp",), mesh)[0]
               for i, d in heads):
        roles = [r and tuple(None if x == "tp" else x for x in r)
                 for r in roles]
    placements = [None if r is None else to_placements(
        _ctx.fitted_spec(a.shape, r, mesh), mesh) for a, r in zip(args, roles)]
    return local_map(fn, out_placements=list(placements[0]),
                     in_placements=tuple(placements), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def _training(name: str, state, *inputs: torch.Tensor) -> bool:
    """Whether autograd records the call: grad mode on and an input that
    requires grad. Training runs the recurrence from zeros, so a given
    state (which the kernel would write in place) raises there."""
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in inputs)):
        return False
    if state is not None:
        raise ValueError(f"{name}: under autograd the recurrence runs from "
                         f"a zero state; pass a state under torch.no_grad()")
    return True


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
    if _ctx.sharded(q):
        return _on_local_heads(
            lambda q, k, v: flash_attention(q, k, v, window=window,
                                            impl=impl),
            (q, k, v), (SEQ_ROLES,) * 3, ((0, 2), (1, 2)))
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
    if _ctx.sharded(q):
        return _on_local_heads(
            lambda q, k, v, n: decode_attention(q, k, v, n, impl=impl),
            (q, k_cache, v_cache, cache_len),
            (DECODE_Q_ROLES, SEQ_ROLES, SEQ_ROLES, ("dp",)),
            ((0, 1), (1, 2)))
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
    if _training("wkv6", state, r, k, v, w, u):
        # the kernel's forward under autograd, on either device, so its
        # backward (wkv6_bwd) is the one that runs
        return _wkv6.Wkv6Fn.apply(r, k, v, w, u)
    return _wkv6.wkv6(r, k, v, w, u, state)


def mamba_scan(dt: torch.Tensor, dt_bias: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
               a_log: torch.Tensor, d_skip: torch.Tensor,
               h: Optional[torch.Tensor] = None, *, impl: str = "kernel"):
    """Mamba's selective scan with dt's softplus, the skip term and the
    gating, in the model's layout: dt (the raw ``x_c @ dt_a @ dt_b``), x, z
    (B, S, di) and b, c (B, S, n) in the model's dtype; dt_bias, d_skip
    (di) and a_log (di, n) fp32; h (B, di, n) fp32 or None (zeros). Returns
    (out (B, S, di) in the model's dtype, final state); a given h is
    overwritten with the final state in place. The scan runs in fp32, as
    JAX's ``step`` does."""
    _check_impl(impl)
    args = (dt, dt_bias, b, c, x, z, a_log, d_skip)
    if impl == "reference":
        return _mamba.mamba_scan_plain(*args, h)
    if _training("mamba_scan", h, *args):
        return _mamba.MambaScanFn.apply(*args)
    return _mamba.mamba_scan(*args, h)
