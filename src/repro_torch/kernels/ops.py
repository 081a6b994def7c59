"""Dispatch for the kernels, mirroring ``repro.kernels.ops``.

``impl`` selects the path:
  * "kernel"     the CUDA kernel for a CUDA tensor (it launches or raises;
                 nothing falls back), the kernel's plain version for a CPU
                 tensor. The model always uses this. With grad mode on,
                 flash attention goes through ``FlashAttentionFn``, whose
                 backward is ``flash_attention_backward``; WKV6 and the
                 Mamba scan go through ``Wkv6Fn`` and ``MambaScanFn``
                 (backward ``wkv6_backward``, ``mamba_scan_backward``)
                 when an input also requires grad. Those train from a
                 zero state: a state given under autograd raises.
  * "reference"  the plain version on any device, only when a caller asks
                 for it by name (``chip_smoke.py`` does, to hold the kernels
                 against it on the card).

On the card the three Functions' backwards are kernels too: flash
attention's ``flash_attention_backward`` (from the forward's output and
row log-sum-exp, which its training forward keeps), WKV6's
``wkv6_backward`` and the Mamba scan's ``mamba_scan_backward``;
``flash_attention_bwd``, ``wkv6_bwd`` and ``mamba_scan_bwd`` are their
plain versions, which the CPU runs.

Each attention and WKV6 function takes the JAX kernel's 3-D layout, or
the model's 4-D layout, which the kernel reads in place through its
strides. A 3-D input becomes a 4-D view with no copy. ``mamba_scan`` has
no JAX kernel: it takes the model's (B, S, ...) layout only.

Each wrapper counts its launches in ``.launches`` (the backward kernels'
too: one call of ``flash_attention_backward`` is one C call of three
kernels, counted once); ``wkv6`` and ``mamba_scan`` also count in
``.token_launches`` those that ran their token body (decode).

Under a mesh (``sharding.ctx``) every function takes DTensors and runs
the kernel, or on the CPU its plain version, on each rank's local shards
through ``local_map``, which moves the inputs to the kernel's placements
first (a DTensor never reaches a wrapper); under autograd the Function
and its backward run inside the same map. Batch is on the data-parallel
axes, and on ``model``:
  * attention: the heads, query and KV alike, unless ``model`` does not
    divide both head counts (a GQA group must stay whole on a rank);
  * WKV6: the heads of r, k, v, w, u and the state;
  * the Mamba scan: the channels of dt, x, z, dt_bias, d_skip, a_log and
    the state, unless a rank's slice would not be a multiple of the
    kernel's ``CHANNEL_MULTIPLE``; b and c stay whole.
What ``model`` does not split stays whole on every rank (the rules'
fallback). A weight that ranks splitting the work all hold whole gets a
gradient summed over them. A recurrent state arrives in its cache's
placements (``cache_specs`` shards WKV's key rows and Mamba's n, not the
heads or channels): ``local_map`` then hands the kernel a temporary, and
the final state is written back into the given DTensor (``write_back``).
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
           "mamba_scan": _mamba.mamba_scan,
           "flash_attention_backward": _flash.flash_attention_backward,
           "wkv6_backward": _wkv6.wkv6_backward,
           "mamba_scan_backward": _mamba.mamba_scan_backward}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _wkv6.wkv6.token_launches = 0
    _mamba.mamba_scan.token_launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last ``reset_launches``}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


# roles of the kernels' operands under a mesh. Attention: the model's
# layout, (B, S, H, hd) and decode's q (B, Hkv, grp, hd), cache_len (B,).
# WKV6: r, k, v, w as attention's, u (H, hd), the state (B, H, hd, hd): a
# head is the kernel's unit. The Mamba scan: dt, x, z (B, S, di) on their
# channels, dt_bias, d_skip (di), a_log (di, n), b, c (B, S, n) whole on
# every model rank, the state (B, di, n): a channel is the kernel's unit.
SEQ_ROLES = ("dp", None, "tp", None)
DECODE_Q_ROLES = ("dp", "tp", None, None)
WKV_U_ROLES = ("tp", None)
WKV_STATE_ROLES = ("dp", "tp", None, None)
SCAN_ROLES = {"seq": ("dp", None, "tp"), "channel": ("tp",),
              "a_log": ("tp", None), "bc": ("dp", None, None),
              "state": ("dp", "tp", None)}


def _model_splits(mesh, *counts: int, multiple: int = 1) -> bool:
    """Whether ``model`` divides every count into local counts that are
    multiples of ``multiple``."""
    tp = _ctx._extent(_ctx.spec_of(1, ("tp",))[0], mesh)
    return all(c % tp == 0 and (c // tp) % multiple == 0 for c in counts)


def _on_local_shards(fn, args: tuple, roles: tuple, outs: tuple,
                     split: bool):
    """``fn(*args)`` on each rank's shards of DTensor ``args`` (a None role
    passes its argument as it is), each moved to its roles' placements
    first (``local_map`` hands ``fn`` a temporary where they differ).
    ``outs``: (shape, roles) of each output. ``split``: whether ``model``
    shards the "tp" dims; if not, they stay whole on every rank."""
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh

    def placements(shape, r):
        if not split:
            r = tuple(None if x == "tp" else x for x in r)
        return to_placements(_ctx.fitted_spec(shape, r, mesh), mesh)

    ins = tuple(None if r is None else placements(a.shape, r)
                for a, r in zip(args, roles))
    # an input that the ranks splitting the work (batch rows on dp, heads
    # or channels on model) all hold whole gets a gradient summed over
    # them: each computes its share from its rows or heads
    splits = [role for role, on in (("dp", _ctx.fitted_spec(
        args[0].shape, roles[0], mesh)[0] is not None), ("tp", split)) if on]
    grads = tuple(p if p is None else _ctx.summed_over(
        p, mesh, *(s for s in splits if s not in r))
        for p, r in zip(ins, roles))
    # one output's placements are a list: local_map reads a tuple as one
    # placements per output
    out = [list(placements(s, r)) for s, r in outs]
    return local_map(fn, out_placements=tuple(out) if len(out) > 1
                     else out[0], in_placements=ins, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _on_local_heads(fn, args: tuple, roles: tuple, heads: tuple):
    """Attention on each rank's local heads, the output laid out as
    ``args[0]``. ``heads``: (arg index, dim) of each head count; ``model``
    shards them only if it divides them all."""
    split = _model_splits(args[0].device_mesh,
                          *(args[i].shape[d] for i, d in heads))
    return _on_local_shards(fn, args, roles, ((args[0].shape, roles[0]),),
                            split)


def write_back(state: torch.Tensor, final: torch.Tensor) -> torch.Tensor:
    """The recurrence's final state, laid out as the kernel ran, into the
    DTensor ``state`` in its own placements: where they differ, the
    kernel wrote its in-place update into ``local_map``'s temporary."""
    if final.to_local().data_ptr() != state.to_local().data_ptr():
        _ctx.assign(state, final)
    return state


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
        # so its backward (the backward kernel, or flash_attention_bwd on
        # the CPU) is the one that runs
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
    if _ctx.sharded(r):
        return _wkv6_sharded(r, k, v, w, u, state, impl)
    if impl == "reference":
        return _wkv6.wkv6_plain(r, k, v, w, u, state)
    if _training("wkv6", state, r, k, v, w, u):
        # the kernel's forward under autograd, on either device, so its
        # backward (wkv6_backward) is the one that runs
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
    if _ctx.sharded(dt):
        return _mamba_scan_sharded(args, h, impl)
    if impl == "reference":
        return _mamba.mamba_scan_plain(*args, h)
    if _training("mamba_scan", h, *args):
        return _mamba.MambaScanFn.apply(*args)
    return _mamba.mamba_scan(*args, h)


def _wkv6_sharded(r, k, v, w, u, state, impl: str):
    """``wkv6`` on each rank's local heads: batch on the dp axes, heads on
    ``model`` where it divides them (else whole on every rank). A given
    state arrives in the cache's placements (``cache_specs`` shards its
    key rows, not its heads): it is moved to the heads', and the final
    state written back into it."""
    b, _, h, hd = r.shape
    roles = (SEQ_ROLES,) * 4 + (WKV_U_ROLES,)
    args = (r, k, v, w, u)
    if state is not None:
        roles, args = roles + (WKV_STATE_ROLES,), args + (state,)
    y, final = _on_local_shards(
        lambda *a: wkv6(*a, impl=impl), args, roles,
        ((r.shape, SEQ_ROLES), ((b, h, hd, hd), WKV_STATE_ROLES)),
        _model_splits(r.device_mesh, h))
    return y, final if state is None else write_back(state, final)


def _mamba_scan_sharded(args: tuple, h, impl: str):
    """``mamba_scan`` on each rank's local channels: batch on the dp axes,
    channels on ``model`` where it divides them into slices the kernel
    takes (a multiple of ``CHANNEL_MULTIPLE``; else whole on every rank),
    b and c whole. A given state arrives in the cache's placements
    (``cache_specs`` shards its state dim n): it is moved to the
    channels', and the final state written back into it."""
    dt, a_log = args[0], args[6]
    bsz, _, di = dt.shape
    r = SCAN_ROLES
    roles = (r["seq"], r["channel"], r["bc"], r["bc"], r["seq"], r["seq"],
             r["a_log"], r["channel"])
    if h is not None:
        roles, args = roles + (r["state"],), args + (h,)
    out, final = _on_local_shards(
        lambda *a: mamba_scan(*a, impl=impl), args, roles,
        ((dt.shape, r["seq"]), ((bsz, di, a_log.shape[1]), r["state"])),
        _model_splits(dt.device_mesh, di,
                      multiple=_mamba.CHANNEL_MULTIPLE))
    return out, final if h is None else write_back(h, final)
