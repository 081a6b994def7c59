"""RWKV6 WKV recurrence: CUDA C++ kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6.py`` (``wkv6_chunked``).
The kernel is ``csrc/wkv6.cu``; its header says what bounds it on the H100
and how its design answers that: a chunked body on the tensor cores for
S >= ``chunk_tokens()``, the token-by-token body below it (decode).

Layout is the model's: r, k, v, w (B, S, H, hd), u (H, hd), all fp32, and
a state (B, H, hd, hd) indexed [key dim i, value dim j]. It computes, for
each step t,

    y_t = r_t^T (S + (u * k_t) v_t^T),    S <- diag(w_t) S + k_t v_t^T

from a start state (zeros when none is given) and returns y (B, S, H, hd)
and the final state. A given state is overwritten with the final one in
place: decode carries one state buffer per layer and never copies it. The
kernel reads r, k, v, w, y through their strides (only the head dim must
be contiguous), so views of the model's projections go in without a copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build
from .flash_attention import _check_operand

HEAD_DIMS = (16, 32, 64)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the token-by-token fp32
    recurrence of ``repro.kernels.ref.wkv6_ref``, from ``state`` (zeros if
    None) and returning the final state as well."""
    b, s, h, hd = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    cur = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device) \
        if state is None else state.float()
    bonus = u.float()[None, :, :, None]
    ys = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], cur + bonus * kv))
        cur = w[:, t, :, :, None] * cur + kv
    y = torch.stack(ys, dim=1)
    if state is None:
        return y, cur
    state.copy_(cur)
    return y, state


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv6")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32,
                                ctypes.POINTER(ctypes.c_int64),
                                i32, i32, i32, i32, vp]
    lib.wkv6_launch.restype = i32
    lib.wkv6_chunk_tokens.restype = i32
    return lib


def chunk_tokens() -> int:
    """T of the kernel's chunked body: a call with S >= T runs the chunked
    body, a shorter one (a decode step) the token-by-token body."""
    return _lib().wkv6_chunk_tokens()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence; returns (y, final state). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, or raises."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: no kernel for {r.device}")
    b, s, h, hd = r.shape
    if r.dtype != torch.float32 or hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: unsupported {r.dtype}, hd={hd}")
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (h, hd) \
            or (state is not None and state.shape != (b, h, hd, hd)):
        raise ValueError(f"wkv6: shapes {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}, "
                         f"{tuple(u.shape)}, "
                         f"{None if state is None else tuple(state.shape)}")
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    final = torch.empty((b, h, hd, hd), dtype=torch.float32,
                        device=r.device) if state is None else state
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("state", final)):
        _check_operand(name, t, r)
    if u.device != r.device or u.dtype != r.dtype or u.stride(1) != 1:
        raise ValueError("wkv6: u must be fp32 on r's device, with a "
                         "contiguous head dim")
    strides = (ctypes.c_int64 * 19)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *out.stride()[:3], u.stride(0), *final.stride()[:3])
    lib = _lib()
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), final.data_ptr(), int(state is not None), strides,
        b, h, s, hd, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "wkv6")
    wkv6.launches += 1
    return out, final


wkv6.launches = 0
