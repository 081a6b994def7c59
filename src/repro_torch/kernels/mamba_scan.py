"""Mamba selective scan: CUDA C++ kernel and its plain version.

No Pallas kernel stands behind this one. JAX runs the recurrence as a
``lax.scan`` of ``step`` in ``repro.models.ssm.apply_mamba`` (the
``vmemkernel_mamba_scan`` scope, ``ssm.py:208-218``), which XLA compiles
into one loop on the device; in eager PyTorch the same loop launches a few
kernels a step. The kernel, ``csrc/mamba_scan.cu``, is the port's form of
that loop; its header says what bounds it and how it is laid out.

Layout is the model's: dt and x (B, S, di), b and c (B, S, n), a (di, n),
all fp32, and a state h (B, di, n). For each step t it computes, in JAX's
order of operations,

    da = exp(dt_t * a),   h <- da * h + (dt_t * x_t) b_t,   y_t = h c_t

from a start state (zeros when none is given) and returns y (B, S, di) and
the final state. A given state is overwritten with the final one in place,
as ``wkv6`` does with its state: decode carries one buffer per layer. The
kernel reads dt, b, c and x through their strides (only the last dim must
be contiguous), so b and c go in as the two halves of one (B, S, 2n)
projection without a copy. The ``d_skip`` term and the gating stay outside,
as in JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

# the kernel's instances of n: hymba-1.5b's state and its reduced config's
STATE_DIMS = (8, 16)


def mamba_scan_plain(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                     x: torch.Tensor, a: torch.Tensor,
                     h: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: JAX's ``step`` looped over
    time in fp32, from ``h`` (zeros if None), returning the final state as
    well."""
    bsz, s, di = dt.shape
    dt, b, c, x, a = (t.float() for t in (dt, b, c, x, a))
    cur = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                      device=dt.device) if h is None else h.float()
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a[None])
        cur = da * cur + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", cur, c[:, t]))
    y = torch.stack(ys, dim=1)
    if h is None:
        return y, cur
    h.copy_(cur)
    return y, h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mamba_scan_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32,
                                      ctypes.POINTER(ctypes.c_int64),
                                      i32, i32, i32, i32, vp]
    lib.mamba_scan_launch.restype = i32
    lib.mamba_scan_time_tile.restype = i32
    return lib


def time_tile() -> int:
    """Steps the kernel stages at a time: its tile edges are at multiples
    of this."""
    return _lib().mamba_scan_time_tile()


def mamba_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               x: torch.Tensor, a: torch.Tensor,
               h: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan; returns (y, final state). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, or raises."""
    if dt.device.type == "cpu":
        return mamba_scan_plain(dt, b, c, x, a, h)
    if dt.device.type != "cuda":
        raise ValueError(f"mamba_scan: no kernel for {dt.device}")
    bsz, s, di = dt.shape
    n = a.shape[-1]
    if n not in STATE_DIMS or s < 1:
        raise ValueError(f"mamba_scan: unsupported n={n}, S={s}")
    if x.shape != dt.shape or b.shape != (bsz, s, n) or c.shape != b.shape \
            or a.shape != (di, n) \
            or (h is not None and h.shape != (bsz, di, n)):
        raise ValueError(f"mamba_scan: shapes {tuple(dt.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{None if h is None else tuple(h.shape)}")
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=dt.device)
    final = torch.empty((bsz, di, n), dtype=torch.float32,
                        device=dt.device) if h is None else h
    for name, t in (("dt", dt), ("b", b), ("c", c), ("x", x), ("a", a),
                    ("h", final)):
        if t.device != dt.device or t.dtype != torch.float32:
            raise ValueError(f"mamba_scan: {name} is {t.dtype} on "
                             f"{t.device}, expected fp32 on {dt.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"mamba_scan: {name} needs a contiguous last "
                             f"dim")
    if a.stride(0) != n or final.stride(1) != n:
        raise ValueError("mamba_scan: a and each batch row of h must be "
                         "contiguous (di, n) blocks")
    strides = (ctypes.c_int64 * 11)(
        *dt.stride()[:2], *b.stride()[:2], *c.stride()[:2], *x.stride()[:2],
        *y.stride()[:2], final.stride(0))
    lib = _lib()
    err = lib.mamba_scan_launch(
        dt.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), a.data_ptr(),
        y.data_ptr(), final.data_ptr(), int(h is not None), strides, bsz, s,
        di, n, torch.cuda.current_stream(dt.device).cuda_stream)
    _build.check(lib, err, "mamba_scan")
    mamba_scan.launches += 1
    return y, final


mamba_scan.launches = 0
