"""Mamba selective scan, fused with the elementwise work around it: CUDA
C++ kernel and its plain version.

No Pallas kernel stands behind this one. JAX computes it in
``repro.models.ssm.apply_mamba``: dt's softplus (``ssm.py:198``), a
``lax.scan`` of ``step`` (the ``vmemkernel_mamba_scan`` scope,
``ssm.py:208-218``, which XLA compiles into one loop on the device), the
``d_skip`` term (``:219``) and the gating by ``silu(z)`` (``:220``). In
eager PyTorch the loop launches a few kernels a step and the rest a dozen
elementwise passes a layer; the kernel, ``csrc/mamba_scan.cu``, does all of
it in one launch. Its header says what bounds it and how its two bodies
are laid out: a chunked parallel scan for S >= ``time_tile()`` (prefill),
one thread per channel below it (decode).

Layout is the model's. dt_raw (the product ``x_c @ dt_a @ dt_b``), x, z
(B, S, di) and b, c (B, S, n) in the model's dtype (fp32 or bf16);
dt_bias, d_skip (di) and a_log (di, n) fp32; a state h (B, di, n) fp32.
With the plain version's rounding points,

    dt = softplus(fp32(dt_raw) + dt_bias),   a = -exp(a_log),
    da = exp(dt_t * a),   h <- da * h + (dt_t * x_t) b_t,   y_t = h c_t,
    out_t = dtype(dtype(y_t + d_skip * x_t) * dtype(silu(z_t)))

from a start state (zeros when none is given); it returns out (B, S, di)
in the model's dtype and the final state. A given state is overwritten
with the final one in place, as ``wkv6`` does with its state: decode
carries one buffer per layer. The kernel reads its inputs through their
strides (the last dim contiguous, each row 16-byte aligned), so b and c go
in as the two halves of one (B, S, 2n) projection and z as the second half
of ``in_proj``'s output, without a copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

# the kernel's instances of n: hymba-1.5b's state and its reduced config's
STATE_DIMS = (8, 16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mamba_scan_plain(dt: torch.Tensor, dt_bias: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
                     z: torch.Tensor, a_log: torch.Tensor,
                     d_skip: torch.Tensor, h: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: dt's softplus, JAX's
    ``step`` looped over time in fp32 from ``h`` (zeros if None), the skip
    term and the gating, in the torch operations the model ran them in
    before the kernel took them over. Returns (out, final state)."""
    bsz, s, di = dt.shape
    dt = F.softplus(dt.float() + dt_bias)
    a = -torch.exp(a_log)
    x_f = x.float()
    b, c = b.float(), c.float()
    cur = torch.zeros((bsz, di, a.shape[1]), dtype=torch.float32,
                      device=dt.device) if h is None else h.float()
    ys = []
    for t in range(s):
        da = torch.exp(dt[:, t, :, None] * a[None])
        cur = da * cur + (dt[:, t] * x_f[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", cur, c[:, t]))
    y = torch.stack(ys, dim=1) + d_skip * x_f
    out = y.to(x.dtype) * F.silu(z)
    if h is None:
        return out, cur
    h.copy_(cur)
    return out, h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mamba_scan_launch.argtypes = [vp] * 10 + [
        i32, ctypes.POINTER(ctypes.c_int64), i32, i32, i32, i32, i32, vp]
    lib.mamba_scan_launch.restype = i32
    lib.mamba_scan_time_tile.restype = i32
    return lib


def time_tile() -> int:
    """T of the kernel's chunked body: a call with S >= T runs the chunked
    body (its tile edges at multiples of T), a shorter one (a decode step)
    the token body."""
    return _lib().mamba_scan_time_tile()


def _aligned(name: str, t: torch.Tensor) -> None:
    """The kernel copies rows of 16 bytes: a contiguous last dim and rows
    that start 16-byte aligned."""
    size = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 \
            or any(st * size % 16 for st in t.stride()[:-1]):
        raise ValueError(f"mamba_scan: {name} needs a contiguous last dim "
                         f"and 16-byte aligned rows")


def mamba_scan(dt: torch.Tensor, dt_bias: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
               a_log: torch.Tensor, d_skip: torch.Tensor,
               h: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused scan; returns (out, final state). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, or raises."""
    if dt.device.type == "cpu":
        return mamba_scan_plain(dt, dt_bias, b, c, x, z, a_log, d_skip, h)
    if dt.device.type != "cuda":
        raise ValueError(f"mamba_scan: no kernel for {dt.device}")
    bsz, s, di = dt.shape
    n = a_log.shape[-1]
    if n not in STATE_DIMS or s < 1 or di % 8 or dt.dtype not in DTYPES:
        raise ValueError(f"mamba_scan: unsupported n={n}, S={s}, di={di}, "
                         f"{dt.dtype}")
    if x.shape != dt.shape or z.shape != dt.shape \
            or b.shape != (bsz, s, n) or c.shape != b.shape \
            or a_log.shape != (di, n) or dt_bias.shape != (di,) \
            or d_skip.shape != (di,) \
            or (h is not None and h.shape != (bsz, di, n)):
        raise ValueError(f"mamba_scan: shapes {tuple(dt.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(x.shape)}, {tuple(z.shape)}, "
                         f"{tuple(a_log.shape)}, "
                         f"{None if h is None else tuple(h.shape)}")
    out = torch.empty((bsz, s, di), dtype=dt.dtype, device=dt.device)
    final = torch.empty((bsz, di, n), dtype=torch.float32,
                        device=dt.device) if h is None else h
    for name, t, dtype in (("dt", dt, dt.dtype), ("b", b, dt.dtype),
                           ("c", c, dt.dtype), ("x", x, dt.dtype),
                           ("z", z, dt.dtype), ("dt_bias", dt_bias,
                                                torch.float32),
                           ("a_log", a_log, torch.float32),
                           ("d_skip", d_skip, torch.float32),
                           ("h", final, torch.float32)):
        if t.device != dt.device or t.dtype != dtype:
            raise ValueError(f"mamba_scan: {name} is {t.dtype} on "
                             f"{t.device}, expected {dtype} on {dt.device}")
    for name, t in (("dt", dt), ("b", b), ("c", c), ("x", x), ("z", z)):
        _aligned(name, t)
    if not (dt_bias.is_contiguous() and d_skip.is_contiguous()
            and a_log.is_contiguous()) or final.stride()[1:] != (n, 1):
        raise ValueError("mamba_scan: dt_bias, d_skip, a_log and each "
                         "batch row of h must be contiguous")
    strides = (ctypes.c_int64 * 13)(
        *dt.stride()[:2], *b.stride()[:2], *c.stride()[:2], *x.stride()[:2],
        *z.stride()[:2], *out.stride()[:2], final.stride(0))
    lib = _lib()
    err = lib.mamba_scan_launch(
        dt.data_ptr(), dt_bias.data_ptr(), b.data_ptr(), c.data_ptr(),
        x.data_ptr(), z.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
        out.data_ptr(), final.data_ptr(), int(h is not None), strides,
        DTYPES[dt.dtype], bsz, s, di, n,
        torch.cuda.current_stream(dt.device).cuda_stream)
    _build.check(lib, err, "mamba_scan")
    mamba_scan.launches += 1
    if s < lib.mamba_scan_time_tile():
        mamba_scan.token_launches += 1
    return out, final


# launches, and of them those that ran the token body (S < time_tile())
mamba_scan.launches = 0
mamba_scan.token_launches = 0
