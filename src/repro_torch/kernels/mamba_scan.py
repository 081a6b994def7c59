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

Training goes through ``MambaScanFn``: its forward launches the kernel once
per ``TIME_CHUNK`` steps from the previous chunk's state and keeps the
state at each chunk boundary, as JAX's ``chunked_time_scan`` keeps them
(``repro/models/ssm.py:30-47``); its backward, ``mamba_scan_bwd``,
recomputes each chunk from its saved start state in the chunked form of
``mamba_scan_chunked`` (torch operations), takes autograd's gradient of
it and carries the state's gradient from chunk to chunk backwards
(``_remat.py``). JAX's gradient of its scan is XLA's; no backward kernel
exists.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from ._remat import TIME_CHUNK, acc_dtype, remat_backward

# the kernel's instances of n: hymba-1.5b's state and its reduced config's
STATE_DIMS = (8, 16)
# the kernel takes di in multiples of this (its lanes copy 16-byte rows);
# under a mesh, a rank's slice of the channels must be one too
CHANNEL_MULTIPLE = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# training: the steps of a sub-chunk in the backward's chunked form
SUB_CHUNK = 16
# the backward recomputes up to this many steps of kept chunks at once:
# chunk by chunk it is launch-bound on the card, and all 4096 steps of a
# training sequence at once take 3.8x the memory for 5 % less time
# (tools/time_backwards.py)
RECOMPUTE_STEPS = 1024


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
    acc = acc_dtype(x.dtype)
    dt = F.softplus(dt.to(acc) + dt_bias)
    a = -torch.exp(a_log)
    x_f = x.to(acc)
    b, c = b.to(acc), c.to(acc)
    cur = torch.zeros((bsz, di, a.shape[1]), dtype=acc,
                      device=dt.device) if h is None else h.to(acc)
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
    if n not in STATE_DIMS or s < 1 or di % CHANNEL_MULTIPLE \
            or dt.dtype not in DTYPES:
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


# ============================================================= training
def mamba_scan_chunked(dt: torch.Tensor, dt_bias: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
                       z: torch.Tensor, a_log: torch.Tensor,
                       d_skip: torch.Tensor, h: torch.Tensor,
                       sub: int = SUB_CHUNK
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused function from the state ``h`` in chunked form, in torch
    operations that autograd differentiates; what the backward recomputes.
    Same arguments, rounding points and result as ``mamba_scan_plain``,
    returning a new final state. Per sub-chunk of ``sub`` steps, with
    da_t = exp(dt_t a) and the local state g (zero at the sub-chunk's
    start),

        g_t = da_t * g_{t-1} + (dt_t x_t) b_t,   h_t = g_t + e^{a D_t} h_0

    where D_t sums dt over the sub-chunk's steps up to t and h_0 is the
    state at its start, carried from sub-chunk to sub-chunk. The T steps
    of g run as one loop over all sub-chunks at once, the carry as a loop
    over sub-chunks: T + S / T short steps in place of S. Every decay is
    e to a non-positive sum over its own span, so none is a quotient
    that could underflow. The tail is padded with dt = 0 and x = 0, which
    leave the state as it is."""
    bsz, s, di = dt.shape
    acc = acc_dtype(x.dtype)
    dt = F.softplus(dt.to(acc) + dt_bias)
    a = -torch.exp(a_log)
    x_f = x.to(acc)
    pad = -s % sub
    m = (s + pad) // sub

    def split(t):               # (B, S, k) -> (B, M, T, k), the tail padded
        return F.pad(t, (0, 0, 0, pad)).view(bsz, m, sub, t.shape[-1])

    dts, push, cs = split(dt), split(dt * x_f), split(c.to(acc))
    push = push[..., None] * split(b.to(acc))[..., None, :]   # (B,M,T,di,n)
    steps = torch.exp(dts[..., None] * a)
    fade = torch.exp(dts.cumsum(2)[..., None] * a)
    local, g = [], None
    for da, p in zip(steps.unbind(2), push.unbind(2)):
        g = p if g is None else torch.addcmul(p, da, g)
        local.append(g)
    local = torch.stack(local, 2)
    starts = []
    for f, g in zip(fade[:, :, -1].unbind(1), local[:, :, -1].unbind(1)):
        starts.append(h)
        h = torch.addcmul(g, f, h)
    states = torch.addcmul(local, fade, torch.stack(starts, 1)[:, :, None])
    y = (states @ cs[..., None])[..., 0].reshape(bsz, m * sub, di)[:, :s]
    y = y + d_skip * x_f
    return y.to(x.dtype) * F.silu(z), h


def mamba_chunk_states(dt: torch.Tensor, dt_bias: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
                       z: torch.Tensor, a_log: torch.Tensor,
                       d_skip: torch.Tensor, chunk: int = TIME_CHUNK
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused function from zeros through ``mamba_scan`` (the kernel on
    the card), one launch per ``chunk`` steps from the previous chunk's
    state. Returns (out, final state, the state at each chunk's start
    (B, chunks, di, n))."""
    bsz, s, di = dt.shape
    h = torch.zeros((bsz, di, a_log.shape[1]), dtype=acc_dtype(x.dtype),
                    device=dt.device)
    starts = h.new_empty((bsz, -(-s // chunk), *h.shape[1:]))
    outs = []
    for i, c0 in enumerate(range(0, s, chunk)):
        starts[:, i] = h
        dt_i, b_i, c_i, x_i, z_i = (t[:, c0:c0 + chunk]
                                    for t in (dt, b, c, x, z))
        outs.append(mamba_scan(dt_i, dt_bias, b_i, c_i, x_i, z_i, a_log,
                               d_skip, h)[0])
    return torch.cat(outs, dim=1), h, starts


def mamba_scan_bwd(dt: torch.Tensor, dt_bias: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
                   z: torch.Tensor, a_log: torch.Tensor,
                   d_skip: torch.Tensor, starts: torch.Tensor,
                   dout: torch.Tensor, dh: Optional[torch.Tensor] = None,
                   chunk: int = TIME_CHUNK,
                   steps: int = RECOMPUTE_STEPS) -> tuple[torch.Tensor, ...]:
    """Gradient of the fused function from zeros, given the state at each
    chunk's start (``mamba_chunk_states``), dout and the final state's
    gradient ``dh`` (None: zeros): each chunk recomputed from its start
    state by ``mamba_scan_chunked`` under autograd, the state's gradient
    carried from chunk to chunk backwards (``_remat.remat_backward``; a
    chunk's final state is its start times exp(a * the chunk's sum of dt),
    plus terms free of the start). Returns the gradients of (dt, dt_bias,
    b, c, x, z, a_log, d_skip): those of the (B, S, ...) inputs in their
    dtype (the model's), the others in fp32."""
    def run(dt, b, c, x, z, dt_bias, a_log, d_skip, h):
        return mamba_scan_chunked(dt, dt_bias, b, c, x, z, a_log, d_skip, h)

    def fade(seq, params):
        step = F.softplus(seq[0].to(acc_dtype(seq[3].dtype)) + params[0])
        return torch.exp(step.sum(1)[..., None] * -torch.exp(params[1]))

    (d_dt, d_b, d_c, d_x, d_z), (d_bias, d_alog, d_skip_) = remat_backward(
        run, (dt, b, c, x, z), (dt_bias, a_log, d_skip), starts, dout, dh,
        fade, chunk, steps)
    return d_dt, d_bias, d_b, d_c, d_x, d_z, d_alog, d_skip_


class MambaScanFn(torch.autograd.Function):
    """``mamba_scan`` from zeros under autograd, for training: the forward
    is ``mamba_chunk_states`` (the kernel on the card, the plain version on
    the CPU), which keeps the state at each ``TIME_CHUNK`` boundary; the
    backward is ``mamba_scan_bwd``. Returns (out, final state)."""

    @staticmethod
    def forward(ctx, dt, dt_bias, b, c, x, z, a_log, d_skip):
        out, final, starts = mamba_chunk_states(dt, dt_bias, b, c, x, z,
                                                a_log, d_skip)
        ctx.save_for_backward(dt, dt_bias, b, c, x, z, a_log, d_skip, starts)
        return out, final

    @staticmethod
    def backward(ctx, dout, dh):
        return mamba_scan_bwd(*ctx.saved_tensors, dout, dh)
