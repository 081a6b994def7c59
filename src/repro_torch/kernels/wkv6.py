"""RWKV6 WKV recurrence: CUDA C++ kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6.py`` (``wkv6_chunked``).
The kernel is ``csrc/wkv6.cu``; its header says what bounds it on the H100
and how its design answers that: a chunked body on the tensor cores for
S >= ``chunk_tokens()``, the token-by-token body below it (decode), which
reads and writes the state 16 bytes a thread along whole rows. The wrapper
counts its launches in ``wkv6.launches`` and, of them, those that ran the
token body in ``wkv6.token_launches``.

Layout is the model's: r, k, v, w (B, S, H, hd), u (H, hd), all fp32, and
a state (B, H, hd, hd) indexed [key dim i, value dim j]. It computes, for
each step t,

    y_t = r_t^T (S + (u * k_t) v_t^T),    S <- diag(w_t) S + k_t v_t^T

from a start state (zeros when none is given) and returns y (B, S, H, hd)
and the final state. A given state is overwritten with the final one in
place: decode carries one state buffer per layer and never copies it. The
kernel reads r, k, v, w, y through their strides (only the head dim must
be contiguous), so views of the model's projections go in without a copy.

Training goes through ``Wkv6Fn``: its forward keeps the state at each
``TIME_CHUNK`` boundary, as JAX's ``chunked_time_scan`` keeps them
(``repro/models/ssm.py:30-47``); on the card that is one C call a layer
(``wkv6_train``: every chunk's own state from zeros, the carry over the
chunks, then every chunk's y from its start at once); its backward is
``wkv6_backward``: on the card the backward kernel ``csrc/wkv6_bwd.cu``
(its header says how it works), on the CPU its plain version
``wkv6_bwd``, which recomputes each chunk from its saved start state in
the chunked form of ``wkv6_chunked`` (torch operations), takes autograd's
gradient of it and carries the state's gradient from chunk to chunk
backwards (``_remat.py``). JAX has no backward kernel for the recurrence:
its gradient is XLA's of the scan.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from . import _build
from ._remat import TIME_CHUNK, acc_dtype, remat_backward
from .flash_attention import _check_operand, _misaligned

HEAD_DIMS = (16, 32, 64)
# training: the tokens of a sub-chunk in the backward's chunked form
SUB_CHUNK = 8
# the backward recomputes up to this many steps of kept chunks at once:
# chunk by chunk it is launch-bound on the card, and all 4096 steps of a
# training sequence at once take 2.7x the memory for 10 % less time
# (tools/time_backwards.py)
RECOMPUTE_STEPS = 1024


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the token-by-token fp32
    recurrence of ``repro.kernels.ref.wkv6_ref``, from ``state`` (zeros if
    None) and returning the final state as well."""
    b, s, h, hd = r.shape
    acc = acc_dtype(r.dtype)
    r, k, v, w = (t.to(acc) for t in (r, k, v, w))
    cur = torch.zeros((b, h, hd, hd), dtype=acc, device=r.device) \
        if state is None else state.to(acc)
    bonus = u.to(acc)[None, :, :, None]
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
    lib.wkv6_train_launch.argtypes = [vp] * 9 + [
        ctypes.POINTER(ctypes.c_int64), i32, i32, i32, i32, i32, vp]
    lib.wkv6_train_launch.restype = i32
    lib.wkv6_chunk_tokens.restype = i32
    return lib


@functools.cache
def chunk_tokens() -> int:
    """T of the kernel's chunked body: a call with S >= T runs the chunked
    body, a shorter one (a decode step) the token-by-token body."""
    return _lib().wkv6_chunk_tokens()


def _check_shapes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state: torch.Tensor) -> None:
    b, s, h, hd = r.shape
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (h, hd) \
            or state.shape != (b, h, hd, hd):
        raise ValueError(f"wkv6: shapes {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}, "
                         f"{tuple(u.shape)}, {tuple(state.shape)}")


def _check_operands(r, k, v, w, u) -> torch.Tensor:
    """Raise unless the kernel takes r, k, v, w and u; returns an empty
    y."""
    hd = r.shape[-1]
    if r.dtype != torch.float32 or hd not in HEAD_DIMS:
        raise ValueError(f"wkv6: unsupported {r.dtype}, hd={hd}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        _check_operand(name, t, r)
    if u.device != r.device or u.dtype != r.dtype or u.stride(1) != 1:
        raise ValueError("wkv6: u must be fp32 on r's device, with a "
                         "contiguous head dim")
    if u.data_ptr() % 16 or u.stride(0) % 4:
        raise ValueError("wkv6: u needs 16-byte aligned rows")
    return torch.empty(r.shape, dtype=torch.float32, device=r.device)


def _strides(r, k, v, w, y, u) -> list:
    """The element strides (batch, step, head) of r, k, v, w and y, then
    u's head stride: the kernel's strides[0..15]."""
    return [*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], *y.stride()[:3], u.stride(0)]


torch.library.define(
    "repro_torch::wkv6",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor(a!) state, bool has_state) -> Tensor")


def _wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
               has_state: bool) -> torch.Tensor:
    """The kernel's launch, as an operator that writes the final state
    into ``state`` (from zeros unless ``has_state``, else from it) and
    returns y; with a fake implementation for meta tensors, its flops and
    what the plain body would move (``reference_bytes``); see
    ``flash_attention._flash_attention_cuda``."""
    _check_shapes(r, k, v, w, u, state)
    b, s, h, hd = r.shape
    out = _check_operands(r, k, v, w, u)
    # the token body reads each state row 16 bytes a load
    _check_operand("state", state, r)
    strides = (ctypes.c_int64 * 19)(*_strides(r, k, v, w, out, u),
                                    *state.stride()[:3])
    lib = _lib()
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        out.data_ptr(), state.data_ptr(), int(has_state), strides,
        b, h, s, hd, torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "wkv6")
    # the state was written in place, as an in-place op marks it
    torch.autograd.graph.increment_version(state)
    _WKV6.launches += 1
    if s < chunk_tokens():
        _WKV6.token_launches += 1
    return out


torch.library.impl("repro_torch::wkv6", "cuda",
                   _wkv6_cuda)


@torch.library.register_fake("repro_torch::wkv6")
def _(r, k, v, w, u, state, has_state):
    _check_shapes(r, k, v, w, u, state)
    return torch.empty(r.shape, dtype=torch.float32, device=r.device)


@register_flop_formula(torch.ops.repro_torch.wkv6)
def _(r_shape, *args, out_shape=None, **kwargs):
    """5 hd^2 fp32 flops a (token, head), as the recurrence's step does."""
    b, s, h, hd = r_shape
    return 5 * hd * hd * h * b * s


wkv6_op = torch.ops.repro_torch.wkv6.default


def reference_bytes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                    has_state: bool) -> int:
    """HBM bytes of the plain body, JAX's token loop in its
    ``vmemkernel_wkv6`` scope (``repro/models/ssm.py:130``): each step
    reads and writes the fp32 state (B, H, hd, hd), reads r, k, v and w
    of one token and writes its y, all fp32; u read once."""
    b, s, h, hd = r.shape
    return 4 * s * (2 * b * h * hd * hd + 5 * b * h * hd) + 4 * u.numel()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: Optional[torch.Tensor] = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV6 recurrence; returns (y, final state). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, or raises; a meta
    tensor takes the operator's fake implementation."""
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6: no kernel for {r.device}")
    b, _, h, hd = r.shape
    final = torch.empty((b, h, hd, hd), dtype=torch.float32,
                        device=r.device) if state is None else state
    return wkv6_op(r, k, v, w, u, final, state is not None), final


# launches, and of them those that ran the token body (S < chunk_tokens())
wkv6.launches = 0
wkv6.token_launches = 0
# the operators count on the wrapper as defined here, also while a caller
# has the module's name patched (a spy, a timing span)
_WKV6 = wkv6


# ============================================================= training
def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 sub: int = SUB_CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence from ``state`` in chunked form, in torch operations
    that autograd differentiates; what the backward recomputes. Same
    layout and result as ``wkv6_plain`` (in the inputs' type), returning a
    new final state. Per sub-chunk of ``sub`` tokens and head, with
    L(a, b) = sum_{a < s < b} log w_s, the log decay strictly between two
    steps:

        y_t = r_t^T (e^{L(-1, t)} S) + sum_{s<t} (sum_i r_t,i k_s,i
              e^{L(s, t)_i}) v_s + (r_t . (u * k_t)) v_t
        S  <- e^{L(-1, T)} S + sum_s (k_s * e^{L(s, T)}) v_s^T

    a pairwise term over (T, T, hd) and a state carried from sub-chunk to
    sub-chunk. Each L is summed over its own span (a masked cumulative
    sum), not taken as a difference of two running sums: so every decay is
    at most 1 and no quotient of products can underflow, and the gradient
    of each log w_s sums only terms that hold w_s, which keeps dw exact to
    rounding where w is small. A decay below the type's smallest normal
    number is taken as that number and gets dw = 0, where the plain loop's
    dw is not 0; the model's decay exp(-exp(x)) passes neither on to x,
    as its derivative there is 0 in fp32 too. The tail is padded with
    w = 1, k = v = 0, which leave the state as it is."""
    b, s, h, hd = r.shape
    pad = -s % sub
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = (s + pad) // sub

    def split(t):                     # (B, S, H, hd) -> (B, H, N, T, hd)
        return t.reshape(b, n, sub, h, hd).permute(0, 3, 1, 2, 4)

    r, k, v = split(r), split(k), split(v)
    log_w = split(torch.log(w.clamp_min(torch.finfo(w.dtype).tiny)))
    prev = F.pad(log_w[..., :-1, :], (0, 0, 1, 0))     # log w_{t-1}
    rows = torch.arange(sub, device=r.device)
    gap = (rows[:, None] - rows[None, :])[:, :, None]   # t - s
    # L(s, t) for s < t: row t sums log w_{t'-1} over s + 1 < t' <= t
    spans = torch.where(gap > 1, prev[..., :, None, :], 0.0).cumsum(-3)
    decay = spans.masked_fill(gap < 1, float("-inf")).exp()
    pairs = (r[..., :, None, :] * k[..., None, :, :] * decay).sum(-1)
    pairs = pairs + torch.diag_embed((r * u[:, None, None, :] * k).sum(-1))
    y = pairs @ v
    # L(s, T): the reversed running sum, shifted past s
    after = F.pad(log_w.flip(3).cumsum(3).flip(3)[..., 1:, :], (0, 0, 0, 1))
    grow = (k * after.exp()).transpose(-1, -2) @ v            # (B,H,N,hd,hd)
    fade = log_w.sum(3).exp()[..., None]                      # (B,H,N,hd,1)
    starts = []
    for g, f in zip(grow.unbind(2), fade.unbind(2)):
        starts.append(state)
        state = torch.addcmul(g, f, state)
    y = y + (r * prev.cumsum(3).exp()) @ torch.stack(starts, 2)
    y = y.permute(0, 2, 3, 1, 4).reshape(b, n * sub, h, hd)
    return y[:, :s], state


def _check_train(r, k, v, w, u, chunk) -> None:
    b, _, h, hd = r.shape
    _check_shapes(r, k, v, w, u, torch.empty((b, h, hd, hd), device="meta"))
    if chunk < 1:
        raise ValueError(f"wkv6_train: chunk {chunk}")


torch.library.define(
    "repro_torch::wkv6_train",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, SymInt chunk) -> "
    "(Tensor, Tensor, Tensor)")


def _wkv6_train_cuda(r, k, v, w, u, chunk):
    """The training forward from zeros in one C call
    (``wkv6_train_launch``: each chunk's summary, the carry over chunks,
    every chunk's y from its start), as the CUDA implementation of
    ``repro_torch::wkv6_train``; returns (y, final state, the state at
    each ``chunk`` tokens' start). It counts in ``wkv6.launches``; its
    scratch (each chunk's fade) is allocated here."""
    _check_train(r, k, v, w, u, chunk)
    b, s, h, hd = r.shape
    y = _check_operands(r, k, v, w, u)
    nc = -(-s // chunk)
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=r.device)
    final, starts = new((b, h, hd, hd)), new((b, nc, h, hd, hd))
    fade = new((b, nc, h, hd))
    strides = (ctypes.c_int64 * 16)(*_strides(r, k, v, w, y, u))
    lib = _lib()
    err = lib.wkv6_train_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), final.data_ptr(), starts.data_ptr(), fade.data_ptr(),
        strides, b, h, s, hd, chunk,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "wkv6_train")
    _WKV6.launches += 1
    return y, final, starts


torch.library.impl("repro_torch::wkv6_train", "cuda", _wkv6_train_cuda)


@torch.library.register_fake("repro_torch::wkv6_train")
def _(r, k, v, w, u, chunk):
    _check_train(r, k, v, w, u, chunk)
    b, s, h, hd = r.shape
    final = torch.empty((b, h, hd, hd), device=r.device)
    return (torch.empty(r.shape, device=r.device), final,
            final.new_empty((b, -(-s // chunk), h, hd, hd)))


@register_flop_formula(torch.ops.repro_torch.wkv6_train)
def _(r_shape, *args, out_shape=None, **kwargs):
    """``wkv6``'s: the function is the same."""
    b, s, h, hd = r_shape
    return 5 * hd * hd * h * b * s


wkv6_train_op = torch.ops.repro_torch.wkv6_train.default


def train_reference_bytes(r, k, v, w, u, chunk) -> int:
    """HBM bytes of the plain body of JAX's training forward,
    ``chunked_time_scan`` around ``wkv_step`` (``repro/models/ssm.py:30-47``,
    ``:97-103``): ``reference_bytes``' token loop, and the fp32 state
    (B, H, hd, hd) kept at each chunk's start."""
    b, s, h, hd = r.shape
    return reference_bytes(r, k, v, w, u, None, False) \
        + 4 * -(-s // chunk) * b * h * hd * hd


def wkv6_chunk_states(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor,
                      chunk: int = TIME_CHUNK
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence from zeros, keeping the state at each ``chunk``
    tokens' start. A CUDA tensor makes one call of the training entry
    (``wkv6_train``: every chunk in flight at once), or raises; a meta
    tensor takes its fake implementation; a CPU tensor runs the plain
    version through ``wkv6``, chunk after chunk from the last one's state.
    Returns (y, final state, the state at each chunk's start (B, chunks,
    H, hd, hd))."""
    if r.device.type in ("cuda", "meta"):
        return wkv6_train_op(r, k, v, w, u, chunk)
    if r.device.type != "cpu":
        raise ValueError(f"wkv6_chunk_states: no kernel for {r.device}")
    b, s, h, hd = r.shape
    state = torch.zeros((b, h, hd, hd), dtype=acc_dtype(r.dtype),
                        device=r.device)
    starts = state.new_empty((b, -(-s // chunk), h, hd, hd))
    ys = []
    for i, c0 in enumerate(range(0, s, chunk)):
        starts[:, i] = state
        ys.append(wkv6(*(t[:, c0:c0 + chunk] for t in (r, k, v, w)), u,
                       state)[0])
    return torch.cat(ys, dim=1), state, starts


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, starts: torch.Tensor,
             dy: torch.Tensor, dstate: Optional[torch.Tensor] = None,
             chunk: int = TIME_CHUNK,
             steps: int = RECOMPUTE_STEPS) -> tuple[torch.Tensor, ...]:
    """Gradient of the recurrence from zeros, given the state at each
    chunk's start (``wkv6_chunk_states``), dy and the final state's
    gradient ``dstate`` (None: zeros): each chunk recomputed from its start
    state by ``wkv6_chunked`` under autograd, the state's gradient carried
    from chunk to chunk backwards (``_remat.remat_backward``; a chunk's
    final state is its start decayed row by row by the product of its w,
    plus terms free of the start). Returns (dr, dk, dv, dw, du) in the
    inputs' type (fp32 on the model's path)."""
    def fade(seq, params):
        log_w = torch.log(seq[3].clamp_min(torch.finfo(seq[3].dtype).tiny))
        return log_w.sum(1).exp()[..., None]
    grads, (du,) = remat_backward(wkv6_chunked, (r, k, v, w), (u,), starts,
                                  dy, dstate, fade, chunk, steps)
    return (*grads, du)


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("wkv6_bwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_bwd_launch.argtypes = [vp] * 6 + [
        ctypes.POINTER(ctypes.c_int64)] + [vp] * 10 + [i32] * 5 + [vp]
    lib.wkv6_bwd_launch.restype = i32
    lib.wkv6_bwd_sub_chunk.restype = i32
    return lib


def _check_backward(r, k, v, w, u, starts, dy, dstate, chunk) -> None:
    b, s, h, hd = r.shape
    _check_shapes(r, k, v, w, u, torch.empty((b, h, hd, hd), device="meta"))
    if chunk < 1 or starts.shape != (b, -(-s // chunk), h, hd, hd) \
            or dy.shape != r.shape \
            or (dstate is not None and dstate.shape != (b, h, hd, hd)):
        raise ValueError(f"wkv6_backward: starts {tuple(starts.shape)}, dy "
                         f"{tuple(dy.shape)} for r {tuple(r.shape)}, chunk "
                         f"{chunk}")


torch.library.define(
    "repro_torch::wkv6_backward",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor starts, "
    "Tensor dy, Tensor? dstate, SymInt chunk) -> (Tensor, Tensor, Tensor, "
    "Tensor, Tensor)")


def _wkv6_backward_cuda(r, k, v, w, u, starts, dy, dstate, chunk):
    """The backward kernel's launch (``csrc/wkv6_bwd.cu``, three kernels in
    one C call), as the CUDA implementation of
    ``repro_torch::wkv6_backward``. Its scratch (the state every
    ``wkv6_bwd_sub_chunk()`` = 32 steps, the carried chunk gradients) is
    allocated here; du comes per (batch row, chunk) and is summed here, in
    a fixed order."""
    _check_backward(r, k, v, w, u, starts, dy, dstate, chunk)
    b, s, h, hd = r.shape
    lib = _bwd_lib()
    sub = lib.wkv6_bwd_sub_chunk()
    if r.dtype != torch.float32 or hd not in HEAD_DIMS or chunk % sub:
        raise ValueError(f"wkv6_backward: unsupported {r.dtype}, hd={hd}, "
                         f"chunk {chunk}")
    if _misaligned(dy):
        dy = dy.contiguous()
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("dy", dy)):
        _check_operand(name, t, r)
    if u.device != r.device or u.dtype != r.dtype:
        raise ValueError("wkv6_backward: u must be fp32 on r's device")
    u = u.contiguous()
    starts = starts.to(torch.float32).contiguous()
    if dstate is not None:
        dstate = dstate.to(torch.float32).contiguous()
    nc = starts.shape[1]
    new = functools.partial(torch.empty, dtype=torch.float32,
                            device=r.device)
    grads = [new((b, s, h, hd)) for _ in range(4)]
    ckpt = new((b, -(-s // sub), h, hd, hd))
    acc = new((b, nc, h, hd, hd))
    fade, du_part = new((b, nc, h, hd)), new((b, nc, h, hd))
    strides = (ctypes.c_int64 * 16)(
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *dy.stride()[:3], u.stride(0))
    err = lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        dy.data_ptr(), u.data_ptr(), strides, starts.data_ptr(),
        None if dstate is None else dstate.data_ptr(), ckpt.data_ptr(),
        acc.data_ptr(), fade.data_ptr(), *(g.data_ptr() for g in grads),
        du_part.data_ptr(), b, h, s, hd, chunk,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "wkv6_backward")
    _WKV6_BACKWARD.launches += 1
    return (*grads, du_part.sum((0, 1)))


torch.library.impl("repro_torch::wkv6_backward", "cuda",
                   _wkv6_backward_cuda)


@torch.library.register_fake("repro_torch::wkv6_backward")
def _(r, k, v, w, u, starts, dy, dstate, chunk):
    _check_backward(r, k, v, w, u, starts, dy, dstate, chunk)
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (r, k, v, w, u))


def _backward_flops(tokens: int, heads: int, hd: int) -> int:
    """fp32 flops of the backward over ``tokens`` (batch x steps) of
    ``heads`` heads: the vjp of the token step, dS <- w dS + r dy^T (3
    hd^2), dr = S dy, dk = dS v, dv = dS^T k and dw = the row sums of dS o
    S (2 hd^2 each), 11 hd^2, and the forward it recomputes from the kept
    states, 5 hd^2 (``wkv6``'s formula)."""
    return 16 * hd * hd * heads * tokens


@register_flop_formula(torch.ops.repro_torch.wkv6_backward)
def _(r_shape, *args, out_shape=None, **kwargs):
    b, s, h, hd = r_shape
    return _backward_flops(b * s, h, hd)


wkv6_backward_op = torch.ops.repro_torch.wkv6_backward.default


def backward_reference_bytes(r, k, v, w, u, starts, dy, dstate,
                             chunk) -> int:
    """HBM bytes of the plain body of JAX's gradient of its scan
    (``chunked_time_scan`` around ``wkv_step``, ``repro/models/ssm.py:30-47``,
    ``:97-103``): each chunk's forward recomputed from its kept state, each
    step reading and writing the fp32 state (B, H, hd, hd) and keeping it
    for the backward (one more write); the backward reading each kept
    state and reading and writing the state's gradient (3); per step the
    forward's r, k, v, w, y (``reference_bytes``) and dy, dr, dk, dv, dw,
    all (B, H, hd) fp32; u and du once."""
    b, s, h, hd = r.shape
    return 4 * s * (7 * b * h * hd * hd + 10 * b * h * hd) + 8 * u.numel()


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, starts: torch.Tensor,
                  dy: torch.Tensor, dstate: Optional[torch.Tensor] = None,
                  chunk: int = TIME_CHUNK) -> tuple[torch.Tensor, ...]:
    """The gradients ``wkv6_bwd`` returns, (dr, dk, dv, dw, du), from the
    same arguments. A CPU tensor takes the plain version (``wkv6_bwd``); a
    CUDA tensor launches the kernel, or raises; a meta tensor takes the
    operator's fake implementation."""
    if r.device.type == "cpu":
        return wkv6_bwd(r, k, v, w, u, starts, dy, dstate, chunk)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"wkv6_backward: no kernel for {r.device}")
    return wkv6_backward_op(r, k, v, w, u, starts, dy, dstate, chunk)


wkv6_backward.launches = 0
# the operator counts on the wrapper as defined here, also while a caller
# has the module's name patched (a spy, a timing span)
_WKV6_BACKWARD = wkv6_backward


class Wkv6Fn(torch.autograd.Function):
    """``wkv6`` from zeros under autograd, for training: the forward is
    ``wkv6_chunk_states`` (one C call on the card, the plain version on
    the CPU), which keeps the state at each ``TIME_CHUNK`` boundary; the
    backward is ``wkv6_backward`` (the backward kernel on the card, its
    plain version ``wkv6_bwd`` on the CPU). Returns (y, final state)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        y, final, starts = wkv6_chunk_states(r, k, v, w, u)
        ctx.save_for_backward(r, k, v, w, u, starts)
        return y, final

    @staticmethod
    def backward(ctx, dy, dstate):
        return wkv6_backward(*ctx.saved_tensors, dy, dstate)
