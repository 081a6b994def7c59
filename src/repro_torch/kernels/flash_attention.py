"""Flash attention forward (prefill): CUDA C++ kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_fwd``). The kernel is ``csrc/flash_attention.cu``; its
header says what bounds it on the H100 and how its design answers that.

Layout is the model's: q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) with
H % Hkv == 0 (query head h reads KV head h // (H // Hkv)). The kernel reads
each operand through its strides, so views of the projections go in
without a copy; only the head dim must be contiguous. Output is a new
contiguous (B, Sq, H, hd) tensor in q's dtype.

Training: ``FlashAttentionFn`` puts the kernel's forward under autograd.
The Pallas kernel has no backward (the JAX package trains through XLA's
gradient of ``models.layers.causal_attention_ref``, which XLA fuses on the
TPU). On the card the Function runs the training forward
(``flash_attention_train``: the same kernel, also writing each row's
log-sum-exp) and the backward kernel ``csrc/flash_attention_bwd.cu``
(``flash_attention_backward``), which recomputes P from the log-sum-exp.
Their plain version is ``flash_attention_bwd``, that gradient in torch
operations (the scores recomputed over chunks of query rows), which the
CPU runs and the card's checks compare with; given the forward's output
and log-sum-exp it takes the kernel's rounding points.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 96, 128, 160)   # the kernels' instances
BWD_CHUNK = 512     # query rows per chunk of the backward: JAX's chunk
PLAIN_CHUNK = 1024  # query rows per chunk of the plain version


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32, or fp64 for fp64 inputs (the tests' exact references)."""
    return torch.promote_types(t.dtype, torch.float32)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """(len(qpos), len(kpos)) bool: key visible to query, causal and
    optionally windowed."""
    mask = qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= qpos[:, None] - kpos[None, :] < window
    return mask


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with the kernel's convention: the
    max(l, 1e-30) clamp over an unnormalised exp-sum, so a row with every
    key masked gives 0, not NaN."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m.masked_fill(m == float("-inf"), 0.0))
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _row_lse(s: torch.Tensor) -> torch.Tensor:
    """The training forward's log-sum-exp of each row of scaled scores,
    with the kernel's convention: m + log(max(l, 1e-30)), m taken as 0
    for a row with every key masked."""
    m = s.amax(dim=-1, keepdim=True)
    m = m.masked_fill(m == float("-inf"), 0.0)
    l = torch.exp(s - m).sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return (m + torch.log(l))[..., 0]


def _attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: Optional[int], keep_lse: bool):
    """``flash_attention_plain``, and with ``keep_lse`` the rows'
    log-sum-exp (B, H, Sq) in the compute dtype as well."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    ct = _compute_dtype(q)
    qg = q.to(ct).reshape(b, sq, hkv, h // hkv, hd)
    kc, vc = k.to(ct), v.to(ct)
    kpos = torch.arange(sk, device=q.device)
    outs, lses = [], []
    for c0 in range(0, sq, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, sq)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, c0:c1], kc) \
            / math.sqrt(hd)
        mask = _mask(torch.arange(c0, c1, device=q.device), kpos, window)
        s = s.masked_fill(~mask, float("-inf"))
        if keep_lse:
            lses.append(_row_lse(s))
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", _softmax(s), vc))
    out = torch.cat(outs, dim=1).reshape(b, sq, h, hd).to(q.dtype)
    if not keep_lse:
        return out
    return out, torch.cat(lses, dim=-1).reshape(b, h, sq)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense fp32 scores (fp64 for
    fp64 inputs), GQA by grouping, unnormalised exp-sum and the max(l,
    1e-30) clamp, so a fully masked row gives 0 as in the kernel. The
    scores are taken PLAIN_CHUNK query rows at a time, which bounds them
    (4 x 5120 tokens of h2o-danube would be 13 GB at once)."""
    return _attention_plain(q, k, v, window, keep_lse=False)


def flash_attention_train_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, window: Optional[int] = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward's function in plain PyTorch: (out, the rows'
    log-sum-exp of the scaled, masked scores (B, H, Sq) in fp32, fp64 for
    fp64 inputs)."""
    return _attention_plain(q, k, v, window, keep_lse=True)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over matching leading axes, accumulated and returned in the
    compute dtype. bf16 operands stay bf16: on the card one product of
    bf16 operands into fp32 (the tensor cores' bf16 rate); on the CPU the
    operands are widened first, which is exact, so both devices compute the
    same sums up to their order."""
    ct = _compute_dtype(a)
    if a.dtype == ct:
        return torch.matmul(a, b)
    if a.device.type == "cpu":
        return torch.matmul(a.to(ct), b.to(ct))
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=ct)
    return out.view(*lead, *out.shape[-2:])


def _softmax_grad(p: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """dS from P and dP through the softmax, P * (dP - sum(P * dP)), as
    P * dP - P * sum(P * dP): written over dP, in two passes over it."""
    pdp = dp.mul_(p)
    return pdp.addcmul_(p, pdp.sum(dim=-1, keepdim=True), value=-1.0)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, window: Optional[int] = None, *,
                        out: Optional[torch.Tensor] = None,
                        lse: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``dout``,
    in the inputs' layouts and dtypes: the gradient XLA takes of the JAX
    package's ``causal_attention_ref``, which the JAX model trains through.
    The plain version of ``flash_attention_backward``.

    Queries and keys are the same positions (Sq == Sk, as in training), so
    every row sees at least its own key. Over chunks of BWD_CHUNK query rows
    (JAX's chunk), the scores are
    recomputed and masked and P taken by the softmax; P is cast to q's
    dtype for dV += P^T dO, as JAX's forward casts it before the PV
    product; dP = dO V^T, dS = P * (dP - sum(P * dP)), dQ = dS K * scale,
    dK += dS^T Q * scale. A chunk reads only the keys some row of it can
    see (the causal and window bounds), and query heads are grouped onto
    their KV head, so dK and dV sum over each group. Products take bf16
    operands into fp32 sums; dK and dV accumulate in fp32. At B=2, H=32,
    S=4096 a chunk holds ~0.5 GB of fp32 scores, where the whole matrix
    would be 4.3 GB.

    Given the forward's ``out`` and ``lse`` (``flash_attention_train``),
    it takes the kernel's rounding points: P = exp(S - lse) in place of
    the softmax, and D = rowsum(dO * out) in place of sum(P * dP)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if sq != sk:
        raise ValueError(f"flash_attention_bwd: {sq} queries against {sk} "
                         f"keys; the backward needs Sq == Sk")
    g = h // hkv
    ct = _compute_dtype(q)
    scale = 1.0 / math.sqrt(hd)
    # head-major: queries (B, Hkv, G, Sq, hd), keys and values (B, Hkv, Sk, hd)
    qh = q.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)
    doh = dout.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4).to(q.dtype)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    if lse is not None:
        oh = out.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)
        lseh = lse.reshape(b, hkv, g, sq).to(ct)
    dq = torch.zeros((b, hkv, g, sq, hd), dtype=ct, device=q.device)
    dk = torch.zeros((b, hkv, sk, hd), dtype=ct, device=q.device)
    dv = torch.zeros_like(dk)
    for c0 in range(0, sq, BWD_CHUNK):
        c1 = min(c0 + BWD_CHUNK, sq)
        lo = 0 if window is None else max(0, c0 - window + 1)
        n = g * (c1 - c0)
        qc = qh[:, :, :, c0:c1].reshape(b, hkv, n, hd)
        doc = doh[:, :, :, c0:c1].reshape(b, hkv, n, hd)
        kc, vc = kh[:, :, lo:c1], vh[:, :, lo:c1]
        s = _mm(qc, kc.transpose(-1, -2)).mul_(scale)
        mask = _mask(torch.arange(c0, c1, device=q.device),
                     torch.arange(lo, c1, device=q.device), window)
        s = s.view(b, hkv, g, c1 - c0, c1 - lo).masked_fill_(
            ~mask, float("-inf")).view(b, hkv, n, c1 - lo)
        if lse is None:
            p = torch.softmax(s, dim=-1)
        else:
            p = torch.exp(s.view(b, hkv, g, c1 - c0, c1 - lo).sub_(
                lseh[:, :, :, c0:c1, None])).view(b, hkv, n, c1 - lo)
        del s
        dv[:, :, lo:c1] += _mm(p.to(q.dtype).transpose(-1, -2), doc)
        dp = _mm(doc, vc.transpose(-1, -2))
        if lse is None:
            ds = _softmax_grad(p, dp).to(q.dtype)
        else:
            oc = oh[:, :, :, c0:c1].reshape(b, hkv, n, hd)
            d = (doc.to(ct) * oc.to(ct)).sum(dim=-1, keepdim=True)
            ds = dp.sub_(d).mul_(p).to(q.dtype)
        del p
        dq[:, :, :, c0:c1] = _mm(ds, kc).view(b, hkv, g, c1 - c0, hd)
        dk[:, :, lo:c1] += _mm(ds.transpose(-1, -2), qc)
    dq = dq.mul_(scale).permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return (dq.to(q.dtype), dk.mul_(scale).permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int64),
        i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.flash_attention_launch.restype = i32
    lib.flash_attention_body.argtypes = [i32, i32]
    lib.flash_attention_body.restype = i32
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [vp] * 10 + [
        ctypes.POINTER(ctypes.c_int64), i32, i32, i32, i32, i32, i32, i32,
        vp]
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_bwd_body.argtypes = [i32, i32]
    lib.flash_attention_bwd_body.restype = i32
    return lib


# the bodies a C library reports by code (``flash_attention_body``,
# ``flash_attention_bwd_body``)
BODIES = ("cuda cores", "wgmma")


def forward_body(hd: int, dtype: torch.dtype) -> str:
    """The body that the forward kernel runs on the card for head dim
    ``hd`` and ``dtype``, as the library's dispatch reports it: "wgmma"
    (the Hopper body: wgmma on TMA tiles with a producer warp; bf16 at
    every head dim) or "cuda cores" (fp32). Builds and loads the library,
    so it raises where the kernels cannot be built (no nvcc)."""
    code = _lib().flash_attention_body(hd, DTYPE_CODES.get(dtype, -1))
    if code < 0:
        raise ValueError(f"flash_attention: no body for hd={hd}, {dtype}")
    return BODIES[code]


def backward_body(hd: int, dtype: torch.dtype) -> str:
    """The body that the backward kernels run on the card for head dim
    ``hd`` and ``dtype``, as the library's dispatch reports it: "wgmma"
    (the Hopper bodies: wgmma on TMA tiles with a producer warp; bf16 at
    every head dim) or "cuda cores" (fp32). Builds and loads the
    library."""
    code = _bwd_lib().flash_attention_bwd_body(hd, DTYPE_CODES.get(dtype, -1))
    if code < 0:
        raise ValueError(f"flash_attention_backward: no body for hd={hd}, "
                         f"{dtype}")
    return BODIES[code]


def _misaligned(t: torch.Tensor) -> bool:
    """Whether the kernels cannot read ``t`` in place: they need 4 dims, a
    contiguous head dim and 16-byte aligned rows."""
    vec = 16 // t.element_size()
    return t.dim() != 4 or t.stride(3) != 1 or t.data_ptr() % 16 \
        or any(st % vec for st in t.stride()[:3])


def _check_operand(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    if t.device != q.device or t.dtype != q.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{q.dtype} on {q.device}")
    if _misaligned(t):
        raise ValueError(f"{name}: needs 4 dims with a contiguous head dim "
                         f"and 16-byte aligned rows")


def visible_pairs(sq: int, sk: int, window: Optional[int]) -> int:
    """The (query, key) pairs the kernel computes: query i sees keys 0..i,
    the last ``window`` of them with a window."""
    width = min(sk, window or sk)
    if sq <= width:
        return sq * (sq + 1) // 2
    return width * (width + 1) // 2 + (sq - width) * width


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> None:
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, hkv, hd) or v.shape != k.shape or h % hkv:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def _check_kernel(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    """What the kernels take beyond the shapes: fp32 or bf16, a head dim of
    HEAD_DIMS, operands on q's device in q's dtype that they can read in
    place."""
    if q.dtype not in DTYPE_CODES or q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported {q.dtype}, "
                         f"hd={q.shape[3]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: Optional[int], lse: Optional[torch.Tensor]
             ) -> torch.Tensor:
    """One launch of the forward kernel; with ``lse`` ((B, H, Sq) fp32) it
    also writes each row's log-sum-exp there."""
    _check_shapes(q, k, v, window)
    _check_kernel(q, k, v)
    # a broadcast operand (a stride of 0) is copied: the bf16 body reads
    # each operand through a TMA map of its strides
    q, k, v = (t.clone(memory_format=torch.contiguous_format)
               if 0 in t.stride() else t for t in (q, k, v))
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), strides,
        b, h, hkv, sq, sk, hd, window or 0, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


torch.library.define(
    "repro_torch::flash_attention",
    "(Tensor q, Tensor k, Tensor v, SymInt? window) -> Tensor")


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int]) -> torch.Tensor:
    """The kernel's launch, as the CUDA implementation of the operator
    ``repro_torch::flash_attention`` (``flash_attention_op``). The
    operator also has a fake implementation for meta tensors (the output's
    shape, dtype and strides), its flops and what the plain body would
    move (``reference_bytes``), so a model runs and is counted on meta
    tensors (``roofline.py``). It is defined with ``torch.library.define``
    and ``impl`` rather than ``torch.library.custom_op``, whose Python
    autograd and in-place layers add 19-36 us to a call where this
    registration adds 2-7 us (an H100 machine's host at the decode
    shapes, ``tools/time_op_dispatch.py``)."""
    return _forward(q, k, v, window, None)


torch.library.impl("repro_torch::flash_attention", "cuda",
                   _flash_attention_cuda)


@torch.library.register_fake("repro_torch::flash_attention")
def _(q, k, v, window):
    _check_shapes(q, k, v, window)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


def _forward_flops(q_shape, k_shape, window) -> int:
    b, sq, h, hd = q_shape
    return 4 * b * h * hd * visible_pairs(sq, k_shape[1], window)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _(q_shape, k_shape, v_shape, window, *args, out_shape=None, **kwargs):
    return _forward_flops(q_shape, k_shape, window)


flash_attention_op = torch.ops.repro_torch.flash_attention.default


def reference_bytes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int]) -> int:
    """HBM bytes of the plain body, JAX's ``causal_attention_ref`` in its
    ``vmemkernel_flash_attention`` scope (``repro/models/layers.py:98``):
    per chunk of BWD_CHUNK queries, fp32 scores over every key written and
    read by the mask and softmax (4 + 4 bytes), bf16 probabilities written
    and read by the PV product (2 + 2), and K and V, repeated to the query
    heads, read by each chunk; q read and the output written once."""
    b, sq, h, hd = q.shape
    sk, size = k.shape[1], q.element_size()
    chunks = -(-sq // BWD_CHUNK)
    return 12 * b * h * sq * sk + chunks * 2 * b * sk * h * hd * size \
        + 2 * q.numel() * size


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, or raises; a meta
    tensor takes the operator's fake implementation."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return flash_attention_op(q, k, v, window)


flash_attention.launches = 0


# ------------------------------------------------------------- training
torch.library.define(
    "repro_torch::flash_attention_train",
    "(Tensor q, Tensor k, Tensor v, SymInt? window) -> (Tensor, Tensor)")


def _flash_attention_train_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, window: Optional[int]
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch that also writes the rows' log-sum-exp
    (B, H, Sq) fp32, as the CUDA implementation of
    ``repro_torch::flash_attention_train``; it counts in
    ``flash_attention.launches`` (the same kernel). Its fake
    implementation, flops and ``reference_bytes`` are the forward's."""
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, window, lse), lse


torch.library.impl("repro_torch::flash_attention_train", "cuda",
                   _flash_attention_train_cuda)


@torch.library.register_fake("repro_torch::flash_attention_train")
def _(q, k, v, window):
    _check_shapes(q, k, v, window)
    b, sq, h, _ = q.shape
    return (torch.empty(q.shape, dtype=q.dtype, device=q.device),
            torch.empty((b, h, sq), dtype=torch.float32, device=q.device))


@register_flop_formula(torch.ops.repro_torch.flash_attention_train)
def _(q_shape, k_shape, v_shape, window, *args, out_shape=None, **kwargs):
    return _forward_flops(q_shape, k_shape, window)


flash_attention_train_op = torch.ops.repro_torch.flash_attention_train.default


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention`` and the rows' log-sum-exp (B, H, Sq), which the
    backward kernel recomputes P from. Routed as ``flash_attention``."""
    if q.device.type == "cpu":
        return flash_attention_train_plain(q, k, v, window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_train: no kernel for {q.device}")
    return flash_attention_train_op(q, k, v, window)


def _check_backward(q, k, v, out, lse, dout, window) -> None:
    _check_shapes(q, k, v, window)
    b, sq, h, _ = q.shape
    if k.shape[1] != sq:
        raise ValueError(f"flash_attention_backward: {sq} queries against "
                         f"{k.shape[1]} keys; the backward needs Sq == Sk")
    if out.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (b, h, sq):
        raise ValueError(f"flash_attention_backward: out {tuple(out.shape)},"
                         f" lse {tuple(lse.shape)}, dout "
                         f"{tuple(dout.shape)} for q {tuple(q.shape)}")


torch.library.define(
    "repro_torch::flash_attention_backward",
    "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, Tensor dout, "
    "SymInt? window) -> (Tensor, Tensor, Tensor)")


def _flash_attention_backward_cuda(q, k, v, out, lse, dout, window):
    """The backward kernels' launch (``csrc/flash_attention_bwd.cu``: the
    delta, dK/dV and dQ kernels in one C call), as the CUDA implementation
    of ``repro_torch::flash_attention_backward``. dout is copied only if
    the kernels cannot read it in place; dq, dk, dv are new contiguous
    tensors in the inputs' dtype, D a scratch buffer."""
    _check_backward(q, k, v, out, lse, dout, window)
    _check_kernel(q, k, v)
    # a broadcast dout (a stride of 0) is copied too: the Hopper bodies
    # read it through a TMA map of its strides
    if _misaligned(dout) or 0 in dout.stride():
        dout = dout.clone(memory_format=torch.contiguous_format)
    _check_operand("out", out, q)
    _check_operand("dout", dout, q)
    if lse.dtype != torch.float32 or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_backward: lse must be contiguous "
                         f"fp32 on {q.device}")
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 24)(*(st for t in (q, k, v, out, dout, dq,
                                                   dk, dv)
                                      for st in t.stride()[:3]))
    lib = _bwd_lib()
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), strides, b, h, hkv, s, hd,
        window or 0, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention_backward")
    _FLASH_ATTENTION_BACKWARD.launches += 1
    return dq, dk, dv


torch.library.impl("repro_torch::flash_attention_backward", "cuda",
                   _flash_attention_backward_cuda)


@torch.library.register_fake("repro_torch::flash_attention_backward")
def _(q, k, v, out, lse, dout, window):
    _check_backward(q, k, v, out, lse, dout, window)
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v))


def _backward_flops(q_shape, window) -> int:
    """The products the backward kernels run over the visible pairs:
    dK/dV's S^T, dP^T, dV and dK, and dQ's S and dP again and dQ: seven,
    where the forward runs two."""
    b, s, h, hd = q_shape
    return 14 * b * h * hd * visible_pairs(s, s, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _(q_shape, k_shape, v_shape, out_shape_, lse_shape, dout_shape, window,
      *args, out_shape=None, **kwargs):
    return _backward_flops(q_shape, window)


flash_attention_backward_op = \
    torch.ops.repro_torch.flash_attention_backward.default


def backward_reference_bytes(q, k, v, out, lse, dout, window) -> int:
    """HBM bytes of the plain body of JAX's gradient of its
    ``vmemkernel_flash_attention`` chunk (``repro/models/layers.py:91-112``,
    checkpointed): per (query, key) over every key, the fp32 scores
    recomputed, written and read (4 + 4), the fp32 P written and read by
    the dV product and by dS (4 + 8), the fp32 dP written and read (4 + 4),
    dS written in fp32 and read (4 + 4), its copy in the dtype written and
    read by the dQ and dK products (3 x size); per chunk of BWD_CHUNK
    queries K and V, repeated to the query heads, read by the recompute
    and by the products (4 x) and dK, dV written (2 x); q, out and dout
    read and dq written once."""
    b, s, h, hd = q.shape
    size = q.element_size()
    chunks = -(-s // BWD_CHUNK)
    return (32 + 3 * size) * b * h * s * s \
        + chunks * 6 * b * s * h * hd * size + 4 * q.numel() * size


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             window: Optional[int] = None):
    """(dq, dk, dv) given the training forward's ``out`` and ``lse``. A CPU
    tensor takes the plain version (``flash_attention_bwd`` with out and
    lse); a CUDA tensor launches the kernels, or raises; a meta tensor
    takes the operator's fake implementation."""
    if q.device.type == "cpu":
        return flash_attention_bwd(q, k, v, dout, window, out=out, lse=lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_backward: no kernel for "
                         f"{q.device}")
    return flash_attention_backward_op(q, k, v, out, lse, dout, window)


flash_attention_backward.launches = 0
# the operator counts on the wrapper as defined here, also while a caller
# has the module's name patched (a spy, a timing span)
_FLASH_ATTENTION_BACKWARD = flash_attention_backward


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd. On the CPU the forward is the
    plain version and the backward ``flash_attention_bwd``, from q, k and
    v, recomputing the scores as JAX's checkpointed chunks do. Elsewhere
    the forward is ``flash_attention_train`` (the kernel on the card),
    which keeps out and the rows' log-sum-exp for the backward kernel,
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.window = window
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            return flash_attention(q, k, v, window)
        out, lse = flash_attention_train(q, k, v, window)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        if len(saved) == 3:
            return (*flash_attention_bwd(*saved, dout, ctx.window), None)
        return (*flash_attention_backward(*saved, dout, ctx.window), None)
