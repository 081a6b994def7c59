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
gradient of ``models.layers.causal_attention_ref``), so the backward,
``flash_attention_bwd``, is that gradient in torch operations: the scores
recomputed over chunks of query rows, matrix products on the card's tensor
cores.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense fp32 scores (fp64 for
    fp64 inputs), GQA by grouping, unnormalised exp-sum and the max(l,
    1e-30) clamp, so a fully masked row gives 0 as in the kernel. The
    scores are taken PLAIN_CHUNK query rows at a time, which bounds them
    (4 x 5120 tokens of h2o-danube would be 13 GB at once)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    ct = _compute_dtype(q)
    qg = q.to(ct).reshape(b, sq, hkv, h // hkv, hd)
    kc, vc = k.to(ct), v.to(ct)
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for c0 in range(0, sq, PLAIN_CHUNK):
        c1 = min(c0 + PLAIN_CHUNK, sq)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, c0:c1], kc) \
            / math.sqrt(hd)
        mask = _mask(torch.arange(c0, c1, device=q.device), kpos, window)
        p = _softmax(s.masked_fill(~mask, float("-inf")))
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, vc))
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd).to(q.dtype)


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
                        dout: torch.Tensor, window: Optional[int] = None):
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``dout``,
    in the inputs' layouts and dtypes: the gradient XLA takes of the JAX
    package's ``causal_attention_ref``, which the JAX model trains through.

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
    would be 4.3 GB."""
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
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, :, lo:c1] += _mm(p.to(q.dtype).transpose(-1, -2), doc)
        ds = _softmax_grad(p, _mm(doc, vc.transpose(-1, -2))).to(q.dtype)
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
        vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int64),
        i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.flash_attention_launch.restype = i32
    return lib


def _check_operand(name: str, t: torch.Tensor, q: torch.Tensor) -> None:
    vec = 16 // t.element_size()
    if t.device != q.device or t.dtype != q.dtype:
        raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                         f"{q.dtype} on {q.device}")
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{name}: needs 4 dims with a contiguous head dim")
    if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
        raise ValueError(f"{name}: rows must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, or raises."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPE_CODES or hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: unsupported {q.dtype}, hd={hd}")
    if k.shape != (b, sk, hkv, hd) or v.shape != k.shape or h % hkv:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q)
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        b, h, hkv, sq, sk, hd, window or 0, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd: the forward is the wrapper (the
    kernel on the card, the plain version on the CPU), the backward
    ``flash_attention_bwd``. It saves q, k, v and recomputes the scores, as
    JAX's checkpointed chunks do."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return flash_attention(q, k, v, window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, dout, ctx.window), None)
