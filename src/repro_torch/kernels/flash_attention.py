"""Flash attention forward (prefill): CUDA C++ kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_fwd``). The kernel is ``csrc/flash_attention.cu``; its
header says what bounds it on the H100 and how its design answers that.

Layout is the model's: q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) with
H % Hkv == 0 (query head h reads KV head h // (H // Hkv)). The kernel reads
each operand through its strides, so views of the projections go in
without a copy; only the head dim must be contiguous. Output is a new
contiguous (B, Sq, H, hd) tensor in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense fp32 scores, GQA by
    grouping, unnormalised exp-sum and the max(l, 1e-30) clamp, so a fully
    masked row gives 0 as in the kernel."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, h // hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m.masked_fill(m == float("-inf"), 0.0))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


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
