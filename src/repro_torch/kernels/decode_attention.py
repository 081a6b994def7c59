"""Flash decode: CUDA C++ kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``flash_decode``). The kernel is ``csrc/decode_attention.cu``; its header
says what bounds it on the H100 and how its design answers that: the slots
are split over blocks (``plan_splits``), whose partial results a second
kernel merges, both launched by one call.

Layout is the model's: q (B, Hkv, grp, hd) holds the group of query heads
that share each KV head, the caches are (B, S, Hkv, hd) and cache_len (B,)
counts the valid slots of each batch row. The kernel reads every operand
through its strides (only the head dim must be contiguous), so a layer's
slice of the stacked cache goes in without a transpose, and it never reads
a slot at or past cache_len. Output is a new contiguous (B, Hkv, grp, hd)
tensor in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build
from .flash_attention import DTYPE_CODES, HEAD_DIMS, _check_operand

MAX_GROUP = 16
SLOT_TILE = 64      # cache slots per tile of the kernel (csrc BS)
WAVES = 4           # blocks to aim for, in multiples of the SM count


def plan_splits(rows: int, capacity: int, n_sm: int) -> tuple[int, int]:
    """(n_split, chunk): split each of ``rows`` (batch x KV head) caches of
    ``capacity`` slots into n_split chunks of ``chunk`` slots, a multiple of
    SLOT_TILE; the last chunk is cut at the capacity. It aims for
    WAVES * n_sm blocks (rows * n_split) and, rounding the chunk up to
    whole tiles, never gives fewer than WAVES / 2 * n_sm, or one tile per
    chunk where the capacity has fewer tiles than that. The plan reads no
    cache_len: that is a device tensor, and reading it would sync."""
    tiles = -(-capacity // SLOT_TILE)
    want = -(-WAVES * n_sm // rows)                 # splits per row
    chunk = SLOT_TILE * -(-tiles // min(want, tiles))
    return -(-capacity // chunk), chunk


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           cache_len: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dense fp32 scores over the
    slots below cache_len, unnormalised exp-sum and the max(l, 1e-30)
    clamp, so a row with no valid slot gives 0 as in the kernel."""
    hd, s = q.shape[-1], k_cache.shape[1]
    scores = torch.einsum("bkgd,bskd->bkgs", q.float(),
                          k_cache.float()) / math.sqrt(hd)
    valid = torch.arange(s, device=q.device)[None, :] < cache_len[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m.masked_fill(m == float("-inf"), 0.0))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bkgs,bskd->bkgd", p / l,
                        v_cache.float()).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int64),
        i32, i32, i32, i32, i32, i32, vp, i32, i32, vp]
    lib.decode_attention_launch.restype = i32
    return lib


def _check_shapes(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, cache_len: torch.Tensor) -> None:
    b, hkv, grp, hd = q.shape
    s = k_cache.shape[1]
    if k_cache.shape != (b, s, hkv, hd) or v_cache.shape != k_cache.shape \
            or cache_len.shape != (b,):
        raise ValueError(f"decode_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}, "
                         f"{tuple(cache_len.shape)}")


torch.library.define(
    "repro_torch::decode_attention",
    "(Tensor q, Tensor k_cache, Tensor v_cache, Tensor cache_len) "
    "-> Tensor")


def _decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           cache_len: torch.Tensor) -> torch.Tensor:
    """The kernels' launch (split-S and merge, one C call), as an operator
    with a fake implementation for meta tensors, its flops and what the
    plain body would move (``reference_bytes``); see
    ``flash_attention._flash_attention_cuda``."""
    _check_shapes(q, k_cache, v_cache, cache_len)
    b, hkv, grp, hd = q.shape
    s = k_cache.shape[1]
    if q.dtype not in DTYPE_CODES or hd not in HEAD_DIMS or grp > MAX_GROUP:
        raise ValueError(f"decode_attention: unsupported {q.dtype}, "
                         f"hd={hd}, grp={grp}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        _check_operand(name, t, q)
    lens = cache_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, hkv, grp, hd), dtype=q.dtype, device=q.device)
    n_split, chunk = plan_splits(b * hkv, s, _sm_count(q.device))
    # per (row, split, query): acc (hd floats), then m and l
    ws = torch.empty(b * hkv * n_split * grp * (hd + 2), dtype=torch.float32,
                     device=q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:3])
    lib = _lib()
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lens.data_ptr(), strides, b, hkv, grp, s, hd, DTYPE_CODES[q.dtype],
        ws.data_ptr(), n_split, chunk,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return out


torch.library.impl("repro_torch::decode_attention", "cuda",
                   _decode_attention_cuda)


@torch.library.register_fake("repro_torch::decode_attention")
def _(q, k_cache, v_cache, cache_len):
    _check_shapes(q, k_cache, v_cache, cache_len)
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _(q_shape, k_shape, v_shape, len_shape, *args, out_shape=None,
      **kwargs):
    """Every slot of the cache: cache_len lives on the device, and the
    count reads no data (the kernel skips the slots past it)."""
    b, hkv, grp, hd = q_shape
    return 4 * b * hkv * grp * hd * k_shape[1]


decode_attention_op = torch.ops.repro_torch.decode_attention.default


def reference_bytes(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, cache_len: torch.Tensor) -> int:
    """HBM bytes of the plain body, JAX's ``decode_attention_ref`` in its
    ``vmemkernel_decode_attention`` scope (``repro/models/layers.py:140``):
    both caches read whole, fp32 scores over every slot written and read
    by the mask and softmax (4 + 4 bytes), probabilities in the cache's
    dtype written and read by the PV product, q read and the output
    written."""
    b, hkv, grp, hd = q.shape
    slots, size = k_cache.shape[1], k_cache.element_size()
    return 2 * k_cache.numel() * size \
        + b * hkv * grp * slots * (8 + 2 * size) \
        + 2 * q.numel() * q.element_size()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """One query token per head against the cache. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel, or raises; a meta
    tensor takes the operator's fake implementation."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    return decode_attention_op(q, k_cache, v_cache, cache_len)


decode_attention.launches = 0
