"""The port's CUDA kernels against their plain versions on the card. Every
test here needs a CUDA device and skips without one; this file imports no
JAX, so it runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bf16 2e-2; fp32 1e-4, because the kernel sums in another order
than the plain version (the WKV6 recurrence: atol 2e-5, rtol 1e-4, the
limits tests/test_kernels.py holds JAX's scan and Pallas kernel to).
"""

import numpy as np
import pytest
import torch

from _torch_cases import (DECODE_CASES, FA_CASES, WKV_CASES, decode_inputs,
                          fa_inputs, wkv_inputs)
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.wkv6 import chunk_tokens, wkv6

pytestmark = pytest.mark.cuda
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# beyond the JAX tests' rows: the bf16 tensor-core body at a ragged S and
# hd 32, at hd 128 with S not a multiple of its 64-row tile, windowed
FA_CARD_CASES = [
    (6, 2, 193, 32, None, 64, 64, "bfloat16"),
    (4, 2, 300, 128, None, 64, 64, "bfloat16"),
    (8, 2, 300, 128, 100, 64, 64, "bfloat16"),
]
# WKV6's chunked body at its edges (S relative to its chunk length T; the
# token body below T) and with the decays of wkv_inputs, the model's
# range, or exact 0s and 1s mixed in
WKV_CHUNK_CASES = [(s, decays) for s in ("T-1", "T", "T+1", "2T+3", "1000")
                   for decays in ("inputs", "0.99-0.9999", "0 and 1")]
# caches long enough to split over many blocks; grp 16, the largest group
DECODE_CARD_CASES = [
    (2, 2, 4, 4096, 128, 64, "bfloat16"),
    (1, 8, 4, 2048, 64, 64, "float32"),
    (2, 2, 16, 1024, 128, 64, "bfloat16"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def close(got, want, tol):
    np.testing.assert_allclose(got.cpu().float().numpy(),
                               want.cpu().float().numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("bh,bhkv,s,hd,window,bq,bk,dtype",
                         FA_CASES + FA_CARD_CASES)
def test_flash_attention_matches_plain(cuda, bh, bhkv, s, hd, window, bq,
                                       bk, dtype):
    q, k, v = (torch.from_numpy(x).to(cuda, getattr(torch, dtype))
               for x in fa_inputs(bh, bhkv, s, hd, bh * s + hd))
    before = flash_attention.launches
    out = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    close(out, ops.flash_attention(q, k, v, window=window, impl="reference"),
          TOL[dtype])


@pytest.mark.parametrize("bh,bhkv,s,hd,window,bq,bk,dtype",
                         FA_CASES[1:4] + FA_CASES[6:] + FA_CARD_CASES[2:])
def test_flash_attention_backward_matches_plain(cuda, bh, bhkv, s, hd,
                                                window, bq, bk, dtype):
    """FlashAttentionFn (the kernel's forward, flash_attention_bwd) against
    autograd through the plain version: within the tolerance of each
    gradient's largest magnitude (bf16: the two paths round P and dS at
    other points)."""
    td = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to(cuda, td)
               for x in fa_inputs(bh, bhkv, s, hd, bh * s + hd + 1))
    dout = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(
        s), device=cuda).to(td)
    grads = {}
    for impl in ("kernel", "reference"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.flash_attention(*leaves, window=window, impl=impl).backward(dout)
        grads[impl] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    for got, want in zip(grads["kernel"], grads["reference"]):
        assert got.dtype == td
        close(got, want, TOL[dtype] * want.float().abs().max().item())


@pytest.mark.parametrize("b,hkv,grp,s,hd,bs,dtype",
                         DECODE_CASES + DECODE_CARD_CASES)
def test_flash_decode_matches_plain(cuda, b, hkv, grp, s, hd, bs, dtype):
    q, kc, vc, lens = (torch.from_numpy(x).to(cuda) for x in
                       decode_inputs(b, hkv, grp, s, hd, b * s + hd))
    td = getattr(torch, dtype)
    q = q.to(td).view(b, hkv, grp, hd)
    kc, vc = kc.to(td), vc.to(td)
    before = decode_attention.launches
    out = ops.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    close(out, ops.decode_attention(q, kc, vc, lens, impl="reference"),
          TOL[dtype])


@pytest.mark.parametrize("s,lens", [(256, [100, 1]), (4096, [1, 2049]),
                                    (4096, [4095, 1024])])
def test_decode_ignores_poisoned_slots(cuda, s, lens):
    """Slots at or past cache_len are never read, whatever the split."""
    q, kc, vc, _ = (torch.from_numpy(x).to(cuda) for x in
                    decode_inputs(2, 2, 4, s, 64, 7))
    q = q.view(2, 2, 4, 64)
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda)
    clean = ops.decode_attention(q, kc, vc, lens)
    dead = torch.arange(s, device=cuda)[None, :] >= lens[:, None].long()
    kc[dead], vc[dead] = 99.0, -99.0
    assert torch.equal(ops.decode_attention(q, kc, vc, lens), clean)


def wkv_on(cuda, shape, seed):
    return tuple(torch.from_numpy(x).to(cuda) for x in wkv_inputs(shape, seed))


def close_wkv(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("bh,s,hd,chunk", WKV_CASES)
def test_wkv6_matches_plain(cuda, bh, s, hd, chunk):
    """The JAX kernel's (BH, S, hd) layout: strided views of the kernel's."""
    r, k, v, w, u = wkv_on(cuda, (bh, s, hd), bh * s + hd)
    before = wkv6.launches
    out = ops.wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    close_wkv(out, ops.wkv6(r, k, v, w, u, impl="reference"))


def test_wkv6_state_carries_across_a_split(cuda):
    r, k, v, w, u = wkv_on(cuda, (2, 77, 3, 64), 5)
    y, final = ops.wkv6(r, k, v, w, u)
    y_plain, final_plain = ops.wkv6(r, k, v, w, u, impl="reference")
    close_wkv(y, y_plain)
    close_wkv(final, final_plain)
    y1, mid = ops.wkv6(r[:, :40], k[:, :40], v[:, :40], w[:, :40], u)
    y2, end = ops.wkv6(r[:, 40:], k[:, 40:], v[:, 40:], w[:, 40:], u, mid)
    assert end is mid
    close_wkv(torch.cat([y1, y2], dim=1), y)
    close_wkv(end, final)


def test_wkv6_one_step_updates_the_state_in_place(cuda):
    """Decode: S=1 from a carried state, read and written in one buffer
    that is a layer's slice of a stacked (L, B, H, hd, hd) cache."""
    r, k, v, w, u = wkv_on(cuda, (4, 1, 5, 32), 6)
    cache = torch.randn((3, 4, 5, 32, 32), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    start = cache.clone()
    y, final = ops.wkv6(r, k, v, w, u, cache[1])
    assert final.data_ptr() == cache[1].data_ptr()
    want_state = start[1].clone()
    want, _ = ops.wkv6(r, k, v, w, u, want_state, impl="reference")
    close_wkv(y, want)
    close_wkv(cache[1], want_state)
    assert torch.equal(cache[0], start[0]) and torch.equal(cache[2], start[2])


@pytest.mark.parametrize("s,decays", WKV_CHUNK_CASES)
def test_wkv6_chunk_edges_and_decays(cuda, s, decays):
    """From a nonzero state at rwkv6-3b's head width, y and the final
    state against the plain version."""
    t = chunk_tokens()
    steps = {"T-1": t - 1, "T": t, "T+1": t + 1, "2T+3": 2 * t + 3,
             "1000": 1000}[s]
    r, k, v, w, u = (torch.from_numpy(x) for x in
                     wkv_inputs((2, steps, 5, 64), steps))
    rng = np.random.default_rng(steps + 1)
    if decays == "0.99-0.9999":
        w = torch.from_numpy(rng.uniform(0.99, 0.9999, w.shape)
                             .astype(np.float32))
    elif decays == "0 and 1":
        pick = torch.from_numpy(rng.uniform(size=w.shape))
        w = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.9, 1.0, w))
    start = torch.from_numpy(rng.standard_normal((2, 5, 64, 64))
                             .astype(np.float32))
    r, k, v, w, u, start = (x.to(cuda) for x in (r, k, v, w, u, start))
    st_k, st_p = start.clone(), start.clone()
    before = wkv6.launches
    y, _ = ops.wkv6(r, k, v, w, u, st_k)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    want, _ = ops.wkv6(r, k, v, w, u, st_p, impl="reference")
    close_wkv(y, want)
    close_wkv(st_k, st_p)
