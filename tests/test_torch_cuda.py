"""The port's CUDA kernels against their plain versions on the card. Every
test here needs a CUDA device and skips without one; this file imports no
JAX, so it runs where only PyTorch is installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: bf16 2e-2; fp32 1e-4, because the kernel sums in another order
than the plain version (the WKV6 recurrence and the Mamba scan: atol 2e-5,
rtol 1e-4, the limits tests/test_kernels.py holds JAX's scan and Pallas
kernel to).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from _torch_cases import (DECODE_CASES, FA_CASES, MAMBA_CASES, WKV_CASES,
                          decode_inputs, fa_inputs, mamba_inputs, wkv_inputs)
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan, time_tile
from repro_torch.kernels.wkv6 import chunk_tokens, wkv6
from repro_torch.models import moe

pytestmark = pytest.mark.cuda
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# beyond the JAX tests' rows: the bf16 tensor-core body at a ragged S and
# hd 32, at hd 128 with S not a multiple of its 64-row tile, windowed; then
# hd 96, 80 and 160 with GQA and a window (hd 160's two-buffer ring)
FA_CARD_CASES = [
    (6, 2, 193, 32, None, 64, 64, "bfloat16"),
    (4, 2, 300, 128, None, 64, 64, "bfloat16"),
    (8, 2, 300, 128, 100, 64, 64, "bfloat16"),
    (8, 2, 300, 96, 100, 64, 64, "bfloat16"),
    (8, 2, 700, 80, 256, 64, 64, "bfloat16"),
    (8, 2, 700, 160, 256, 64, 64, "bfloat16"),
    (8, 2, 300, 160, 100, 64, 64, "float32"),
]
# WKV6's chunked body at its edges (S relative to its chunk length T; the
# token body below T) and with the decays of wkv_inputs, the model's
# range, or exact 0s and 1s mixed in
WKV_CHUNK_CASES = [(s, decays) for s in ("T-1", "T", "T+1", "2T+3", "1000")
                   for decays in ("inputs", "0.99-0.9999", "0 and 1")]
# WKV6's token body: S of 1 (a decode step), 2 and T-1 (the longest run
# below the chunked body), at every head dim the kernel takes
WKV_TOKEN_STEPS = ["1", "2", "T-1"]
# caches long enough to split over many blocks; grp 16, the largest group
DECODE_CARD_CASES = [
    (2, 2, 4, 4096, 128, 64, "bfloat16"),
    (1, 8, 4, 2048, 64, 64, "float32"),
    (2, 2, 16, 1024, 128, 64, "bfloat16"),
    (2, 4, 1, 1024, 96, 64, "bfloat16"),
    (2, 2, 4, 4096, 80, 64, "bfloat16"),
    (2, 2, 4, 2048, 160, 64, "float32"),
    (1, 2, 16, 1024, 160, 64, "bfloat16"),
]


# the fused Mamba scan at hymba's state width over many channels, and on
# both sides of its body switch: S relative to the chunked body's tile T
# (the token body below T), and one decode step
MAMBA_CARD_CASES = [(4, 1000, 1600, 16, True), (2, 333, 200, 8, False)]
MAMBA_TILE_EDGES = ["1", "T-1", "T", "T+1", "2T+3"]
# the token body: S of 1 (a decode step), 2 (the first with a step loaded
# ahead), 15 and T-1 (the longest run below the chunked body)
MAMBA_TOKEN_STEPS = ["1", "2", "15", "T-1"]


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
    """FlashAttentionFn (the training forward and the backward kernels)
    against autograd through the plain version: within the tolerance of
    each gradient's largest magnitude (bf16: the two paths round P and dS
    at other points)."""
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
    before = wkv6.launches, wkv6.token_launches
    y, _ = ops.wkv6(r, k, v, w, u, st_k)
    torch.cuda.synchronize()
    assert (wkv6.launches, wkv6.token_launches) == \
        (before[0] + 1, before[1] + (steps < t))
    want, _ = ops.wkv6(r, k, v, w, u, st_p, impl="reference")
    close_wkv(y, want)
    close_wkv(st_k, st_p)


@pytest.mark.parametrize("start", ["state", "zero"])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("s", WKV_TOKEN_STEPS)
def test_wkv6_token_body_matches_plain(cuda, s, hd, start):
    """The token body into layer 1's slice of a stacked (3, B, H, hd, hd)
    cache, from the slice's contents or from zero (the slice poisoned
    with NaN: has_state 0 reads none of it and writes the final state
    there), against the plain version; layers 0 and 2 unchanged; each
    launch counted as the token body's. From zero the public call with no
    state gives the same y."""
    from repro_torch.kernels.wkv6 import wkv6_op
    steps = {"1": 1, "2": 2, "T-1": chunk_tokens() - 1}[s]
    r, k, v, w, u = wkv_on(cuda, (3, steps, 5, hd), steps * hd)
    cache = torch.randn((3, 3, 5, hd, hd), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(hd))
    if start == "zero":
        cache[1] = float("nan")
    before = cache.clone()
    counts = wkv6.launches, wkv6.token_launches
    if start == "state":
        y, final = ops.wkv6(r, k, v, w, u, cache[1])
        assert final.data_ptr() == cache[1].data_ptr()
        want_state = before[1].clone()
    else:
        y = wkv6_op(r, k, v, w, u, cache[1], False)
        y_none, final_none = ops.wkv6(r, k, v, w, u)
        want_state = torch.zeros_like(before[1])
    torch.cuda.synchronize()
    calls = 1 if start == "state" else 2
    assert (wkv6.launches, wkv6.token_launches) == \
        (counts[0] + calls, counts[1] + calls)
    want, _ = ops.wkv6(r, k, v, w, u, want_state, impl="reference")
    close_wkv(y, want)
    close_wkv(cache[1], want_state)
    if start == "zero":
        close_wkv(y_none, want)
        close_wkv(final_none, want_state)
    assert torch.equal(cache[0], before[0]) and \
        torch.equal(cache[2], before[2])


def test_wkv6_raises_on_a_misaligned_state(cuda):
    """A state whose rows are not 16-byte aligned (its start 4 bytes off,
    or a key-row stride of 65 floats) raises and launches nothing; so
    does a u whose start is 4 bytes off, and the state is left as it
    was."""
    r, k, v, w, u = wkv_on(cuda, (2, 1, 3, 64), 9)
    counts = wkv6.launches, wkv6.token_launches
    flat = torch.zeros(2 * 3 * 64 * 64 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.wkv6(r, k, v, w, u, flat[1:].view(2, 3, 64, 64))
    wide = torch.zeros((2, 3, 64, 65), device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.wkv6(r, k, v, w, u, wide[..., :64])
    u_off = torch.zeros(3 * 64 + 1, device=cuda)[1:].view(3, 64)
    u_off.copy_(u)
    state = torch.ones((2, 3, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.wkv6(r, k, v, w, u_off, state)
    assert (wkv6.launches, wkv6.token_launches) == counts
    assert torch.equal(state, torch.ones_like(state))


def mamba_on(cuda, bsz, s, di, n, seed, dtype, carried=True):
    """The fused scan's inputs on the card: dt_raw, b and c (the halves of
    one projection), x and z (the second half of one (B, S, 2 di) tensor)
    in ``dtype``, dt_bias, a_log, d_skip and the state h in fp32."""
    dt_raw, dt_bias, bc, x, zz, a_log, d_skip, h = mamba_inputs(
        bsz, s, di, n, seed, carried)
    td = getattr(torch, dtype)
    dt_raw, bc, x, zz = (torch.from_numpy(t).to(cuda, td)
                         for t in (dt_raw, bc, x, zz))
    dt_bias, a_log, d_skip = (torch.from_numpy(t).to(cuda)
                              for t in (dt_bias, a_log, d_skip))
    h = None if h is None else torch.from_numpy(h).to(cuda)
    return (dt_raw, dt_bias, bc[..., :n], bc[..., n:], x, zz[..., di:],
            a_log, d_skip, h)


def check_mamba(cuda, args):
    """The kernel against its plain version: out (fp32 within the scan's
    atol 2e-5, rtol 1e-4; bf16 within TOL, a step of its rounding) and the
    final state (fp32, the scan's limits; bit-equal from the token body,
    which keeps JAX's step order), the given state written in place; one
    launch, counted as the token body's below the tile."""
    *inputs, h = args
    s = inputs[0].shape[1]
    before = mamba_scan.launches, mamba_scan.token_launches
    state = None if h is None else h.clone()
    out, final = ops.mamba_scan(*inputs, state)
    torch.cuda.synchronize()
    token = s < time_tile()
    assert (mamba_scan.launches, mamba_scan.token_launches) == \
        (before[0] + 1, before[1] + token)
    assert h is None or final is state
    want, want_final = ops.mamba_scan(*inputs,
                                      None if h is None else h.clone(),
                                      impl="reference")
    assert out.dtype == inputs[0].dtype and final.dtype == torch.float32
    if out.dtype == torch.float32:
        close_wkv(out, want)
    else:
        close(out, want, TOL["bfloat16"])
    close_wkv(final, want_final)
    if token:
        assert torch.equal(final, want_final)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,s,di,n,carried",
                         MAMBA_CASES + MAMBA_CARD_CASES)
def test_mamba_scan_matches_plain(cuda, bsz, s, di, n, carried, dtype):
    check_mamba(cuda, mamba_on(cuda, bsz, s, di, n, s + di, dtype, carried))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", MAMBA_TILE_EDGES)
def test_mamba_scan_tile_edges(cuda, edge, dtype):
    t = time_tile()
    steps = {"1": 1, "T-1": t - 1, "T": t, "T+1": t + 1,
             "2T+3": 2 * t + 3}[edge]
    check_mamba(cuda, mamba_on(cuda, 2, steps, 48, 16, steps, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_scan_one_step_updates_the_state_in_place(cuda, dtype):
    """Decode: S=1 from a carried state, read and written in one buffer
    that is a layer's slice of a stacked (L, B, di, n) cache; the state
    bit-equal to the plain loop's."""
    *inputs, _ = mamba_on(cuda, 4, 1, 160, 16, 9, dtype)
    cache = torch.randn((3, 4, 160, 16), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(0))
    start = cache.clone()
    out, final = ops.mamba_scan(*inputs, cache[1])
    assert final.data_ptr() == cache[1].data_ptr()
    want_state = start[1].clone()
    want, _ = ops.mamba_scan(*inputs, want_state, impl="reference")
    close(out, want, TOL[dtype] if dtype == "bfloat16" else 2e-5)
    assert torch.equal(cache[1], want_state)
    assert torch.equal(cache[0], start[0]) and torch.equal(cache[2], start[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", ["state", "zero"])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("s", MAMBA_TOKEN_STEPS)
def test_mamba_token_body_matches_plain(cuda, s, n, start, dtype):
    """The token body into layer 1's slice of a stacked (3, B, di, n)
    cache, from the slice's contents or from zero (the slice poisoned with
    NaN: the operator with has_state false reads none of it and writes the
    final state there), against the plain loop: out within the scan's
    fp32 limits or a bf16 step, the state bit-equal, layers 0 and 2
    unchanged, one launch counted as the token body's. di 40 is no
    multiple of a block's channels."""
    from repro_torch.kernels.mamba_scan import mamba_scan_op
    steps = {"1": 1, "2": 2, "15": 15, "T-1": time_tile() - 1}[s]
    *inputs, _ = mamba_on(cuda, 3, steps, 40, n, steps + n, dtype)
    cache = torch.randn((3, 3, 40, n), device=cuda,
                        generator=torch.Generator(cuda).manual_seed(n))
    if start == "zero":
        cache[1] = float("nan")
    before = cache.clone()
    counts = mamba_scan.launches, mamba_scan.token_launches
    if start == "state":
        out, final = ops.mamba_scan(*inputs, cache[1])
        assert final.data_ptr() == cache[1].data_ptr()
        want_state = before[1].clone()
    else:
        out = mamba_scan_op(*inputs, cache[1], False)
        want_state = None
    torch.cuda.synchronize()
    assert (mamba_scan.launches, mamba_scan.token_launches) == \
        (counts[0] + 1, counts[1] + 1)
    want, want_final = ops.mamba_scan(*inputs, want_state, impl="reference")
    if dtype == "float32":
        close_wkv(out, want)
    else:
        close(out, want, TOL[dtype])
    assert torch.equal(cache[1], want_final)
    assert torch.equal(cache[0], before[0]) and \
        torch.equal(cache[2], before[2])


def test_mamba_scan_raises_on_a_misaligned_state(cuda):
    """The token body reads and writes the state and a_log as 16-byte
    vectors: a state whose start is 4 bytes off, or whose batch stride is
    not a multiple of 4 floats, raises and launches nothing, as does an
    a_log 4 bytes off; the state is left as it was and nothing is
    copied."""
    dt, bias, b, c, x, z, a_log, skip, h = mamba_on(cuda, 2, 1, 48, 16, 5,
                                                    "bfloat16")
    counts = mamba_scan.launches, mamba_scan.token_launches
    flat = torch.zeros(2 * 48 * 16 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.mamba_scan(dt, bias, b, c, x, z, a_log, skip,
                       flat[1:].view(2, 48, 16))
    wide = torch.zeros(2 * 48 * 16 + 1, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.mamba_scan(dt, bias, b, c, x, z, a_log, skip,
                       wide.as_strided((2, 48, 16), (48 * 16 + 1, 16, 1)))
    a_off = torch.zeros(48 * 16 + 1, device=cuda)[1:].view(48, 16)
    a_off.copy_(a_log)
    state = torch.ones((2, 48, 16), device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.mamba_scan(dt, bias, b, c, x, z, a_off, skip, state)
    assert (mamba_scan.launches, mamba_scan.token_launches) == counts
    assert torch.equal(state, torch.ones_like(state))
    assert torch.equal(wide, torch.zeros_like(wide))


def test_mamba_scan_raises_rather_than_falling_back(cuda):
    """A CUDA tensor the kernel does not take raises, launches nothing and
    never goes to the plain version: di not a multiple of 8, z's rows not
    16-byte aligned, b in another dtype."""
    dt, bias, b, c, x, z, a_log, skip, h = mamba_on(cuda, 2, 70, 48, 16, 3,
                                                    "bfloat16")
    before = mamba_scan.launches
    with pytest.raises(ValueError):
        mamba_scan(dt[..., :12], bias[:12], b, c, x[..., :12], z[..., :12],
                   a_log[:12], skip[:12], h[:, :12])
    zz = torch.zeros((2, 70, 97), dtype=z.dtype, device=cuda)
    zz[..., 1:49] = z
    with pytest.raises(ValueError):
        mamba_scan(dt, bias, b, c, x, zz[..., 1:49], a_log, skip, h)
    with pytest.raises(ValueError):
        mamba_scan(dt, bias, b.float(), c, x, z, a_log, skip, h)
    assert mamba_scan.launches == before


# training: the recurrences under Wkv6Fn and MambaScanFn (the kernels'
# training forward one call a layer), S within one chunk, with a ragged
# last chunk, and across two
TRAIN_LENGTHS = [40, 300, 512]


def check_grads(kernel, plain, inputs, dout, tol):
    """Autograd through ``kernel`` (ops, the Function) against autograd
    through ``plain`` (impl="reference") on the same inputs: every input
    gets a gradient within ``tol`` of the largest magnitude of the plain
    one. Returns the kernel path's output."""
    got = [t.detach().clone().requires_grad_(True) for t in inputs]
    want = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = kernel(*got)[0]
    assert out.grad_fn is not None       # the kernel did not cut the graph
    out.backward(dout)
    plain(*want)[0].backward(dout)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.grad is not None and g.grad.dtype == w.grad.dtype, i
        scale = w.grad.float().abs().max().item()
        np.testing.assert_allclose(g.grad.float().cpu().numpy(),
                                   w.grad.float().cpu().numpy(), rtol=0,
                                   atol=tol * scale, err_msg=f"input {i}")
    return out


@pytest.mark.parametrize("s", TRAIN_LENGTHS)
def test_wkv6_training_carries_the_gradient(cuda, s):
    inputs = wkv_on(cuda, (2, s, 3, 64), s)
    dy = torch.randn((2, s, 3, 64), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(s))
    before = wkv6.launches
    check_grads(ops.wkv6, functools.partial(ops.wkv6, impl="reference"),
                inputs, dy, 2e-5)
    assert wkv6.launches == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", TRAIN_LENGTHS)
def test_mamba_scan_training_carries_the_gradient(cuda, s, dtype):
    *inputs, _ = mamba_on(cuda, 2, s, 48, 16, s, dtype, carried=False)
    dout = torch.randn((2, s, 48), device=cuda,
                       generator=torch.Generator(cuda).manual_seed(s))
    before = mamba_scan.launches
    check_grads(ops.mamba_scan,
                functools.partial(ops.mamba_scan, impl="reference"),
                inputs, dout.to(inputs[0].dtype),
                2e-5 if dtype == "float32" else TOL["bfloat16"])
    assert mamba_scan.launches == before + 1


# the training forwards (one call a layer, every chunk's start state kept)
# at ragged S: within a chunk, a ragged last chunk of 44 steps (under the
# scan's 64-step tile) and of 100 (over it)
TRAIN_FORWARD_LENGTHS = [40, 4 * 256 + 44, 4 * 256 + 100]


def wkv6_chain(r, k, v, w, u, chunk=256):
    """The plain version chunk by chunk from the last chunk's state, on
    the inputs' device: (y, final state, starts)."""
    from repro_torch.kernels.wkv6 import wkv6_plain
    b, s, h, hd = r.shape
    state = torch.zeros((b, h, hd, hd), device=r.device)
    starts, ys = [], []
    for c0 in range(0, s, chunk):
        starts.append(state.clone())
        ys.append(wkv6_plain(*(t[:, c0:c0 + chunk] for t in (r, k, v, w)),
                             u, state)[0])
    return torch.cat(ys, 1), state, torch.stack(starts, 1)


@pytest.mark.parametrize("decays", ["inputs", "0 and 1"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("s", TRAIN_FORWARD_LENGTHS)
def test_wkv6_train_forward_matches_plain(cuda, s, hd, decays):
    """WKV6's training forward (summaries, carry, every chunk's y in one C
    call, one launch counted) against the plain version chunk by chunk:
    y, the final state and every chunk's start within the scan's limits;
    with exact 0 (the state wiped) and 1 decays mixed in."""
    from repro_torch.kernels import wkv6 as wk
    r, k, v, w, u = wkv_on(cuda, (2, s, 3, hd), s + hd)
    if decays == "0 and 1":
        pick = torch.rand(w.shape, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(s))
        w = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.9, 1.0, w))
    before = wkv6.launches
    y, final, starts = wk.wkv6_chunk_states(r, k, v, w, u)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    want_y, want_final, want_starts = wkv6_chain(r, k, v, w, u)
    assert starts.shape == want_starts.shape
    assert torch.count_nonzero(starts[:, 0]) == 0
    close_wkv(y, want_y)
    close_wkv(final, want_final)
    close_wkv(starts, want_starts)


def mamba_chain(dt, dt_bias, b, c, x, z, a_log, d_skip, chunk=256):
    """The scan kernel launched chunk by chunk, each from the last one's
    state (the training forward before it kept its starts itself): (out,
    final state, starts)."""
    bsz, s, di = dt.shape
    h = torch.zeros((bsz, di, a_log.shape[1]), device=dt.device)
    starts, outs = [], []
    for c0 in range(0, s, chunk):
        starts.append(h.clone())
        b_c, c_c, x_c, z_c = (t[:, c0:c0 + chunk] for t in (b, c, x, z))
        outs.append(mamba_scan(dt[:, c0:c0 + chunk], dt_bias, b_c, c_c, x_c,
                               z_c, a_log, d_skip, h)[0])
    return torch.cat(outs, 1), h, torch.stack(starts, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", TRAIN_FORWARD_LENGTHS)
def test_mamba_train_forward_is_the_chain(cuda, s, dtype):
    """The scan's training forward (one launch that writes every chunk's
    start) against the chain of one launch a chunk: the starts bit-equal,
    and out and the final state bit-equal wherever the chain ran the
    chunked body (its last chunk at least a tile long); everything
    against the plain version within the scan's limits."""
    from repro_torch.kernels import mamba_scan as ms
    *inputs, _ = mamba_on(cuda, 2, s, 48, 16, s, dtype, carried=False)
    before = mamba_scan.launches, mamba_scan.token_launches
    out, final, starts = ms.mamba_chunk_states(*inputs)
    torch.cuda.synchronize()
    assert (mamba_scan.launches, mamba_scan.token_launches) == \
        (before[0] + 1, before[1])
    chain = mamba_chain(*inputs)
    assert torch.equal(starts, chain[2])
    tail = s % 256
    if tail == 0 or tail >= time_tile():
        assert torch.equal(out, chain[0]) and torch.equal(final, chain[1])
    else:
        assert torch.equal(out[:, :s - tail], chain[0][:, :s - tail])
    want, want_final = ops.mamba_scan(*inputs, impl="reference")
    if out.dtype == torch.float32:
        close_wkv(out, want)
    else:
        close(out, want, TOL["bfloat16"])
    close_wkv(final, want_final)


def test_train_forwards_raise_rather_than_fall_back(cuda):
    """A CUDA tensor the training forwards do not take raises and launches
    nothing: WKV6 in bf16 or at hd 128, the scan with a chunk that is no
    multiple of its time tile or b in another dtype."""
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    r, k, v, w, u = wkv_on(cuda, (2, 300, 3, 64), 4)
    before = wkv6.launches, mamba_scan.launches
    with pytest.raises(ValueError):
        wk.wkv6_chunk_states(*(t.bfloat16() for t in (r, k, v, w, u)))
    r2 = torch.zeros((2, 300, 3, 128), device=cuda)
    with pytest.raises(ValueError):
        wk.wkv6_chunk_states(r2, r2, r2, r2, torch.zeros((3, 128),
                                                          device=cuda))
    dt, bias, b, c, x, z, a_log, skip, _ = mamba_on(cuda, 2, 300, 48, 16, 3,
                                                    "bfloat16")
    with pytest.raises(ValueError):
        ms.mamba_chunk_states(dt, bias, b, c, x, z, a_log, skip, chunk=100)
    with pytest.raises(ValueError):
        ms.mamba_chunk_states(dt, bias, b.float(), c, x, z, a_log, skip)
    assert (wkv6.launches, mamba_scan.launches) == before


# the backward kernels against their plain versions on the same inputs:
# attention at every head dim, query groups of 1, 4 and 5 over 2 KV heads,
# S ragged against the 64- and 32-row tiles, with and without a window;
# the scan at both state widths, S within a 256-step chunk, with a ragged
# last chunk and across five, from dh None and given
BWD_HEAD_DIMS = [32, 64, 80, 96, 128, 160]
SCAN_BWD_LENGTHS = [40, 300, 4 * 256 + 44]


def attention_train_inputs(cuda, grp, s, hd, dtype, seed):
    """q (2, S, 2 grp, hd), k, v (2, S, 2, hd) and dout, in ``dtype``."""
    rng = np.random.default_rng(seed)
    td = getattr(torch, dtype)

    def rand(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda, td)
    return (rand((2, s, 2 * grp, hd), 1.0), rand((2, s, 2, hd), 1.0),
            rand((2, s, 2, hd), 0.5), rand((2, s, 2 * grp, hd), 1.0))


def close_to_max(got, want, tol, name=""):
    """|got - want| <= tol x max |want|, elementwise."""
    scale = max(want.float().abs().max().item(), 1e-30)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0,
                               atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("grp", [1, 4, 5])
@pytest.mark.parametrize("hd", BWD_HEAD_DIMS)
def test_flash_attention_backward_kernel_matches_plain(cuda, hd, grp,
                                                       window, dtype):
    """The training forward's log-sum-exp, and the backward kernels given
    its out and lse, against their plain versions on the same inputs
    (``flash_attention_train_plain``; ``flash_attention_bwd`` with out and
    lse, the kernel's rounding points): lse within 1e-5 absolute (fp32
    scores; bf16: 2e-2, the scores' products differ in order), dq, dk,
    dv within TOL of each gradient's largest magnitude; one launch of
    each."""
    from repro_torch.kernels import flash_attention as fa
    s = 333
    q, k, v, dout = attention_train_inputs(cuda, grp, s, hd, dtype,
                                           hd + grp + (window or 0))
    before = fa.flash_attention.launches, fa.flash_attention_backward.launches
    out, lse = fa.flash_attention_train(q, k, v, window)
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, window)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches,
            fa.flash_attention_backward.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want_out, want_lse = fa.flash_attention_train_plain(q, k, v, window)
    assert lse.shape == (2, 2 * grp, s) and lse.dtype == torch.float32
    close(lse, want_lse, 1e-5 if dtype == "float32" else 2e-2)
    close(out, want_out, TOL[dtype])
    want = fa.flash_attention_bwd(q, k, v, dout, window, out=out, lse=lse)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == w.dtype == q.dtype and g.shape == w.shape
        close_to_max(g, w, TOL[dtype], name)


# the scan's backward kernel against mamba_scan_bwd: batch rows, n, S
# (one chunk, a ragged last chunk, five chunks), dtype, dh given; at B=1
# every chunk is a block column of its own
SCAN_BWD_CASES = [(b, n, s, dtype, given)
                  for b, n in ((2, 8), (2, 16), (1, 16))
                  for s in SCAN_BWD_LENGTHS
                  for dtype in ("float32", "bfloat16")
                  for given in ((False, True) if b == 2 else (True,))]


@pytest.mark.parametrize("b,n,s,dtype,given", SCAN_BWD_CASES)
def test_mamba_scan_backward_kernel_matches_plain(cuda, b, n, s, dtype,
                                                  given):
    """The backward kernel against its plain version (``mamba_scan_bwd``)
    from the same kept states, dout and dh (None, or given): every
    gradient in the plain version's dtype and within 2e-5 (fp32) or TOL
    (bf16) of its largest magnitude; one launch, and the same bits from a
    second run."""
    from repro_torch.kernels import mamba_scan as ms
    *inputs, _ = mamba_on(cuda, b, s, 48, n, s + n, dtype, carried=False)
    gen = torch.Generator(cuda).manual_seed(s)
    dout = torch.randn((b, s, 48), device=cuda, generator=gen).to(
        inputs[0].dtype)
    dh = torch.randn((b, 48, n), device=cuda, generator=gen) if given \
        else None
    _, _, starts = ms.mamba_chunk_states(*inputs)
    before = ms.mamba_scan_backward.launches
    got = ms.mamba_scan_backward(*inputs, starts, dout, dh)
    again = ms.mamba_scan_backward(*inputs, starts, dout, dh)
    torch.cuda.synchronize()
    assert ms.mamba_scan_backward.launches == before + 2
    want = ms.mamba_scan_bwd(*inputs, starts, dout, dh)
    tol = 2e-5 if dtype == "float32" else TOL["bfloat16"]
    names = ("d dt_raw", "d dt_bias", "db", "dc", "dx", "dz", "d a_log",
             "d d_skip")
    for name, g, a, w in zip(names, got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        close_to_max(g, w, tol, name)


# WKV6's backward kernel against wkv6_bwd from the same kept states: every
# head dim, S within a 256-step chunk and off the kernel's 16-step
# sub-chunks and 32-step kept states, with a ragged last chunk and across
# five, decays in the model's range or with exact 0s and 1s, dstate None
# or given; two batch rows, and one at hd 64 and 32
WKV_BWD_CASES = [(2, hd, s, decays, given)
                 for hd, s in ((16, 40), (32, 300), (64, 4 * 256 + 44))
                 for decays in ("inputs", "0 and 1")
                 for given in (False, True)] + [
    (1, 64, 300, "inputs", True), (1, 32, 4 * 256 + 44, "0 and 1", True)]


def wkv6_backward_inputs(cuda, b, s, h, hd, decays, seed):
    """r, k, v, w, u on the card from wkv_inputs, w with exact 0s and 1s
    mixed in if asked, and dy."""
    r, k, v, w, u = (torch.from_numpy(x) for x in
                     wkv_inputs((b, s, h, hd), seed))
    rng = np.random.default_rng(seed + 1)
    if decays == "0 and 1":
        pick = torch.from_numpy(rng.uniform(size=w.shape))
        w = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.9, 1.0, w))
    dy = torch.from_numpy(rng.standard_normal((b, s, h, hd))
                          .astype(np.float32))
    return [x.to(cuda) for x in (r, k, v, w, u)], dy.to(cuda)


@pytest.mark.parametrize("b,hd,s,decays,given", WKV_BWD_CASES)
def test_wkv6_backward_kernel_matches_plain(cuda, b, hd, s, decays, given):
    """The backward kernel against its plain version (``wkv6_bwd``) from
    the same kept states, dy and dstate: dr, dk, dv, dw, du in fp32 within
    2e-5 of each gradient's largest magnitude; one launch, and the same
    bits from a second run."""
    from repro_torch.kernels import wkv6 as wk
    inputs, dy = wkv6_backward_inputs(cuda, b, s, 3, hd, decays, hd + s)
    dstate = torch.randn((b, 3, hd, hd), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(s)) \
        if given else None
    _, _, starts = wk.wkv6_chunk_states(*inputs)
    before = wk.wkv6_backward.launches
    got = wk.wkv6_backward(*inputs, starts, dy, dstate)
    again = wk.wkv6_backward(*inputs, starts, dy, dstate)
    torch.cuda.synchronize()
    assert wk.wkv6_backward.launches == before + 2
    want = wk.wkv6_bwd(*inputs, starts, dy, dstate)
    for name, g, a, w in zip(("dr", "dk", "dv", "dw", "du"), got, again,
                             want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, a), name
        close_to_max(g, w, 2e-5, name)


# the trained models' attention, cut in batch and length: h2o-danube-1.8b's
# GQA 4x at hd 80 with its window equal to S (every causal pair visible),
# phi3-mini-3.8b's MHA at hd 96; (grp, hd, S, window)
BWD_MODEL_CASES = [(4, 80, 1000, 1000), (1, 96, 1000, None)]


@pytest.mark.parametrize("grp,hd,s,window", BWD_MODEL_CASES,
                         ids=["h2o-danube", "phi3"])
def test_flash_attention_backward_kernel_at_a_model_shape(cuda, grp, hd, s,
                                                          window):
    """bf16 at hd 80 and 96 runs the Hopper (wgmma, TMA) bodies, within
    TOL of the plain backward given the same out and lse, and within 2x
    the plain path's own error against the fp32 plain backward."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.backward_body(hd, torch.bfloat16) == "wgmma"
    q, k, v, dout = attention_train_inputs(cuda, grp, s, hd, "bfloat16",
                                           hd + s)
    out, lse = fa.flash_attention_train(q, k, v, window)
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, window)
    want = fa.flash_attention_bwd(q, k, v, dout, window, out=out, lse=lse)
    f32 = [t.float() for t in (q, k, v, dout)]
    out32, lse32 = fa.flash_attention_train_plain(*f32[:3], window)
    truth = fa.flash_attention_bwd(*f32, window, out=out32, lse=lse32)
    for name, g, w, t in zip(("dq", "dk", "dv"), grads, want, truth):
        close_to_max(g, w, TOL["bfloat16"], name)
        err = (g.float() - t).norm() / t.norm()
        assert err <= 2 * (w.float() - t).norm() / t.norm(), name


# the forward's Hopper body (128 query rows a block, two consumer
# warpgroups of 64): (B, S, H, Hkv, window) at every head dim; S not a
# multiple of 128 with a window edge inside a 128-row tile, hymba-1.5b's
# query group of 5 with its window, and a ragged S under 64 rows
FWD_BODY_CASES = [(2, 333, 4, 1, 100), (1, 700, 10, 2, 300),
                  (2, 45, 4, 4, None), (1, 1100, 8, 2, None)]


@pytest.mark.parametrize("b,s,h,hkv,window", FWD_BODY_CASES,
                         ids=["ragged-window", "group5-window", "short",
                              "gqa4-causal"])
@pytest.mark.parametrize("hd", BWD_HEAD_DIMS)
def test_flash_attention_forward_body_matches_plain(cuda, hd, b, s, h, hkv,
                                                    window):
    """bf16 runs the Hopper (wgmma, TMA) forward body at every head dim:
    out within TOL and each row's log-sum-exp within 2e-2 of
    ``flash_attention_train_plain`` (the scores' products sum in another
    order), the same bits from a second run, one launch each."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.forward_body(hd, torch.bfloat16) == "wgmma"
    rng = np.random.default_rng(hd + s + h)
    q, k, v = (torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(cuda, torch.bfloat16)
               for shape, scale in (((b, s, h, hd), 1.5),
                                    ((b, s, hkv, hd), 1.5),
                                    ((b, s, hkv, hd), 1.0)))
    before = fa.flash_attention.launches
    out, lse = fa.flash_attention_train(q, k, v, window)
    again, lse_again = fa.flash_attention_train(q, k, v, window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    want, want_lse = fa.flash_attention_train_plain(q, k, v, window)
    close(out, want, TOL["bfloat16"])
    close(lse, want_lse, 2e-2)


def test_flash_attention_backward_at_pixtrals_heads(cuda):
    """pixtral-12b's attention (32/8 heads of 160), S = 1000 ragged against
    the 32-row streamed tiles and the 64-row kept ones: bf16 on the Hopper
    bodies within TOL of the plain backward given the same out and lse,
    within 2x the plain path's own error against the fp32 plain backward,
    and the same bits from a second run."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(160)
    q, k, v, dout = (torch.from_numpy((rng.standard_normal(shape) * scale)
                                      .astype(np.float32)).to(
                                          cuda, torch.bfloat16)
                     for shape, scale in (((1, 1000, 32, 160), 1.0),
                                          ((1, 1000, 8, 160), 1.0),
                                          ((1, 1000, 8, 160), 0.5),
                                          ((1, 1000, 32, 160), 1.0)))
    out, lse = fa.flash_attention_train(q, k, v)
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout)
    again = fa.flash_attention_backward(q, k, v, out, lse, dout)
    want = fa.flash_attention_bwd(q, k, v, dout, out=out, lse=lse)
    f32 = [t.float() for t in (q, k, v, dout)]
    out32, lse32 = fa.flash_attention_train_plain(*f32[:3])
    truth = fa.flash_attention_bwd(*f32, out=out32, lse=lse32)
    for name, g, a, w, t in zip(("dq", "dk", "dv"), grads, again, want,
                                truth):
        assert torch.equal(g, a), name
        close_to_max(g, w, TOL["bfloat16"], name)
        err = (g.float() - t).norm() / t.norm()
        assert err <= 2 * (w.float() - t).norm() / t.norm(), name


@pytest.mark.parametrize("hd", BWD_HEAD_DIMS)
def test_flash_attention_backward_gives_the_same_bits_twice(cuda, hd):
    """The attention backward sums in a fixed order: two runs on the same
    inputs give the same bits (bf16, GQA 4x, a window), on the Hopper
    (wgmma, TMA) bodies at every head dim (fp32 runs the CUDA-core ones)."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.backward_body(hd, torch.bfloat16) == "wgmma"
    assert fa.backward_body(hd, torch.float32) == "cuda cores"
    q, k, v, dout = attention_train_inputs(cuda, 4, 700, hd, "bfloat16", hd)
    out, lse = fa.flash_attention_train(q, k, v, 300)
    first = fa.flash_attention_backward(q, k, v, out, lse, dout, 300)
    second = fa.flash_attention_backward(q, k, v, out, lse, dout, 300)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_backward_kernels_raise_rather_than_falling_back(cuda):
    """CUDA tensors the backward kernels do not take raise and launch
    nothing: a head dim outside HEAD_DIMS, Sq != Sk; a state width outside
    STATE_DIMS, di not a multiple of 8, a chunk that is not a multiple of
    the kernel's tile; WKV6 at hd 48, in fp64, with a chunk that is not a
    multiple of its 32-step kept states."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    q, k, v, dout = attention_train_inputs(cuda, 2, 70, 48, "bfloat16", 0)
    lse = torch.zeros((2, 4, 70), device=cuda)
    before = fa.flash_attention_backward.launches
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, k, v, q, lse, dout)
    q, k, v, dout = attention_train_inputs(cuda, 2, 70, 64, "bfloat16", 0)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.flash_attention_backward(q, k[:, :40], v[:, :40], q, lse, dout)
    assert fa.flash_attention_backward.launches == before
    before = ms.mamba_scan_backward.launches
    for n, di, chunk in ((4, 48, 256), (8, 12, 256), (8, 48, 100)):
        *inputs, _ = mamba_on(cuda, 2, 70, di, n, 3, "bfloat16",
                              carried=False)
        starts = torch.zeros((2, -(-70 // chunk), di, n), device=cuda)
        with pytest.raises(ValueError):
            ms.mamba_scan_backward(*inputs, starts, inputs[4], None, chunk)
    assert ms.mamba_scan_backward.launches == before
    before = wk.wkv6_backward.launches
    for hd, dtype, chunk in ((48, torch.float32, 256),
                             (64, torch.float64, 256),
                             (64, torch.float32, 100)):
        inputs, dy = wkv6_backward_inputs(cuda, 2, 70, 2, hd, "inputs", 0)
        inputs, dy = [x.to(dtype) for x in inputs], dy.to(dtype)
        starts = torch.zeros((2, -(-70 // chunk), 2, hd, hd), device=cuda,
                             dtype=dtype)
        with pytest.raises(ValueError):
            wk.wkv6_backward(*inputs, starts, dy, None, chunk)
    assert wk.wkv6_backward.launches == before


@pytest.mark.parametrize("name", ["flash_attention_train",
                                  "flash_attention_backward",
                                  "wkv6_backward",
                                  "mamba_scan_backward"])
def test_training_operators_pass_opcheck(cuda, name):
    """``torch.library.opcheck`` of the training forward's and the backward
    kernels' operators on card inputs: schema, fake implementation
    against the CUDA one, dispatch."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    if name.startswith("flash"):
        q, k, v, dout = attention_train_inputs(cuda, 4, 200, 64, "bfloat16",
                                               1)
        if name == "flash_attention_train":
            op, args = fa.flash_attention_train_op, (q, k, v, 64)
        else:
            out, lse = fa.flash_attention_train(q, k, v, 64)
            op, args = fa.flash_attention_backward_op, (q, k, v, out, lse,
                                                        dout, 64)
    elif name == "wkv6_backward":
        from repro_torch.kernels import wkv6 as wk
        inputs, dy = wkv6_backward_inputs(cuda, 2, 300, 2, 64, "inputs", 2)
        starts = wk.wkv6_chunk_states(*inputs)[2]
        dstate = torch.randn((2, 2, 64, 64), device=cuda,
                             generator=torch.Generator(cuda).manual_seed(0))
        op, args = wk.wkv6_backward_op, (*inputs, starts, dy, dstate, 256)
    else:
        *inputs, _ = mamba_on(cuda, 2, 300, 64, 16, 4, "bfloat16",
                              carried=False)
        starts = ms.mamba_chunk_states(*inputs)[2]
        dh = torch.randn((2, 64, 16), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(0))
        op, args = ms.mamba_scan_backward_op, (*inputs, starts, inputs[4],
                                               dh, 256)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, arch, dtype):
    """One MoE layer at the arch's own experts and top-k (narrow widths,
    the configs' capacity factor 1.25, so rows are dropped) on the card
    against the same layer on the CPU: the same expert choices, then the
    same output (the products sum in other orders; bf16: 2e-2 of the
    largest magnitude)."""
    base = ARCHS[arch]
    cfg = dataclasses.replace(base.reduced(), n_experts=base.n_experts,
                              experts_per_token=base.experts_per_token,
                              capacity_factor=1.25, n_layers=1,
                              param_dtype=dtype)
    td = getattr(torch, dtype)
    p = {k: v[0] if torch.is_tensor(v) else {n: w[0] for n, w in v.items()}
         for k, v in moe.init_moe(torch.Generator().manual_seed(0), cfg,
                                  td).items()}
    x = torch.randn((96, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(td)
    on_card = {k: v.to(cuda) if torch.is_tensor(v) else
               {n: w.to(cuda) for n, w in v.items()} for k, v in p.items()}
    assert torch.equal(moe.route(on_card, x.to(cuda), cfg)[1].cpu(),
                       moe.route(p, x, cfg)[1])
    out, aux = moe.apply_moe(on_card, x.to(cuda), cfg)
    want, want_aux = moe.apply_moe(p, x, cfg)
    torch.cuda.synchronize()
    close(aux, want_aux, 1e-5)
    tol = TOL[dtype] * (want.float().abs().max().item()
                        if dtype == "bfloat16" else 1.0)
    close(out, want, tol)


# ------------------------------------------------------------ under a mesh
@pytest.fixture
def mesh11(cuda):
    """A (1, 1) (data, model) mesh on an NCCL process group of one rank,
    the sharding context set from it; torn down after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import ctx
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device="cuda")
        ctx.set_axes(*ctx.axes_from_mesh(mesh))
        yield mesh
    finally:
        ctx.clear()
        dist.destroy_process_group()


def placed(mesh, t, spec):
    from repro_torch.sharding.rules import shard_tree
    return shard_tree({"t": t}, {"t": spec}, mesh)["t"]


@pytest.mark.parametrize("s", [1, 40])
def test_wkv6_launches_on_local_shards(mesh11, s):
    """``ops.wkv6`` on DTensors (heads on model) launches the kernel on the
    local shards, the token body (S=1) or the chunked one, from a state
    laid out as ``cache_specs`` lays out WKV's (on its key rows): the
    final state lands in it, and y and the state equal the unsharded
    kernel's. On this (1, 1) mesh the kernel writes the cache's own local
    tensor, so the write-back from ``local_map``'s temporary is not
    exercised: the 2 x 2 gloo tests and their mutant hold it. Under
    autograd the call runs ``Wkv6Fn`` in the same map, one training
    forward call."""
    r, k, v, w, u = wkv_on("cuda", (2, s, 4, 64), 11)
    state = torch.randn((2, 4, 64, 64), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(2))
    want_state = state.clone()
    want, _ = ops.wkv6(r, k, v, w, u, want_state)
    seq = ("data", None, "model", None)
    args = [placed(mesh11, t, seq) for t in (r, k, v, w)]
    cache = placed(mesh11, state.clone(), seq)
    laid_out = tuple(cache.placements)
    before = wkv6.launches
    with torch.no_grad():
        y, final = ops.wkv6(*args, placed(mesh11, u, ("model", None)), cache)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    assert final is cache and tuple(cache.placements) == laid_out
    close_wkv(y.to_local(), want)
    close_wkv(cache.to_local(), want_state)
    leaves = [a.detach().requires_grad_() for a in args]
    before = wkv6.launches
    y, _ = ops.wkv6(*leaves, placed(mesh11, u, ("model", None)))
    assert wkv6.launches == before + 1
    y.to_local().sum().backward()
    assert all(torch.isfinite(t.grad.to_local()).all() for t in leaves)


@pytest.mark.parametrize("s", [1, 100])
def test_mamba_scan_launches_on_local_shards(mesh11, s):
    """``ops.mamba_scan`` on DTensors (channels on model) launches the
    kernel on the local shards, its token body (S=1) or chunked one, from
    a state laid out as ``cache_specs`` lays out Mamba's (on n): the final
    state lands in it, and out and the state equal the unsharded kernel's.
    On this (1, 1) mesh the kernel writes the cache's own local tensor, so
    the write-back from ``local_map``'s temporary is not exercised: the
    2 x 2 gloo tests and their mutant hold it. Under autograd
    ``MambaScanFn`` runs in the same map."""
    *inputs, h = mamba_on("cuda", 2, s, 64, 16, 5, "float32")
    want_state = h.clone()
    want, _ = ops.mamba_scan(*inputs, want_state)
    specs = [("data", None, "model"), ("model",), ("data", None, None),
             ("data", None, None), ("data", None, "model"),
             ("data", None, "model"), ("model", None), ("model",)]
    args = [placed(mesh11, t, sp) for t, sp in zip(inputs, specs)]
    cache = placed(mesh11, h.clone(), ("data", None, "model"))
    before = mamba_scan.launches, mamba_scan.token_launches
    with torch.no_grad():
        out, final = ops.mamba_scan(*args, cache)
    torch.cuda.synchronize()
    assert (mamba_scan.launches, mamba_scan.token_launches) == \
        (before[0] + 1, before[1] + (s < time_tile()))
    assert final is cache
    close(out.to_local(), want, 2e-5)
    close(cache.to_local(), want_state, 2e-5)
    leaves = [a.detach().requires_grad_() if a.is_floating_point() else a
              for a in args]
    before = mamba_scan.launches
    out, _ = ops.mamba_scan(*leaves)
    assert mamba_scan.launches == before + 1
    out.to_local().sum().backward()
    assert all(torch.isfinite(t.grad.to_local()).all() for t in leaves)


@pytest.mark.parametrize("name", ["wkv6", "mamba_scan"])
def test_train_forwards_on_local_shards(mesh11, name):
    """The training forwards under a mesh: ``ops`` on DTensors with an
    input that requires grad runs the Function inside ``local_map``, one
    training call on the local shards, and its output (y or out) and
    final state equal the unsharded training forward's bit for bit."""
    seq = ("data", None, "model", None)
    if name == "wkv6":
        from repro_torch.kernels.wkv6 import wkv6_chunk_states as states
        r, k, v, w, u = wkv_on("cuda", (2, 300, 4, 64), 12)
        plain = (r, k, v, w, u)
        args = [placed(mesh11, t, seq) for t in (r, k, v, w)] + [
            placed(mesh11, u, ("model", None))]
        counter, op = wkv6, ops.wkv6
    else:
        from repro_torch.kernels.mamba_scan import mamba_chunk_states \
            as states
        *plain, _ = mamba_on("cuda", 2, 300, 64, 16, 6, "float32",
                             carried=False)
        specs = [("data", None, "model"), ("model",), ("data", None, None),
                 ("data", None, None), ("data", None, "model"),
                 ("data", None, "model"), ("model", None), ("model",)]
        args = [placed(mesh11, t, sp) for t, sp in zip(plain, specs)]
        counter, op = mamba_scan, ops.mamba_scan
    want, want_final, _ = states(*plain)
    leaves = [a.detach().requires_grad_() for a in args]
    before = counter.launches
    got, final = op(*leaves)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert torch.equal(got.to_local(), want)
    assert torch.equal(final.to_local(), want_final)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "wkv6", "mamba_scan", "wkv6_train",
                                  "mamba_scan_train"])
def test_kernel_operators_pass_opcheck(cuda, name):
    """``torch.library.opcheck`` of each kernel's operator on card inputs:
    its schema (the recurrences' states mutated in place), its fake
    implementation against the CUDA one, and its dispatch."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    gen = torch.Generator(cuda).manual_seed(0)

    def rand(*shape, dtype=torch.float32, low=-1.0, high=1.0):
        t = torch.rand(shape, generator=gen, device=cuda)
        return (low + (high - low) * t).to(dtype)

    bf16 = torch.bfloat16
    if name == "flash_attention":
        k = rand(2, 200, 2, 64, dtype=bf16)
        op, args = fa.flash_attention_op, (rand(2, 200, 4, 64, dtype=bf16),
                                           k, k, 64)
    elif name == "decode_attention":
        k = rand(2, 300, 2, 128, dtype=bf16)
        op, args = da.decode_attention_op, (
            rand(2, 2, 4, 128, dtype=bf16), k, k,
            torch.tensor([120, 300], dtype=torch.int32, device=cuda))
    elif name == "wkv6":
        r = rand(2, 40, 3, 64)
        op, args = wk.wkv6_op, (r, r, r, rand(2, 40, 3, 64, low=0.9,
                                               high=0.999),
                                rand(3, 64), rand(2, 3, 64, 64), True)
    elif name == "wkv6_train":
        r = rand(2, 300, 3, 64)
        op, args = wk.wkv6_train_op, (r, r, r, rand(2, 300, 3, 64, low=0.9,
                                                     high=0.999),
                                      rand(3, 64), 256)
    elif name == "mamba_scan_train":
        dt, bc = rand(2, 300, 64, dtype=bf16), rand(2, 300, 32, dtype=bf16)
        vec = rand(64)
        op, args = ms.mamba_scan_train_op, (
            dt, vec, bc[..., :16], bc[..., 16:], dt, dt,
            rand(64, 16, low=0.0), vec, 256)
    else:
        dt, bc = rand(2, 70, 64, dtype=bf16), rand(2, 70, 32, dtype=bf16)
        vec = rand(64)
        op, args = ms.mamba_scan_op, (dt, vec, bc[..., :16], bc[..., 16:],
                                      dt, dt, rand(64, 16, low=0.0),
                                      vec, rand(2, 64, 16), True)
    torch.library.opcheck(op, args)
