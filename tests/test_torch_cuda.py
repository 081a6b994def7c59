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
# forward one launch per 256-step chunk), S within one chunk, with a ragged
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
    assert wkv6.launches == before + -(-s // 256)


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
    assert mamba_scan.launches == before + -(-s // 256)


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
    autograd the call runs ``Wkv6Fn`` in the same map and launches per
    chunk."""
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
    y.to_local().sum().backward()
    assert wkv6.launches > before
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
    out.to_local().sum().backward()
    assert mamba_scan.launches > before
    assert all(torch.isfinite(t.grad.to_local()).all() for t in leaves)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention",
                                  "wkv6", "mamba_scan"])
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
    else:
        dt, bc = rand(2, 70, 64, dtype=bf16), rand(2, 70, 32, dtype=bf16)
        vec = rand(64)
        op, args = ms.mamba_scan_op, (dt, vec, bc[..., :16], bc[..., 16:],
                                      dt, dt, rand(64, 16, low=0.0),
                                      vec, rand(2, 64, 16), True)
    torch.library.opcheck(op, args)
