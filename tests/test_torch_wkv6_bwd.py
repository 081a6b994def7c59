"""WKV6's backward kernel (``csrc/wkv6_bwd.cu``) on the CPU: its
decomposition transcribed in torch, and its operator's routes.

The kernel cannot run here, so ``decomposed`` below does what its three
kernels do, step for step, in torch operations:

1. from each 256-step chunk's kept start state, the chunk walked forward
   in 16-step sub-chunks by the forward's update S <- A o S + (K o E)^T V
   (products, no token walk), the state kept at every 32-step pair's
   start, and the chunk's own part of the state's gradient at its start
   summed as products, G_c = sum over sub-chunks of (R o D o Dg)^T dY (Dg
   the product of w before the sub-chunk), with its fade A_c = prod_t w_t;
2. the carry, backwards over chunks: dS_end(c-1) = A_c o dS_end(c) + G_c;
3. each chunk's pairs of sub-chunks walked backwards from dS_end(c): the
   pair's second start state rebuilt from its kept one by one update,
   then the gradients of each sub-chunk from its start state S0 and its
   end's dS in the closed form of the kernel's header, with P(s, t) =
   prod_{s<tau<t} w_tau (no division), the last term of dw from W_t[s] =
   sum_{t'>t} P(t,t') r_t' Q[t'][s] carried down by its recurrence W_t =
   r_{t+1} Q[t+1] + w_{t+1} W_{t+1}, and dS <- A o dS + (R o D)^T dY.

It is held to fp64 autograd through the plain loop (1e-10, the algebra
exactly) and to ``jax.vjp`` of JAX's ``chunked_time_scan`` of
``wkv_step`` (2e-5 of each gradient's largest magnitude, fp32) at S = 40,
300 (a ragged last chunk, and a last pair of one sub-chunk) and 512 (two
chunks), from a nonzero gradient of the final state, with decays near 0,
exactly 0 and exactly 1; and the gradient through the model's underflowing
decay exp(-exp(x)) against the plain path's. Where w < the smallest normal
number the kernel's dw is 0, the plain version's convention. Inputs are
made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import rand, wkv_inputs
from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wk

SUB = 16            # the kernel's sub-chunk
KEEP = 32           # the state kept every pair of sub-chunks
LENGTHS = [40, 300, 512]


def heads_first(t, t0, t1):
    """Tokens [t0, t1) of a (B, S, H, hd) tensor as (B, H, n, hd)."""
    return t.transpose(1, 2)[:, :, t0:t1]


def sub_decays(w):
    """D_t = prod_{tau<t} w_tau, E_t = prod_{tau>t} w_tau (B, H, n, hd) and
    A = prod_tau w_tau (B, H, hd) of a sub-chunk, by running products."""
    n = w.shape[2]
    d, e = torch.ones_like(w), torch.ones_like(w)
    for t in range(1, n):
        d[:, :, t] = d[:, :, t - 1] * w[:, :, t - 1]
        e[:, :, n - 1 - t] = e[:, :, n - t] * w[:, :, n - t]
    return d, e, d[:, :, -1] * w[:, :, -1]


def update(state, k, v, w):
    """The forward's update over a sub-chunk: A o S + (K o E)^T V."""
    _, e, a = sub_decays(w)
    return a[..., None] * state + (k * e).transpose(-1, -2) @ v


def chunk_pass(r, k, v, w, dy, starts, chunk):
    """Kernel 1: per chunk, from its kept start, the state at each pair's
    start (B, ceil(S / KEEP), H, hd, hd), G_c and A_c, sub-chunk by
    sub-chunk in products."""
    b, s, h, hd = r.shape
    nc = starts.shape[1]
    ckpt = r.new_zeros((b, -(-s // KEEP), h, hd, hd))
    grow = r.new_zeros((b, nc, h, hd, hd))
    fade = r.new_ones((b, nc, h, hd))
    for c in range(nc):
        state, dg = starts[:, c].clone(), r.new_ones((b, h, hd))
        first, last = c * chunk, min(s, (c + 1) * chunk)
        for t0 in range(first, last, SUB):
            t1 = min(last, t0 + SUB)
            if t0 % KEEP == 0:
                ckpt[:, t0 // KEEP] = state
            rr, kk, vv, ww, gy = (heads_first(x, t0, t1)
                                  for x in (r, k, v, w, dy))
            d, _, a = sub_decays(ww)
            grow[:, c] += (rr * d * dg[:, :, None]).transpose(-1, -2) @ gy
            state = update(state, kk, vv, ww)
            dg = dg * a
        fade[:, c] = dg
    return ckpt, grow, fade


def carry_pass(grow, fade, dstate):
    """Kernel 2: the state's gradient at each chunk's end."""
    ends = torch.empty_like(grow)
    carry = torch.zeros_like(grow[:, 0]) if dstate is None else dstate
    for c in reversed(range(grow.shape[1])):
        ends[:, c] = carry
        carry = fade[:, c][..., None] * carry + grow[:, c]
    return ends


def sub_chunk_grads(r, k, v, w, dy, u, s0, ds):
    """Kernel 3 on one sub-chunk of n tokens, inputs (B, H, n, hd), from
    its start state s0 and its end's state gradient ds (B, H, hd, hd).
    Returns dr, dk, dv, dw (B, H, n, hd), du's part (H, hd) and the state
    gradient at the sub-chunk's start."""
    n = r.shape[2]
    q = dy @ v.transpose(-1, -2)                  # Q[t][s] = dy_t . v_s
    z = dy @ s0.transpose(-1, -2)                 # Z[t][i]
    x = v @ ds.transpose(-1, -2)                  # X[s][i]
    rowsum = (ds * s0).sum(-1)                    # q[i]
    # P[s, t] = prod_{s<tau<t} w_tau for s < t, by running products
    p = r.new_zeros((*r.shape[:2], n, n, r.shape[-1]))
    for a in range(n):
        run = torch.ones_like(r[:, :, 0])
        for t in range(a + 1, n):
            p[:, :, a, t] = run
            run = run * w[:, :, t]
    d, e, fade = sub_decays(w)
    diag = torch.diagonal(q, dim1=-2, dim2=-1)[..., None]
    uk, ur = u[None, :, None] * k, u[None, :, None] * r
    dr = d * z + torch.einsum("bhts,bhsi,bhsti->bhti", q, k, p) + uk * diag
    dk = e * x + torch.einsum("bhts,bhti,bhsti->bhsi", q, r, p) + ur * diag
    m = torch.einsum("bhti,bhsi,bhsti->bhts", r, k, p) \
        + torch.diag_embed((r * uk).sum(-1))
    dv = (k * e) @ ds + m.transpose(-1, -2) @ dy
    # the last term of dw: W_t[s] carried down from W_{n-1} = 0, then
    # sum_{s<t} P(s,t) k_s W_t[s] by a running product down from s = t - 1
    t4 = torch.zeros_like(r)
    big_w = r.new_zeros((*r.shape[:2], n, r.shape[-1]))    # W_t[s][i]
    for t in range(n - 2, -1, -1):
        big_w = r[:, :, t + 1, None] * q[:, :, t + 1, :, None] \
            + w[:, :, t + 1, None] * big_w
        run, acc = torch.ones_like(r[:, :, 0]), torch.zeros_like(r[:, :, 0])
        for s_ in range(t - 1, -1, -1):
            acc = acc + run * k[:, :, s_] * big_w[:, :, s_]
            run = run * w[:, :, s_]
        t4[:, :, t] = acc
    dw = d * e * rowsum[:, :, None] \
        + e * torch.einsum("bhsti,bhsi,bhsi->bhti", p, k, x) \
        + d * torch.einsum("bhtxi,bhxi,bhxi->bhti", p, r, z) + t4
    du = (r * k * diag).sum((0, 2))
    return dr, dk, dv, dw, du, fade[..., None] * ds + (r * d).transpose(
        -1, -2) @ dy


def decomposed(r, k, v, w, u, starts, dy, dstate=None, chunk=256):
    """The kernel's (dr, dk, dv, dw, du), transcribed."""
    b, s, h, hd = r.shape
    ckpt, grow, fade = chunk_pass(r, k, v, w, dy, starts, chunk)
    ends = carry_pass(grow, fade, dstate)
    grads = [torch.zeros_like(r) for _ in range(4)]
    du = torch.zeros_like(u)
    for c in range(starts.shape[1]):
        ds = ends[:, c]
        first, last = c * chunk, min(s, (c + 1) * chunk)
        for p0 in reversed(range(first, last, KEEP)):
            s0 = ckpt[:, p0 // KEEP]
            subs = [(p0, min(last, p0 + SUB), s0)]
            if p0 + SUB < last:     # the second start state, rebuilt
                part = (heads_first(t, p0, p0 + SUB) for t in (k, v, w))
                subs.append((p0 + SUB, min(last, p0 + KEEP),
                             update(s0, *part)))
            for t0, t1, st in reversed(subs):
                part = (heads_first(t, t0, t1) for t in (r, k, v, w, dy))
                *got, du_c, ds = sub_chunk_grads(*part, u, st, ds)
                for g, x in zip(grads, got):
                    g[:, t0:t1] = x.transpose(1, 2)
                du += du_c
    dw = torch.where(w < torch.finfo(w.dtype).tiny, 0.0, grads[3])
    return (*grads[:3], dw, du)


def case(s, seed, dtype=torch.float32):
    """r, k, v, w (2, S, 3, 16), u (3, 16), dy and the final state's
    gradient, from numpy."""
    b, h, hd = 2, 3, 16
    inputs = [torch.from_numpy(t).to(dtype)
              for t in wkv_inputs((b, s, h, hd), seed)]
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rand(rng, (b, s, h, hd), 1.0)).to(dtype)
    dstate = torch.from_numpy(rand(rng, (b, h, hd, hd), 1.0)).to(dtype)
    return inputs, dy, dstate


def close_rel(got, want, tol, name=""):
    """|got - want| <= tol x max |want|, elementwise."""
    got = np.asarray(got.detach().double(), np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("s", LENGTHS)
def test_decomposition_matches_fp64_autograd(s):
    """The kernel's algebra, exactly: decays near 0 (w^40), exactly 0 and
    exactly 1 among the model's range; a nonzero final-state gradient."""
    (r, k, v, w, u), dy, dstate = case(s, s + 3, torch.float64)
    w[:, ::5, :, ::3] = 1.0
    w[:, 1::7] = w[:, 1::7] ** 40
    w[:, 2::11, :, 1::4] = 0.0
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    torch.autograd.backward(wk.wkv6_plain(*leaves), (dy, dstate))
    starts = wk.wkv6_chunk_states(r, k, v, w, u)[2]
    got = decomposed(r, k, v, w, u, starts, dy, dstate)
    tiny = torch.finfo(torch.float64).tiny
    for name, g, leaf in zip(("dr", "dk", "dv", "dw", "du"), got, leaves):
        want = leaf.grad
        if name == "dw":
            want = torch.where(w < tiny, 0.0, want)
        assert g.dtype == torch.float64 and g.shape == want.shape
        close_rel(g, want.numpy(), 1e-10, name)


def jax_wkv(r, k, v, w, u):
    """JAX's recurrence as apply_rwkv_tmix runs it: chunked_time_scan of
    wkv_step from zeros over (S, B, H, hd)."""
    b, _, h, hd = r.shape
    seq = tuple(t.transpose(1, 0, 2, 3) for t in (r, k, v, w))
    final, ys = jssm.chunked_time_scan(
        lambda st, x: jssm.wkv_step(st, x, u),
        jnp.zeros((b, h, hd, hd), jnp.float32), seq)
    return ys.transpose(1, 0, 2, 3), final


@pytest.mark.parametrize("s", LENGTHS)
def test_decomposition_matches_jax_vjp(s):
    inputs, dy, dstate = case(s, s)
    _, vjp = jax.vjp(jax_wkv, *(jnp.asarray(t.numpy()) for t in inputs))
    want = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dstate.numpy())))
    starts = wk.wkv6_chunk_states(*inputs)[2]
    got = decomposed(*inputs, starts, dy, dstate)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        close_rel(g, w, 2e-5, name)


def test_decomposition_through_underflowing_decays():
    """The model's decay exp(-exp(x)) underflows to 0 in fp32 where exp(x)
    > ~104: the gradient that reaches x through the decomposition's dw
    (0 there) is the plain loop's, within 2e-5 (fp32)."""
    b, s, h, hd = 2, 300, 3, 16
    rng = np.random.default_rng(12)
    r, k, v = (torch.from_numpy(rand(rng, (b, s, h, hd))) for _ in range(3))
    x = torch.from_numpy(rand(rng, (b, s, h, hd), 2.0) - 5.0)
    x.view(-1)[::97] = 6.0
    u = torch.from_numpy(rand(rng, (h, hd)))
    dy = torch.from_numpy(rand(rng, (b, s, h, hd), 1.0))
    w = torch.exp(-torch.exp(x))
    assert int((w == 0).sum()) >= 100
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, x, u)]
    wl = torch.exp(-torch.exp(leaves[3]))
    wk.wkv6_plain(leaves[0], leaves[1], leaves[2], wl, leaves[4])[0] \
        .backward(dy)
    starts = wk.wkv6_chunk_states(r, k, v, w, u)[2]
    dr, dk, dv, dw, du = decomposed(r, k, v, w, u, starts, dy)
    dx = dw * (-w * torch.exp(x))
    for name, g, leaf in zip(("dr", "dk", "dv", "dx", "du"),
                             (dr, dk, dv, dx, du), leaves):
        close_rel(g, leaf.grad.numpy(), 2e-5, name)


# ------------------------------------------------------------- the operator
def meta_args(s=300, dstate=True):
    """wkv6_backward's arguments on meta at (2, S, 3, 64)."""
    b, h, hd = 2, 3, 64
    seq = [torch.empty((b, s, h, hd), device="meta") for _ in range(4)]
    u = torch.empty((h, hd), device="meta")
    starts = torch.empty((b, -(-s // 256), h, hd, hd), device="meta")
    dy = torch.empty((b, s, h, hd), device="meta")
    ds = torch.empty((b, h, hd, hd), device="meta") if dstate else None
    return [*seq, u, starts, dy, ds]


@pytest.mark.parametrize("dstate", [False, True])
def test_backward_fake_gives_the_gradients_shapes(dstate):
    args = meta_args(dstate=dstate)
    before = wk.wkv6_backward.launches
    grads = wk.wkv6_backward(*args)
    assert len(grads) == 5 and wk.wkv6_backward.launches == before
    for g, t in zip(grads, args[:5]):
        assert g.is_meta and (g.shape, g.dtype) == (t.shape, t.dtype)
    bad = meta_args()
    bad[5] = torch.empty((2, 1, 3, 64, 64), device="meta")
    with pytest.raises(ValueError, match="starts"):
        wk.wkv6_backward(*bad)


def test_backward_flop_formula_counts_the_vjp_and_the_recompute():
    """16 hd^2 a (token, head): the vjp of the token step (11) and the
    forward it recomputes (5)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        wk.wkv6_backward(*meta_args())
    assert counter.get_total_flops() == 16 * 64 * 64 * 3 * 2 * 300


def test_backward_wrapper_routes_by_device(monkeypatch):
    """A CPU tensor takes the plain version (through the module attribute,
    so a spy sees it); a device with no kernel raises; the CUDA route
    raises when its library does not load, and nothing falls back; no
    launch counts."""
    calls = []
    real = wk.wkv6_bwd
    monkeypatch.setattr(wk, "wkv6_bwd",
                        lambda *a: calls.append("wkv6") or real(*a))
    (r, k, v, w, u), dy, _ = case(40, 1)
    starts = wk.wkv6_chunk_states(r, k, v, w, u)[2]
    got = wk.wkv6_backward(r, k, v, w, u, starts, dy)
    assert calls == ["wkv6"] and len(got) == 5
    assert wk.wkv6_backward.launches == 0
    assert ops.KERNELS["wkv6_backward"] is wk.wkv6_backward
    other = dataclasses.make_dataclass("T", ["device"])(torch.device("mps"))
    with pytest.raises(ValueError, match="no kernel for mps"):
        wk.wkv6_backward(other, k, v, w, u, starts, dy)

    def no_library(name):
        raise RuntimeError(f"no {name} library")
    monkeypatch.setattr(wk._build, "load", no_library)
    wk._bwd_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no wkv6_bwd library"):
            wk._wkv6_backward_cuda(r, k, v, w, u, starts, dy, None, 256)
    finally:
        wk._bwd_lib.cache_clear()
    assert calls == ["wkv6"] and wk.wkv6_backward.launches == 0


def test_wkv6_fn_backward_goes_through_the_wrapper(monkeypatch):
    """``Wkv6Fn.backward`` calls ``wkv6_backward``: under autograd on the
    CPU the plain version runs once per backward."""
    calls = []
    real = wk.wkv6_backward
    monkeypatch.setattr(wk, "wkv6_backward",
                        lambda *a: calls.append(1) or real(*a))
    (r, k, v, w, u), dy, _ = case(40, 2)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    ops.wkv6(*leaves)[0].backward(dy)
    assert calls == [1] and all(t.grad is not None for t in leaves)
