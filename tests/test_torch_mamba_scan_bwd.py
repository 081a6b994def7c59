"""The fused Mamba scan's backward kernel (``csrc/mamba_scan_bwd.cu``) on
the CPU: its chunk-parallel decomposition transcribed in torch.

The kernel cannot run here, so ``decomposed`` below does what its kernels
do, step for step, in torch operations:

1. chunk: each 256-step chunk walked forward from its kept start state,
   tile by tile (64 steps): the state at every tile's start is kept, and
   the adjoint's composition over the chunk, E_start = F_c E_end + H_c,
   is built from each tile's own (P, Q) (its steps walked backwards from
   E = 0 by E_t = A_t (dy_t c_t + E_{t+1}), P the product of A) by H +=
   F Q, F *= P: neither needs the adjoint from later chunks;
2. carry: E_end(c-1) = F_c E_end(c) + H_c, from dh (zeros when absent);
3. grads: every chunk on its own, its tiles backwards from E_end(c), each
   tile from its kept start state: the states rebuilt, the steps walked
   backwards with G_t = dy_t c_t + E_{t+1}, w_t = G_t h_{t-1} A_t and each
   gradient's term, the elementwise epilogue (gating, skip, softplus) at
   the forward's rounding points; db and dc summed over the channels, and
   d a_log, d dt_bias, d d_skip per (batch row, chunk), then summed.

It is held to fp64 autograd through ``mamba_scan_plain`` (1e-10, the
algebra exactly) and to ``jax.vjp`` of JAX's ``chunked_time_scan`` around
``apply_mamba``'s ``step`` with its softplus, skip and gating (2e-5 of
each gradient's largest magnitude, fp32), at S = 40, 300 (a ragged last
chunk and tile) and 512 (two chunks), n = 8 and 16, dh zero and given,
dt_raw + dt_bias past the softplus threshold of 20 (``mamba_inputs``);
in bf16, at the model's rounding points, to ``mamba_scan_bwd`` (2e-2); and
the carry's E_end to a sequential adjoint walk over the whole sequence.
Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cases import mamba_inputs, rand
from repro.models import ssm as jssm
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels._remat import acc_dtype

TILE = 64           # the kernel's time tile
CHUNK = 256         # the steps between kept states
LENGTHS = [40, 300, 512]
NAMES = ("d dt_raw", "d dt_bias", "db", "dc", "dx", "dz", "d a_log",
         "d d_skip")


def case(s, n, seed, dtype=torch.float32):
    """(dt_raw, dt_bias, b, c, x, z, a_log, d_skip) at B=2, di=24, with
    the sequence tensors in ``dtype``, dout and a final-state gradient."""
    bsz, di = 2, 24
    dt_raw, dt_bias, bc, x, zz, a_log, d_skip, _ = mamba_inputs(
        bsz, s, di, n, seed, carried=False)
    rng = np.random.default_rng(seed + 1)
    seq = [torch.from_numpy(t).to(dtype) for t in
           (dt_raw, bc[..., :n], bc[..., n:], x, zz[..., di:])]
    par = [torch.from_numpy(t).to(acc_dtype(dtype)) for t in
           (dt_bias, a_log, d_skip)]
    inputs = [seq[0], par[0], seq[1], seq[2], seq[3], seq[4], par[1], par[2]]
    dout = torch.from_numpy(rand(rng, (bsz, s, di), 1.0)).to(dtype)
    dh = torch.from_numpy(rand(rng, (bsz, di, n), 1.0)).to(acc_dtype(dtype))
    return inputs, dout, dh


def converted(dt_raw, dt_bias, b, c, x, z, a_log, dout):
    """The tile's conversion: dt = softplus(dt_raw + dt_bias), u = dt x,
    dy = T(dout T(silu z)) in the recurrence's type; a, b, c."""
    acc = acc_dtype(x.dtype)
    dt = F.softplus(dt_raw.to(acc) + dt_bias)
    dy = (dout * F.silu(z)).to(acc)
    return dt, dt * x.to(acc), dy, -torch.exp(a_log), b.to(acc), c.to(acc)


def decay(dt, a, t):
    """A_t = exp(dt_t a), (B, di, n)."""
    return torch.exp(dt[:, t, :, None] * a)


def chunk_pass(dt, u, dy, a, b, c, starts, chunk):
    """Kernel 1: the state at every tile's start (B, ceil(S / TILE), di,
    n), and each chunk's composition F_c, H_c (B, chunks, di, n)."""
    bsz, s, di = dt.shape
    nc = starts.shape[1]
    tiles = dt.new_zeros((bsz, -(-s // TILE), di, a.shape[1]))
    fc = dt.new_ones((bsz, nc, di, a.shape[1]))
    hc = torch.zeros_like(fc)
    for ci in range(nc):
        h, f, q = starts[:, ci], fc[:, ci].clone(), hc[:, ci].clone()
        for t0 in range(ci * chunk, min(s, (ci + 1) * chunk), TILE):
            t1 = min(s, t0 + TILE)
            tiles[:, t0 // TILE] = h
            tp, tq = torch.ones_like(h), torch.zeros_like(h)
            for t in reversed(range(t0, t1)):
                big_a = decay(dt, a, t)
                tq = big_a * (dy[:, t, :, None] * c[:, t, None, :] + tq)
                tp = tp * big_a
            for t in range(t0, t1):
                h = decay(dt, a, t) * h + u[:, t, :, None] * b[:, t, None, :]
            q, f = q + f * tq, f * tp
        fc[:, ci], hc[:, ci] = f, q
    return tiles, fc, hc


def carry_pass(fc, hc, dh):
    """Kernel 2: the adjoint after each chunk's last step."""
    ends = torch.empty_like(hc)
    e = torch.zeros_like(hc[:, 0]) if dh is None else dh
    for ci in reversed(range(hc.shape[1])):
        ends[:, ci] = e
        e = fc[:, ci] * e + hc[:, ci]
    return ends


def rnd(v, dtype):
    """T: rounding to the model's dtype, back in the recurrence's."""
    return v.to(dtype).to(v.dtype)


def decomposed(dt_raw, dt_bias, b, c, x, z, a_log, d_skip, starts, dout,
               dh=None, chunk=CHUNK):
    """The kernel's gradients of (dt_raw, dt_bias, b, c, x, z, a_log,
    d_skip), transcribed."""
    bsz, s, di = dt_raw.shape
    dtype = x.dtype
    dt, u, dy, a, bf, cf = converted(dt_raw, dt_bias, b, c, x, z, a_log,
                                     dout)
    tiles, fc, hc = chunk_pass(dt, u, dy, a, bf, cf, starts, chunk)
    ends = carry_pass(fc, hc, dh)
    nc = starts.shape[1]
    y, aw, gb = (torch.zeros_like(dt) for _ in range(3))
    db, dc = torch.zeros_like(bf), torch.zeros_like(cf)
    p_alog = dt.new_zeros((bsz, nc, di, a.shape[1]))
    for ci in range(nc):
        e = ends[:, ci]
        first, last = ci * chunk, min(s, (ci + 1) * chunk)
        for t0 in reversed(range(first, last, TILE)):
            t1 = min(last, t0 + TILE)
            hs = [tiles[:, t0 // TILE]]
            for t in range(t0, t1):
                hs.append(decay(dt, a, t) * hs[-1]
                          + u[:, t, :, None] * bf[:, t, None, :])
                y[:, t] = (hs[-1] * cf[:, t, None, :]).sum(-1)
            for t in reversed(range(t0, t1)):
                big_a = decay(dt, a, t)
                g = dy[:, t, :, None] * cf[:, t, None, :] + e
                w = g * hs[t - t0] * big_a
                aw[:, t] = (w * a).sum(-1)
                p_alog[:, ci] += w * dt[:, t, :, None]
                gb[:, t] = (g * bf[:, t, None, :]).sum(-1)
                db[:, t] = (g * u[:, t, :, None]).sum(1)
                dc[:, t] = (dy[:, t, :, None] * hs[t - t0 + 1]).sum(1)
                e = big_a * g
    # the epilogue at the forward's rounding points
    acc = dt.dtype
    v = dt_raw.to(acc) + dt_bias
    x_f, z_f, o_f = x.to(acc), z.to(acc), dout.to(acc)
    gsz = rnd(o_f * rnd(y + d_skip * x_f, dtype), dtype)
    sig = torch.sigmoid(z_f)
    d_z = gsz * sig * (1 + z_f * (1 - sig))
    d_x = dy * d_skip + gb * dt
    d_dt = torch.where(v > 20, aw + gb * x_f,
                       (aw + gb * x_f) * torch.sigmoid(v))
    return (d_dt.to(dtype), d_dt.sum((0, 1)), db.to(dtype), dc.to(dtype),
            d_x.to(dtype), d_z.to(dtype), (p_alog * a).sum((0, 1)),
            (dy * x_f).sum((0, 1)))


def close_rel(got, want, tol, name=""):
    """|got - want| <= tol x max |want|, elementwise."""
    got = np.asarray(got.detach().double(), np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("s", LENGTHS)
def test_decomposition_matches_fp64_autograd(s, n, given):
    """The kernel's algebra, exactly: fp64 autograd through the plain
    loop, from dh zero or given, softplus past its threshold included."""
    inputs, dout, dh = case(s, n, s + n, torch.float64)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out, final = ms.mamba_scan_plain(*leaves)
    torch.autograd.backward((out, final), (dout, dh if given
                                           else torch.zeros_like(dh)))
    starts = ms.mamba_chunk_states(*inputs)[2]
    got = decomposed(*inputs, starts, dout, dh if given else None)
    for name, g, leaf in zip(NAMES, got, leaves):
        assert g.dtype == torch.float64 and g.shape == leaf.shape, name
        close_rel(g, leaf.grad.numpy(), 1e-10, name)


def jax_mamba(dt_raw, dt_bias, b, c, x, z, a_log, d_skip):
    """JAX's pieces of apply_mamba from dt_raw to the gated output
    (ssm.py:198-220): the softplus with the bias, its ``step`` scanned
    from zeros by chunked_time_scan, the skip and the gating."""
    dt = jax.nn.softplus(dt_raw.astype(jnp.float32) + dt_bias)
    a = -jnp.exp(a_log)
    x_f = x.astype(jnp.float32)

    def step(h, t):
        dt_t, b_tt, c_tt, x_t = t
        da = jnp.exp(dt_t[..., None] * a[None])
        h = da * h + (dt_t * x_t)[..., None] * b_tt[:, None, :]
        return h, jnp.einsum("bdn,bn->bd", h, c_tt)

    seq = tuple(t.transpose(1, 0, 2) for t in (
        dt, b.astype(jnp.float32), c.astype(jnp.float32), x_f))
    h0 = jnp.zeros((x.shape[0], x.shape[2], a_log.shape[1]), jnp.float32)
    final, ys = jssm.chunked_time_scan(step, h0, seq)
    y = ys.transpose(1, 0, 2) + d_skip * x_f
    return y.astype(x.dtype) * jax.nn.silu(z), final


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("s", LENGTHS)
def test_decomposition_matches_jax_vjp(s, n):
    inputs, dout, dh = case(s, n, 2 * s + n)
    _, vjp = jax.vjp(jax_mamba, *(jnp.asarray(t.numpy()) for t in inputs))
    want = vjp((jnp.asarray(dout.numpy()), jnp.asarray(dh.numpy())))
    starts = ms.mamba_chunk_states(*inputs)[2]
    got = decomposed(*inputs, starts, dout, dh)
    for name, g, w, t in zip(NAMES, got, want, inputs):
        assert g.dtype == t.dtype and g.shape == w.shape, name
        close_rel(g, w, 2e-5, name)


@pytest.mark.parametrize("s", LENGTHS)
def test_decomposition_in_bf16_matches_the_plain_backward(s):
    """At the model's bf16 rounding points (dy, the gated output's
    gradient, each (B, S, ...) gradient's store) the transcription gives
    the plain version's gradients (``mamba_scan_bwd``, autograd through
    the chunked form in bf16) within 2e-2 of each one's largest magnitude,
    the card's bf16 limit; each in the plain version's dtype."""
    inputs, dout, dh = case(s, 16, 3 * s, torch.bfloat16)
    starts = ms.mamba_chunk_states(*inputs)[2]
    want = ms.mamba_scan_bwd(*inputs, starts, dout, dh)
    got = decomposed(*inputs, starts, dout, dh)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        close_rel(g, w.float().numpy(), 2e-2, name)


@pytest.mark.parametrize("s", [300, 512])
def test_carry_gives_the_adjoint_at_each_chunk_end(s):
    """E_end(c) from the chunks' own compositions and the carry equals the
    adjoint walked step by step over the whole sequence from dh (fp64),
    and F_c is exp(a x the chunk's sum of dt)."""
    inputs, dout, dh = case(s, 8, s + 1, torch.float64)
    dt_raw, dt_bias, b, c, x, z, a_log, _ = inputs
    dt, u, dy, a, bf, cf = converted(dt_raw, dt_bias, b, c, x, z, a_log,
                                     dout)
    starts = ms.mamba_chunk_states(*inputs)[2]
    _, fc, hc = chunk_pass(dt, u, dy, a, bf, cf, starts, CHUNK)
    ends = carry_pass(fc, hc, dh)
    e = dh
    for t in reversed(range(s)):
        if (t + 1) % CHUNK == 0 or t == s - 1:
            close_rel(ends[:, t // CHUNK], e.numpy(), 1e-10, f"E_end at {t}")
        e = decay(dt, a, t) * (dy[:, t, :, None] * cf[:, t, None, :] + e)
    for ci in range(fc.shape[1]):
        span = dt[:, ci * CHUNK:(ci + 1) * CHUNK].sum(1)
        close_rel(fc[:, ci], torch.exp(span[..., None] * a).numpy(), 1e-10,
                  f"F_{ci}")
