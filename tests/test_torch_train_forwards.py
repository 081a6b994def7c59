"""The recurrences' training forwards, ``wkv6_chunk_states`` and
``mamba_chunk_states``, against the JAX package on the CPU.

Each keeps the state at every 256-step chunk's start, which the backward
reads. On the card each is one call (WKV6: every chunk's own state from
zeros, the carry over the chunks, every chunk's y from its start; the
scan: one launch that writes each chunk's start as it passes it); on the
CPU the plain version chunk by chunk. Here:

* every start against JAX's state after that chunk prefix, computed by
  ``chunked_time_scan`` as ``apply_rwkv_tmix`` and ``apply_mamba`` run it,
  at S = 300 and 4 x 256 + 44 (fp32, 2e-5 of the largest magnitude);
* the carry's algebra in fp64 on the plain versions, start_{c+1} = A_c o
  start_c + G_c with G_c the chunk run from zeros and A_c its decay of the
  start, with decays of exactly 0 and 1 mixed in (1e-12);
* the two operators on meta tensors: fake outputs, flop formulas (the
  recurrences' own) and ``train_reference_bytes``, and the roofline
  counter naming them as the forward kernels.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from _torch_cases import mamba_inputs, wkv_inputs
from repro.models import ssm as jssm
from repro_torch.kernels import mamba_scan as mamba_mod
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels._remat import TIME_CHUNK
from repro_torch.roofline import RooflineCounter

LENGTHS = [300, 4 * 256 + 44]
WKV = (2, 3, 16)                # B, H, hd
MAMBA = (2, 24, 8)              # B, di, n


def close_rel(got, want, tol, name=""):
    """|got - want| <= tol x max |want|, elementwise."""
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def wkv_case(s, seed):
    b, h, hd = WKV
    return wkv_inputs((b, s, h, hd), seed)


def jax_wkv_final(r, k, v, w, u):
    """JAX's state after the recurrence from zeros, as apply_rwkv_tmix runs
    it: chunked_time_scan of wkv_step over (S, B, H, hd)."""
    b, _, h, hd = r.shape
    seq = tuple(jnp.asarray(t.transpose(1, 0, 2, 3)) for t in (r, k, v, w))
    final, _ = jssm.chunked_time_scan(
        lambda st, x: jssm.wkv_step(st, x, jnp.asarray(u)),
        jnp.zeros((b, h, hd, hd), jnp.float32), seq)
    return np.asarray(final)


def mamba_case(s, seed):
    """The fused scan's float32 inputs (dt_raw, dt_bias, b, c, x, z, a_log,
    d_skip), from zeros."""
    bsz, di, n = MAMBA
    dt_raw, dt_bias, bc, x, zz, a_log, d_skip, _ = mamba_inputs(
        bsz, s, di, n, seed, carried=False)
    return (dt_raw, dt_bias, bc[..., :n], bc[..., n:], x, zz[..., di:],
            a_log, d_skip)


def jax_mamba_final(dt_raw, dt_bias, b, c, x, z, a_log, d_skip):
    """JAX's state after apply_mamba's scan from zeros (ssm.py:198-218):
    the softplus with the bias, then chunked_time_scan of its ``step``."""
    dt = jax.nn.softplus(jnp.asarray(dt_raw) + jnp.asarray(dt_bias))
    a = -jnp.exp(jnp.asarray(a_log))

    def step(h, t):
        dt_t, b_t, x_t = t
        h = jnp.exp(dt_t[..., None] * a[None]) * h \
            + (dt_t * x_t)[..., None] * b_t[:, None, :]
        return h, None

    seq = (dt.transpose(1, 0, 2), jnp.asarray(b).transpose(1, 0, 2),
           jnp.asarray(x).transpose(1, 0, 2))
    h0 = jnp.zeros((x.shape[0], x.shape[2], a_log.shape[1]), jnp.float32)
    final, _ = jssm.chunked_time_scan(step, h0, seq)
    return np.asarray(final)


@pytest.mark.parametrize("s", LENGTHS)
def test_wkv6_starts_are_jax_states_after_each_prefix(s):
    inputs = wkv_case(s, s)
    y, final, starts = wkv6_mod.wkv6_chunk_states(
        *(torch.from_numpy(t) for t in inputs))
    assert starts.shape == (WKV[0], -(-s // TIME_CHUNK), *WKV[1:], WKV[2])
    assert not starts[:, 0].any()
    for c in range(1, starts.shape[1]):
        t = c * TIME_CHUNK
        close_rel(starts[:, c], jax_wkv_final(
            *(x[:, :t] for x in inputs[:4]), inputs[4]), 2e-5,
            f"start of chunk {c}")
    close_rel(final, jax_wkv_final(*inputs), 2e-5, "final state")


@pytest.mark.parametrize("s", LENGTHS)
def test_mamba_starts_are_jax_states_after_each_prefix(s):
    inputs = mamba_case(s, s)
    seq = (0, 2, 3, 4, 5)
    out, final, starts = mamba_mod.mamba_chunk_states(
        *(torch.from_numpy(t) for t in inputs))
    assert starts.shape == (MAMBA[0], -(-s // TIME_CHUNK), *MAMBA[1:])
    assert not starts[:, 0].any()
    for c in range(1, starts.shape[1]):
        t = c * TIME_CHUNK
        prefix = [x[:, :t] if i in seq else x for i, x in enumerate(inputs)]
        close_rel(starts[:, c], jax_mamba_final(*prefix), 2e-5,
                  f"start of chunk {c}")
    close_rel(final, jax_mamba_final(*inputs), 2e-5, "final state")


def chunks(s):
    return [(c0, min(s, c0 + TIME_CHUNK)) for c0 in range(0, s, TIME_CHUNK)]


def test_wkv6_carry_algebra_fp64():
    """start_{c+1} = A_c o start_c + G_c exactly (fp64, 1e-12): A_c the
    product of the chunk's decays along each key row, G_c the plain loop
    over the chunk from zeros; decays of exactly 0 (the state wiped) and
    1 mixed in."""
    s = 4 * 256 + 44
    r, k, v, w, u = (torch.from_numpy(t).double() for t in wkv_case(s, 7))
    w[:, ::5, :, ::3] = 1.0
    w[:, 3::37] = 0.0
    _, final, starts = wkv6_mod.wkv6_chunk_states(r, k, v, w, u)
    assert starts.dtype == torch.float64
    ends = torch.cat([starts[:, 1:], final[:, None]], 1)
    for c, (c0, c1) in enumerate(chunks(s)):
        part = [t[:, c0:c1] for t in (r, k, v, w)]
        _, grow = wkv6_mod.wkv6_plain(*part, u)
        fade = part[3].prod(1)[..., None]
        close_rel(ends[:, c], (fade * starts[:, c] + grow).numpy(), 1e-12,
                  f"chunk {c}")


def test_mamba_carry_algebra_fp64():
    """start_{c+1} = A_c o start_c + G_c exactly (fp64, 1e-12): A_c =
    exp(a * the chunk's sum of dt), G_c the plain loop over the chunk from
    zeros; decays of exactly 1 (dt = 0) and 0 (dt * a below fp64's range)
    mixed in."""
    s = 4 * 256 + 44
    args = [torch.from_numpy(t).double() for t in mamba_case(s, 9)]
    args[0][:, ::7, ::3] = -1000.0      # softplus -> 0: a decay of 1
    args[0][:, 5::41] = 1000.0          # dt a ~ -1000 a: a decay of 0
    dt = F.softplus(args[0] + args[1])
    assert (dt == 0).any() and (torch.exp(dt[..., None] * -torch.exp(
        args[6])) == 0).any()
    _, final, starts = mamba_mod.mamba_chunk_states(*args)
    ends = torch.cat([starts[:, 1:], final[:, None]], 1)
    for c, (c0, c1) in enumerate(chunks(s)):
        part = [t[:, c0:c1] if i in (0, 2, 3, 4, 5) else t
                for i, t in enumerate(args)]
        _, grow = mamba_mod.mamba_scan_plain(*part)
        fade = torch.exp(dt[:, c0:c1].sum(1)[..., None]
                         * -torch.exp(args[6]))
        close_rel(ends[:, c], (fade * starts[:, c] + grow).numpy(), 1e-12,
                  f"chunk {c}")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("s", LENGTHS)
def test_train_operators_on_meta(s):
    """On meta tensors each training forward is its operator's fake: the
    shapes and dtypes the card's call returns, the recurrence's own flops
    (the function is ``wkv6``'s and ``mamba_scan``'s), and what JAX's plain
    body moves, its token loop and the kept states
    (``train_reference_bytes``); the roofline counter names each as its
    forward kernel."""
    b, h, hd = 2, 40, 64
    r, u = meta(b, s, h, hd), meta(h, hd)
    nc = -(-s // TIME_CHUNK)
    counter = RooflineCounter()
    with counter, FlopCounterMode(display=False) as flops:
        y, final, starts = wkv6_mod.wkv6_chunk_states(r, r, r, r, u)
    assert (y.shape, final.shape, starts.shape) == (
        r.shape, (b, h, hd, hd), (b, nc, h, hd, hd))
    assert y.dtype == final.dtype == starts.dtype == torch.float32
    assert flops.get_total_flops() == 5 * hd * hd * h * b * s
    assert wkv6_mod.train_reference_bytes(r, r, r, r, u, TIME_CHUNK) == \
        wkv6_mod.reference_bytes(r, r, r, r, u, None, False) \
        + 4 * nc * b * h * hd * hd
    assert counter.kernels["wkv6"]["calls"] == 1

    bsz, di, n = 4, 1600, 16
    dt, bc = meta(bsz, s, di, dtype=torch.bfloat16), \
        meta(bsz, s, n, dtype=torch.bfloat16)
    args = (dt, meta(di), bc, bc, dt, dt, meta(di, n), meta(di))
    counter = RooflineCounter()
    with counter, FlopCounterMode(display=False) as flops:
        out, final, starts = mamba_mod.mamba_chunk_states(*args)
    assert (out.shape, out.dtype) == (dt.shape, torch.bfloat16)
    assert (final.shape, starts.shape) == ((bsz, di, n), (bsz, nc, di, n))
    assert final.dtype == starts.dtype == torch.float32
    assert flops.get_total_flops() == (7 * n + 10) * di * bsz * s
    assert mamba_mod.train_reference_bytes(*args, TIME_CHUNK) == \
        mamba_mod.reference_bytes(*args, None, False) + 4 * nc * bsz * di * n
    assert counter.kernels["mamba_scan"]["calls"] == 1
    assert counter.flops_by_region == {
        "mamba_scan": (7 * n + 10) * di * bsz * s}


def test_train_operators_check_their_arguments():
    """The fakes refuse what the card's calls refuse: shapes that disagree
    and a chunk below 1."""
    r, u = meta(2, 300, 3, 16), meta(3, 16)
    with pytest.raises(ValueError):
        wkv6_mod.wkv6_chunk_states(r, r, meta(2, 300, 3, 8), r, u)
    with pytest.raises(ValueError):
        wkv6_mod.wkv6_train_op(r, r, r, r, u, 0)
    dt, bc = meta(2, 300, 24), meta(2, 300, 8)
    args = (dt, meta(24), bc, bc, dt, dt, meta(24, 8), meta(24))
    with pytest.raises(ValueError):
        mamba_mod.mamba_chunk_states(*args[:6], meta(24, 4), args[7])
    with pytest.raises(ValueError):
        mamba_mod.mamba_scan_train_op(*args, 0)
