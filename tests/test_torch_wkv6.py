"""The port's WKV6 recurrence and RWKV6 mixers against the JAX package on
the CPU. On the CPU ``ops.wkv6`` runs the kernel's plain version,
``wkv6_plain``; tests/test_torch_cuda.py holds the CUDA kernel against it
on the card.

Inputs are made with numpy from a seed and handed to both frameworks.
A test-only mirror of the CUDA kernel's chunked algebra (``chunked_wkv6``)
is held against JAX's Pallas kernel and its recurrence at chunk lengths
8, 16 and 32.
Tolerances: the recurrence atol 2e-5, rtol 1e-4, the limits that
tests/test_kernels.py holds JAX's own scan and Pallas kernel to; the mixers
fp32 1e-4, bf16 2e-2 of the tensor's largest magnitude (ROADMAP's model
limits: the frameworks round to bf16 at different points).
"""

import dataclasses
import types
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (WKV_CASES, rand, randomise_norms_and_biases,
                          wkv_inputs)
from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ref as jref
from repro.kernels.rwkv6 import wkv6_chunked
from repro.models import layers as jl
from repro.models import ssm as jssm
from repro.train.checkpoint import _flatten
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.kernels.wkv6 import wkv6, wkv6_plain
from repro_torch.models import layers as tl
from repro_torch.models import ssm

ATOL, RTOL = 2e-5, 1e-4


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def close_model(got, want, dtype: str):
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        atol = rtol = 1e-4
    else:
        atol, rtol = 2e-2 * np.abs(want).max(), 2e-2
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol, rtol=rtol)


def torch_of(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# ------------------------------------------------------------ recurrence
@pytest.mark.parametrize("bh,s,hd,chunk", WKV_CASES)
def test_wkv6_matches_pallas_and_oracle(bh, s, hd, chunk):
    arrays = wkv_inputs((bh, s, hd), bh * s + hd)
    pallas = wkv6_chunked(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                          interpret=True)
    oracle = jref.wkv6_ref(*(jnp.asarray(a) for a in arrays))
    out = ops.wkv6(*torch_of(*arrays))
    assert out.dtype == torch.float32 and out.shape == (bh, s, hd)
    close(out, pallas)
    close(out, oracle)
    close(ops.wkv6(*torch_of(*arrays), impl="reference"), oracle)


def test_wkv6_model_layout_equals_kernel_layout():
    """The model's (B, S, H, hd) layout gives what the JAX kernel's
    (BH, S, hd) layout gives, with u repeated over the batch."""
    b, s, h, hd = 2, 40, 3, 16
    r, k, v, w, u = torch_of(*wkv_inputs((b, s, h, hd), 11))
    y4, final = ops.wkv6(r, k, v, w, u)
    assert final.shape == (b, h, hd, hd) and final.dtype == torch.float32

    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, hd)
    y3 = ops.wkv6(flat(r), flat(k), flat(v), flat(w), u.repeat(b, 1))
    close(flat(y4), y3, 1e-6, 1e-6)


@pytest.mark.parametrize("hd", [16, 64])
def test_wkv6_state_carries_across_a_split(hd):
    """The whole sequence equals its first half, then its second half from
    the first half's final state."""
    r, k, v, w, u = torch_of(*wkv_inputs((2, 50, 2, hd), hd))
    y, final = ops.wkv6(r, k, v, w, u)
    y1, mid = ops.wkv6(r[:, :23], k[:, :23], v[:, :23], w[:, :23], u)
    y2, end = ops.wkv6(r[:, 23:], k[:, 23:], v[:, 23:], w[:, 23:], u,
                       mid.clone())
    close(torch.cat([y1, y2], dim=1), y.numpy())
    close(end, final.numpy())
    assert y[:, 40:].abs().max() > 1e-3


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 2, 15, 48])
def test_wkv6_matches_jax_time_scan_from_a_state(s, hd):
    """Against the model's own recurrence in JAX, ``chunked_time_scan`` of
    ``wkv_step``, from a nonzero state in the model layout: at every S
    the kernel's token body serves (1 to 15, below its chunked body's T)
    and past it, at each head dim the kernel takes."""
    b, h = 2, 3
    r, k, v, w, u = wkv_inputs((b, s, h, hd), s)
    state0 = rand(np.random.default_rng(s + 1), (b, h, hd, hd))
    seq = tuple(jnp.asarray(a).transpose(1, 0, 2, 3) for a in (r, k, v, w))
    jfinal, jys = jssm.chunked_time_scan(
        lambda st, x: jssm.wkv_step(st, x, jnp.asarray(u)),
        jnp.asarray(state0), seq, chunk=16)
    state = torch.from_numpy(state0.copy())
    y, final = ops.wkv6(*torch_of(r, k, v, w, u), state)
    assert final is state                      # written in place
    close(y, np.asarray(jys).transpose(1, 0, 2, 3))
    close(final, jfinal)


def test_wkv6_computes_in_fp32():
    r, k, v, w, u = torch_of(*wkv_inputs((1, 5, 2, 16), 3))
    y, final = ops.wkv6(r.bfloat16(), k, v, w, u)
    assert y.dtype == final.dtype == torch.float32
    want, _ = wkv6_plain(r.bfloat16().float(), k, v, w, u)
    assert torch.equal(y, want)


def test_wkv6_does_not_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: a meta tensor takes the
    kernel's operator (its fake implementation: y's and the state's
    shapes, no launch), and any device but the CPU, the card and meta
    raises."""
    r = torch.empty(1, 8, 2, 16, device="meta")
    u = torch.empty(2, 16, device="meta")
    y, state = wkv6(r, r, r, r, u)
    assert y.shape == r.shape and state.shape == (1, 2, 16, 16)
    with pytest.raises(ValueError, match="no kernel for mps"):
        wkv6(types.SimpleNamespace(device=torch.device("mps")), r, r, r, u)
    with pytest.raises(ValueError):
        ops.wkv6(r, r, r, r, u, impl="pallas")
    assert wkv6.launches == 0 and wkv6.token_launches == 0


# ------------------------------------------------- chunked algebra (CPU)
def chunked_wkv6(r, k, v, w, u, state, t):
    """A test-only mirror of the CUDA kernel's chunked algebra in fp32
    torch, model layout (B, S, H, hd), from ``state``; chunks of ``t``
    tokens, the last one ragged. Per chunk: D, E, A by running products,
    the pairwise M, then y = (r * D) S + M V and S <- diag(A) S +
    (k * E)^T V as three ``@`` products. Returns (y, final state)."""
    b, s, h, hd = r.shape
    cur = state.clone()
    ys = []
    for t0 in range(0, s, t):
        n = min(t, s - t0)
        rc, kc, vc, wc = (x[:, t0:t0 + n].transpose(1, 2)
                          for x in (r, k, v, w))            # (B, H, n, hd)
        d = torch.ones_like(wc)
        e = torch.ones_like(wc)
        for i in range(1, n):
            d[:, :, i] = d[:, :, i - 1] * wc[:, :, i - 1]
        for i in range(n - 2, -1, -1):
            e[:, :, i] = e[:, :, i + 1] * wc[:, :, i + 1]
        a = d[:, :, n - 1] * wc[:, :, n - 1]
        m = torch.zeros((b, h, n, n), dtype=torch.float32)
        for j in range(n):
            m[:, :, j, j] = (rc[:, :, j] * u * kc[:, :, j]).sum(-1)
            kp = kc[:, :, j].clone()
            for i in range(j + 1, n):
                m[:, :, i, j] = (rc[:, :, i] * kp).sum(-1)
                kp = kp * wc[:, :, i]
        ys.append(((rc * d) @ cur + m @ vc).transpose(1, 2))
        cur = a[..., None] * cur + (kc * e).transpose(-1, -2) @ vc
    return torch.cat(ys, dim=1), cur


@functools.cache
def pallas_wkv(case: int) -> tuple:
    """WKV_CASES[case]: its inputs, and y from the Pallas kernel (interpret
    mode) and from the token-by-token oracle."""
    bh, s, hd, chunk = WKV_CASES[case]
    arrays = wkv_inputs((bh, s, hd), bh * s + hd)
    jx = [jnp.asarray(a) for a in arrays]
    return (arrays, np.asarray(wkv6_chunked(*jx, chunk=chunk, interpret=True)),
            np.asarray(jref.wkv6_ref(*jx)))


@pytest.mark.parametrize("t", [8, 16, 32])
@pytest.mark.parametrize("case", range(len(WKV_CASES)))
def test_chunked_algebra_matches_pallas_and_oracle(case, t):
    """The JAX kernel's (BH, S, hd) rows as heads of one batch row, from
    a zero state."""
    arrays, pallas, oracle = pallas_wkv(case)
    r, k, v, w, u = (torch.from_numpy(a) for a in arrays)
    bh, s, hd = r.shape
    y, _ = chunked_wkv6(*(x.transpose(0, 1)[None] for x in (r, k, v, w)), u,
                        torch.zeros((1, bh, hd, hd)), t)
    close(y[0].transpose(0, 1), pallas)
    close(y[0].transpose(0, 1), oracle)


def chunk_case(name: str, t: int) -> tuple:
    """(S, decays) of a named case: the chunk edges with wkv_inputs'
    decays, or S = 100 (ragged for every t) with the model's decays or
    with exact 0s and 1s."""
    return {"S=T-1": (t - 1, "inputs"), "S=T+1": (t + 1, "inputs"),
            "S=1000": (1000, "inputs"), "decays 0.99-0.9999": (100, "model"),
            "exact 0 and 1 decays": (100, "0 and 1")}[name]


def decays_of(kind: str, w: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "model":
        return rng.uniform(0.99, 0.9999, w.shape).astype(np.float32)
    if kind == "0 and 1":
        pick = rng.uniform(size=w.shape)
        return np.where(pick < 0.05, 0.0, np.where(pick > 0.9, 1.0, w)
                        ).astype(np.float32)
    return w


@pytest.mark.parametrize("t", [8, 16, 32])
@pytest.mark.parametrize("name", ["S=T-1", "S=T+1", "S=1000",
                                  "decays 0.99-0.9999",
                                  "exact 0 and 1 decays"])
def test_chunked_algebra_matches_jax_time_scan(name, t):
    """From a nonzero state, against the model's own recurrence in JAX,
    ``chunked_time_scan`` of ``wkv_step``."""
    s, kind = chunk_case(name, t)
    b, h, hd = 2, 3, 16
    r, k, v, w, u = wkv_inputs((b, s, h, hd), s + t)
    w = decays_of(kind, w, s + t)
    state0 = rand(np.random.default_rng(s + t + 1), (b, h, hd, hd), 1.0)
    seq = tuple(jnp.asarray(a).transpose(1, 0, 2, 3) for a in (r, k, v, w))
    jfinal, jys = jssm.chunked_time_scan(
        lambda st, x: jssm.wkv_step(st, x, jnp.asarray(u)),
        jnp.asarray(state0), seq, chunk=16)
    y, final = chunked_wkv6(*torch_of(r, k, v, w, u),
                            torch.from_numpy(state0), t)
    close(y, np.asarray(jys).transpose(1, 0, 2, 3))
    close(final, jfinal)


# ---------------------------------------------------------------- mixers
def test_group_norm_heads_matches():
    rng = np.random.default_rng(0)
    x, w, b = rand(rng, (2, 5, 4, 16), 3.0), rand(rng, (16,)) + 1.0, \
        rand(rng, (16,))
    for dtype in ("float32", "bfloat16"):
        got = tl.group_norm_heads(torch.from_numpy(x).to(getattr(torch, dtype)),
                                  *torch_of(w, b))
        want = jl.group_norm_heads(jnp.asarray(x, getattr(jnp, dtype)),
                                   jnp.asarray(w), jnp.asarray(b))
        assert str(got.dtype) == f"torch.{want.dtype}"
        close_model(got, want, dtype)


def rwkv_config(dtype: str, d_model: int = 64, head_dim: int = 16):
    """(JAX config, port config): reduced rwkv6-3b in ``dtype``."""
    return tuple(dataclasses.replace(a["rwkv6-3b"].reduced(),
                                     param_dtype=dtype, d_model=d_model,
                                     rwkv_head_dim=head_dim)
                 for a in (JAX_ARCHS, ARCHS))


def bridge(name: str, jp: dict, cfg) -> dict:
    return params_from_numpy(_flatten({name: jp}), cfg, "cpu")[name]


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_tmix_matches_jax(dtype, carried):
    """Fresh (prefill) and from a carried shift and WKV state (decode)."""
    jcfg, cfg = rwkv_config(dtype, d_model=128, head_dim=32)
    rng = np.random.default_rng(7)
    jp = randomise_norms_and_biases(jssm.init_rwkv_tmix(
        jax.random.PRNGKey(0), jcfg, getattr(jnp, dtype)), 17)
    p = bridge("tmix", jp, cfg)
    x = rand(rng, (2, 9, 128), 1.0)
    state = None
    if carried:
        state = {"shift": rand(rng, (2, 128), 1.0),
                 "wkv": rand(rng, (2, 4, 32, 32), 2.0)}
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jstate = None if state is None else {
        "shift": jnp.asarray(state["shift"], getattr(jnp, dtype)),
        "wkv": jnp.asarray(state["wkv"])}
    jout, jnew = jssm.apply_rwkv_tmix(jp, jx, jcfg, jstate)
    tstate = None if state is None else {
        "shift": torch.from_numpy(state["shift"]).to(getattr(torch, dtype)),
        "wkv": torch.from_numpy(state["wkv"].copy())}
    out, new = ssm.apply_rwkv_tmix(p, torch.from_numpy(x).to(
        getattr(torch, dtype)), cfg, tstate)
    assert out.dtype == getattr(torch, dtype)
    close_model(out, jout, dtype)
    close_model(new["shift"], jnew["shift"], dtype)
    close_model(new["wkv"], jnew["wkv"], "float32" if dtype == "float32"
                else dtype)
    if carried:
        assert new["wkv"] is tstate["wkv"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_cmix_matches_jax(dtype):
    jcfg, cfg = rwkv_config(dtype)
    rng = np.random.default_rng(8)
    jp = randomise_norms_and_biases(jssm.init_rwkv_cmix(
        jax.random.PRNGKey(1), jcfg, getattr(jnp, dtype)), 18)
    p = bridge("cmix", jp, cfg)
    x, prev = rand(rng, (2, 6, 64), 1.0), rand(rng, (2, 64), 1.0)
    for state in (None, prev):
        jout, jlast = jssm.apply_rwkv_cmix(
            jp, jnp.asarray(x, getattr(jnp, dtype)), jcfg,
            None if state is None else jnp.asarray(state, getattr(jnp, dtype)))
        out, last = ssm.apply_rwkv_cmix(
            p, torch.from_numpy(x).to(getattr(torch, dtype)), cfg,
            None if state is None else
            torch.from_numpy(state).to(getattr(torch, dtype)))
        close_model(out, jout, dtype)
        close_model(last, jlast, dtype)
