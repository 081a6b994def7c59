"""The port's hybrid family (hymba: attention and Mamba heads side by side
in each layer) against the JAX package on the CPU.

On the CPU ``ops.mamba_scan`` runs the kernel's plain version,
``mamba_scan_plain``; tests/test_torch_cuda.py holds the CUDA kernel
against it on the card. Inputs are made with numpy from a seed and handed
to both frameworks; weights cross through ``bridge.params_from_numpy``,
with the Mamba biases and skip (init 0 and 1) randomised first.

Tolerances: the scan fp32 atol 2e-5, rtol 1e-4; the Mamba layer and the
model fp32 1e-4, bf16 2e-2 of the tensor's largest magnitude (the
frameworks round to bf16 at different points).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import (MAMBA_CASES, mamba_inputs, rand,
                          randomise_norms_and_biases)
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import decode_step as jdecode_step
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models import ssm as jssm
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import ServeConfig as JaxServeConfig
from repro.train.checkpoint import _flatten
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models import ssm
from repro_torch.serve.engine import Engine, ServeConfig, preallocate_cache

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


def configs(dtype: str, **changes):
    """(JAX config, port config): reduced hymba-1.5b (d_model 64, 4/2 heads
    of 16, so di = 64, n = 8, window 16) in ``dtype``."""
    return tuple(dataclasses.replace(a["hymba-1.5b"].reduced(),
                                     param_dtype=dtype, **changes)
                 for a in (JAX_ARCHS, ARCHS))


# ------------------------------------------------------------------ scan
def jax_scan(dt, b, c, x, a, h0):
    """The recurrence of ``repro.models.ssm.apply_mamba``: its ``step`` (a
    closure there, written out here as it stands) scanned over time by
    ``chunked_time_scan``, model layout."""
    a = jnp.asarray(a)

    def step(h, t):
        dt_t, b_tt, c_tt, x_t = t
        da = jnp.exp(dt_t[..., None] * a[None])
        h = da * h + (dt_t * x_t)[..., None] * b_tt[:, None, :]
        return h, jnp.einsum("bdn,bn->bd", h, c_tt)

    seq = tuple(jnp.asarray(t).transpose(1, 0, 2) for t in (dt, b, c, x))
    final, ys = jssm.chunked_time_scan(step, jnp.asarray(h0), seq)
    return np.asarray(ys).transpose(1, 0, 2), np.asarray(final)


@pytest.mark.parametrize("bsz,s,di,n,carried", MAMBA_CASES)
def test_mamba_scan_matches_jax_scan(bsz, s, di, n, carried):
    dt, bc, x, a, h = mamba_inputs(bsz, s, di, n, s + di, carried)
    h0 = h if carried else np.zeros((bsz, di, n), np.float32)
    want_y, want_h = jax_scan(dt, bc[..., :n], bc[..., n:], x, a, h0)
    tbc = torch.from_numpy(bc)
    state = None if h is None else torch.from_numpy(h.copy())
    y, final = ops.mamba_scan(torch.from_numpy(dt), tbc[..., :n],
                              tbc[..., n:], torch.from_numpy(x),
                              torch.from_numpy(a), state)
    assert y.dtype == final.dtype == torch.float32
    assert y.shape == (bsz, s, di) and final.shape == (bsz, di, n)
    if carried:
        assert final is state                  # written in place
    close(y, want_y)
    close(final, want_h)
    ref_y, _ = ops.mamba_scan(torch.from_numpy(dt), tbc[..., :n],
                              tbc[..., n:], torch.from_numpy(x),
                              torch.from_numpy(a),
                              None if h is None else torch.from_numpy(h),
                              impl="reference")
    assert torch.equal(ref_y, y)


def test_mamba_scan_state_carries_across_a_split():
    """The whole sequence equals its first part, then the rest from the
    first part's final state."""
    dt, bc, x, a, _ = (torch.from_numpy(t) if t is not None else None
                       for t in mamba_inputs(2, 50, 24, 8, 4, False))
    b, c = bc[..., :8], bc[..., 8:]
    y, final = ops.mamba_scan(dt, b, c, x, a)
    y1, mid = ops.mamba_scan(dt[:, :23], b[:, :23], c[:, :23], x[:, :23], a)
    y2, end = ops.mamba_scan(dt[:, 23:], b[:, 23:], c[:, 23:], x[:, 23:], a,
                             mid.clone())
    close(torch.cat([y1, y2], dim=1), y.numpy())
    close(end, final.numpy())
    assert y[:, 40:].abs().max() > 1e-3


def test_mamba_scan_reads_views_as_copies():
    """b and c as strided halves of one projection, and inputs in another
    dtype, give what contiguous fp32 copies give."""
    dt, bc, x, a, h = (torch.from_numpy(t) for t in
                       mamba_inputs(2, 9, 16, 8, 5))
    y, _ = ops.mamba_scan(dt, bc[..., :8], bc[..., 8:], x, a, h.clone())
    y2, _ = ops.mamba_scan(dt, bc[..., :8].contiguous(),
                           bc[..., 8:].contiguous(), x, a, h.clone())
    assert torch.equal(y, y2)
    y3, _ = ops.mamba_scan(dt, bc[..., :8], bc[..., 8:], x.bfloat16(), a,
                           h.clone())
    want, _ = mamba_scan_plain(dt, bc[..., :8], bc[..., 8:],
                               x.bfloat16().float(), a, h.clone())
    assert y3.dtype == torch.float32 and torch.equal(y3, want)


def test_mamba_scan_does_not_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: on another device the
    wrapper launches its kernel or raises."""
    t = torch.empty(1, 8, 16, device="meta")
    bc = torch.empty(1, 8, 16, device="meta")
    a = torch.empty(16, 8, device="meta")
    with pytest.raises(ValueError):
        mamba_scan(t, bc[..., :8], bc[..., 8:], t, a)
    with pytest.raises(ValueError):
        ops.mamba_scan(t, bc[..., :8], bc[..., 8:], t, a, impl="pallas")
    assert mamba_scan.launches == 0
    assert ops.KERNELS["mamba_scan"] is mamba_scan


# ----------------------------------------------------------------- layer
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype, with_state):
    rng = np.random.default_rng(6)
    x, w, b = rand(rng, (2, 7, 24), 1.0), rand(rng, (4, 24)), \
        rand(rng, (24,))
    state = rand(rng, (2, 3, 24), 1.0) if with_state else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jlast = jssm._causal_conv(
        *(jnp.asarray(v, jd) for v in (x, w, b)),
        None if state is None else jnp.asarray(state, jd))
    out, last = ssm._causal_conv(
        *(torch.from_numpy(v).to(td) for v in (x, w, b)),
        None if state is None else torch.from_numpy(state).to(td))
    assert out.dtype == last.dtype == td and last.shape == (2, 3, 24)
    close_model(out, jout, dtype)
    close_model(last, jlast, dtype)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_matches_jax(dtype, carried):
    """Over a sequence from zeros (prefill), and as one decode step from a
    carried conv and SSM state, which the port updates in place."""
    jcfg, cfg = configs(dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    di = cfg.n_heads * cfg.hd
    jp = randomise_norms_and_biases(
        jssm.init_mamba(jax.random.PRNGKey(0), jcfg, jd), 7)
    p = params_from_numpy(_flatten({"mamba": jp}), cfg, "cpu")["mamba"]
    assert p["a_log"].dtype == p["dt_bias"].dtype == p["d_skip"].dtype \
        == torch.float32 and p["conv_b"].dtype == td
    rng = np.random.default_rng(8)
    x = rand(rng, (2, 1 if carried else 11, cfg.d_model), 1.0)
    state = None
    if carried:
        state = {"conv": rand(rng, (2, 3, di), 1.0),
                 "h": rand(rng, (2, di, cfg.ssm_state), 1.0)}
    jout, jnew = jssm.apply_mamba(
        jp, jnp.asarray(x, jd), jcfg, None if state is None else
        {"conv": jnp.asarray(state["conv"], jd),
         "h": jnp.asarray(state["h"])})
    tstate = None if state is None else {
        "conv": torch.from_numpy(state["conv"]).to(td),
        "h": torch.from_numpy(state["h"].copy())}
    out, new = ssm.apply_mamba(p, torch.from_numpy(x).to(td), cfg, tstate)
    assert out.dtype == td and new["h"].dtype == torch.float32
    close_model(out, jout, dtype)
    close_model(new["conv"], jnew["conv"], dtype)
    close_model(new["h"], jnew["h"], dtype)
    if carried:
        assert new["conv"] is tstate["conv"] and new["h"] is tstate["h"]


# ----------------------------------------------------------------- model
HYBRID_CASES = ["float32", "bfloat16"]


@pytest.fixture(scope="module", params=HYBRID_CASES)
def hybrid_case(request):
    """Reduced hymba: JAX's prefill of 9 tokens, then 3 decode steps
    (inside the 16-token window), and the port's parameters bridged from
    the same weights."""
    dtype = request.param
    jcfg, cfg = configs(dtype)
    jparams = randomise_norms_and_biases(
        jinit_params(jax.random.PRNGKey(0), jcfg), 1)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    jlogits, jcaches, jpos = jax.jit(jprefill, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :9])})
    prefilled = (jlogits, jcaches)
    grown = jax.tree.map(lambda c: jnp.pad(
        c, [(0, 0), (0, 0), (0, 3), (0, 0), (0, 0)]) if c.ndim == 5 else c,
        jcaches)
    jstep = jax.jit(jdecode_step, static_argnums=1)
    decoded = []
    for i in range(3):
        jlogits, grown = jstep(jparams, jcfg, jnp.asarray(tokens[:, 9 + i]),
                               grown, jpos + i)
        decoded.append(jlogits)
    return {"cfg": cfg, "params": params, "tokens": torch.from_numpy(tokens),
            "prefill": prefilled, "decode": (decoded, grown),
            "dtype": dtype}


def close_mamba_states(got, want, dtype):
    for name in ("conv", "h"):
        assert got[name].shape == want[name].shape
        assert str(got[name].dtype) == f"torch.{want[name].dtype}"
        close_model(got[name], want[name], dtype)


def test_hybrid_prefill_matches_jax(hybrid_case):
    c = hybrid_case
    logits, caches, pos = prefill(c["params"], c["cfg"],
                                  {"tokens": c["tokens"][:, :9]})
    jlogits, jcaches = c["prefill"]
    assert logits.dtype == torch.float32 and pos.tolist() == [9, 9]
    close_model(logits, jlogits, c["dtype"])
    for name in ("k", "v"):
        assert caches["kv"][name].shape == jcaches["kv"][name].shape
        close_model(caches["kv"][name], jcaches["kv"][name], c["dtype"])
    close_mamba_states(caches["mamba"], jcaches["mamba"], c["dtype"])


def test_hybrid_decode_steps_match_jax(hybrid_case):
    """Three decode steps write the new K/V and Mamba states into the
    caches in place; the Mamba states pass from prefill to decode."""
    c = hybrid_case
    _, pre, pos = prefill(c["params"], c["cfg"],
                          {"tokens": c["tokens"][:, :9]})
    caches = preallocate_cache(c["cfg"], pre, 12)
    assert caches["mamba"] is pre["mamba"]
    h = caches["mamba"]["h"]
    jdecoded, jcaches = c["decode"]
    for i in range(3):
        logits, caches = decode_step(c["params"], c["cfg"],
                                     c["tokens"][:, 9 + i], caches, pos + i)
        close_model(logits, jdecoded[i], c["dtype"])
    assert caches["mamba"]["h"] is h
    for name in ("k", "v"):
        close_model(caches["kv"][name], jcaches["kv"][name], c["dtype"])
    close_mamba_states(caches["mamba"], jcaches["mamba"], c["dtype"])


@pytest.mark.parametrize("dtype", HYBRID_CASES)
def test_hybrid_prefill_then_decode_matches_full_forward(dtype):
    """Past the window: a 37-token prefill (window 16), then 3 decode steps
    through the ring and the carried Mamba states, each giving the
    last-token logits of the full prefill of the sequence so far."""
    _, cfg = configs(dtype)
    params = init_params(torch.Generator().manual_seed(3), cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 40)))
    _, pre, pos = prefill(params, cfg, {"tokens": tokens[:, :37]})
    caches = preallocate_cache(cfg, pre, 40)
    assert caches["kv"]["k"].shape[2] == cfg.sliding_window == 16
    for i in range(37, 40):
        logits, caches = decode_step(params, cfg, tokens[:, i], caches,
                                     pos + (i - 37))
        full, _, _ = prefill(params, cfg, {"tokens": tokens[:, :i + 1]})
        close_model(logits, full.numpy(), dtype)


def test_hybrid_greedy_generate_matches_jax():
    """Inside the window the JAX engine's padded cache and the port's ring
    hold the same positions: greedy ids match over 6 new tokens."""
    jcfg, cfg = configs("float32")
    jparams = randomise_norms_and_biases(
        jinit_params(jax.random.PRNGKey(1), jcfg), 5)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8),
                                                dtype=np.int32)
    want = JaxEngine(jcfg, jparams, JaxServeConfig(max_new_tokens=6)) \
        .generate(jnp.asarray(prompts))
    got = Engine(cfg, params, ServeConfig(max_new_tokens=6),
                 device="cpu").generate(prompts)
    np.testing.assert_array_equal(got, np.asarray(want))

