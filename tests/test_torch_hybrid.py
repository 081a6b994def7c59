"""The port's hybrid family (hymba: attention and Mamba heads side by side
in each layer) against the JAX package on the CPU.

On the CPU ``ops.mamba_scan`` runs the kernel's plain version,
``mamba_scan_plain``; tests/test_torch_cuda.py holds the CUDA kernel
against it on the card. Inputs are made with numpy from a seed and handed
to both frameworks; weights cross through ``bridge.params_from_numpy``,
with the Mamba biases and skip (init 0 and 1) randomised first.

Tolerances: the scan's state fp32 atol 2e-5, rtol 1e-4; the fused scan's
output, the Mamba layer and the model fp32 1e-4, bf16 2e-2 of the
tensor's largest magnitude (the frameworks round to bf16 at different
points, and JAX's softplus is another formula than torch's). The fused
call is also held bit for bit to the torch operations it replaced.
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
def jax_fused(dt_raw, dt_bias, b, c, x, z, a_log, d_skip, h0, dtype):
    """JAX's own pieces of ``repro.models.ssm.apply_mamba`` from dt_raw to
    the gated output, as they stand there: the softplus with the bias
    (``ssm.py:198``), its ``step`` (a closure there, written out here)
    scanned by ``chunked_time_scan``, the ``d_skip`` term and the gating;
    inputs rounded to ``dtype`` first, as the model's activations are.
    Returns (out, final state) as numpy float32."""
    jd = getattr(jnp, dtype)
    dt_raw, b, c, x, z = (jnp.asarray(t, jd) for t in (dt_raw, b, c, x, z))
    dt = jax.nn.softplus(dt_raw.astype(jnp.float32) + dt_bias)
    a = -jnp.exp(jnp.asarray(a_log))
    x_f = x.astype(jnp.float32)

    def step(h, t):
        dt_t, b_tt, c_tt, x_t = t
        da = jnp.exp(dt_t[..., None] * a[None])
        h = da * h + (dt_t * x_t)[..., None] * b_tt[:, None, :]
        return h, jnp.einsum("bdn,bn->bd", h, c_tt)

    seq = tuple(t.transpose(1, 0, 2) for t in (
        dt, b.astype(jnp.float32), c.astype(jnp.float32), x_f))
    final, ys = jssm.chunked_time_scan(step, jnp.asarray(h0), seq)
    y = ys.transpose(1, 0, 2) + d_skip * x_f
    out = y.astype(jd) * jax.nn.silu(z)
    return np.asarray(out.astype(jnp.float32)), np.asarray(final)


def torch_inputs(args, dtype, n):
    """mamba_inputs as the port's tensors: dt_raw, b, c (the halves of one
    projection), x and z (the second half of one (B, S, 2 di) tensor) in
    ``dtype``, the rest float32; the state as a fresh copy."""
    dt_raw, dt_bias, bc, x, zz, a_log, d_skip, h = args
    td = getattr(torch, dtype)
    bc, zz = torch.from_numpy(bc).to(td), torch.from_numpy(zz).to(td)
    return (torch.from_numpy(dt_raw).to(td), torch.from_numpy(dt_bias),
            bc[..., :n], bc[..., n:], torch.from_numpy(x).to(td),
            zz[..., x.shape[-1]:], torch.from_numpy(a_log),
            torch.from_numpy(d_skip),
            None if h is None else torch.from_numpy(h.copy()))


def check_against_jax(bsz, s, di, n, carried, dtype):
    """The fused function (softplus, scan, skip, gating) against JAX's
    pieces of apply_mamba. Tolerances: the state fp32 ATOL, RTOL (the two
    softplus formulas, JAX's logaddexp and torch's log1p(exp), differ in
    the last bit); out as the layer's (close_model): fp32 1e-4, bf16 2e-2
    of its largest magnitude (the frameworks' fp32 y may round to
    neighbouring bf16 values)."""
    args = mamba_inputs(bsz, s, di, n, s + di, carried)
    dt_raw, dt_bias, bc, x, zz, a_log, d_skip, h = args
    h0 = h if carried else np.zeros((bsz, di, n), np.float32)
    want_out, want_h = jax_fused(dt_raw, dt_bias, bc[..., :n], bc[..., n:],
                                 x, zz[..., di:], a_log, d_skip, h0, dtype)
    t_args = torch_inputs(args, dtype, n)
    out, final = ops.mamba_scan(*t_args)
    assert out.dtype == getattr(torch, dtype)
    assert final.dtype == torch.float32
    assert out.shape == (bsz, s, di) and final.shape == (bsz, di, n)
    if carried:
        assert final is t_args[-1]                # written in place
    close_model(out, want_out, dtype)
    close(final, want_h)
    ref_out, _ = ops.mamba_scan(*torch_inputs(args, dtype, n),
                                impl="reference")
    assert torch.equal(ref_out, out)


@pytest.mark.parametrize("bsz,s,di,n,carried", MAMBA_CASES)
def test_mamba_scan_matches_jax_scan(bsz, s, di, n, carried):
    check_against_jax(bsz, s, di, n, carried, "float32")


@pytest.mark.parametrize("bsz,s,di,n,carried", MAMBA_CASES)
def test_mamba_scan_bf16_matches_jax_scan(bsz, s, di, n, carried):
    check_against_jax(bsz, s, di, n, carried, "bfloat16")


def test_mamba_scan_state_carries_across_a_split():
    """The whole sequence equals its first part, then the rest from the
    first part's final state."""
    args = torch_inputs(mamba_inputs(2, 50, 24, 8, 4, False), "float32", 8)
    dt, bias, b, c, x, z, a_log, skip, _ = args
    out, final = ops.mamba_scan(*args)
    o1, mid = ops.mamba_scan(dt[:, :23], bias, b[:, :23], c[:, :23],
                             x[:, :23], z[:, :23], a_log, skip)
    o2, end = ops.mamba_scan(dt[:, 23:], bias, b[:, 23:], c[:, 23:],
                             x[:, 23:], z[:, 23:], a_log, skip, mid.clone())
    close(torch.cat([o1, o2], dim=1), out.numpy())
    close(end, final.numpy())
    assert out[:, 40:].abs().max() > 1e-3


def test_mamba_scan_reads_views_as_copies():
    """b and c as strided halves of one projection give what contiguous
    copies give, in fp32 and bf16, and so does z as the second half of
    in_proj's output up to the last bit of silu (PyTorch's CPU silu takes
    another exp for a strided tensor than for a contiguous one); bf16
    inputs give the state their exact fp32 widening gives, and that run's
    output within a bf16 step."""
    def run(dtype, prep=lambda i, t: t):
        args = torch_inputs(mamba_inputs(2, 9, 16, 8, 5), dtype, 8)
        assert not args[2].is_contiguous() and not args[5].is_contiguous()
        return ops.mamba_scan(*(prep(i, t) for i, t in
                                enumerate(args[:-1])), args[-1])

    for dtype in ("float32", "bfloat16"):
        out, state = run(dtype)
        out2, state2 = run(dtype, lambda i, t: t.contiguous() if i in (2, 3)
                           else t)
        assert torch.equal(out, out2) and torch.equal(state, state2)
        out2, state2 = run(dtype, lambda i, t: t.contiguous())
        assert torch.equal(state, state2)
        close(out2, out.float().numpy(), atol=1e-6, rtol=1e-6)
    out3, state3 = run("bfloat16", lambda i, t: t.float())
    assert out3.dtype == torch.float32 and torch.equal(state3, state)
    np.testing.assert_allclose(out.float().numpy(), out3.numpy(),
                               atol=2e-2, rtol=2e-2)


def test_mamba_scan_does_not_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: on another device the
    wrapper launches its kernel or raises."""
    t = torch.empty(1, 8, 16, device="meta")
    bc = torch.empty(1, 8, 16, device="meta")
    v = torch.empty(16, device="meta")
    a_log = torch.empty(16, 8, device="meta")
    with pytest.raises(ValueError):
        mamba_scan(t, v, bc[..., :8], bc[..., 8:], t, t, a_log, v)
    with pytest.raises(ValueError):
        ops.mamba_scan(t, v, bc[..., :8], bc[..., 8:], t, t, a_log, v,
                       impl="pallas")
    assert mamba_scan.launches == 0 and mamba_scan.token_launches == 0
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


def apply_mamba_unfused(p, x, cfg, state):
    """The oracle: the port's apply_mamba as it stood before the kernel took
    over dt's softplus, the skip term and the gating, torch operation by
    torch operation, with the fp32 scan loop of JAX's step. Returns (out,
    conv state, final SSM state); it reads a given state and writes none."""
    import torch.nn.functional as F
    n = cfg.ssm_state
    x_in, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    x_c, new_conv = ssm._causal_conv(x_in, p["conv_w"], p["conv_b"],
                                     None if state is None else
                                     state["conv"])
    x_c = F.silu(x_c)
    dt = F.softplus((x_c @ p["dt_a"] @ p["dt_b"]).float() + p["dt_bias"])
    bc = (x_c @ p["w_bc"]).float()
    b, c = bc[..., :n], bc[..., n:]
    a = -torch.exp(p["a_log"])
    x_f = x_c.float()
    cur = torch.zeros((x.shape[0], x_c.shape[-1], n)) if state is None \
        else state["h"].float()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t, :, None] * a[None])
        cur = da * cur + (dt[:, t] * x_f[:, t])[..., None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", cur, c[:, t]))
    y = torch.stack(ys, dim=1) + p["d_skip"] * x_f
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return out, new_conv, cur


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mamba_bit_equal_to_the_unfused_sequence(dtype, carried):
    """On the CPU the fused call computes what the separate torch
    operations computed, bit for bit: a prefill from zeros, and a decode
    step from a carried state."""
    _, cfg = configs(dtype)
    td = getattr(torch, dtype)
    di = cfg.n_heads * cfg.hd
    p = {k: v[0] for k, v in ssm.init_mamba(
        torch.Generator().manual_seed(2), cfg, td).items()}
    rng = np.random.default_rng(9)
    p["dt_bias"] = torch.from_numpy(rand(rng, (di,), 0.5))
    p["d_skip"] = torch.from_numpy(1.0 + rand(rng, (di,), 0.5))
    x = torch.from_numpy(rand(rng, (2, 1 if carried else 70, cfg.d_model),
                              1.0)).to(td)
    state = None
    if carried:
        state = {"conv": torch.from_numpy(rand(rng, (2, 3, di), 1.0)).to(td),
                 "h": torch.from_numpy(rand(rng, (2, di, cfg.ssm_state),
                                            1.0))}
    want, want_conv, want_h = apply_mamba_unfused(p, x, cfg, state)
    out, new = ssm.apply_mamba(p, x, cfg, state)
    assert out.dtype == td
    assert torch.equal(out, want)
    assert torch.equal(new["conv"], want_conv)
    assert torch.equal(new["h"], want_h)


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

