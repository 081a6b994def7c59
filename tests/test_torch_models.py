"""The port's layers and decoder (dense and RWKV6) against ``repro.models``
on the CPU.

Weights cross through ``bridge.params_from_numpy(_flatten(jax_params))``;
tokens and activations are made with numpy from a seed. Norm weights, QKV
biases and RWKV's shift mixes and decay bias, which the JAX init leaves at
constants, are randomised first so that each is really exercised.

Tolerances: fp32 1e-4 (the two frameworks sum in other orders; measured
errors are below 1e-5). bf16: 2e-2 of the tensor's largest magnitude. The
frameworks round to bf16 at different points (JAX's model casts the
softmax probabilities to bf16 before the PV product, the port's kernels
keep them in fp32, as the Pallas kernels do; silu rounds once or twice),
so a value near zero can be a few bf16 ulps of the tensor's range off,
which a pointwise 2e-2 would reject.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import randomise_norms_and_biases
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import decode_step as jdecode_step
from repro.models import init_decode_cache as jinit_decode_cache
from repro.models import init_params as jinit_params
from repro.models import layers as jl
from repro.models import prefill as jprefill
from repro.train.checkpoint import _flatten
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.launch.train import PRESETS
from repro_torch.models import (decode_step, init_decode_cache,
                                init_params, prefill)
from repro_torch.models import layers as tl
from repro_torch.serve.engine import preallocate_cache

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def rand(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def close_model(got, want, dtype: str):
    want = np.asarray(want, np.float32)
    tol = TOL[dtype]
    atol = tol * np.abs(want).max() if dtype == "bfloat16" else tol
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol, rtol=tol)


# ---------------------------------------------------------------- layers
def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x, w = rand(rng, (2, 5, 3, 16)), rand(rng, (16,)) + 1.0
    close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6),
          jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-6)
    for pos in (np.arange(5), np.array([[3], [17]])):
        jc, js = jl.rope_tables(jnp.asarray(pos), 16, 1e6)
        tc, ts = tl.rope_tables(torch.from_numpy(pos), 16, 1e6)
        close(tc, jc, 1e-6)
        close(ts, js, 1e-6)
    close(tl.apply_rope(torch.from_numpy(x),
                        tl.rope_tables(torch.arange(5), 16, 1e4)),
          jl.apply_rope(jnp.asarray(x), jl.rope_tables(jnp.arange(5), 16,
                                                       1e4)), 1e-5)


def test_repeat_kv_and_swiglu_match():
    rng = np.random.default_rng(1)
    k = rand(rng, (2, 4, 3, 8))
    for n_rep in (1, 4):
        close(tl.repeat_kv(torch.from_numpy(k), n_rep),
              jl.repeat_kv(jnp.asarray(k), n_rep), 0)
    x, wg, wu, wd = (rand(rng, s) for s in ((3, 8), (8, 16), (8, 16),
                                            (16, 8)))
    close(tl.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd))),
          jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,q_offset,chunk", [
    (None, 0, 512), (None, 0, 16), (24, 0, 16), (None, 7, 512)])
def test_causal_attention_ref_matches(dtype, window, q_offset, chunk):
    rng = np.random.default_rng(2)
    sq, sk = (40, 40) if q_offset == 0 else (5, 12)
    q, k, v = rand(rng, (2, sq, 4, 16)), rand(rng, (2, sk, 4, 16)), \
        rand(rng, (2, sk, 4, 16))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = tl.causal_attention_ref(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), window=window,
        q_offset=q_offset, chunk=chunk)
    want = jl.causal_attention_ref(
        *(jnp.asarray(a, jd) for a in (q, k, v)), window=window,
        q_offset=q_offset, chunk=chunk)
    close(got, want, 2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_ref_matches(window):
    rng = np.random.default_rng(3)
    q, kc, vc = rand(rng, (2, 1, 8, 16)), rand(rng, (2, 20, 2, 16)), \
        rand(rng, (2, 20, 2, 16))
    lens = np.array([9, 20], np.int32)
    got = tl.decode_attention_ref(
        *(torch.from_numpy(a) for a in (q, kc, vc, lens)), window=window)
    want = jl.decode_attention_ref(
        *(jnp.asarray(a) for a in (q, kc, vc, lens)), window=window)
    close(got, want, 2e-5)


def test_dense_init_scale_per_layer():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, (3, 256, 64), torch.float32)
    assert abs(w.std().item() - 256 ** -0.5) < 0.003
    assert tl.dense_init(gen, (4,), torch.bfloat16).dtype == torch.bfloat16


# ----------------------------------------------------------------- model
MODEL_CASES = [
    ("tiny", "float32"),
    ("qwen3-8b", "float32"),
    ("qwen3-8b", "bfloat16"),
    ("qwen2.5-3b", "float32"),
    ("qwen2.5-3b", "bfloat16"),
]


def configs(name: str, dtype: str):
    """(JAX config, port config): the tiny preset, or the arch's reduced
    same-family config, in ``dtype``."""
    from repro.launch.train import PRESETS as JAX_PRESETS
    if name in PRESETS:
        jcfg, tcfg = JAX_PRESETS[name], PRESETS[name]
    else:
        jcfg, tcfg = JAX_ARCHS[name].reduced(), ARCHS[name].reduced()
    return (dataclasses.replace(jcfg, param_dtype=dtype),
            dataclasses.replace(tcfg, param_dtype=dtype))


@pytest.fixture(scope="module", params=MODEL_CASES,
                ids=[f"{n}-{d}" for n, d in MODEL_CASES])
def model_case(request):
    return make_case(*request.param)


def make_case(name: str, dtype: str) -> dict:
    """JAX's prefill of 11 tokens and decode of the 12th, and the port's
    parameters bridged from the same weights."""
    jcfg, tcfg = configs(name, dtype)
    jparams = randomise_norms_and_biases(
        jinit_params(jax.random.PRNGKey(0), jcfg), 1)
    params = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    jlogits, jcaches, jpos = jax.jit(jprefill, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :-1])})
    grown = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]),
        jcaches)
    jdec, _ = jax.jit(jdecode_step, static_argnums=1)(
        jparams, jcfg, jnp.asarray(tokens[:, -1]), grown, jpos)
    return {"cfg": tcfg, "params": params, "tokens": torch.from_numpy(tokens),
            "prefill": (jlogits, jcaches), "decode": jdec, "dtype": dtype}


def test_prefill_matches_jax(model_case):
    c = model_case
    logits, caches, pos = prefill(c["params"], c["cfg"],
                                  {"tokens": c["tokens"][:, :-1]})
    jlogits, jcaches = c["prefill"]
    assert logits.dtype == torch.float32 and pos.tolist() == [11, 11]
    close_model(logits, jlogits, c["dtype"])
    for name in ("k", "v"):
        assert caches["kv"][name].shape == jcaches["kv"][name].shape
        close_model(caches["kv"][name], jcaches["kv"][name], c["dtype"])


def test_decode_step_matches_jax(model_case):
    c = model_case
    _, pre, pos = prefill(c["params"], c["cfg"],
                          {"tokens": c["tokens"][:, :-1]})
    caches = preallocate_cache(c["cfg"], pre, 15)
    logits, caches = decode_step(c["params"], c["cfg"], c["tokens"][:, -1],
                                 caches, pos)
    close_model(logits, c["decode"], c["dtype"])
    # the new token's K/V went into slot 11 in place; the rest stay zero
    assert caches["kv"]["k"][:, :, 11].abs().sum() > 0
    assert caches["kv"]["k"][:, :, 12:].abs().sum() == 0


def test_prefill_then_decode_matches_full_forward(model_case):
    """The port's own decode with caches agrees with its full prefill."""
    c = model_case
    full, _, _ = prefill(c["params"], c["cfg"], {"tokens": c["tokens"]})
    _, pre, pos = prefill(c["params"], c["cfg"],
                          {"tokens": c["tokens"][:, :-1]})
    logits, _ = decode_step(c["params"], c["cfg"], c["tokens"][:, -1],
                            preallocate_cache(c["cfg"], pre, 16), pos)
    close_model(logits, full.numpy(), c["dtype"])


def test_ring_cache_decode_matches_jax():
    """A sliding-window config decodes into a ring of ``window`` slots at
    ``pos % window``, masked by ``min(pos + 1, window)``: 20 steps from a
    blank ring of 16 slots wrap it, as JAX's ``init_decode_cache`` ring
    does."""
    jcfg, cfg = configs("h2o-danube-1.8b", "float32")
    jparams = jinit_params(jax.random.PRNGKey(3), jcfg)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 20),
                                             dtype=np.int32)
    jcaches = jinit_decode_cache(jcfg, 2, max_len=64)
    caches = init_decode_cache(cfg, 2, max_len=64)
    assert caches["kv"]["k"].shape == jcaches["kv"]["k"].shape
    assert caches["kv"]["k"].shape[2] == cfg.sliding_window == 16
    jstep = jax.jit(jdecode_step, static_argnums=1)
    for i in range(20):
        pos = np.full((2,), i, np.int32)
        jlogits, jcaches = jstep(jparams, jcfg, jnp.asarray(toks[:, i]),
                                 jcaches, jnp.asarray(pos))
        logits, caches = decode_step(params, cfg, torch.from_numpy(toks[:, i]),
                                     caches, torch.from_numpy(pos))
    close_model(logits, jlogits, "float32")
    close_model(caches["kv"]["k"], jcaches["kv"]["k"], "float32")


def test_decode_after_long_prompt_stays_in_window():
    """The engine's cache keeps a sliding-window config inside its window
    after a prompt longer than the window: decode steps after a 22-token
    prefill (window 16) give the last-token logits of JAX's windowed
    ``prefill`` over the whole sequence so far."""
    jcfg, cfg = configs("h2o-danube-1.8b", "float32")
    jparams = jinit_params(jax.random.PRNGKey(5), jcfg)
    params = params_from_numpy(_flatten(jparams), cfg, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 25),
                                             dtype=np.int32)
    _, pre, pos = prefill(params, cfg,
                          {"tokens": torch.from_numpy(toks[:, :22])})
    caches = preallocate_cache(cfg, pre, 25)
    assert caches["kv"]["k"].shape[2] == cfg.sliding_window == 16
    for i in range(22, 25):
        logits, caches = decode_step(params, cfg, torch.from_numpy(toks[:, i]),
                                     caches, pos + (i - 22))
        jlogits, _, _ = jprefill(jparams, jcfg,
                                 {"tokens": jnp.asarray(toks[:, :i + 1])})
        close_model(logits, jlogits, "float32")


# ------------------------------------------------------------------ RWKV
RWKV_CASES = [(16, "float32"), (16, "bfloat16"), (64, "float32"),
              (64, "bfloat16")]


@pytest.fixture(scope="module", params=RWKV_CASES,
                ids=[f"hd{h}-{d}" for h, d in RWKV_CASES])
def rwkv_case(request):
    """Reduced rwkv6-3b: 4 heads of 16 (d_model 64), or 4 heads of 64
    (d_model 256). JAX's prefill of 9 tokens, then 3 decode steps, and the
    port's parameters bridged from the same weights."""
    head_dim, dtype = request.param
    jcfg, tcfg = (dataclasses.replace(c, d_model=4 * head_dim,
                                      rwkv_head_dim=head_dim)
                  for c in configs("rwkv6-3b", dtype))
    jparams = randomise_norms_and_biases(
        jinit_params(jax.random.PRNGKey(0), jcfg), 1)
    params = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 12),
                                               dtype=np.int32)
    jlogits, jcaches, jpos = jax.jit(jprefill, static_argnums=1)(
        jparams, jcfg, {"tokens": jnp.asarray(tokens[:, :9])})
    prefilled = (jlogits, jcaches)
    jstep = jax.jit(jdecode_step, static_argnums=1)
    decoded = []
    for i in range(3):
        jlogits, jcaches = jstep(jparams, jcfg, jnp.asarray(tokens[:, 9 + i]),
                                 jcaches, jpos + i)
        decoded.append(jlogits)
    return {"cfg": tcfg, "params": params, "tokens": torch.from_numpy(tokens),
            "prefill": prefilled, "decode": (decoded, jcaches),
            "dtype": dtype}


def close_rwkv_caches(caches, jcaches, dtype):
    for got, want in ((caches["tmix"]["shift"], jcaches["tmix"]["shift"]),
                      (caches["tmix"]["wkv"], jcaches["tmix"]["wkv"]),
                      (caches["cmix"], jcaches["cmix"])):
        assert got.shape == want.shape
        assert str(got.dtype) == f"torch.{want.dtype}"
        close_model(got, want, dtype)


def test_rwkv_prefill_matches_jax(rwkv_case):
    c = rwkv_case
    logits, caches, pos = prefill(c["params"], c["cfg"],
                                  {"tokens": c["tokens"][:, :9]})
    jlogits, jcaches = c["prefill"]
    assert logits.dtype == torch.float32 and pos.tolist() == [9, 9]
    close_model(logits, jlogits, c["dtype"])
    close_rwkv_caches(caches, jcaches, c["dtype"])


def test_rwkv_decode_steps_match_jax(rwkv_case):
    """Three decode steps write the new states into the caches in place."""
    c = rwkv_case
    _, pre, pos = prefill(c["params"], c["cfg"],
                          {"tokens": c["tokens"][:, :9]})
    caches = preallocate_cache(c["cfg"], pre, 12)
    assert caches is pre
    wkv = caches["tmix"]["wkv"]
    jdecoded, jcaches = c["decode"]
    for i in range(3):
        logits, caches = decode_step(c["params"], c["cfg"],
                                     c["tokens"][:, 9 + i], caches, pos + i)
        close_model(logits, jdecoded[i], c["dtype"])
    assert caches["tmix"]["wkv"] is wkv
    close_rwkv_caches(caches, jcaches, c["dtype"])


def test_rwkv_prefill_then_decode_matches_full_forward(rwkv_case):
    c = rwkv_case
    full, _, _ = prefill(c["params"], c["cfg"], {"tokens": c["tokens"]})
    _, caches, pos = prefill(c["params"], c["cfg"],
                             {"tokens": c["tokens"][:, :-1]})
    logits, _ = decode_step(c["params"], c["cfg"], c["tokens"][:, -1],
                            caches, pos)
    close_model(logits, full.numpy(), c["dtype"])


def test_init_params_layout_matches_jax():
    """Same keys, shapes and dtypes as the JAX tree."""
    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    for name in ("qwen3-8b", "qwen2.5-3b", "rwkv6-3b", "moonshot-v1-16b-a3b",
                 "arctic-480b", "pixtral-12b", "musicgen-large",
                 "hymba-1.5b"):
        jcfg, tcfg = configs(name, "bfloat16")
        jtree = jinit_params(jax.random.PRNGKey(0), jcfg)
        jleaves = {"/".join(str(p.key) for p in path): leaf for path, leaf in
                   jax.tree_util.tree_flatten_with_path(jtree)[0]}
        tleaves = dict(leaves(init_params(torch.Generator(), tcfg)))
        assert sorted(tleaves) == sorted(jleaves)
        for k, leaf in jleaves.items():
            assert tuple(tleaves[k].shape) == leaf.shape, k
            assert str(tleaves[k].dtype) == f"torch.{leaf.dtype}", k
