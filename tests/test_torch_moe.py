"""The port's MoE layer and the MoE and stub-frontend models against
``repro.models`` on the CPU.

Layer: ``apply_moe`` against JAX's at moonshot's and arctic's own expert
counts and top-k (64 top-6; 128 top-2 with the dense residual) at narrow
widths, in fp32 and bf16, at a drop-free capacity and at the configs'
capacity factor of 1.25, for a prefill's tokens and for a decode step's
T = B = 4 (capacity 1 at cf 1.25: a row past it is dropped, as in JAX).
The expert choices and the aux loss are asserted before the outputs, so a
routing flip is named as one.

Models: reduced moonshot and arctic (4 experts, top-2), drop-free and at
cf 1.25; reduced pixtral and musicgen, whose inputs are precomputed
embeddings. ``prefill``, ``decode_step`` and ``forward_train``'s loss and
gradients against JAX's, weights bridged through
``bridge.params_from_numpy(_flatten(jax_params))``.

Grouped dispatch: ``apply_moe`` under ``set_moe_groups(2)`` and ``(4)``
in both packages (JAX's group-local ``_apply_moe_grouped``) at both
archs, drop-free and at cf 1.25, fp32 and bf16; drop-free it equals the
flat dispatch, in the layer and in training.

Tolerances are ROADMAP's: fp32 1e-4, bf16 2e-2 of the largest magnitude
(gradients: 1e-4 of each leaf's largest magnitude, as in
tests/test_torch_train.py).
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import randomise_norms_and_biases
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import decode_step as jdecode_step
from repro.models import forward_train as jforward_train
from repro.models import hidden_states as jhidden_states
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.models.moe import apply_moe as japply_moe
from repro.models.moe import init_moe as jinit_moe
from repro.train.checkpoint import _flatten
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig
from repro_torch.models import (decode_step, hidden_states, init_params,
                                prefill)
from repro_torch.models import moe as tmoe
from repro_torch.serve.engine import Engine, ServeConfig, preallocate_cache
from repro_torch.train.train_step import loss_and_grads

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MOE_ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b")
STUB_ARCHS = ("pixtral-12b", "musicgen-large")


def close_model(got, want, dtype: str, name: str = ""):
    want = np.asarray(want, np.float32)
    tol = TOL[dtype]
    atol = tol * np.abs(want).max() if dtype == "bfloat16" else tol
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol, rtol=tol, err_msg=name)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------------------ layer
def layer_cfg(arch: str, cf, dtype: str):
    """The arch's own experts and top-k at narrow widths; ``cf`` "free"
    gives a capacity no expert can overflow."""
    base = JAX_ARCHS[arch]
    cfg = dataclasses.replace(base.reduced(), n_experts=base.n_experts,
                              experts_per_token=base.experts_per_token,
                              param_dtype=dtype)
    return dataclasses.replace(
        cfg, capacity_factor=float(cfg.n_experts) if cf == "free" else cf)


LAYER_CASES = [(arch, cf, t, dtype) for arch in MOE_ARCHS
               for cf in ("free", 1.25) for t in (48, 4)
               for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("arch,cf,t,dtype", LAYER_CASES)
def test_apply_moe_matches_jax(arch, cf, t, dtype):
    jcfg = layer_cfg(arch, cf, dtype)
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    jp = jinit_moe(jax.random.PRNGKey(t), jcfg, jnp.dtype(dtype))
    tp = params_from_numpy(_flatten({"moe": jp}), tcfg, "cpu")["moe"]
    assert tp["router"].dtype == torch.float32
    x = np.random.default_rng(t).standard_normal(
        (t, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.dtype(dtype)), torch.from_numpy(x).to(
        getattr(torch, dtype))
    capacity = max(1, int(jcfg.capacity_factor * t * jcfg.experts_per_token
                          / jcfg.n_experts))
    if cf == 1.25 and t == 4:
        assert capacity == 1

    # routing first: the same experts in the same order, then the aux loss
    jprobs = jax.nn.softmax(jx.astype(jnp.float32) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, jcfg.experts_per_token)
    _, tidx, _ = tmoe.route(tp, tx, tcfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx),
                                  err_msg="routing: expert choices differ")
    jout, jaux = japply_moe(jp, jx, jcfg)
    out, aux = tmoe.apply_moe(tp, tx, tcfg)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               err_msg="aux loss")
    assert out.dtype == tx.dtype and out.shape == tx.shape
    close_model(out, jout, dtype, "output")


def test_capacity_drops_rows_as_jax_does():
    """At cf 1.25 and T = 4 (capacity 1), two rows that pick one expert
    keep only the first in token-major order: the output differs from the
    drop-free one exactly where JAX's does."""
    jcfg = layer_cfg("moonshot-v1-16b-a3b", 1.25, "float32")
    free = dataclasses.replace(jcfg, capacity_factor=64.0)
    tcfg, tfree = (ArchConfig(**dataclasses.asdict(c)) for c in (jcfg, free))
    jp = jinit_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(_flatten({"moe": jp}), tcfg, "cpu")["moe"]
    x = np.random.default_rng(0).standard_normal((4, jcfg.d_model)) \
        .astype(np.float32)
    idx = tmoe.route(tp, torch.from_numpy(x), tcfg)[1].numpy()
    assert len(np.unique(idx)) < idx.size     # some expert is picked twice
    jdrop = np.abs(np.asarray(japply_moe(jp, jnp.asarray(x), jcfg)[0])
                   - np.asarray(japply_moe(jp, jnp.asarray(x), free)[0]))
    tdrop = (tmoe.apply_moe(tp, torch.from_numpy(x), tcfg)[0]
             - tmoe.apply_moe(tp, torch.from_numpy(x), tfree)[0]).abs()
    assert jdrop.max() > 1e-3
    np.testing.assert_array_equal(tdrop.numpy().max(-1) > 1e-3,
                                  jdrop.max(-1) > 1e-3)


# --------------------------------------------------------- grouped dispatch
GROUPED_CASES = [(arch, cf, groups, dtype) for arch in MOE_ARCHS
                 for cf in ("free", 1.25) for groups in (2, 4)
                 for dtype in ("float32", "bfloat16")]


@contextlib.contextmanager
def moe_groups(n: int):
    """``set_moe_groups(n)`` in both packages' sharding contexts."""
    from repro.sharding import ctx as jctx
    from repro_torch.sharding import ctx as tctx
    jctx.set_moe_groups(n)
    tctx.set_moe_groups(n)
    try:
        yield
    finally:
        jctx.set_moe_groups(1)
        tctx.set_moe_groups(1)


def layer_case(arch: str, cf, dtype: str, t: int = 48):
    """(JAX config, port config, JAX params, port params, JAX x, port x)."""
    jcfg = layer_cfg(arch, cf, dtype)
    tcfg = ArchConfig(**dataclasses.asdict(jcfg))
    jp = jinit_moe(jax.random.PRNGKey(t), jcfg, jnp.dtype(dtype))
    tp = params_from_numpy(_flatten({"moe": jp}), tcfg, "cpu")["moe"]
    x = np.random.default_rng(t).standard_normal(
        (t, jcfg.d_model)).astype(np.float32)
    return (jcfg, tcfg, jp, tp, jnp.asarray(x, jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


@pytest.mark.parametrize("arch,cf,groups,dtype", GROUPED_CASES)
def test_grouped_dispatch_matches_jax(arch, cf, groups, dtype):
    """``apply_moe`` under ``set_moe_groups(groups)`` on both sides takes
    the group-local dispatch (JAX's constrain does nothing without a
    mesh): the same aux loss and, within the layer tolerances, output."""
    jcfg, tcfg, jp, tp, jx, tx = layer_case(arch, cf, dtype)
    with moe_groups(groups):
        jout, jaux = japply_moe(jp, jx, jcfg)
        out, aux = tmoe.apply_moe(tp, tx, tcfg)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               err_msg="aux loss")
    direct, _ = tmoe._apply_moe_grouped(tp, tx, tcfg, groups)
    torch.testing.assert_close(out, direct, rtol=0, atol=0)
    close_model(out, jout, dtype, "output")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_dispatch_equals_flat_when_drop_free(arch):
    """Drop-free, grouped and flat dispatch compute one function; at cf
    1.25 the group-local capacity drops other rows. A token count the
    groups do not divide keeps the flat dispatch, as in JAX."""
    jcfg, tcfg, jp, tp, jx, tx = layer_case(arch, "free", "float32")
    flat_out, flat_aux = tmoe.apply_moe(tp, tx, tcfg)
    with moe_groups(4):
        grouped, aux = tmoe.apply_moe(tp, tx, tcfg)
        odd = tmoe.apply_moe(tp, tx[:46], tcfg)[0]
    torch.testing.assert_close(grouped, flat_out, rtol=1e-5, atol=1e-6)
    assert float(aux) == float(flat_aux)
    torch.testing.assert_close(odd, tmoe.apply_moe(tp, tx[:46], tcfg)[0],
                               rtol=0, atol=0)
    cfg = dataclasses.replace(tcfg, capacity_factor=1.25)
    flat_out = tmoe.apply_moe(tp, tx, cfg)[0]
    with moe_groups(4):
        grouped = tmoe.apply_moe(tp, tx, cfg)[0]
    assert (grouped - flat_out).abs().max() > 1e-3


def test_grouped_dispatch_trains_as_flat_when_drop_free():
    """The card's grouped check at CPU size: reduced moonshot's loss and
    gradients with 4 dispatch groups equal the flat dispatch's drop-free."""
    c = make_train_case("moonshot-v1-16b-a3b", "free")
    loss, grads = loss_and_grads(c["params"], c["cfg"], c["batch"])
    with moe_groups(4):
        gloss, ggrads = loss_and_grads(c["params"], c["cfg"], c["batch"])
    np.testing.assert_allclose(float(gloss), float(loss), rtol=1e-6)
    for key, want in flat(grads).items():
        torch.testing.assert_close(flat(ggrads)[key], want, rtol=1e-5,
                                   atol=1e-7, msg=key)


def test_moe_init_layout_and_scale():
    """The stacked leaves have JAX's keys, shapes and dtypes, and the
    experts JAX's scale: ``dense_init`` takes the fan-in from the first
    axis of each layer's (E, d_in, d_out) leaf."""
    jcfg, tcfg = (dataclasses.replace(
        a["arctic-480b"].reduced(), n_experts=16, d_model=128)
        for a in (JAX_ARCHS, ARCHS))
    jtree = jinit_params(jax.random.PRNGKey(0), jcfg)["layers"]["moe"]
    ttree = init_params(torch.Generator().manual_seed(0), tcfg)["layers"][
        "moe"]
    jleaves, tleaves = flat(jtree), flat(ttree)
    assert sorted(jleaves) == sorted(tleaves)
    for key, leaf in jleaves.items():
        assert tuple(tleaves[key].shape) == leaf.shape, key
        assert str(tleaves[key].dtype) == f"torch.{leaf.dtype}", key
        want = float(np.asarray(leaf, np.float32).std())
        assert abs(tleaves[key].float().std().item() - want) < 0.1 * want, \
            key


# ------------------------------------------------------------------ model
def model_configs(arch: str, dtype: str, cf="free"):
    """(JAX, port) reduced configs: 4 experts, top-2; ``cf`` "free" keeps
    the reduced config's drop-free capacity."""
    jcfg, tcfg = (dataclasses.replace(a[arch].reduced(), param_dtype=dtype)
                  for a in (JAX_ARCHS, ARCHS))
    if cf != "free":
        jcfg, tcfg = (dataclasses.replace(c, capacity_factor=cf)
                      for c in (jcfg, tcfg))
    return jcfg, tcfg


def inputs(cfg, b: int, s: int, seed: int) -> dict:
    """numpy batch: token ids, or a stub frontend's embeddings (scale 0.02,
    as train/data.py makes them), and labels."""
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s),
                                    dtype=np.int32)}
    if cfg.embedding_stub:
        batch["embeds"] = (rng.standard_normal((b, s, cfg.d_model))
                           * 0.02).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s),
                                       dtype=np.int32)
    return batch


def model_in(batch: dict, sl=slice(None)) -> tuple[dict, dict]:
    """(JAX, port) model inputs of positions ``sl`` (no labels)."""
    key = "embeds" if "embeds" in batch else "tokens"
    x = batch[key][:, sl]
    return {key: jnp.asarray(x)}, {key: torch.from_numpy(np.array(x))}


def step_in(batch: dict, i: int):
    """(JAX, port) decode-step input of position i: ids (B,) or embeds
    (B, D)."""
    x = batch["embeds"][:, i] if "embeds" in batch else batch["tokens"][:, i]
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def jax_routed(fn, *args):
    """Run a JAX model function eagerly (``disable_jit`` makes its layer
    scan a Python loop), recording each MoE call's expert choices from
    JAX's own inputs. Returns (fn's result, [(T, k) ids per call])."""
    from repro.models import transformer as jt
    real, ids = jt.apply_moe, []

    def rec(p, x, cfg):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        ids.append(np.asarray(jax.lax.top_k(probs, cfg.experts_per_token)[1]))
        return real(p, x, cfg)
    with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
        mp.setattr(jt, "apply_moe", rec)
        out = fn(*args)
    return out, ids


def routed(monkeypatch, fn, *args):
    """The port's counterpart: fn's result and each MoE call's ids."""
    from repro_torch.models import transformer
    real, ids = transformer.apply_moe, []

    def rec(p, x, cfg):
        ids.append(tmoe.route(p, x, cfg)[1].numpy())
        return real(p, x, cfg)
    monkeypatch.setattr(transformer, "apply_moe", rec)
    out = fn(*args)
    monkeypatch.setattr(transformer, "apply_moe", real)
    return out, ids


def same_routing(got: list, want: list):
    assert len(got) == len(want)
    for layer, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(
            g, w, err_msg=f"MoE call {layer}: routing differs from JAX's")


MODEL_CASES = [(arch, dtype, cf) for arch in MOE_ARCHS
               for dtype, cf in (("float32", "free"), ("float32", 1.25),
                                 ("bfloat16", "free"))] + \
    [(arch, dtype, "free") for arch in STUB_ARCHS
     for dtype in ("float32", "bfloat16")]


# drop-free: the decode step's capacity cannot drop what the prefill kept
FREE_CASES = [case for case in MODEL_CASES if case[2] == "free"]


@pytest.fixture(scope="module", params=MODEL_CASES,
                ids=[f"{a}-{d}-cf{c}" for a, d, c in MODEL_CASES])
def model_case(request):
    return make_model_case(*request.param)


@functools.cache
def make_model_case(arch: str, dtype: str, cf):
    """JAX's prefill of 11 positions and decode of the 12th, and the port's
    parameters bridged from the same weights."""
    jcfg, tcfg = model_configs(arch, dtype, cf)
    jparams = randomise_norms_and_biases(
        jinit_params(jax.random.PRNGKey(0), jcfg), 1)
    params = params_from_numpy(_flatten(jparams), tcfg, "cpu")
    batch = inputs(tcfg, 2, 12, 2)
    (jlogits, jcaches, jpos), jpre_ids = jax_routed(
        jprefill, jparams, jcfg, model_in(batch, slice(0, 11))[0])
    grown = jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]),
        jcaches)
    (jdec, _), jdec_ids = jax_routed(jdecode_step, jparams, jcfg,
                                     step_in(batch, 11)[0], grown, jpos)
    return {"cfg": tcfg, "params": params, "batch": batch, "dtype": dtype,
            "prefill": (jlogits, jcaches, jpre_ids),
            "decode": (jdec, jdec_ids)}


def test_prefill_matches_jax(model_case, monkeypatch):
    """Each layer's expert choices first, then the logits and caches."""
    c = model_case
    (logits, caches, pos), ids = routed(
        monkeypatch, prefill, c["params"], c["cfg"],
        model_in(c["batch"], slice(0, 11))[1])
    jlogits, jcaches, jids = c["prefill"]
    assert len(ids) == (c["cfg"].n_layers if c["cfg"].is_moe else 0)
    same_routing(ids, jids)
    assert logits.dtype == torch.float32 and pos.tolist() == [11, 11]
    close_model(logits, jlogits, c["dtype"], "logits")
    for name in ("k", "v"):
        close_model(caches["kv"][name], jcaches["kv"][name], c["dtype"], name)


def test_decode_step_matches_jax(model_case, monkeypatch):
    c = model_case
    _, pre, pos = prefill(c["params"], c["cfg"],
                          model_in(c["batch"], slice(0, 11))[1])
    caches = preallocate_cache(c["cfg"], pre, 15)
    (logits, caches), ids = routed(
        monkeypatch, decode_step, c["params"], c["cfg"],
        step_in(c["batch"], 11)[1], caches, pos)
    jlogits, jids = c["decode"]
    assert all(i.shape == (2, c["cfg"].experts_per_token) for i in ids)
    same_routing(ids, jids)
    close_model(logits, jlogits, c["dtype"], "logits")
    assert caches["kv"]["k"][:, :, 11].abs().sum() > 0


@pytest.mark.parametrize("arch,dtype,cf", FREE_CASES)
def test_prefill_then_decode_matches_full_forward(arch, dtype, cf):
    """Drop-free, the port's decode with caches agrees with its own full
    prefill (at cf 1.25 the decode step's capacity differs from the
    prefill's, by the reference's formula)."""
    c = make_model_case(arch, dtype, cf)
    full, _, _ = prefill(c["params"], c["cfg"], model_in(c["batch"])[1])
    _, pre, pos = prefill(c["params"], c["cfg"],
                          model_in(c["batch"], slice(0, 11))[1])
    logits, _ = decode_step(c["params"], c["cfg"], step_in(c["batch"], 11)[1],
                            preallocate_cache(c["cfg"], pre, 16), pos)
    close_model(logits, full.numpy(), c["dtype"])


# --------------------------------------------------------------- training
TRAIN_CASES = [(arch, cf) for arch in MOE_ARCHS for cf in ("free", 1.25)] + \
    [(arch, "free") for arch in STUB_ARCHS]


@pytest.fixture(scope="module", params=TRAIN_CASES,
                ids=[f"{a}-cf{c}" for a, c in TRAIN_CASES])
def train_case(request):
    return make_train_case(*request.param)


@functools.cache
def make_train_case(arch: str, cf):
    """JAX's aux loss, loss and gradients for a reduced fp32 config."""
    jcfg, tcfg = model_configs(arch, "float32", cf)
    jparams = randomise_norms_and_biases(
        jinit_params(jax.random.PRNGKey(0), jcfg), 1)
    batch = inputs(tcfg, 2, 24, 3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jaux = jax.jit(jhidden_states, static_argnums=1)(jparams, jcfg,
                                                        jbatch)
    loss, grads = jax.jit(jax.value_and_grad(jforward_train),
                          static_argnums=1)(jparams, jcfg, jbatch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["labels"] = tbatch["labels"].long()
    if "tokens" in tbatch:
        tbatch["tokens"] = tbatch["tokens"].long()
    return {"cfg": tcfg, "params": params_from_numpy(_flatten(jparams), tcfg,
                                                     "cpu"),
            "batch": tbatch, "aux": float(jaux), "loss": float(loss),
            "grads": _flatten(grads)}


def test_forward_train_loss_and_grads_match_jax(train_case):
    """The aux loss summed over layers first (MoE; 0 for a dense stack),
    then the loss with its 0.01 x aux, then every leaf's gradient."""
    c = train_case
    with torch.no_grad():
        _, aux = hidden_states(c["params"], c["cfg"], c["batch"])
    np.testing.assert_allclose(float(aux), c["aux"], rtol=1e-5, atol=1e-7,
                               err_msg="aux loss")
    if c["cfg"].is_moe:
        assert c["aux"] > 0
    loss, grads = loss_and_grads(c["params"], c["cfg"], c["batch"])
    np.testing.assert_allclose(float(loss), c["loss"], rtol=1e-5)
    got = flat(grads)
    assert sorted(got) == sorted(c["grads"])
    for key, want in c["grads"].items():
        g = got[key].double().numpy()
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g, want, atol=1e-4 * scale, rtol=0,
                                   err_msg=key)
        # the stub's token table is not read; every other leaf learns
        assert (np.abs(want).max() == 0) == (key == "embed"
                                             and c["cfg"].embedding_stub), key


@pytest.mark.parametrize("arch,cf", [case for case in TRAIN_CASES
                                     if case[0] in MOE_ARCHS])
def test_aux_loss_flows_through_remat(arch, cf):
    """The aux loss leaves each layer's checkpoint beside its output: its
    gradient reaches the router with remat on and off alike."""
    c = make_train_case(arch, cf)
    grads = {}
    for remat in (True, False):
        cfg = dataclasses.replace(c["cfg"], remat=remat)
        router = c["params"]["layers"]["moe"]["router"].clone() \
            .requires_grad_(True)
        params = {**c["params"], "layers": {
            **c["params"]["layers"],
            "moe": {**c["params"]["layers"]["moe"], "router": router}}}
        _, aux = hidden_states(params, cfg, c["batch"])
        grads[remat] = torch.autograd.grad(aux, router)[0]
    assert grads[True].abs().max() > 0
    torch.testing.assert_close(grads[True], grads[False])


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("arch", STUB_ARCHS)
def test_engine_refuses_stub_frontends(arch):
    """JAX's Engine fails on these configs with KeyError: 'embeds'; the
    port's says why, and invents no frontend."""
    cfg = ARCHS[arch].reduced()
    params = init_params(torch.Generator(), cfg)
    with pytest.raises(ValueError, match="embeddings"):
        Engine(cfg, params, ServeConfig(), device="cpu")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_serves_moe_drop_free_as_prefill(arch):
    """Greedy generation on a reduced MoE config (drop-free capacity): each
    generated id is the argmax of a prefill over the prompt and the ids
    before it."""
    cfg = dataclasses.replace(ARCHS[arch].reduced(), param_dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 7))
    ids = Engine(cfg, params, ServeConfig(max_new_tokens=3),
                 device="cpu").generate(prompts)
    seq = torch.from_numpy(prompts).long()
    for i in range(3):
        logits, _, _ = prefill(params, cfg, {"tokens": seq})
        np.testing.assert_array_equal(ids[:, i], logits.argmax(-1).numpy())
        seq = torch.cat([seq, torch.from_numpy(ids[:, i:i + 1]).long()], 1)
