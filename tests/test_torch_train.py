"""The port's training path against ``repro``'s on the CPU: the attention
backward, ``forward_train``'s loss and gradients, the optimizers, the data
pipeline, the train step, checkpoints across the two packages, and
``run_training`` with the coordinator.

Weights cross through ``bridge.params_from_numpy(_flatten(jax_params))``;
inputs are made with numpy from a seed. Tolerances: attention gradients
2e-5 (fp32) and 2e-2 (bf16) of each gradient's largest magnitude, 1e-10
against fp64 autograd; model loss rtol 1e-5 and gradients 1e-4 of each
leaf's largest magnitude (fp32; the frameworks sum in other orders);
optimizer states 1e-5 (fp32, one framework's scalar rounding against the
other's); losses over train steps rtol 1e-4.
"""

import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import randomise_norms_and_biases
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import forward_train as jforward_train
from repro.models import init_params as jinit_params
from repro.models import layers as jl
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.checkpoint import _flatten
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import train_step as jtrain_step
from repro_torch.bridge import params_from_numpy, tree_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.coord.registry import ClusterRegistry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import run_training
from repro_torch.models import forward_train, init_params
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (init_train_state, loss_and_grads,
                                          train_step)


def rand(rng, shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def flat(tree, prefix=""):
    """{key path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def close_rel(got, want, tol, name="", scale=None):
    """|got - want| <= tol x ``scale`` (default max |want|), elementwise."""
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    if scale is None:
        scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=name)


# ------------------------------------------------------ attention backward
ATTN_CASES = [
    # (B, S, H, Hkv, hd, window); the backward's chunks are 512 query rows
    (2, 70, 4, 2, 16, None),         # GQA, one chunk
    (1, 100, 4, 4, 8, 17),           # a window
    (1, 600, 2, 1, 16, None),        # S not a multiple of 512: ragged chunk
    (1, 1100, 2, 1, 8, 40),          # window narrower than a chunk, 3 chunks
    (1, 1100, 6, 2, 8, 700),         # window wider than a chunk
]


def attn_inputs(b, s, h, hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rand(rng, (b, s, h, hd), 1.0), rand(rng, (b, s, hkv, hd), 1.0),
            rand(rng, (b, s, hkv, hd)), rand(rng, (b, s, h, hd)))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bwd_matches_fp64_autograd(case):
    """The backward's algebra, exactly: fp64 autograd through the plain
    forward."""
    b, s, h, hkv, hd, window = case
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in attn_inputs(b, s, h, hkv, hd, 0))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_plain(*leaves, window).backward(do)
    got = fa.flash_attention_bwd(q, k, v, do, window)
    for name, g, leaf in zip("qkv", got, leaves):
        assert g.dtype == torch.float64
        close_rel(g, leaf.grad.numpy(), 1e-10, f"d{name}")


def test_attention_bwd_needs_equal_lengths():
    """The backward is for training, where queries and keys are the same
    positions; Sq != Sk raises rather than giving rows with no key."""
    rng = np.random.default_rng(5)
    q, do = (torch.from_numpy(rand(rng, (1, 30, 2, 8))) for _ in range(2))
    k, v = (torch.from_numpy(rand(rng, (1, 10, 1, 8))) for _ in range(2))
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.flash_attention_bwd(q, k, v, do, 4)


@functools.cache
def jax_attention_vjp(case, dtype):
    """JAX's gradient of the model's attention (repeat_kv, then
    causal_attention_ref with its 512-row chunks)."""
    b, s, h, hkv, hd, window = case
    q, k, v, do = attn_inputs(b, s, h, hkv, hd, 1)
    jd = getattr(jnp, dtype)

    def attend(q, k, v):
        return jl.causal_attention_ref(q, jl.repeat_kv(k, h // hkv),
                                       jl.repeat_kv(v, h // hkv),
                                       window=window)
    _, vjp = jax.vjp(attend, *(jnp.asarray(a, jd) for a in (q, k, v)))
    return (q, k, v, do), [np.asarray(g, np.float32)
                           for g in vjp(jnp.asarray(do, jd))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES[:3])
def test_attention_bwd_matches_jax_vjp(case, dtype):
    (q, k, v, do), want = jax_attention_vjp(case, dtype)
    td = getattr(torch, dtype)
    got = fa.flash_attention_bwd(*(torch.from_numpy(a).to(td)
                                   for a in (q, k, v, do)), case[5])
    tol = 2e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == td
        close_rel(g, w, tol, f"d{name}")


def test_ops_routes_training_through_the_function(monkeypatch):
    """With grad on, the CPU path too runs FlashAttentionFn, and backward
    calls flash_attention_bwd (not autograd through the plain version);
    with grad off the output has no graph."""
    q, k, v, do = (torch.from_numpy(a)
                   for a in attn_inputs(1, 20, 4, 2, 8, 2))
    q.requires_grad_(True)
    calls = []
    real = fa.flash_attention_bwd
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        lambda *a: calls.append(1) or real(*a))
    out = ops.flash_attention(q, k, v)
    assert isinstance(out.grad_fn, fa.FlashAttentionFn._backward_cls)
    out.backward(do)
    assert calls == [1] and q.grad is not None
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    assert ops.flash_attention(q, k, v, impl="reference").grad_fn is not None


# ------------------------------------------------------------------ model
def model_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
    return {"tokens": tokens, "labels": labels}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


@pytest.fixture(scope="module", params=[("qwen3-8b", 24),
                                        ("h2o-danube-1.8b", 40)],
                ids=["qwen3-8b", "h2o-danube-windowed"])
def model_case(request):
    """JAX's loss and gradients for a reduced fp32 config (h2o-danube's
    window, 16, is shorter than its 40 tokens), and the port's params."""
    name, s = request.param
    jcfg, tcfg = (dataclasses.replace(a[name].reduced(), param_dtype="float32")
                  for a in (JAX_ARCHS, ARCHS))
    jparams = randomise_norms_and_biases(
        jinit_params(jax.random.PRNGKey(0), jcfg), 1)
    batch = model_batch(jcfg, 2, s, 3)
    loss, grads = jax.jit(jax.value_and_grad(jforward_train), static_argnums=1)(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"cfg": tcfg, "params": params_from_numpy(_flatten(jparams), tcfg,
                                                     "cpu"),
            "batch": torch_batch(batch), "loss": float(loss),
            "grads": _flatten(grads)}


def test_forward_train_loss_and_grads_match_jax(model_case):
    c = model_case
    loss, grads = loss_and_grads(c["params"], c["cfg"], c["batch"])
    np.testing.assert_allclose(float(loss), c["loss"], rtol=1e-5)
    got = flat(grads)
    assert sorted(got) == sorted(c["grads"])
    for key, want in c["grads"].items():
        g = got[key]
        assert g is not None and g.abs().max() > 0, f"{key}: no gradient"
        close_rel(g, want, 1e-4, key)


def test_stacked_leaf_autograd_agrees(model_case):
    """Plain autograd through the stacked leaves (each layer a slice) gives
    the gradients of ``loss_and_grads``'s per-layer leaves, with and without
    remat."""
    c = model_case
    _, want = loss_and_grads(c["params"], c["cfg"], c["batch"])
    want = flat(want)
    for remat in (True, False):
        cfg = dataclasses.replace(c["cfg"], remat=remat)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in flat(c["params"]).items()}
        tree = {}
        for key, leaf in leaves.items():
            *path, name = key.split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[name] = leaf
        loss = forward_train(tree, cfg, c["batch"])
        got = torch.autograd.grad(loss, list(leaves.values()))
        for key, g in zip(leaves, got):
            close_rel(g, want[key].numpy(), 1e-6, f"{key}, remat={remat}")


@functools.cache
def loss_shape_case():
    cfg = ArchConfig(name="loss-shapes", family="dense", n_layers=1,
                     d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                     vocab_size=64, param_dtype="float32")
    jcfg = JAX_ARCHS["qwen3-8b"].__class__(**dataclasses.asdict(cfg))
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jparams, params_from_numpy(_flatten(jparams), cfg,
                                                 "cpu")


@pytest.mark.parametrize("s", [1500, 2500])
def test_loss_chunks_accepted_as_in_jax(s):
    cfg, jcfg, jparams, params = loss_shape_case()
    batch = model_batch(cfg, 1, s, 4)
    want = jforward_train(jparams, jcfg,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = forward_train(params, cfg, torch_batch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loss_chunks_rejected_as_in_jax():
    """S = 2049: two chunks of 1024 do not cover it; JAX fails to reshape,
    the port raises a ValueError that names the chunking."""
    cfg, jcfg, jparams, params = loss_shape_case()
    batch = model_batch(cfg, 1, 2049, 5)
    with pytest.raises(TypeError):
        jforward_train(jparams, jcfg,
                       {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="2 chunks of 1024"):
        with torch.no_grad():
            forward_train(params, cfg, torch_batch(batch))


def test_rwkv_training_raises():
    cfg = ARCHS["rwkv6-3b"].reduced()
    params = init_params(torch.Generator(), cfg)
    with pytest.raises(NotImplementedError, match="gradient for the WKV6"):
        forward_train(params, cfg, torch_batch(model_batch(cfg, 1, 8, 0)))


# -------------------------------------------------------- optimizer, data
def opt_tree(seed):
    """A model-shaped tree: stacked (L, d) norms, a stacked matrix, an
    unstacked (d,) norm and an embedding."""
    rng = np.random.default_rng(seed)
    return {"embed": rand(rng, (16, 8)), "final_norm": 1 + rand(rng, (8,)),
            "layers": {"ln1": 1 + rand(rng, (3, 8)),
                       "mlp": {"w_up": rand(rng, (3, 8, 12))}}}


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def ttree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("name,compress", [("adamw", "none"),
                                           ("adamw", "int8_ef"),
                                           ("adafactor", "none"),
                                           ("adafactor", "int8_ef")])
def test_optimizer_matches_jax(name, compress):
    """Four steps of apply_updates (clip, compress, update) on the same
    trees; the clip bites on the first step (norm > 1). The error-feedback
    buffers are differences of two near-equal fp32 numbers (a clipped
    gradient and its int8 value), so they are held to 1e-5 of the largest
    clipped gradient: one ulp of it, not of the buffer."""
    kw = dict(name=name, lr=0.05, warmup_steps=2, total_steps=10,
              compress=compress)
    jcfg, tcfg = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    params = opt_tree(0)
    jp, tp = jtree(params), ttree(params)
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, tcfg)
    for step in range(4):
        g = jax.tree.map(lambda a: a * (4.0 if step == 0 else 0.3),
                         opt_tree(step + 1))
        jp, js, jn = jopt.apply_updates(jtree(g), js, jp, jcfg, step)
        tp, ts, tn = topt.apply_updates(ttree(g), ts, tp, tcfg, step)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    clipped = max(float(jnp.abs(x).max()) for x in jax.tree.leaves(
        jopt.clip_by_global_norm(jtree(g), 1.0)[0]))
    for key, want in _flatten({"p": jp, "s": js}).items():
        got = flat({"p": tp, "s": ts})[key]
        close_rel(got, want, 1e-5, key,
                  clipped if key.startswith("s/ef/") else None)


def test_stacked_norms_are_decayed_as_in_jax():
    """Weight decay reaches every leaf of 2+ axes: the stacked (L, d) ln1
    moves under zero gradients, the (d,) final norm does not."""
    cfg = topt.OptConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    params = ttree(opt_tree(0))
    before = {k: v.clone() for k, v in flat(params).items()}
    zeros = topt.tree_map(torch.zeros_like, params)
    topt.apply_updates(zeros, topt.init_opt_state(params, cfg), params, cfg,
                       0)
    after = flat(params)
    assert not torch.equal(after["layers/ln1"], before["layers/ln1"])
    assert torch.equal(after["final_norm"], before["final_norm"])


def test_clip_and_quantize_match_jax():
    g = opt_tree(7)
    jc, jn = jopt.clip_by_global_norm(jtree(g), 1.0)
    tc, tn = topt.clip_by_global_norm(ttree(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for key, want in _flatten(jc).items():
        close_rel(flat(tc)[key], want, 1e-6, key)
    x = g["layers"]["mlp"]["w_up"]
    jq, js = jopt.quantize_int8(jnp.asarray(x))
    tq, ts = topt.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)


def test_lr_schedule_matches_jax():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 5, 9, 10, 11, 50, 99, 150):
        np.testing.assert_allclose(
            topt.lr_schedule(topt.OptConfig(**cfg), step),
            float(jopt.lr_schedule(jopt.OptConfig(**cfg), step)), rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-8b", "pixtral-12b"])
def test_synth_batch_bit_equal(arch):
    shape = (ShapeConfig("t", "train", 33, 4), JaxShapeConfig("t", "train",
                                                              33, 4))
    for step in (0, 7):
        got = tdata.synth_batch(ARCHS[arch], shape[0], step,
                                tdata.DataConfig(seed=3))
        want = jdata.synth_batch(JAX_ARCHS[arch], shape[1], step,
                                 jdata.DataConfig(seed=3))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = tdata.DataIterator(ARCHS[arch], shape[0], start_step=2)
    next(it)
    resumed = tdata.DataIterator.from_state(ARCHS[arch], shape[0], it.state())
    np.testing.assert_array_equal(next(resumed)["labels"],
                                  tdata.synth_batch(ARCHS[arch], shape[0],
                                                    3)["labels"])


# -------------------------------------------------------------- train step
SHAPE = (ShapeConfig("t", "train", 16, 4), JaxShapeConfig("t", "train", 16, 4))


def step_configs(accum):
    kw = dict(warmup_steps=2, total_steps=10, lr=1e-2)
    jcfg, tcfg = (dataclasses.replace(a["qwen3-8b"].reduced(),
                                      param_dtype="float32", grad_accum=accum)
                  for a in (JAX_ARCHS, ARCHS))
    return jcfg, tcfg, jopt.OptConfig(**kw), topt.OptConfig(**kw)


@functools.cache
def jax_step_fn(accum):
    jcfg, _, jocfg, _ = step_configs(accum)
    return jax.jit(functools.partial(jtrain_step, cfg=jcfg, opt_cfg=jocfg))


def jax_run(state, accum, steps):
    """(state, losses) after ``steps`` JAX train steps from ``state``."""
    losses = []
    for _ in range(steps):
        batch = jdata.synth_batch(step_configs(accum)[0], SHAPE[1],
                                  int(state["step"]))
        state, m = jax_step_fn(accum)(state, jtree(batch))
        losses.append(float(m["loss"]))
    return state, losses


def torch_run(state, accum, steps):
    _, tcfg, _, tocfg = step_configs(accum)
    losses = []
    for _ in range(steps):
        batch = tdata.synth_batch(tcfg, SHAPE[0], state["step"])
        state, m = train_step(state, batch, tcfg, tocfg)
        losses.append(float(m["loss"]))
    return state, losses


def jax_state(accum):
    jcfg, _, jocfg, _ = step_configs(accum)
    return jinit_train_state(jax.random.PRNGKey(0), jcfg, jocfg)


def state_from_jax(jstate, accum):
    """The port's train state holding JAX's values."""
    _, tcfg, _, tocfg = step_configs(accum)
    template = init_train_state(torch.Generator(), tcfg, tocfg)
    return tree_from_numpy(_flatten(jstate), template)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    jstate = jax_state(accum)
    state = state_from_jax(jstate, accum)
    _, want = jax_run(jstate, accum, 3)
    state, got = torch_run(state, accum, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert state["step"] == 3


def test_train_step_grad_dtypes_and_norm():
    """grad_accum 1 keeps the grads in the parameters' dtype, as JAX's
    value_and_grad does; the step's grad norm is the clip's input."""
    _, tcfg, _, tocfg = step_configs(1)
    tcfg = dataclasses.replace(tcfg, param_dtype="bfloat16")
    state = init_train_state(torch.Generator().manual_seed(0), tcfg, tocfg)
    batch = tdata.synth_batch(tcfg, SHAPE[0], 0)
    _, grads = loss_and_grads(state["params"], tcfg,
                              {k: torch.from_numpy(v).long()
                               for k, v in batch.items()})
    assert grads["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert grads["layers"]["ln1"].dtype == torch.float32
    norm = torch.sqrt(sum(g.float().square().sum()
                          for g in topt.leaves(grads)))
    _, m = train_step(state, batch, tcfg, tocfg)
    np.testing.assert_allclose(float(m["grad_norm"]), float(norm), rtol=1e-5)


def test_checkpoint_jax_to_port_and_back():
    """JAX trains 2 steps and saves; the port restores and trains 2 more,
    against JAX's own continuation. Then the reverse: the port saves, JAX
    restores and continues, against the port's continuation."""
    jcfg, tcfg, jocfg, tocfg = step_configs(1)
    with tempfile.TemporaryDirectory() as d:
        jstate, _ = jax_run(jax_state(1), 1, 2)
        manifest = jckpt.save_checkpoint(d + "/jax", 2, jstate)
        template = init_train_state(torch.Generator(), tcfg, tocfg)
        state = tckpt.restore_checkpoint(template, manifest)
        assert state["step"] == 2
        assert state["opt"]["m"]["embed"].abs().max() > 0
        state, got = torch_run(state, 1, 2)
        _, want = jax_run(jstate, 1, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4)

        manifest = tckpt.save_checkpoint(d + "/torch", 4, state)
        assert tckpt.verify_checkpoint(manifest)
        assert sorted(np.load(manifest["path"] + "/arrays.npz").files) == \
            sorted(_flatten(jstate))
        jtemplate = jax.eval_shape(functools.partial(
            jinit_train_state, jax.random.PRNGKey(0), jcfg, jocfg))
        jstate = jckpt.restore_checkpoint(jtemplate, manifest)
        assert int(jstate["step"]) == 4
        _, want = torch_run(state, 1, 2)
        _, got = jax_run(jstate, 1, 2)
        np.testing.assert_allclose(got, want, rtol=1e-4)


# ------------------------------------------------------------ run_training
TINY = ArchConfig(
    name="sys-tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512, grad_accum=1,
    param_dtype="float32")
RUN_SHAPE = ShapeConfig("s", "train", 32, 4)


def test_run_training_resume_is_deterministic():
    """6 straight steps == 3 steps + commit + restore + 3 steps."""
    with tempfile.TemporaryDirectory() as d:
        full = run_training(TINY, RUN_SHAPE, 6, d + "/a", ckpt_every=100,
                            registry=ClusterRegistry(), log_every=100,
                            device="cpu")
        reg = ClusterRegistry()
        run_training(TINY, RUN_SHAPE, 3, d + "/b", ckpt_every=3,
                     registry=reg, log_every=100, device="cpu")
        resumed = run_training(TINY, RUN_SHAPE, 6, d + "/b", ckpt_every=100,
                               registry=reg, log_every=100, device="cpu")
    assert len(resumed["losses"]) == 3
    np.testing.assert_allclose(full["losses"][3:], resumed["losses"],
                               rtol=1e-4)


def test_train_through_failover_then_serve_committed_version():
    """Train -> coordinator failover -> checkpoint -> serve the committed
    version, against one replicated control plane; leased reads cost no
    messages beyond the heartbeats around the failover."""
    reg = ClusterRegistry()
    with tempfile.TemporaryDirectory() as d:
        out = run_training(TINY, RUN_SHAPE, 6, d, ckpt_every=3, registry=reg,
                           failover_at=2, log_every=100, device="cpu")
        assert len(out["losses"]) == 6
        manifest = reg.latest_checkpoint()
        assert manifest is not None and manifest["step"] == 6
        assert tckpt.verify_checkpoint(manifest)
        eng = Engine(TINY, out["state"]["params"],
                     ServeConfig(max_new_tokens=3), registry=reg,
                     device="cpu")
        assert eng.model_version["step"] == 6
        assert eng.generate(np.zeros((2, 4), np.int32)).shape == (2, 3)
    stats = reg.coord.stats()
    assert stats["reads"] > 0
    assert stats["read_messages"] <= 2, stats


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_training(TINY, RUN_SHAPE, 1, d)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--preset", "tiny", "--ckpt-dir", d])


def test_train_cli_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        out = train_cli.main(["--preset", "tiny", "--steps", "2", "--seq",
                              "16", "--batch", "2", "--ckpt-dir", d,
                              "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "checkpoint step 2 committed" in capsys.readouterr().out
