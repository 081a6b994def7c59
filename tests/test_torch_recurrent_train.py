"""Training through the port's two recurrences, WKV6 (rwkv6-3b) and the
fused Mamba scan (hymba-1.5b), against the JAX package on the CPU.

Each recurrence trains through a ``torch.autograd.Function``: its forward
is the kernel's wrapper run chunk by chunk from zeros (on the CPU the
plain loop), keeping the state at every 256-step boundary as JAX's
``chunked_time_scan`` does; its backward recomputes each chunk in a
chunked form and carries the state's gradient backwards. Here:

* ``wkv6_bwd`` and ``mamba_scan_bwd`` against ``jax.vjp`` of JAX's
  ``chunked_time_scan`` of ``wkv_step`` and of ``apply_mamba``'s ``step``
  (with its softplus, skip and gating), at S = 40 (one plain scan), 300
  (a ragged last chunk; JAX scans it unchunked) and 512 (two remat
  chunks): fp32 within 2e-5 and bf16 within 2e-2 of each gradient's
  largest magnitude;
* both against fp64 autograd through the port's plain loops (1e-10: the
  algebra, exactly);
* ``ops`` routes through the Functions under autograd, and only there,
  and the card's wrappers, which fill their outputs outside autograd, no
  longer cut the gradient (their launch is stubbed here);
* one train step of reduced fp32 rwkv6-3b and hymba-1.5b against JAX's,
  and both families through ``launch.train`` on the CPU, with a resume.

``forward_train``'s loss and every gradient leaf of both families against
``jax.value_and_grad`` are ``model_case`` rows of tests/test_torch_train.py.
Inputs are made with numpy from a seed.
"""

import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import mamba_inputs, rand, wkv_inputs
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import ssm as jssm
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.checkpoint import _flatten
from repro.train.train_step import init_train_state as jinit_train_state
from repro.train.train_step import train_step as jtrain_step
from repro_torch.bridge import tree_from_numpy
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.coord.registry import ClusterRegistry
from repro_torch.kernels import mamba_scan as mamba_mod
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.launch import train as train_cli
from repro_torch.launch.train import run_training
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import init_train_state, train_step

LENGTHS = [40, 300, 512]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FAMILIES = ["rwkv6-3b", "hymba-1.5b"]


def close_rel(got, want, tol, name=""):
    """|got - want| <= tol x max |want|, elementwise."""
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                               atol=tol * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------ WKV6
WKV_SHAPE = (2, 3, 16)          # B, H, hd


def wkv_case(s, seed):
    """r, k, v, w (B, S, H, hd), u (H, hd), and the gradients of y and of
    the final state, float32."""
    b, h, hd = WKV_SHAPE
    r, k, v, w, u = wkv_inputs((b, s, h, hd), seed)
    rng = np.random.default_rng(seed + 1)
    return (r, k, v, w, u), rand(rng, (b, s, h, hd), 1.0), \
        rand(rng, (b, h, hd, hd), 1.0)


def jax_wkv(r, k, v, w, u):
    """JAX's recurrence as apply_rwkv_tmix runs it: chunked_time_scan of
    wkv_step from zeros over (S, B, H, hd). Returns (y, final state)."""
    b, _, h, hd = r.shape
    seq = tuple(t.transpose(1, 0, 2, 3) for t in (r, k, v, w))
    final, ys = jssm.chunked_time_scan(
        lambda st, x: jssm.wkv_step(st, x, u),
        jnp.zeros((b, h, hd, hd), jnp.float32), seq)
    return ys.transpose(1, 0, 2, 3), final


@pytest.mark.parametrize("s", LENGTHS)
def test_wkv6_bwd_matches_jax_vjp(s):
    inputs, dy, dstate = wkv_case(s, s)
    (y, final), vjp = jax.vjp(jax_wkv, *(jnp.asarray(t) for t in inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    tin = [torch.from_numpy(t) for t in inputs]
    got_y, got_final, starts = wkv6_mod.wkv6_chunk_states(*tin)
    assert starts.shape == (2, -(-s // 256), 3, 16, 16)
    close_rel(got_y, y, TOL["float32"], "y")
    close_rel(got_final, final, TOL["float32"], "final state")
    got = wkv6_mod.wkv6_bwd(*tin, starts, torch.from_numpy(dy),
                            torch.from_numpy(dstate))
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        close_rel(g, w, TOL["float32"], name)


@pytest.mark.parametrize("s", [40, 300])
def test_wkv6_bwd_matches_fp64_autograd(s):
    """The backward's algebra, exactly: fp64 autograd through the plain
    loop, with decays near 1, near 0 and exactly 1."""
    inputs, dy, dstate = wkv_case(s, s + 7)
    r, k, v, w, u = (torch.from_numpy(t).double() for t in inputs)
    w[:, ::5, :, ::3] = 1.0
    w[:, 1::7] = w[:, 1::7] ** 40
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    dy, dstate = torch.from_numpy(dy).double(), \
        torch.from_numpy(dstate).double()
    torch.autograd.backward(wkv6_mod.wkv6_plain(*leaves), (dy, dstate))
    _, _, starts = wkv6_mod.wkv6_chunk_states(r, k, v, w, u)
    got = wkv6_mod.wkv6_bwd(r, k, v, w, u, starts, dy, dstate)
    for name, g, leaf in zip(("dr", "dk", "dv", "dw", "du"), got, leaves):
        assert g.dtype == torch.float64
        close_rel(g, leaf.grad.numpy(), 1e-10, name)


def test_wkv6_bwd_through_underflowing_decays():
    """The model's decay, w = exp(-exp(x)), underflows to 0 in fp32 where
    exp(x) > ~104. wkv6_bwd works in clamped log decays, so there dw is 0
    (the plain loop's dw is not), but the gradient that reaches x, dw *
    dw/dx with dw/dx = -w exp(x) = 0, is the plain loop's: every input's
    gradient through the decay, x's included, within 2e-5 (fp32)."""
    b, s, h, hd = 2, 300, 3, 16
    rng = np.random.default_rng(11)
    r, k, v = (torch.from_numpy(rand(rng, (b, s, h, hd))) for _ in range(3))
    x = torch.from_numpy(rand(rng, (b, s, h, hd), 2.0) - 5.0)
    x.view(-1)[::97] = 6.0
    u = torch.from_numpy(rand(rng, (h, hd)))
    dy = torch.from_numpy(rand(rng, (b, s, h, hd), 1.0))
    assert int((torch.exp(-torch.exp(x)) == 0).sum()) >= 100

    def grads(impl):
        leaves = [t.clone().requires_grad_(True) for t in (r, k, v, x, u)]
        r_, k_, v_, x_, u_ = leaves
        ops.wkv6(r_, k_, v_, torch.exp(-torch.exp(x_)), u_,
                 impl=impl)[0].backward(dy)
        return [t.grad for t in leaves]
    for name, g, w in zip(("dr", "dk", "dv", "dx", "du"), grads("kernel"),
                          grads("reference")):
        close_rel(g, w.numpy(), TOL["float32"], name)


# ------------------------------------------------------------ Mamba scan
MAMBA_SHAPE = (2, 24, 8)        # B, di, n


def mamba_case(s, seed):
    """The fused scan's float32 inputs (dt_raw, dt_bias, b, c, x, z,
    a_log, d_skip), the start state's absence (training runs from zeros),
    and the gradients of out and of the final state."""
    bsz, di, n = MAMBA_SHAPE
    dt_raw, dt_bias, bc, x, zz, a_log, d_skip, _ = mamba_inputs(
        bsz, s, di, n, seed, carried=False)
    rng = np.random.default_rng(seed + 1)
    inputs = (dt_raw, dt_bias, bc[..., :n], bc[..., n:], x, zz[..., di:],
              a_log, d_skip)
    return inputs, rand(rng, (bsz, s, di), 1.0), rand(rng, (bsz, di, n), 1.0)


# the inputs in the model's dtype: dt_raw, b, c, x, z
SEQ_ARGS = (0, 2, 3, 4, 5)


def jax_mamba(dt_raw, dt_bias, b, c, x, z, a_log, d_skip):
    """JAX's pieces of apply_mamba from dt_raw to the gated output, as
    they stand there (ssm.py:198-220): the softplus with the bias, its
    ``step`` (a closure there, written out here) scanned from zeros by
    chunked_time_scan, the d_skip term and the gating in the model's
    dtype. Returns (out, final state)."""
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


def as_dtype(inputs, dtype, lib):
    """The inputs with the sequence tensors in ``dtype`` (jnp or torch)."""
    if lib == "jax":
        return [jnp.asarray(t, getattr(jnp, dtype)) if i in SEQ_ARGS
                else jnp.asarray(t) for i, t in enumerate(inputs)]
    return [torch.from_numpy(t).to(getattr(torch, dtype)) if i in SEQ_ARGS
            else torch.from_numpy(t) for i, t in enumerate(inputs)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", LENGTHS)
def test_mamba_scan_bwd_matches_jax_vjp(s, dtype):
    inputs, dout, dh = mamba_case(s, s)
    jd = getattr(jnp, dtype)
    (out, final), vjp = jax.vjp(jax_mamba, *as_dtype(inputs, dtype, "jax"))
    want = vjp((jnp.asarray(dout, jd), jnp.asarray(dh)))
    tin = as_dtype(inputs, dtype, "torch")
    got_out, got_final, starts = mamba_mod.mamba_chunk_states(*tin)
    assert starts.shape == (2, -(-s // 256), 24, 8)
    close_rel(got_out, np.asarray(out, np.float32), TOL[dtype], "out")
    close_rel(got_final, final, TOL["float32"], "final state")
    got = mamba_mod.mamba_scan_bwd(
        *tin, starts, torch.from_numpy(dout).to(got_out.dtype),
        torch.from_numpy(dh))
    names = ("d dt", "d dt_bias", "db", "dc", "dx", "dz", "d a_log",
             "d d_skip")
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        assert g.dtype == tin[i].dtype and g.shape == w.shape, name
        close_rel(g, np.asarray(w, np.float32), TOL[dtype], name)


@pytest.mark.parametrize("s", [40, 300])
def test_mamba_scan_bwd_matches_fp64_autograd(s):
    """The backward's algebra, exactly: fp64 autograd through the plain
    loop (softplus past its threshold included)."""
    inputs, dout, dh = mamba_case(s, s + 7)
    args = [torch.from_numpy(t).double() for t in inputs]
    leaves = [t.clone().requires_grad_(True) for t in args]
    dout, dh = torch.from_numpy(dout).double(), torch.from_numpy(dh).double()
    torch.autograd.backward(mamba_mod.mamba_scan_plain(*leaves), (dout, dh))
    _, _, starts = mamba_mod.mamba_chunk_states(*args)
    got = mamba_mod.mamba_scan_bwd(*args, starts, dout, dh)
    for i, (g, leaf) in enumerate(zip(got, leaves)):
        assert g.dtype == torch.float64
        close_rel(g, leaf.grad.numpy(), 1e-10, f"input {i}")


@pytest.mark.parametrize("name", ["wkv6", "mamba_scan"])
def test_bwd_recompute_groups_agree(name):
    """The backward recomputes kept chunks in groups of up to ``steps``
    steps (a ragged last chunk alone) and carries the state's gradient
    between and within groups: one chunk a group, two, and all at once
    give the same gradients (fp64, 1e-12)."""
    s = 4 * 256 + 44
    if name == "wkv6":
        inputs, dout, dfinal = wkv_case(s, 5)
        mod, bwd, states = wkv6_mod, wkv6_mod.wkv6_bwd, \
            wkv6_mod.wkv6_chunk_states
    else:
        inputs, dout, dfinal = mamba_case(s, 5)
        mod, bwd, states = mamba_mod, mamba_mod.mamba_scan_bwd, \
            mamba_mod.mamba_chunk_states
    args = [torch.from_numpy(t).double() for t in inputs]
    dout, dfinal = torch.from_numpy(dout).double(), \
        torch.from_numpy(dfinal).double()
    starts = states(*args)[2]
    assert starts.shape[1] == 5 and mod.TIME_CHUNK == 256
    want = bwd(*args, starts, dout, dfinal, steps=256)
    for steps in (512, 4096):
        got = bwd(*args, starts, dout, dfinal, steps=steps)
        for i, (g, w) in enumerate(zip(got, want)):
            close_rel(g, w.numpy(), 1e-12, f"steps={steps}, input {i}")


# --------------------------------------------------------------- routing
def wkv_tensors(s=40, seed=3):
    inputs, dy, _ = wkv_case(s, seed)
    return [torch.from_numpy(t) for t in inputs], torch.from_numpy(dy)


def mamba_tensors(s=40, seed=3):
    inputs, dout, _ = mamba_case(s, seed)
    return [torch.from_numpy(t) for t in inputs], torch.from_numpy(dout)


# per recurrence: (its inputs, its module, the wrapper's name, the
# Function, the backward's name, the ops entry, a state of the right shape)
RECURRENCES = {
    "wkv6": (wkv_tensors, wkv6_mod, "wkv6", "Wkv6Fn", "wkv6_bwd", "wkv6",
             lambda a: torch.zeros(2, 3, 16, 16)),
    "mamba_scan": (mamba_tensors, mamba_mod, "mamba_scan", "MambaScanFn",
                   "mamba_scan_bwd", "mamba_scan",
                   lambda a: torch.zeros(2, 24, 8)),
}


@pytest.mark.parametrize("name", RECURRENCES)
def test_ops_routes_training_through_the_functions(name, monkeypatch):
    """With grad on and an input that requires grad, ops runs the Function
    and backward calls its backward (not autograd through the plain loop);
    without an input that requires grad, under no_grad, and with
    impl="reference", it does not; a state given under autograd raises."""
    make, mod, _, fn_name, bwd_name, op, state = RECURRENCES[name]
    args, dout = make()
    args[0].requires_grad_(True)
    calls = []
    real = getattr(mod, bwd_name)
    monkeypatch.setattr(mod, bwd_name,
                        lambda *a: calls.append(1) or real(*a))
    out, _ = getattr(ops, op)(*args)
    assert isinstance(out.grad_fn, getattr(mod, fn_name)._backward_cls)
    out.backward(dout)
    assert calls == [1] and args[0].grad is not None
    with torch.no_grad():
        assert getattr(ops, op)(*args)[0].grad_fn is None
    ref = getattr(ops, op)(*args, impl="reference")[0]
    assert ref.grad_fn is not None and not isinstance(
        ref.grad_fn, getattr(mod, fn_name)._backward_cls)
    with pytest.raises(ValueError, match="zero state"):
        getattr(ops, op)(*args, state(args))
    args[0].requires_grad_(False)
    assert getattr(ops, op)(*args)[0].grad_fn is None


@pytest.mark.parametrize("name", RECURRENCES)
def test_kernel_outputs_carry_the_gradient(name, monkeypatch):
    """The card's wrappers fill a fresh tensor through ctypes, outside
    autograd. Stubbed so here (the plain version under no_grad, counting
    its launches), ``ops`` must still give an output with a grad_fn whose
    backward matches autograd through the plain loop: the gradient is not
    cut at the kernel."""
    make, mod, wrapper, _, _, op, _ = RECURRENCES[name]
    plain = getattr(mod, f"{wrapper}_plain")
    launches = []

    def kernel(*a):
        launches.append(1)
        with torch.no_grad():
            return plain(*a)
    monkeypatch.setattr(mod, wrapper, kernel)
    args, dout = make(s=300)
    leaves = [t.clone().requires_grad_(True) for t in args]
    out, _ = getattr(ops, op)(*leaves)
    assert launches and out.grad_fn is not None
    out.backward(dout)
    want = [t.clone().requires_grad_(True) for t in args]
    plain(*want)[0].backward(dout)
    for i, (got, ref) in enumerate(zip(leaves, want)):
        assert got.grad is not None, f"input {i}: no gradient"
        close_rel(got.grad, ref.grad.numpy(), 1e-5, f"input {i}")


# ------------------------------------------------------------ train step
SHAPE = (ShapeConfig("t", "train", 16, 4), JaxShapeConfig("t", "train", 16, 4))


def step_configs(arch):
    kw = dict(warmup_steps=2, total_steps=10, lr=1e-2)
    jcfg, tcfg = (dataclasses.replace(a[arch].reduced(),
                                      param_dtype="float32")
                  for a in (JAX_ARCHS, ARCHS))
    return jcfg, tcfg, jopt.OptConfig(**kw), topt.OptConfig(**kw)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    """Two steps from JAX's initial state: the losses (the second after one
    AdamW update) within rtol 1e-4."""
    jcfg, tcfg, jocfg, tocfg = step_configs(arch)
    jstate = jinit_train_state(jax.random.PRNGKey(0), jcfg, jocfg)
    state = tree_from_numpy(_flatten(jstate), init_train_state(
        torch.Generator(), tcfg, tocfg))
    step = jax.jit(functools.partial(jtrain_step, cfg=jcfg, opt_cfg=jocfg))
    want, got = [], []
    for i in range(2):
        jstate, m = step(jstate, jax.tree.map(jnp.asarray, jdata.synth_batch(
            jcfg, SHAPE[1], i)))
        want.append(float(m["loss"]))
        state, m = train_step(state, tdata.synth_batch(tcfg, SHAPE[0], i),
                              tcfg, tocfg)
        got.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert state["step"] == 2


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_training_resumes(arch):
    """The smoke config: 4 straight steps == 2 steps + commit + restore + 2
    steps."""
    cfg, shape = ARCHS[arch].reduced(), ShapeConfig("s", "train", 16, 2)
    with tempfile.TemporaryDirectory() as d:
        full = run_training(cfg, shape, 4, d + "/a", ckpt_every=100,
                            registry=ClusterRegistry(), log_every=100,
                            device="cpu")
        reg = ClusterRegistry()
        run_training(cfg, shape, 2, d + "/b", ckpt_every=2, registry=reg,
                     log_every=100, device="cpu")
        resumed = run_training(cfg, shape, 4, d + "/b", ckpt_every=100,
                               registry=reg, log_every=100, device="cpu")
    assert len(resumed["losses"]) == 2 and np.isfinite(full["losses"]).all()
    np.testing.assert_allclose(full["losses"][2:], resumed["losses"],
                               rtol=1e-4)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_smoke_on_cpu(arch, capsys):
    with tempfile.TemporaryDirectory() as d:
        out = train_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                              "--seq", "16", "--batch", "2", "--ckpt-dir", d,
                              "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert "checkpoint step 2 committed" in capsys.readouterr().out
    leaves = topt.leaves(out["state"]["opt"]["m"])
    assert all(bool(torch.isfinite(t).all()) for t in leaves)


def test_recurrent_state_leaves_are_fp32():
    """Both families' fp32 leaves (bridge.FP32_LEAVES) stay fp32 in a bf16
    train state, with fp32 optimizer moments and gradients in the
    parameters' dtypes."""
    from repro_torch.bridge import FP32_LEAVES
    from repro_torch.train.train_step import loss_and_grads
    for arch in FAMILIES:
        cfg = dataclasses.replace(ARCHS[arch].reduced(),
                                  param_dtype="bfloat16")
        state = init_train_state(torch.Generator().manual_seed(0), cfg,
                                 topt.OptConfig())
        batch = {k: torch.from_numpy(v).long() for k, v in
                 tdata.synth_batch(cfg, SHAPE[0], 0).items()}
        _, grads = loss_and_grads(state["params"], cfg, batch)
        layers = state["params"]["layers"]
        mixer = layers["tmix"] if cfg.attn_free else layers["mamba"]
        fp32 = [k for k in mixer if k in FP32_LEAVES]
        assert fp32, arch
        gmixer = grads["layers"]["tmix" if cfg.attn_free else "mamba"]
        for k, p in mixer.items():
            want = torch.float32 if k in FP32_LEAVES else torch.bfloat16
            assert p.dtype == want and gmixer[k].dtype == want, (arch, k)
            assert gmixer[k].abs().max() > 0, (arch, k)
