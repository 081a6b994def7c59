"""The two backward kernels' plain versions and operators on the CPU: the
attention backward from the training forward's output and row log-sum-exp
(``flash_attention_backward``), and the fused Mamba scan's
(``mamba_scan_backward``).

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
to these plain versions there). Here:

* the training forward's plain log-sum-exp against ``jax.nn.logsumexp``
  of JAX's masked, scaled scores (``causal_attention_ref``'s), for every
  ``ATTN_CASES`` row (fp32, 1e-5 absolute);
* the plain attention backward given out and lse (the kernel's rounding
  points: P from the log-sum-exp, D = rowsum(dO * out)) against fp64
  autograd through the plain forward (1e-10 of each gradient's largest
  magnitude) and against ``jax.vjp`` of JAX's attention (fp32 2e-5, bf16
  2e-2), also at the trained head dims 80 (GQA 4x, a window of S) and 96
  (MHA), the yardstick that the card holds the Hopper bodies to;
* on meta tensors, each new operator's fake shapes and dtypes, no launch,
  and its flop formula against a count by hand; the roofline counter files
  the backwards' flops under their Functions' backward regions;
* routing: a CPU tensor takes the plain version, another device raises.

Inputs are made with numpy from a seed.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import mamba_inputs
from repro.models import layers as jl
from repro_torch import roofline
from repro_torch.configs import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import ops
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import OptConfig
from test_torch_train import ATTN_CASES, VJP_CASES, attn_inputs, close_rel


def jax_lse(q, k, window):
    """JAX's scores as ``causal_attention_ref`` forms them (scaled, GQA by
    ``repeat_kv``, masked with -inf), their log-sum-exp over the keys:
    (B, H, Sq)."""
    h, hkv, hd = q.shape[2], k.shape[2], q.shape[3]
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q),
                   jl.repeat_kv(jnp.asarray(k), h // hkv)) / np.sqrt(hd)
    pos = jnp.arange(q.shape[1])
    mask = pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    return jax.nn.logsumexp(jnp.where(mask[None, None], s, -jnp.inf),
                            axis=-1)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_lse_matches_jax_logsumexp(case):
    b, s, h, hkv, hd, window = case
    q, k, v, _ = attn_inputs(b, s, h, hkv, hd, 3)
    out, lse = fa.flash_attention_train_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), window)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse(q, k, window)),
                               rtol=0, atol=1e-5)
    want = fa.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                    window)
    assert torch.equal(out, want)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_backward_from_lse_matches_fp64_autograd(case):
    """The kernel's algebra, exactly: P from the forward's log-sum-exp and
    D = rowsum(dO * out) give fp64 autograd's gradients."""
    b, s, h, hkv, hd, window = case
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in attn_inputs(b, s, h, hkv, hd, 4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_plain(*leaves, window).backward(do)
    out, lse = fa.flash_attention_train_plain(q, k, v, window)
    assert lse.dtype == torch.float64
    got = fa.flash_attention_backward(q, k, v, out, lse, do, window)
    for name, g, leaf in zip("qkv", got, leaves):
        assert g.dtype == torch.float64
        close_rel(g, leaf.grad.numpy(), 1e-10, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", VJP_CASES)
def test_plain_backward_from_lse_matches_jax_vjp(case, dtype):
    from test_torch_train import jax_attention_vjp
    (q, k, v, do), want = jax_attention_vjp(case, dtype)
    td = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(td) for a in (q, k, v, do))
    out, lse = fa.flash_attention_train(q, k, v, case[5])
    got = fa.flash_attention_backward(q, k, v, out, lse, do, case[5])
    tol = 2e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == td
        close_rel(g, w, tol, f"d{name}")


def test_function_saves_out_and_lse_off_the_cpu(monkeypatch):
    """Off the CPU (meta here) FlashAttentionFn runs the training forward,
    keeps out and the log-sum-exp, and its backward is
    ``flash_attention_backward`` (on the CPU it keeps q, k, v and calls
    ``flash_attention_bwd``: tests/test_torch_train.py)."""
    calls = []
    real = fa.flash_attention_backward
    monkeypatch.setattr(fa, "flash_attention_backward",
                        lambda *a: calls.append(a) or real(*a))
    q = torch.empty((2, 64, 4, 32), device="meta", requires_grad=True)
    k = torch.empty((2, 64, 2, 32), device="meta", requires_grad=True)
    out = ops.flash_attention(q, k, k, window=16)
    assert out.grad_fn.saved_tensors[4].shape == (2, 4, 64)
    out.backward(torch.empty(out.shape, device="meta"))
    assert len(calls) == 1 and calls[0][-1] == 16
    assert q.grad.shape == q.shape and k.grad.shape == k.shape


def attention_meta(window=16):
    q = torch.empty((2, 70, 4, 32), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 70, 2, 32), dtype=torch.bfloat16, device="meta")
    out = torch.empty(q.shape, dtype=q.dtype, device="meta")
    lse = torch.empty((2, 4, 70), device="meta")
    return q, k, out, lse


def scan_meta(s=300, di=16, n=8):
    dt_raw, dt_bias, bc, x, zz, a_log, d_skip, _ = mamba_inputs(
        2, s, di, n, 0, carried=False)
    args = [torch.from_numpy(t) for t in (dt_raw, dt_bias)] \
        + [torch.from_numpy(bc[..., :n]), torch.from_numpy(bc[..., n:])] \
        + [torch.from_numpy(t) for t in (x, zz[..., di:], a_log, d_skip)]
    args = [t.to(torch.bfloat16) if i in (0, 2, 3, 4, 5) else t
            for i, t in enumerate(args)]
    starts = torch.empty((2, -(-s // 256), di, n), device="meta")
    return [t.to("meta") for t in args], starts


def test_backward_fakes_give_the_plain_shapes_and_launch_nothing():
    """On meta tensors both backward operators (and the training forward)
    give their plain versions' shapes and dtypes, and nothing launches."""
    before = (fa.flash_attention.launches,
              fa.flash_attention_backward.launches,
              ms.mamba_scan_backward.launches)
    q, k, out, lse = attention_meta()
    got_out, got_lse = fa.flash_attention_train(q, k, k, 16)
    assert (got_out.shape, got_out.dtype) == (q.shape, q.dtype)
    assert (got_lse.shape, got_lse.dtype) == ((2, 4, 70), torch.float32)
    grads = fa.flash_attention_backward(q, k, k, out, lse, out, 16)
    for g, t in zip(grads, (q, k, k)):
        assert g.is_meta and (g.shape, g.dtype) == (t.shape, t.dtype)
    args, starts = scan_meta()
    dout = torch.empty(args[0].shape, dtype=args[0].dtype, device="meta")
    grads = ms.mamba_scan_backward(*args, starts, dout, None)
    assert len(grads) == 8
    for g, t in zip(grads, args):
        assert g.is_meta and (g.shape, g.dtype) == (t.shape, t.dtype)
    assert (fa.flash_attention.launches, fa.flash_attention_backward.launches,
            ms.mamba_scan_backward.launches) == before


def test_backward_flop_formulas_count_the_kernels_work():
    """``FlopCounterMode`` counts the attention backward as seven products
    over the visible pairs (dK/dV's four, dQ's three, S and dP recomputed)
    and the scan's as its vjp, 14 n + 15 a (token, channel), plus the
    forward it recomputes, 7 n + 10."""
    from torch.utils.flop_counter import FlopCounterMode
    q, k, out, lse = attention_meta()
    with FlopCounterMode(display=False) as counter:
        fa.flash_attention_backward(q, k, k, out, lse, out, 16)
    pairs = 16 * 17 // 2 + (70 - 16) * 16
    assert counter.get_total_flops() == 7 * 2 * 2 * 4 * 32 * pairs
    with FlopCounterMode(display=False) as counter:
        fa.flash_attention_train(q, k, k, 16)
    assert counter.get_total_flops() == 2 * 2 * 2 * 4 * 32 * pairs
    args, starts = scan_meta()
    dout = torch.empty(args[0].shape, dtype=args[0].dtype, device="meta")
    with FlopCounterMode(display=False) as counter:
        ms.mamba_scan_backward(*args, starts, dout, None)
    assert counter.get_total_flops() == \
        (14 * 8 + 15 + 7 * 8 + 10) * 16 * 2 * 300


@pytest.mark.parametrize("arch", ["qwen3-8b", "hymba-1.5b", "rwkv6-3b"])
def test_counter_files_backward_kernels_under_their_functions(arch):
    """A reduced train step on meta: each backward kernel launches once a
    layer and microbatch, its flops land in its Function's backward region
    (attention: 7/2 of the forward's, in the inputs' dtype; WKV6 and the
    scan: their formulas, in fp32), and the forwards stay in their own
    regions."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=2,
                              grad_accum=2)
    opt = OptConfig(name=cfg.optimizer, warmup_steps=2, total_steps=10)
    state = ts.init_train_state(torch.Generator().manual_seed(0), cfg, opt,
                                device="meta")
    batch = {k: torch.empty((4, 96), dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    counter = roofline.RooflineCounter()
    with counter:
        ts.train_step(state, batch, cfg, opt)
    got = counter.take()
    calls = {k: v["calls"] for k, v in got.kernels.items()}
    per = cfg.n_layers * cfg.grad_accum
    region = got.flops_by_region
    if cfg.attn_free:
        heads, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        assert calls["wkv6_backward"] == per
        assert region["Wkv6FnBackward"] == \
            16 * hd * hd * heads * 4 * 96 * cfg.n_layers
        assert "wkv6_backward" not in region
    else:
        assert calls["flash_attention"] == 2 * per
        assert calls["flash_attention_backward"] == per
        assert region["FlashAttentionFnBackward"] * 4 == \
            region["flash_attention"] * 7
    if cfg.hybrid_ssm:
        di, n = cfg.n_heads * cfg.hd, cfg.ssm_state
        assert calls["mamba_scan_backward"] == per
        assert region["MambaScanFnBackward"] == \
            (21 * n + 25) * di * 4 * 96 * cfg.n_layers
        assert "mamba_scan_backward" not in region


def test_backward_wrappers_route_by_device(monkeypatch):
    """A CPU tensor takes the plain version (through the module attribute,
    so a spy sees it); a device with no kernel raises."""
    calls = []
    real_fa, real_ms = fa.flash_attention_bwd, ms.mamba_scan_bwd
    monkeypatch.setattr(fa, "flash_attention_bwd",
                        lambda *a, **kw: calls.append("fa") or
                        real_fa(*a, **kw))
    monkeypatch.setattr(ms, "mamba_scan_bwd",
                        lambda *a: calls.append("ms") or real_ms(*a))
    q, k, v, do = (torch.from_numpy(a) for a in attn_inputs(1, 20, 4, 2, 8, 2))
    out, lse = fa.flash_attention_train(q, k, v)
    fa.flash_attention_backward(q, k, v, out, lse, do)
    dt_raw, dt_bias, bc, x, zz, a_log, d_skip, _ = mamba_inputs(
        2, 40, 16, 8, 1, carried=False)
    args = [torch.from_numpy(t) for t in (dt_raw, dt_bias)] \
        + [torch.from_numpy(bc[..., :8]), torch.from_numpy(bc[..., 8:])] \
        + [torch.from_numpy(t) for t in (x, zz[..., 16:], a_log, d_skip)]
    starts = ms.mamba_chunk_states(*args)[2]
    got = ms.mamba_scan_backward(*args, starts, args[4])
    assert calls == ["fa", "ms"] and len(got) == 8
    assert fa.flash_attention_backward.launches == 0
    assert ms.mamba_scan_backward.launches == 0
    other = types.SimpleNamespace(device=torch.device("mps"))
    with pytest.raises(ValueError, match="no kernel for mps"):
        fa.flash_attention_backward(other, k, v, out, lse, do)
    with pytest.raises(ValueError, match="no kernel for mps"):
        fa.flash_attention_train(other, k, v)
    with pytest.raises(ValueError, match="no kernel for mps"):
        ms.mamba_scan_backward(other, *args[1:], starts, args[4])
