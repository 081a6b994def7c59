"""The port's attention kernels against the JAX package's Pallas kernels
(interpret mode) and oracles. On the CPU the port's wrappers run their
plain versions; tests/test_torch_cuda.py holds the CUDA kernels against
those plain versions on the card.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances are those of tests/test_kernels.py: fp32 2e-5, bf16 2e-2.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import DECODE_CASES, FA_CASES, decode_inputs, fa_inputs, rand
from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode
from repro.kernels.flash_attention import flash_attention_fwd
from repro.models.layers import decode_attention_ref as jdecode_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (SLOT_TILE, WAVES,
                                                  decode_attention,
                                                  plan_splits)
from repro_torch.kernels.flash_attention import flash_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def both(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bh,bhkv,s,hd,window,bq,bk,dtype", FA_CASES)
def test_flash_attention_matches_pallas_and_oracle(bh, bhkv, s, hd, window,
                                                   bq, bk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in
                                    fa_inputs(bh, bhkv, s, hd, bh * s + hd))
    pallas = flash_attention_fwd(jq, jk, jv, window=window, block_q=bq,
                                 block_k=bk, interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, window=window)
    out = ops.flash_attention(tq, tk, tv, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    tol = TOL[dtype]
    close(out, pallas, tol)
    close(out, oracle, tol)
    close(ref.flash_attention_ref(tq, tk, tv, window=window), oracle, tol)


def test_flash_attention_first_row_is_v0():
    """Causal: position 0 attends only to itself."""
    q, k, v = (torch.from_numpy(x) for x in fa_inputs(2, 2, 64, 32, 0))
    out = ops.flash_attention(q, k, v)
    np.testing.assert_allclose(out[:, 0].numpy(), v[:, 0].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("window", [None, 48])
def test_flash_attention_model_layout_equals_kernel_layout(window):
    """The model's (B, S, H, hd) layout, read through strides, gives what
    the JAX kernels' (BH, S, hd) layout gives."""
    rng = np.random.default_rng(5)
    b, s, h, hkv, hd = 2, 96, 8, 2, 32
    q = torch.from_numpy(rand(rng, (b, s, h, hd)))
    k = torch.from_numpy(rand(rng, (b, s, hkv, hd)))
    v = torch.from_numpy(rand(rng, (b, s, hkv, hd)))
    out4 = ops.flash_attention(q, k, v, window=window)

    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(-1, s, hd)
    out3 = ops.flash_attention(flat(q), flat(k), flat(v), window=window)
    close(flat(out4), out3, 1e-6)
    jout = flash_attention_fwd(*(jnp.asarray(flat(t).numpy())
                                 for t in (q, k, v)),
                               window=window, block_q=32, block_k=32,
                               interpret=True)
    close(flat(out4), jout, 2e-5)


@pytest.mark.parametrize("b,hkv,grp,s,hd,bs,dtype", DECODE_CASES)
def test_flash_decode_matches_pallas_and_oracle(b, hkv, grp, s, hd, bs,
                                                dtype):
    *qkv, lens = decode_inputs(b, hkv, grp, s, hd, b * s + hd)
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in qkv)
    oracle = jdecode_ref(jq, jk, jv, jnp.asarray(lens))      # (B,1,H,hd)
    # the JAX kernel's layout: fold (B, Hkv), group queries per kv head
    jqg = jq[:, 0].reshape(b * hkv, grp, hd)
    jkk = jk.transpose(0, 2, 1, 3).reshape(b * hkv, s, hd)
    jvv = jv.transpose(0, 2, 1, 3).reshape(b * hkv, s, hd)
    jlens = jnp.repeat(jnp.asarray(lens), hkv)
    pallas = flash_decode(jqg, jkk, jvv, jlens, block_s=bs, interpret=True)

    tlens = torch.from_numpy(lens)
    out4 = ops.decode_attention(tq.view(b, hkv, grp, hd), tk, tv, tlens)
    tqg = tq[:, 0].reshape(b * hkv, grp, hd)
    tkk = tk.transpose(1, 2).reshape(b * hkv, s, hd)
    tvv = tv.transpose(1, 2).reshape(b * hkv, s, hd)
    out3 = ops.decode_attention(tqg, tkk, tvv, tlens.repeat_interleave(hkv))
    tol = TOL[dtype]
    close(out4.reshape(b, 1, hkv * grp, hd), oracle, tol)
    close(out3, pallas, tol)
    close(out4.reshape(b * hkv, grp, hd), out3, 1e-6)
    close(ref.flash_decode_ref(tqg, tkk, tvv, tlens.repeat_interleave(hkv)),
          pallas, tol)


def test_flash_decode_respects_cache_len():
    """Slots at or past cache_len must not influence the output."""
    rng = np.random.default_rng(0)
    s, hd = 128, 32
    q, k, v = (torch.from_numpy(rand(rng, shape)) for shape in
               ((1, 4, hd), (1, s, hd), (1, s, hd)))
    lens = torch.tensor([64], dtype=torch.int32)
    out1 = ops.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, 64:], v2[:, 64:] = 99.0, -99.0
    out2 = ops.decode_attention(q, k2, v2, lens)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)
    pallas = flash_decode(*(jnp.asarray(t.numpy()) for t in (q, k2, v2)),
                          jnp.array([64]), block_s=64, interpret=True)
    close(out2, pallas, 2e-5)


def test_fully_masked_rows_are_zero():
    """The kernels clamp the denominator (max(l, 1e-30)), so a row with no
    valid key gives 0, not NaN; the plain versions do the same."""
    q = torch.ones(1, 2, 1, 32)
    kc = torch.ones(1, 8, 1, 32)
    out = ops.decode_attention(q, kc, kc, torch.tensor([0], dtype=torch.int32))
    assert torch.equal(out, torch.zeros_like(out))
    q4 = torch.ones(1, 40, 1, 32)
    k4 = torch.ones(1, 8, 1, 32)
    out = ops.flash_attention(q4, k4, k4, window=4)   # rows >= 11 see none
    assert torch.equal(out[:, 11:], torch.zeros_like(out[:, 11:]))
    assert torch.isfinite(out).all()


def test_impl_reference_and_unknown_impl():
    q, k, v = (torch.from_numpy(x) for x in fa_inputs(4, 2, 64, 32, 1))
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ops.flash_attention(q, k, v,
                                                   impl="reference"))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, :2], k, v, torch.tensor([64, 64]),
                             impl="triton")


def test_wrappers_do_not_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: a meta tensor takes the
    kernel's operator (its fake implementation: the output's shape, no
    launch), and any device but the CPU, the card and meta raises."""
    q = torch.empty(1, 64, 4, 32, device="meta")
    k = torch.empty(1, 64, 2, 32, device="meta")
    assert flash_attention(q, k, k).shape == q.shape
    qd = q[:, 0].view(1, 2, 2, 32)
    lens = torch.empty(1, dtype=torch.int32, device="meta")
    assert decode_attention(qd, k, k, lens).shape == qd.shape
    other = types.SimpleNamespace(device=torch.device("mps"))
    with pytest.raises(ValueError, match="no kernel for mps"):
        flash_attention(other, k, k)
    with pytest.raises(ValueError, match="no kernel for mps"):
        decode_attention(other, k, k, lens)
    assert flash_attention.launches == 0 and decode_attention.launches == 0


def test_build_raises_without_nvcc(monkeypatch):
    import torch.utils.cpp_extension as cpp
    from repro_torch.kernels import _build
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def test_forward_body_raises_without_nvcc(monkeypatch, tmp_path):
    """``forward_body`` asks the built library which body a launch runs:
    where the kernels cannot be built it raises, naming nvcc, and reports
    no body."""
    import torch.utils.cpp_extension as cpp
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    caches = (fa._lib, _build.load, _build.build_all)
    for fn in caches:
        fn.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            fa.forward_body(128, torch.bfloat16)
    finally:
        for fn in caches:
            fn.cache_clear()


def _forward_operands(case: str):
    """q, k, v on the CPU that the forward kernel's wrapper refuses, and
    the window, one per ``case``."""
    q = torch.zeros((2, 64, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 64, 2, 64), dtype=torch.bfloat16)
    window = None
    if case == "fp16":
        q, k = q.half(), k.half()
    elif case == "hd 48":
        q, k = q[..., :48].contiguous(), k[..., :48].contiguous()
    elif case == "k in another dtype":
        k = k.float()
    elif case == "strided head dim":
        q = torch.zeros((2, 64, 4, 128), dtype=torch.bfloat16)[..., ::2]
    elif case == "rows not 16-byte aligned":
        q = torch.zeros((2, 64, 4 * 64 + 4), dtype=torch.bfloat16)[
            ..., 4:].view(2, 64, 4, 64)
    elif case == "3 dims":
        q = q[0]
    elif case == "group not whole":
        q = q[:, :, :3]
    elif case == "window 0":
        window = 0
    return q, k, k, window


@pytest.mark.parametrize("case", [
    "fp16", "hd 48", "k in another dtype", "strided head dim",
    "rows not 16-byte aligned", "3 dims", "group not whole", "window 0"])
def test_forward_kernel_wrapper_refuses_what_the_kernel_cannot_read(case):
    """The forward kernel's launch checks its operands before it loads the
    library: each case raises ValueError and launches nothing (on the
    card the same checks run before the C call)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, window = _forward_operands(case)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError):
        fa._forward(q, k, v, window, None)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("rows,capacity,n_sm", [
    (32, 544, 132),      # qwen3-8b serving decode: B=4 x Hkv=8
    (8, 32768, 132),     # batch 1 against a long cache
    (16, 4096, 132), (1, 1, 132), (4, 130, 132), (200, 10000, 132),
    (1000, 100, 132), (3, 65, 8), (8, 64 * 1000 + 1, 132),
    (2000, 70000, 132)])
def test_plan_splits_covers_the_cache(rows, capacity, n_sm):
    n_split, chunk = plan_splits(rows, capacity, n_sm)
    assert n_split >= 1 and chunk > 0 and chunk % SLOT_TILE == 0
    # the chunks cover [0, capacity) exactly: none empty, none past the end
    spans = [min(chunk, capacity - i * chunk) for i in range(n_split)]
    assert min(spans) > 0 and sum(spans) == capacity
    # at least WAVES / 2 SM-counts of blocks, or one tile per chunk
    tiles = -(-capacity // SLOT_TILE)
    assert rows * n_split >= min(WAVES // 2 * n_sm, rows * tiles)
    # and no more splits than the aim of WAVES SM-counts needs
    assert n_split <= max(1, -(-WAVES * n_sm // rows))


def test_plan_splits_reads_no_cache_len():
    """The plan is a function of the cache's shape and the card alone."""
    import inspect
    assert list(inspect.signature(plan_splits).parameters) == [
        "rows", "capacity", "n_sm"]
    assert plan_splits(32, 544, 132) == (9, 64)
