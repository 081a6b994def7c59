"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

  python3 chip_smoke.py

Phases; each raises on failure, so any failure exits non-zero:
  1. environment: card, power limit, versions; build the CUDA kernels from
     src/repro_torch/kernels/csrc/ (one nvcc per source, in parallel),
     print ptxas' registers and spills and each library's count of HMMA
     (tensor-core) instructions, which must not be 0 for flash attention
     and WKV6;
  2. each kernel against its plain PyTorch version on the card, at the
     serving shapes and in windowed, ragged, 3-D layout, hd 32 and 128,
     fp32, many-split, poisoned-cache and carried-state cases, with its
     time beside the plain version's and one PyTorch library call's where
     one computes the same function; flash decode is also timed at batch 1
     against a 32,768-slot cache; WKV6 also at its chunk edges (S of T-1,
     T, T+1, 2T+3), with decays in the model's range and with exact 0s
     and 1s, a decay-one-step-late mutant, and timed at the decode shape
     (B=4, S=1, H=40, hd=64);
  3. serve each model of SERVED at full width and full depth (bf16, random
     weights from a seed) through Engine.generate: 4 requests, 32 new
     tokens, greedy; qwen3-8b (36 layers, d_model 4096) with 512 prompt
     tokens, then rwkv6-3b (32 layers, d_model 2560) with 1024. The
     kernels' launch counters are zeroed just before and read just after,
     and must show one launch per layer of the model's prefill kernel
     and one per layer and decode step of its decode kernel (rwkv6: the
     same WKV6 kernel), and none of the other kernels. A profile of one
     prefill and one decode step shows where the device time goes, and
     their own counts must be one launch per layer. Then the prefill
     logits and three decode steps fed the same tokens, through the
     kernels and through impl="reference" (the plain versions, on the
     card), in bf16 and with the weights widened to fp32, must agree
     (compare_paths). Each model's weights are freed before the next;
  4. small fp32 models (dense and RWKV) served on the card and on the CPU
     must agree.
The last lines are a JSON line of per-kernel numbers, the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# the models served in phase 3, each with its prompt length: rwkv6's
# recurrence is sequential in time, so its users' long prompts set the
# kernel's critical path
SERVED = {"qwen3-8b": 512, "rwkv6-3b": 1024}
REQUESTS, MAX_NEW = 4, 32
PROMPT_LEN = SERVED["qwen3-8b"]      # the attention kernels' checks
RWKV_HEADS, RWKV_HD = 40, 64         # rwkv6-3b: d_model 2560 in heads of 64
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs its plain version: max abs error (atol = rtol), and relative L2
# error a few times above what rounding the output to the dtype gives
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
REL_TOL = {torch.bfloat16: 5e-3, torch.float32: 1e-5}
# Q and K are drawn at this scale, so scores have a std of QK_SCALE ** 2 and
# the softmax is peaked: a near-uniform one would make every output close
# to the mean of V, whatever the kernel did with the scores
QK_SCALE = 1.5
# a wrong softmax temperature by this factor, or a decay raised to this
# power, must fail REL_TOL (mutant checks)
MUTANT_TEMP = 1.02
# full-width logits against an fp32 run of the same weights (compare_paths)
FP32_REL_TOL = 1e-4
BF16_ERR_RATIO = 1.1


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls (CUDA
    events; warm L2 where the operands fit in it). A spin kernel holds the
    stream while the host queues every call, so the events time the device
    alone and not the host's launch rate; if the host was not done queueing
    when the spin ended, the spin is lengthened and the timing repeated."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for cycles in (10 ** 8, 4 * 10 ** 8, 16 * 10 ** 8):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            break
    else:
        log("  (the host could not queue the calls ahead of the device: "
            "the next time includes launch gaps)")
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: dict) -> tuple[float, str]:
    """The larger of the bytes over the memory rate and the operations,
    ``{dtype: flops}``, over the peak rate of each type."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_FLOPS[dt] for dt, n in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def assert_close(name: str, got, want) -> float:
    tol, rel_tol = TOL[want.dtype], REL_TOL[want.dtype]
    err, rel = max_err(got, want), rel_err(got, want)
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) \
        and rel <= rel_tol and bool(torch.isfinite(got.float()).all())
    log(f"  {name}: max_abs_err {err:.3e} (atol=rtol={tol}), rel L2 "
        f"{rel:.3e} (limit {rel_tol}), rms of the plain output "
        f"{want.float().pow(2).mean().sqrt().item():.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err}, rel L2 {rel})")
    return err


def assert_mutant_caught(name: str, mutant, want,
                         what: str = f"q x {MUTANT_TEMP}") -> None:
    """The check has teeth: the plain version run with a 2 % error (the
    softmax temperature, or the decay) must fail the relative limit."""
    rel = rel_err(mutant, want)
    log(f"  mutant ({name}, {what}): rel L2 {rel:.3e} "
        f"(must exceed {REL_TOL[want.dtype]})")
    if rel <= REL_TOL[want.dtype]:
        raise AssertionError(f"{name}: the kernel check cannot tell the "
                             f"mutant {what}")


# ------------------------------------------------------------ phase 1
def environment() -> str:
    """Print the card and versions, build the kernels; returns the
    nvidia-smi line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(p.name for p in libs.values())})")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {lib.stem.split('-')[0]}: {line.strip()}")
    hmma = hmma_counts(libs)
    log(f"HMMA instructions in the SASS: {hmma}")
    for name, what in (("flash_attention", "bf16 body"),
                       ("wkv6", "chunked body's 3xTF32 products")):
        if not hmma[name]:
            raise AssertionError(f"{name}'s library has no HMMA: its {what} "
                                 f"does not run on the tensor cores")
    return smi


def hmma_counts(libs: dict) -> dict:
    """{kernel source: count of HMMA instructions in cuobjdump -sass}."""
    from torch.utils.cpp_extension import CUDA_HOME
    cuobjdump = Path(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    counts = {}
    for name, lib in libs.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[name] = sum("HMMA" in line for line in sass.splitlines())
    return counts


# ------------------------------------------------------------ phase 2
def randn(gen, shape, dtype, scale=QK_SCALE):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def check_flash_attention() -> dict:
    from repro_torch.kernels import ops
    import torch.nn.functional as F
    gen = torch.Generator("cuda").manual_seed(0)
    log("flash_attention (prefill) vs its plain version:")
    # (name, B, S, H, Hkv, hd, window, dtype, 3-D layout)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("serving prefill", 4, PROMPT_LEN, 32, 8, 128, None, bf16,
              False),
             ("windowed", 2, 512, 8, 2, 64, 128, bf16, False),
             ("ragged S=193, hd 32", 2, 193, 6, 2, 32, None, bf16, False),
             ("(BH, S, hd), ragged S=193", 1, 193, 8, 2, 64, None, bf16,
              True),
             ("hd 128, S=300 (not a multiple of 64), windowed", 2, 300, 8,
              4, 128, 100, bf16, False),
             ("ragged fp32, (BH, S, hd)", 1, 193, 6, 2, 32, None, f32,
              True)]
    result = {}
    for name, b, s, h, hkv, hd, window, dtype, flat in cases:
        q = randn(gen, (b, s, h, hd), dtype)
        k = randn(gen, (b, s, hkv, hd), dtype)
        v = randn(gen, (b, s, hkv, hd), dtype, 1.0)
        if flat:   # the JAX kernel's (BH, S, hd) layout
            q, k, v = (t[0].transpose(0, 1).contiguous() for t in (q, k, v))
        got = ops.flash_attention(q, k, v, window=window)
        want = ops.flash_attention(q, k, v, window=window, impl="reference")
        torch.cuda.synchronize()
        err = assert_close(name, got, want)
        if name == "serving prefill":
            result = {"q": q, "k": k, "v": v, "err": err}
            scores = q[0, :, 0].float() @ k[0, :, 0].float().T / hd ** 0.5
            log(f"  (scores of one head: std {scores.std().item():.3f})")
            assert_mutant_caught(name, ops.flash_attention(
                q * MUTANT_TEMP, k, v, impl="reference"), want)
    q, k, v = result["q"], result["k"], result["v"]
    b, s, h, hd = q.shape
    pairs = s * (s + 1) // 2                          # causal (q, k) pairs
    # Q, K, V read once, O (the size of Q) written once
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound, by = bound_ms(n_bytes, {q.dtype: 4 * b * h * hd * pairs})
    ms = time_ms(lambda: ops.flash_attention(q, k, v), 50)
    plain = time_ms(lambda: ops.flash_attention(q, k, v, impl="reference"),
                    10)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 50)
    log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} "
        f"ms, bound {bound:.4f} ms ({by})")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:75",
            "max_abs_err": result["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def check_decode_attention() -> dict:
    from repro_torch.kernels import ops
    gen = torch.Generator("cuda").manual_seed(1)
    log("decode_attention (flash decode) vs its plain version:")
    b, hkv, grp, s, hd, dtype = REQUESTS, 8, 4, PROMPT_LEN + MAX_NEW, 128, \
        torch.bfloat16
    q = randn(gen, (b, hkv, grp, hd), dtype)
    kc = randn(gen, (b, s, hkv, hd), dtype)
    vc = randn(gen, (b, s, hkv, hd), dtype, 1.0)
    lens = torch.tensor([s, s - 16, s - 24, PROMPT_LEN + 1], device="cuda",
                        dtype=torch.int32)
    want = ops.decode_attention(q, kc, vc, lens, impl="reference")
    err = assert_close("serving decode, ragged cache_len",
                       ops.decode_attention(q, kc, vc, lens), want)
    assert_mutant_caught("serving decode", ops.decode_attention(
        q * MUTANT_TEMP, kc, vc, lens, impl="reference"), want)
    # poison: slots at or past cache_len must not change the output
    plens = torch.tensor([300, 1, s, 129], device="cuda", dtype=torch.int32)
    dead = torch.arange(s, device="cuda")[None, :] >= plens[:, None].long()
    kp, vp = kc.clone(), vc.clone()
    kp[dead], vp[dead] = 99.0, -99.0
    clean = ops.decode_attention(q, kc, vc, plens)
    poisoned = ops.decode_attention(q, kp, vp, plens)
    assert_close("poisoned slots past cache_len", poisoned,
                 ops.decode_attention(q, kc, vc, plens, impl="reference"))
    if not torch.equal(clean, poisoned):
        raise AssertionError("decode kernel read slots past cache_len")
    # fp32, (BHkv, grp, hd) layout, wider group
    q3 = randn(gen, (4, 8, 64), torch.float32)
    k3 = randn(gen, (4, 384, 64), torch.float32)
    v3 = randn(gen, (4, 384, 64), torch.float32)
    l3 = torch.tensor([384, 200, 17, 1], device="cuda", dtype=torch.int32)
    assert_close("fp32 (BHkv, grp, hd), grp 8",
                 ops.decode_attention(q3, k3, v3, l3),
                 ops.decode_attention(q3, k3, v3, l3, impl="reference"))
    check_many_splits(gen)

    valid = int(lens.sum()) * hkv * hd                # K (and V) elements
    n_bytes = (2 * q.numel() + 2 * valid) * q.element_size() + 4 * b
    bound, by = bound_ms(n_bytes, {dtype: 4 * grp * valid})
    ms = time_ms(lambda: ops.decode_attention(q, kc, vc, lens), 200)
    plain = time_ms(lambda: ops.decode_attention(q, kc, vc, lens,
                                                 impl="reference"), 20)
    lib = time_ms(masked_sdpa(q, kc, vc, lens), 200)
    log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} "
        f"ms, bound {bound:.4f} ms ({by})")
    time_long_cache(gen)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:63",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


def masked_sdpa(q, kc, vc, lens):
    """One PyTorch call computing flash decode's function, for its time:
    SDPA over the (B, H, S, hd) caches with a cache_len mask."""
    import torch.nn.functional as F
    b, hkv, grp, hd = q.shape
    s = kc.shape[1]
    qs = q.reshape(b, hkv * grp, 1, hd)
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None].long())
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def check_many_splits(gen) -> None:
    """A 4096-slot cache split over many blocks: cache_len 1 (every split
    but one empty), a cache_len that ends on a chunk boundary, and poison
    past cache_len."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import _sm_count, plan_splits
    b, hkv, grp, s, hd = 2, 8, 4, 4096, 128
    n_split, chunk = plan_splits(b * hkv, s, _sm_count(torch.device("cuda")))
    log(f"  4096-slot cache, {b * hkv} rows: {n_split} splits of {chunk} "
        f"slots")
    q = randn(gen, (b, hkv, grp, hd), torch.bfloat16)
    kc = randn(gen, (b, s, hkv, hd), torch.bfloat16)
    vc = randn(gen, (b, s, hkv, hd), torch.bfloat16, 1.0)
    lens = torch.tensor([1, 3 * chunk], device="cuda", dtype=torch.int32)
    assert_close(f"cache_len 1 and {3 * chunk} (a chunk boundary)",
                 ops.decode_attention(q, kc, vc, lens),
                 ops.decode_attention(q, kc, vc, lens, impl="reference"))
    plens = torch.tensor([chunk + 1, s - 5], device="cuda",
                         dtype=torch.int32)
    dead = torch.arange(s, device="cuda")[None, :] >= plens[:, None].long()
    clean = ops.decode_attention(q, kc, vc, plens)
    kc[dead], vc[dead] = 99.0, -99.0
    poisoned = ops.decode_attention(q, kc, vc, plens)
    torch.cuda.synchronize()
    if not torch.equal(clean, poisoned):
        raise AssertionError("split decode read slots past cache_len")
    log(f"  poisoned slots past cache_len {plens.tolist()} over {n_split} "
        f"splits: output bit-identical ok")


def time_long_cache(gen) -> None:
    """Batch-1 decode at qwen3-8b's shape against a full 32,768-slot
    cache, the shape the split exists for, beside masked SDPA and the
    bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import _sm_count, plan_splits
    b, hkv, grp, s, hd, dtype = 1, 8, 4, 32768, 128, torch.bfloat16
    q = randn(gen, (b, hkv, grp, hd), dtype)
    kc = randn(gen, (b, s, hkv, hd), dtype)
    vc = randn(gen, (b, s, hkv, hd), dtype, 1.0)
    lens = torch.full((b,), s, device="cuda", dtype=torch.int32)
    assert_close("batch 1, 32768 slots",
                 ops.decode_attention(q, kc, vc, lens),
                 ops.decode_attention(q, kc, vc, lens, impl="reference"))
    n_bytes = (2 * q.numel() + kc.numel() + vc.numel()) * q.element_size()
    bound, by = bound_ms(n_bytes, {dtype: 4 * grp * kc.numel()})
    ms = time_ms(lambda: ops.decode_attention(q, kc, vc, lens), 100)
    lib = time_ms(masked_sdpa(q, kc, vc, lens), 100)
    n_split, chunk = plan_splits(b * hkv, s, _sm_count(q.device))
    log(f"decode batch 1, 32768-slot cache ({n_bytes / 1e6:.1f} MB, "
        f"{n_split} splits of {chunk}): kernel {ms:.4f} ms, SDPA "
        f"{lib:.4f} ms (masked), bound {bound:.4f} ms ({by})")


def check_wkv6() -> dict:
    from repro_torch.kernels import ops
    gen = torch.Generator("cuda").manual_seed(2)
    log("wkv6 (RWKV6 WKV recurrence) vs its plain version:")

    def inputs(shape):
        """r, k, v at scale 0.5 and per-channel decays exp(-exp(x)) with
        x ~ N(-5, 2): from ~1 (state kept over the whole sequence) to ~0;
        u (heads, hd) for the model layout or (BH, hd) for the 3-D one."""
        r, k, v = (randn(gen, shape, torch.float32, 0.5) for _ in range(3))
        w = torch.exp(-torch.exp(randn(gen, shape, torch.float32, 2.0) - 5))
        u = randn(gen, shape[-2:] if len(shape) == 4 else
                  (shape[0], shape[-1]), torch.float32, 0.5)
        return r, k, v, w, u

    # the serving prefill shape; its state buffer starts at zero, as the
    # model's prefill gives it (read and written in place)
    b, s, h, hd = REQUESTS, SERVED["rwkv6-3b"], RWKV_HEADS, RWKV_HD
    r, k, v, w, u = inputs((b, s, h, hd))
    zero = torch.zeros((b, h, hd, hd), device="cuda")
    state = zero.clone()
    got, final = ops.wkv6(r, k, v, w, u, state)
    want, want_final = ops.wkv6(r, k, v, w, u, zero.clone(), impl="reference")
    torch.cuda.synchronize()
    err = assert_close("serving prefill, y", got, want)
    assert_close("serving prefill, final state", final, want_final)
    y0, _ = ops.wkv6(r, k, v, w, u)
    assert_close("serving prefill, no state given", y0, want)
    assert_mutant_caught("serving prefill", ops.wkv6(
        r, k, v, w ** MUTANT_TEMP, u, zero.clone(), impl="reference")[0],
        want, f"w ** {MUTANT_TEMP}")
    # ragged S from a nonzero state, hd 32
    r2, k2, v2, w2, u2 = inputs((2, 1000, 8, 32))
    start = randn(gen, (2, 8, 32, 32), torch.float32, 1.0)
    st_k, st_p = start.clone(), start.clone()
    y2, _ = ops.wkv6(r2, k2, v2, w2, u2, st_k)
    y2p, _ = ops.wkv6(r2, k2, v2, w2, u2, st_p, impl="reference")
    assert_close("S=1000 from a state, hd 32, y", y2, y2p)
    assert_close("S=1000 from a state, hd 32, final state", st_k, st_p)
    # decode: one step, the state a layer's slice of a stacked cache
    r3, k3, v3, w3, u3 = inputs((b, 1, h, hd))
    cache = randn(gen, (3, b, h, hd, hd), torch.float32, 1.0)
    before = cache.clone()
    y3, _ = ops.wkv6(r3, k3, v3, w3, u3, cache[1])
    plain_state = before[1].clone()
    y3p, _ = ops.wkv6(r3, k3, v3, w3, u3, plain_state, impl="reference")
    assert_close("decode step, y", y3, y3p)
    assert_close("decode step, state in place", cache[1], plain_state)
    if not (torch.equal(cache[0], before[0])
            and torch.equal(cache[2], before[2])):
        raise AssertionError("wkv6 wrote outside its state slice")
    # the JAX kernel's (BH, S, hd) layout, hd 16
    r4, k4, v4, w4, u4 = inputs((12, 300, 16))
    assert_close("(BH, S, hd), hd 16", ops.wkv6(r4, k4, v4, w4, u4),
                 ops.wkv6(r4, k4, v4, w4, u4, impl="reference"))
    check_wkv6_chunks(gen, inputs)

    # r, k, v, w read once, y written once, the state read and written
    # once; 5 hd^2 fp32 flops per (token, head): 2 hd^2 for r^T S and
    # 3 hd^2 for S <- w * S + k v^T, as y_t = r_t^T S + (r_t . (u * k_t)) v_t
    n_bytes = (5 * r.numel() + 2 * zero.numel() + u.numel()) * 4
    bound, by = bound_ms(n_bytes, {torch.float32: 5 * hd * hd * b * s * h})
    ms = time_ms(lambda: ops.wkv6(r, k, v, w, u, state), 20)
    plain = time_ms(lambda: ops.wkv6(r, k, v, w, u, state, impl="reference"),
                    2, warmup=1)
    log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, no single "
        f"PyTorch call computes it, bound {bound:.4f} ms ({by})")
    # the decode shape: one step from a carried state, the token body
    n_bytes = (5 * r3.numel() + 2 * cache[1].numel() + u3.numel()) * 4
    dbound, dby = bound_ms(n_bytes, {torch.float32: 5 * hd * hd * b * h})
    dms = time_ms(lambda: ops.wkv6(r3, k3, v3, w3, u3, cache[1]), 200)
    dplain = time_ms(lambda: ops.wkv6(r3, k3, v3, w3, u3, cache[1],
                                      impl="reference"), 50)
    log(f"wkv6 decode step (B={b}, S=1, H={h}, hd={hd}, "
        f"{n_bytes / 1e6:.2f} MB): kernel {dms:.6f} ms, plain {dplain:.6f} "
        f"ms, bound {dbound:.6f} ms ({dby})")
    return {"name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6.py:49",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def check_wkv6_chunks(gen, inputs) -> None:
    """The chunked body's edges and decays, at the serving heads: S of
    T-1 (the token body), T, T+1 and 2T+3 (a ragged last chunk) from a
    nonzero state; decays in the model's range (0.99-0.9999, a state kept
    over thousands of steps); decays with exact 0s (the state wiped) and
    1s mixed in. A decay applied one step late, the slip a chunk's running
    products invite, must fail the check."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv6 import chunk_tokens
    t = chunk_tokens()
    h, hd = RWKV_HEADS, RWKV_HD

    def case(name, s, decays):
        r, k, v, w, u = inputs((2, s, h, hd))
        if decays == "model":
            w = 0.99 + 0.0099 * torch.rand(w.shape, generator=gen,
                                            device="cuda")
        elif decays == "0 and 1":
            pick = torch.rand(w.shape, generator=gen, device="cuda")
            w = torch.where(pick < 0.05, 0.0, torch.where(pick > 0.9, 1.0, w))
        start = randn(gen, (2, h, hd, hd), torch.float32, 1.0)
        st_k, st_p = start.clone(), start.clone()
        y, _ = ops.wkv6(r, k, v, w, u, st_k)
        want, _ = ops.wkv6(r, k, v, w, u, st_p, impl="reference")
        assert_close(f"{name}, y", y, want)
        assert_close(f"{name}, final state", st_k, st_p)
        return r, k, v, w, u, start, want

    for s in (t - 1, t, t + 1, 2 * t + 3):
        case(f"S={s} from a state (chunk T={t})", s, "serving")
    r, k, v, w, u, start, want = case(f"S={2 * t + 3}, decays 0.99-0.9999",
                                      2 * t + 3, "model")
    late = torch.cat([torch.ones_like(w[:, :1]), w[:, :-1]], dim=1)
    assert_mutant_caught("decays 0.99-0.9999", ops.wkv6(
        r, k, v, late, u, start.clone(), impl="reference")[0], want,
        "each decay one step late")
    case("S=1024, decays 0.99-0.9999", 1024, "model")
    case(f"S={2 * t + 3}, exact 0 and 1 decays", 2 * t + 3, "0 and 1")
    case("S=1000, exact 0 and 1 decays", 1000, "0 and 1")


# ------------------------------------------------------------ phase 3
def expected_counts(cfg, decode_steps: int, prefills: int = 1) -> dict:
    """One launch per layer of the prefill kernel per prefill, and of the
    decode kernel per decode step; none of the others."""
    prefill_kernel, decode_kernel = ("wkv6", "wkv6") if cfg.attn_free \
        else ("flash_attention", "decode_attention")
    from repro_torch.kernels.ops import KERNELS
    want = dict.fromkeys(KERNELS, 0)
    want[prefill_kernel] += cfg.n_layers * prefills
    want[decode_kernel] += cfg.n_layers * decode_steps
    return want


def check_counts(what: str, got: dict, want: dict) -> None:
    log(f"  launches in {what}: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{what}: launch counts {got} != {want}")


def serve_full_width(arch: str) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve.engine import Engine, ServeConfig, \
        preallocate_cache
    cfg, prompt_len = get_arch(arch), SERVED[arch]
    t0 = time.perf_counter()
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    heads = f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of " \
        f"{cfg.rwkv_head_dim}" if cfg.attn_free else \
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}"
    log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, {heads}, "
        f"vocab {cfg.vocab_size}; {n_params / 1e9:.3f} B params "
        f"({n_bytes / 1e9:.2f} GB) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=MAX_NEW),
                    device="cuda")
    gen = torch.Generator("cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (REQUESTS, prompt_len),
                            generator=gen, device="cuda")
    engine.generate(prompts[:, :16], max_new_tokens=2)     # warm-up

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ids = engine.generate(prompts)
    launches = ops.launch_counts()
    st = engine.stats
    log(f"generate: {REQUESTS} requests x {prompt_len} prompt tokens -> "
        f"{ids.shape[1]} new tokens each; prefill {st['prefill_ms']:.3f} ms, "
        f"decode {st['decode_ms_per_token']:.3f} ms/token "
        f"({REQUESTS * 1e3 / st['decode_ms_per_token']:.1f} tokens/s), "
        f"prefill {REQUESTS * prompt_len * 1e3 / st['prefill_ms']:.0f} "
        f"prompt tokens/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check_counts("generate", launches, expected_counts(cfg, MAX_NEW - 1))
    prefill_bound, decode_bound = serve_bounds(cfg, params, prompt_len)
    log(f"  bounds: prefill {prefill_bound[0]:.4f} ms ({prefill_bound[1]}), "
        f"decode {decode_bound[0]:.4f} ms/token ({decode_bound[1]})")
    if ids.shape != (REQUESTS, MAX_NEW) or ids.min() < 0 \
            or ids.max() >= cfg.vocab_size:
        raise AssertionError(f"generated ids out of range: {ids.shape}")

    toks = torch.as_tensor(ids, device="cuda").long()
    ops.reset_launches()
    profile("prefill", lambda: prefill(params, cfg, {"tokens": prompts}),
            st["prefill_ms"])
    check_counts("one prefill", ops.launch_counts(), expected_counts(cfg, 0))
    _, pre, pos = prefill(params, cfg, {"tokens": prompts})
    caches = preallocate_cache(cfg, pre, prompt_len + MAX_NEW)
    del pre
    ops.reset_launches()
    profile("decode step", lambda: decode_step(params, cfg, toks[:, 0],
                                               caches, pos),
            st["decode_ms_per_token"])
    check_counts("one decode step", ops.launch_counts(),
                 expected_counts(cfg, 1, prefills=0))
    del caches
    compare_paths(params, cfg, prompts, toks)
    return {"launches": launches, **st}


def serve_bounds(cfg, params, prompt_len: int) -> tuple:
    """Least time for the prefill and for one decode step of the main path.
    Prefill: 2 flops per layer weight per prompt token, causal attention
    (or RWKV's fp32 recurrence, 5 hd^2 flops per token and head), the LM
    head for the last token; it reads every weight but the embedding table
    once. Decode: it reads the layer weights, the LM head, and the KV cache
    at its mean length over the decode loop (or reads and writes RWKV's
    WKV states) once."""
    layers = list(_leaves(params["layers"]))
    layer_params = sum(t.numel() for t in layers)
    layer_bytes = sum(t.numel() * t.element_size() for t in layers)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    head_bytes = head.numel() * head.element_size()
    if cfg.attn_free:
        hd = cfg.rwkv_head_dim
        heads = cfg.d_model // hd
        seq_flops = {torch.float32: 5 * hd * hd * heads * cfg.n_layers
                     * REQUESTS * prompt_len}
        step_flops = 5 * hd * hd * heads * cfg.n_layers * REQUESTS
        cache_bytes = 2 * cfg.n_layers * REQUESTS * heads * hd * hd * 4
    else:
        seq_flops = {torch.bfloat16: 4 * REQUESTS * cfg.n_heads * cfg.hd
                     * cfg.n_layers * (prompt_len * (prompt_len + 1) // 2)}
        step_flops = 0
        cache_bytes = 2 * cfg.n_layers * REQUESTS * (
            prompt_len + MAX_NEW / 2) * cfg.n_kv_heads * cfg.hd \
            * head.element_size()
    dense = 2 * layer_params * REQUESTS * prompt_len \
        + 2 * head.numel() * REQUESTS
    prefill = bound_ms(layer_bytes + head_bytes, {
        torch.bfloat16: dense + seq_flops.get(torch.bfloat16, 0),
        torch.float32: seq_flops.get(torch.float32, 0)})
    decode = bound_ms(layer_bytes + head_bytes + cache_bytes, {
        torch.bfloat16: 2 * (layer_params + head.numel()) * REQUESTS,
        torch.float32: step_flops})
    return prefill, decode


def model_logits(params, cfg, prompts, toks, impl: str) -> list:
    """Last-token logits of the prefill, then of 3 decode steps fed
    ``toks`` (the same tokens for every path)."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import preallocate_cache
    logits, pre, pos = prefill(params, cfg, {"tokens": prompts}, impl=impl)
    caches = preallocate_cache(cfg, pre, prompts.shape[1] + MAX_NEW)
    del pre
    out = [logits]
    for i in range(3):
        logits, caches = decode_step(params, cfg, toks[:, i], caches,
                                     pos + i, impl=impl)
        out.append(logits)
    return out


def compare_paths(params, cfg, prompts, toks) -> None:
    """The served logits four ways: the bf16 weights, and the same weights
    widened to fp32, each through the kernels and through their plain
    versions (impl="reference") on the card. fp32 plain is the truth.

    - fp32 kernels vs truth: relative L2 error <= FP32_REL_TOL; only the
      order of the attention (or WKV) sums differs.
    - bf16: rounding to bf16 in every layer of a random-init full-depth
      model moves the logits by ~1e-2 relative whichever kernel path
      runs, and the two paths round independently, so they are as far
      from each other as from the truth. The kernel path must be about as
      close to the truth as the plain path: error <= BF16_ERR_RATIO x the
      plain path's error. This is a loose guard; the fp32 comparison and
      the kernel checks of phase 2 are the tight ones.
    """
    params32 = _map(params, lambda t: t.float())
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    runs = {(dt, impl): model_logits(p, c, prompts, toks, impl)
            for dt, p, c in (("bf16", params, cfg), ("fp32", params32, cfg32))
            for impl in ("kernel", "reference")}
    del params32
    for i in range(4):
        name = "prefill" if i == 0 else f"decode {i}"
        truth = runs["fp32", "reference"][i]
        got = {key: run[i] for key, run in runs.items()}
        for key, t in got.items():
            if t.shape != (REQUESTS, cfg.vocab_size) or \
                    not torch.isfinite(t).all():
                raise AssertionError(f"{name} logits {key}: not finite or "
                                     f"wrong shape {tuple(t.shape)}")
        e32 = rel_err(got["fp32", "kernel"], truth)
        ek = rel_err(got["bf16", "kernel"], truth)
        er = rel_err(got["bf16", "reference"], truth)
        ekr = rel_err(got["bf16", "kernel"], got["bf16", "reference"])
        log(f"  logits {name} (rel L2 vs fp32 plain): fp32 kernels {e32:.3e} "
            f"(tol {FP32_REL_TOL}); bf16 kernels {ek:.3e}, bf16 plain "
            f"{er:.3e} (tol {BF16_ERR_RATIO} x plain); bf16 kernels vs bf16 "
            f"plain {ekr:.3e}, max abs "
            f"{max_err(got['bf16', 'kernel'], got['bf16', 'reference']):.3e}"
            f" (|logit| max {truth.abs().max().item():.2f})")
        if e32 > FP32_REL_TOL or ek > BF16_ERR_RATIO * er:
            raise AssertionError(f"{name}: the kernel path's logits "
                                 f"disagree with the plain path's")


def profile(label: str, fn, step_ms: float) -> None:
    """Device time of one call by kernel, from torch.profiler, beside the
    call's time measured without the profiler (``step_ms``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"profile {label}: the profiler saw no kernels: device time "
            f"not measured")
        return
    log(f"profile {label}: device busy {busy:.3f} ms of {step_ms:.3f} ms "
        f"({100 * busy / step_ms:.1f} %), {sum(r[1] for r in rows)} kernels;"
        f" by kernel:")
    for ms, n, key in rows[:8]:
        log(f"    {ms:9.3f} ms {n:5d}x  {key[:100]}")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ------------------------------------------------------------ phase 4
def small_models_cpu_vs_card() -> None:
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import init_params, prefill
    from repro_torch.serve.engine import Engine, ServeConfig
    rwkv = dataclasses.replace(get_arch("rwkv6-3b").reduced(),
                               param_dtype="float32")
    for cfg in (PRESETS["tiny"], rwkv):
        params = init_params(torch.Generator("cpu").manual_seed(0), cfg)
        prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                                generator=torch.Generator("cpu").manual_seed(1))
        on_card = _map(params, lambda t: t.to("cuda"))
        cpu_logits, _, _ = prefill(params, cfg, {"tokens": prompts})
        gpu_logits, _, _ = prefill(on_card, cfg, {"tokens": prompts.to("cuda")})
        err = max_err(gpu_logits.cpu(), cpu_logits)
        scfg = ServeConfig(max_new_tokens=8)
        ids_cpu = Engine(cfg, params, scfg, device="cpu").generate(prompts)
        ids_gpu = Engine(cfg, on_card, scfg, device="cuda").generate(prompts)
        log(f"{cfg.name} fp32, card vs CPU: prefill logits max abs err "
            f"{err:.3e}; greedy ids equal: {(ids_cpu == ids_gpu).all()}")
        if err > 1e-3 or not (ids_cpu == ids_gpu).all():
            raise AssertionError(f"{cfg.name}: card and CPU disagree")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels.ops  # noqa: F401  (fails outside the repo)
    smi = environment()
    kernels = [check_flash_attention(), check_decode_attention(),
               check_wkv6()]
    launches = {}
    for arch in SERVED:
        served = serve_full_width(arch)
        # each kernel's count comes from the run of the model that serves it
        launches.update({name: n for name, n in served["launches"].items()
                         if n})
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{arch} freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"still allocated")
    for k in kernels:
        k["launches"] = launches[k["name"]]
    small_models_cpu_vs_card()
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
