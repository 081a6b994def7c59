"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

  python3 chip_smoke.py

Phases; each raises on failure, so any failure exits non-zero:
  1. environment: card, power limit, versions; build the CUDA kernels from
     src/repro_torch/kernels/csrc/ (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, at the
     serving shapes and in windowed, ragged, fp32 and poisoned-cache cases,
     with its time beside the plain version's and one PyTorch library
     call's;
  3. serve qwen3-8b at full width (36 layers, d_model 4096, bf16, random
     weights from a seed) through Engine.generate: 4 requests of 512
     prompt tokens, 32 new tokens, greedy. The kernels' launch counters are
     zeroed just before and read just after, and must show 36 prefill and
     36 x 31 decode launches. A profile of one prefill and one decode step
     shows where the device time goes. Then the prefill logits and three
     decode steps fed the same tokens, through the kernels and through
     impl="reference" (the plain versions, on the card), in bf16 and with
     the weights widened to fp32, must agree (compare_paths);
  4. a small fp32 model served on the card and on the CPU must agree.
The last lines are a JSON line of per-kernel numbers, the card's name and
power limit from nvidia-smi, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-8b"
REQUESTS, PROMPT_LEN, MAX_NEW = 4, 512, 32
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
# a wrong softmax temperature by this factor must fail REL_TOL (mutant check)
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


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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


def assert_mutant_caught(name: str, mutant, want) -> None:
    """The check has teeth: the plain version run with the softmax
    temperature off by MUTANT_TEMP must fail the relative limit."""
    rel = rel_err(mutant, want)
    log(f"  mutant ({name}, q x {MUTANT_TEMP}): rel L2 {rel:.3e} "
        f"(must exceed {REL_TOL[want.dtype]})")
    if rel <= REL_TOL[want.dtype]:
        raise AssertionError(f"{name}: the kernel check cannot tell a "
                             f"{MUTANT_TEMP}x temperature error")


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
    return smi


# ------------------------------------------------------------ phase 2
def randn(gen, shape, dtype, scale=QK_SCALE):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def check_flash_attention() -> dict:
    from repro_torch.kernels import ops
    import torch.nn.functional as F
    gen = torch.Generator("cuda").manual_seed(0)
    log("flash_attention (prefill) vs its plain version:")
    # (name, B, S, H, Hkv, hd, window, dtype, 3-D layout)
    cases = [("serving prefill", 4, PROMPT_LEN, 32, 8, 128, None,
              torch.bfloat16, False),
             ("windowed", 2, 512, 8, 2, 64, 128, torch.bfloat16, False),
             ("ragged fp32, (BH, S, hd)", 1, 193, 6, 2, 32, None,
              torch.float32, True)]
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
    bound, by = bound_ms(n_bytes, 4 * b * h * hd * pairs, q.dtype)
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
    import torch.nn.functional as F
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

    valid = int(lens.sum()) * hkv * hd                # K (and V) elements
    n_bytes = (2 * q.numel() + 2 * valid) * q.element_size() + 4 * b
    bound, by = bound_ms(n_bytes, 4 * grp * valid, dtype)
    ms = time_ms(lambda: ops.decode_attention(q, kc, vc, lens), 200)
    plain = time_ms(lambda: ops.decode_attention(q, kc, vc, lens,
                                                 impl="reference"), 20)
    qs = q.reshape(b, hkv * grp, 1, hd)
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None].long())
    mask = mask[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), 200)
    log(f"  time: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} "
        f"ms, bound {bound:.4f} ms ({by})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:63",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": lib}


# ------------------------------------------------------------ phase 3
def serve_full_width() -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve.engine import Engine, ServeConfig, \
        preallocate_cache
    cfg = get_arch(ARCH)
    t0 = time.perf_counter()
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"{ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, vocab "
        f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params "
        f"({n_bytes / 1e9:.2f} GB) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=MAX_NEW),
                    device="cuda")
    gen = torch.Generator("cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (REQUESTS, PROMPT_LEN),
                            generator=gen, device="cuda")
    engine.generate(prompts[:, :16], max_new_tokens=2)     # warm-up

    flash_attention.launches = decode_attention.launches = 0
    ids = engine.generate(prompts)
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    st = engine.stats
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (MAX_NEW - 1)}
    log(f"generate: {REQUESTS} requests x {PROMPT_LEN} prompt tokens -> "
        f"{ids.shape[1]} new tokens each; prefill {st['prefill_ms']:.3f} ms, "
        f"decode {st['decode_ms_per_token']:.3f} ms/token "
        f"({REQUESTS * 1e3 / st['decode_ms_per_token']:.1f} tokens/s), "
        f"prefill {REQUESTS * PROMPT_LEN * 1e3 / st['prefill_ms']:.0f} "
        f"prompt tokens/s; launches {launches} (expected {want}); peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    prefill_bound, decode_bound = serve_bounds(cfg, params)
    log(f"  bounds: prefill {prefill_bound[0]:.4f} ms ({prefill_bound[1]}), "
        f"decode {decode_bound[0]:.4f} ms/token ({decode_bound[1]})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if ids.shape != (REQUESTS, MAX_NEW) or ids.min() < 0 \
            or ids.max() >= cfg.vocab_size:
        raise AssertionError(f"generated ids out of range: {ids.shape}")

    toks = torch.as_tensor(ids, device="cuda").long()
    profile("prefill", lambda: prefill(params, cfg, {"tokens": prompts}),
            st["prefill_ms"])
    _, pre, pos = prefill(params, cfg, {"tokens": prompts})
    caches = preallocate_cache(cfg, pre, PROMPT_LEN + MAX_NEW)
    del pre
    profile("decode step", lambda: decode_step(params, cfg, toks[:, 0],
                                               caches, pos),
            st["decode_ms_per_token"])
    del caches
    compare_paths(params, cfg, prompts, toks)
    return {"launches": launches, **st}


def serve_bounds(cfg, params) -> tuple:
    """Least time for the prefill and for one decode step of the main path.
    Prefill: 2 flops per layer weight per prompt token, causal attention,
    the LM head for the last token; it reads every weight but the
    embedding table once. Decode: it reads the layer weights, the LM head
    and the KV cache at its mean length over the decode loop once."""
    layers = list(_leaves(params["layers"]))
    layer_params = sum(t.numel() for t in layers)
    layer_bytes = sum(t.numel() * t.element_size() for t in layers)
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    head_bytes = head.numel() * head.element_size()
    attn_flops = 4 * REQUESTS * cfg.n_heads * cfg.hd * cfg.n_layers * (
        PROMPT_LEN * (PROMPT_LEN + 1) // 2)
    prefill = bound_ms(layer_bytes + head_bytes,
                       2 * layer_params * REQUESTS * PROMPT_LEN + attn_flops
                       + 2 * head.numel() * REQUESTS, torch.bfloat16)
    kv_bytes = 2 * cfg.n_layers * REQUESTS * (PROMPT_LEN + MAX_NEW / 2) \
        * cfg.n_kv_heads * cfg.hd * head.element_size()
    decode = bound_ms(layer_bytes + head_bytes + kv_bytes,
                      2 * (layer_params + head.numel()) * REQUESTS,
                      torch.bfloat16)
    return prefill, decode


def model_logits(params, cfg, prompts, toks, impl: str) -> list:
    """Last-token logits of the prefill, then of 3 decode steps fed
    ``toks`` (the same tokens for every path)."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import preallocate_cache
    logits, pre, pos = prefill(params, cfg, {"tokens": prompts}, impl=impl)
    caches = preallocate_cache(cfg, pre, PROMPT_LEN + MAX_NEW)
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
      order of the attention sums differs.
    - bf16: rounding to bf16 in every layer of a random-init 36-layer
      model moves the logits by ~1e-2 relative whichever attention path
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
def small_model_cpu_vs_card() -> None:
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import init_params, prefill
    from repro_torch.serve.engine import Engine, ServeConfig
    cfg = PRESETS["tiny"]
    params = init_params(torch.Generator("cpu").manual_seed(0), cfg)
    prompts = torch.randint(0, cfg.vocab_size, (2, 40),
                            generator=torch.Generator("cpu").manual_seed(1))
    on_card = _map(params, lambda t: t.to("cuda"))
    cpu_logits, _, _ = prefill(params, cfg, {"tokens": prompts})
    gpu_logits, _, _ = prefill(on_card, cfg, {"tokens": prompts.cuda()})
    err = max_err(gpu_logits.cpu(), cpu_logits)
    scfg = ServeConfig(max_new_tokens=8)
    ids_cpu = Engine(cfg, params, scfg, device="cpu").generate(prompts)
    ids_gpu = Engine(cfg, on_card, scfg, device="cuda").generate(prompts)
    log(f"{cfg.name} fp32, card vs CPU: prefill logits max abs err "
        f"{err:.3e}; greedy ids equal: {(ids_cpu == ids_gpu).all()}")
    if err > 1e-3 or not (ids_cpu == ids_gpu).all():
        raise AssertionError("small model: card and CPU disagree")


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
    kernels = [check_flash_attention(), check_decode_attention()]
    served = serve_full_width()
    for k in kernels:
        k["launches"] = served["launches"][k["name"]]
    small_model_cpu_vs_card()
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
