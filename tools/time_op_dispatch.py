"""Host time of one call of the decode path's kernel operators on one
NVIDIA GPU, against the launch that each wraps and against the same
launch registered through ``torch.library.custom_op``.

  python3 tools/time_op_dispatch.py [--calls N] [--rounds R]

Shapes: one decode step's call of each kernel, as the models serve four
requests: the Mamba scan at hymba-1.5b's (di 1600, n 16, bf16) with its
state a layer's slice of the (L, B, di, n) cache, WKV6 at rwkv6-3b's (40
heads of 64, fp32) with its state a slice of its cache, and decode
attention at hymba-1.5b's (25 query heads over 5 KV heads of 64, a
1024-slot cache, bf16). Each variant runs N calls in a row under
``torch.no_grad`` (as ``Engine`` decodes), the card synchronised before
and after; R rounds, the order rotated each round; the median of the
host clock's microseconds a call:

* ``launch``: the operator's CUDA implementation called as a Python
  function: the checks, the output's allocation, the ctypes launch;
* ``operator``: the operator as the port registers it
  (``torch.library.define`` and ``impl``), called through ``torch.ops``;
* ``wrapper``: the function the model calls (``mamba_scan.mamba_scan``,
  ``wkv6.wkv6``, ``decode_attention.decode_attention``);
* ``custom_op``: the same launch registered through
  ``torch.library.custom_op`` with the port's schema, the state in
  ``mutates_args``;
* ``custom_op_pure``: the same without the ``(a!)`` mark and
  ``mutates_args``, to part the in-place layers' cost from the rest.

Then a ``cProfile`` of the Mamba scan's ``custom_op`` calls: the
functions with the most time of their own. Last, in the same process,
hymba-1.5b and rwkv6-3b served as ``tools/time_decode.py`` serves them
(full width and depth, random weights from seed 0, chip_smoke.py's
prompts and MAX_NEW), R rounds of three routes in rotating order, the
model's wrappers calling: ``operators`` (as shipped), ``launches`` (each
CUDA implementation directly, as the wrappers did before the kernels
were operators) or ``custom_op`` (the registrations above); the median
decode ms/token and prefill ms of each.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mamba_scan as ms  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

SCHEMAS = {
    "mamba_scan": "(Tensor dt, Tensor dt_bias, Tensor b, Tensor c, "
                  "Tensor x, Tensor z, Tensor a_log, Tensor d_skip, "
                  "Tensor(a!) h, bool has_state) -> Tensor",
    "wkv6": "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
            "Tensor(a!) state, bool has_state) -> Tensor",
    "decode_attention": "(Tensor q, Tensor k_cache, Tensor v_cache, "
                        "Tensor cache_len) -> Tensor",
    "flash_attention": "(Tensor q, Tensor k, Tensor v, SymInt? window) "
                       "-> Tensor",
}
MODULES = {"mamba_scan": ms, "wkv6": wk, "decode_attention": da,
           "flash_attention": fa}
STATE = {"mamba_scan": "h", "wkv6": "state"}


def custom_op(name: str, impl, mutating: bool):
    """``impl`` registered through ``torch.library.custom_op`` under a
    name of its own, with or without the state's mutation declared."""
    schema = SCHEMAS[name]
    if not mutating:
        schema = schema.replace("Tensor(a!)", "Tensor")
    suffix = "" if mutating else "_pure"
    return torch.library.custom_op(
        f"time_op_dispatch::{name}{suffix}",
        mutates_args=(STATE[name],) if mutating and name in STATE else (),
        device_types="cuda", schema=schema)(impl)


def inputs(dev: str) -> dict:
    """{kernel: (operator arguments, wrapper arguments)} at the decode
    shapes, from seed 0."""
    gen = torch.Generator(dev).manual_seed(0)
    bf16 = torch.bfloat16

    def rand(*shape, dtype=torch.float32, low=-1.0, high=1.0):
        t = torch.rand(shape, generator=gen, device=dev)
        return (low + (high - low) * t).to(dtype)

    bsz, di, n = 4, 1600, 16
    dt, x, z = (rand(bsz, 1, di, dtype=bf16) for _ in range(3))
    b, c = rand(bsz, 1, n, dtype=bf16), rand(bsz, 1, n, dtype=bf16)
    vec, a_log = rand(di), rand(di, n, low=0.0)
    h = torch.zeros(32, bsz, di, n, device=dev)[5]
    r, k, v = (rand(bsz, 1, 40, 64) for _ in range(3))
    w, u = rand(bsz, 1, 40, 64, low=0.9, high=0.999), rand(40, 64)
    state = torch.zeros(32, bsz, 40, 64, 64, device=dev)[5]
    q = rand(bsz, 5, 5, 64, dtype=bf16)
    kc, vc = (rand(bsz, 1024, 5, 64, dtype=bf16) for _ in range(2))
    lens = torch.full((bsz,), 1024, dtype=torch.int32, device=dev)
    return {"mamba_scan": ((dt, vec, b, c, x, z, a_log, vec, h, True),
                           (dt, vec, b, c, x, z, a_log, vec, h)),
            "wkv6": ((r, k, v, w, u, state, True), (r, k, v, w, u, state)),
            "decode_attention": ((q, kc, vc, lens), (q, kc, vc, lens))}


def per_call_us(fn, args, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def serve_routes(rounds: int, custom: dict) -> None:
    """hymba-1.5b and rwkv6-3b served through each route in turn (see the
    module docstring); one line per model."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import MAX_NEW, REQUESTS, SERVED
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Engine, ServeConfig
    routes = {
        "operators": {k: getattr(m, f"{k}_op") for k, m in MODULES.items()},
        "launches": {k: getattr(m, f"_{k}_cuda") for k, m in MODULES.items()},
        "custom_op": custom}
    for arch in ("hymba-1.5b", "rwkv6-3b"):
        cfg = get_arch(arch)
        params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
        engine = Engine(cfg, params, ServeConfig(max_new_tokens=MAX_NEW),
                        device="cuda")
        prompts = torch.randint(0, cfg.vocab_size, (REQUESTS, SERVED[arch]),
                                generator=torch.Generator(
                                    "cuda").manual_seed(1), device="cuda")
        runs = {r: {"decode_ms_per_token": [], "prefill_ms": []}
                for r in routes}
        order = list(routes)
        for r in range(rounds):
            for route in order[r % len(order):] + order[:r % len(order)]:
                for k, fn in routes[route].items():
                    setattr(MODULES[k], f"{k}_op", fn)
                engine.generate(prompts[:, :16], max_new_tokens=2)  # warm-up
                engine.generate(prompts)
                for key in runs[route]:
                    runs[route][key].append(engine.stats[key])
        for k, fn in routes["operators"].items():
            setattr(MODULES[k], f"{k}_op", fn)
        print(json.dumps({"arch": arch, "median": {
            route: {key: statistics.median(v) for key, v in r.items()}
            for route, r in runs.items()}, "runs": runs}), flush=True)
        del engine, params
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("time_op_dispatch: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}", flush=True)
    custom = {k: custom_op(k, getattr(m, f"_{k}_cuda"), True)
              for k, m in MODULES.items()}
    pure = {k: custom_op(k, getattr(m, f"_{k}_cuda"), False)
            for k, m in MODULES.items() if k in STATE}
    data = inputs("cuda")
    with torch.no_grad():
        for name, args_ in data.items():
            m = MODULES[name]
            op_args, wrapper_args = args_
            variants = {"launch": (getattr(m, f"_{name}_cuda"), op_args),
                        "operator": (getattr(m, f"{name}_op"), op_args),
                        "wrapper": (getattr(m, name), wrapper_args),
                        "custom_op": (custom[name], op_args)}
            if name in pure:
                variants["custom_op_pure"] = (pure[name], op_args)
            for fn, a in variants.values():             # build and warm up
                per_call_us(fn, a, 20)
            runs = {v: [] for v in variants}
            order = list(variants)
            for r in range(args.rounds):
                for v in order[r % len(order):] + order[:r % len(order)]:
                    runs[v].append(per_call_us(*variants[v], args.calls))
            print(json.dumps({"kernel": name, "median_us_per_call": {
                v: statistics.median(t) for v, t in runs.items()},
                "runs_us": runs}), flush=True)
        fn, a = custom["mamba_scan"], data["mamba_scan"][0]
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(500):
            fn(*a)
        prof.disable()
        torch.cuda.synchronize()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(18)
    print("custom_op mamba_scan, 500 calls, by own time:")
    print(out.getvalue()[-6000:], flush=True)
    serve_routes(args.rounds, custom)
    return 0


if __name__ == "__main__":
    sys.exit(main())
