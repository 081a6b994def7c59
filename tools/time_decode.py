"""Decode ms/token of every model that ``chip_smoke.py`` serves, timed on
one NVIDIA GPU, to hold a change of the serving path's host cost against
another checkout.

  python3 tools/time_decode.py [--arch A,B] [--rounds N] [SRC ...]

Each SRC (default: this checkout's ``src``) is a directory that holds
``repro_torch``; each runs in a process of its own, in the order given, so
that a parent and a change can run as parent, change, change, parent. With
``--rounds N`` the SRCs run N times, the order rotated by one each round,
and a closing line gives each (SRC, model)'s median. In each process,
every model of chip_smoke.py's SERVED and STUB_SERVED (or those that
``--arch`` names), at full width and depth (bf16, random weights from seed
0), serves REQUESTS prompts of its prompt length and MAX_NEW new tokens as
phase 3 serves it: through ``Engine.generate`` (CUDA events around the
decode loop), or for a stub frontend through ``prefill`` and
``decode_step`` fed seeded embeddings (the same events), after a short
warm-up run. One line per model: decode ms/token and the host clock's ms
per run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def serve_stub(cfg, params, prompt_len: int, steps: int) -> float:
    """Decode ms per step of a stub frontend's prefill and ``steps``
    decode steps, on CUDA events as chip_smoke.py's serve_stub times it."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.serve.engine import preallocate_cache
    from chip_smoke import REQUESTS
    gen = torch.Generator("cuda").manual_seed(1)
    embeds = torch.randn((REQUESTS, prompt_len + steps, cfg.d_model),
                         generator=gen, device="cuda")
    with torch.no_grad():
        _, pre, pos = prefill(params, cfg, {"embeds": embeds[:, :prompt_len]})
        caches = preallocate_cache(cfg, pre, prompt_len + steps)
        del pre
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for i in range(steps):
            _, caches = decode_step(params, cfg, embeds[:, prompt_len + i],
                                    caches, pos + i)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / steps


def run(src: str, archs: list) -> None:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    from chip_smoke import MAX_NEW, REQUESTS, SERVED, STUB_SERVED
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Engine, ServeConfig
    for arch, prompt_len in {**SERVED, **STUB_SERVED}.items():
        if archs and arch not in archs:
            continue
        cfg = get_arch(arch)
        params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
        t0 = time.perf_counter()
        if arch in STUB_SERVED:
            serve_stub(cfg, params, 16, 2)                    # warm-up
            t0 = time.perf_counter()
            ms = serve_stub(cfg, params, prompt_len, MAX_NEW)
            host = (time.perf_counter() - t0) * 1e3
        else:
            engine = Engine(cfg, params, ServeConfig(max_new_tokens=MAX_NEW),
                            device="cuda")
            prompts = torch.randint(0, cfg.vocab_size, (REQUESTS, prompt_len),
                                    generator=torch.Generator(
                                        "cuda").manual_seed(1),
                                    device="cuda")
            engine.generate(prompts[:, :16], max_new_tokens=2)  # warm-up
            t0 = time.perf_counter()
            engine.generate(prompts)
            host = (time.perf_counter() - t0) * 1e3
            ms = engine.stats["decode_ms_per_token"]
        print(json.dumps({"src": src, "arch": arch, "decode_ms_per_token": ms,
                          "host_ms_per_run": host}), flush=True)
        del params
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--arch", default="", help="models to serve, a,b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("srcs", nargs="*")
    args = ap.parse_args()
    archs = [a for a in args.arch.split(",") if a]
    if args.run:
        run(args.run, archs)
        return 0
    srcs = args.srcs or [str(ROOT / "src")]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    times = {}
    for r in range(args.rounds):
        for src in srcs[r % len(srcs):] + srcs[:r % len(srcs)]:
            child = subprocess.run(
                [sys.executable, __file__, "--run", src, "--arch",
                 args.arch], stdout=subprocess.PIPE, text=True)
            sys.stdout.write(child.stdout)
            if child.returncode:
                return child.returncode
            for line in child.stdout.splitlines():
                if not line.startswith('{"src"'):
                    continue
                row = json.loads(line)
                times.setdefault(f"{src} {row['arch']}", []).append(
                    row["decode_ms_per_token"])
    if args.rounds > 1:
        print(json.dumps({"median_decode_ms_per_token": {
            k: statistics.median(v) for k, v in times.items()},
            "runs": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
