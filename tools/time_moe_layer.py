"""moonshot-v1-16b-a3b's MoE layer (``models.moe.apply_moe``, the flat
dispatch) timed on one NVIDIA GPU, to hold a change of the dispatch
against another checkout.

  python3 tools/time_moe_layer.py [SRC ...]

Each SRC (default: this checkout's ``src``) is a directory that holds
``repro_torch``; each runs in a process of its own, in the order given, so
that a parent and a change can run as parent, change, change, parent. At
full width (d 2048, 64 experts, top 6, d_ff 1408, cf 1.25, bf16, one
layer of random weights from seed 0) it times the serving prefill's 4 x
512 tokens and a decode step's 4 tokens without autograd, and a training
microbatch's 2 x 4096 tokens forward and backward: the median of 20 calls
after 3 warm-up calls, on CUDA events and on the host clock (a decode
step is host-bound, so its host time is the one that moves end to end).
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("prefill", 4 * 512, False), ("decode", 4, False),
          ("train", 2 * 4096, True))


def timed(fn, calls: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(median device ms, median host ms) of ``fn``'s calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return statistics.median(dev), statistics.median(host)


def run(src: str) -> None:
    sys.path.insert(0, src)
    from repro_torch.configs import get_arch
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"), n_layers=1)
    gen = torch.Generator("cuda").manual_seed(0)
    p = {k: v[0] for k, v in moe.init_moe(gen, cfg, torch.bfloat16).items()}
    cells = []
    for name, t, train in SHAPES:
        x = torch.randn((t, cfg.d_model), device="cuda", dtype=torch.bfloat16,
                        generator=gen)
        if train:
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            x.requires_grad_()

            def step():
                out, aux = moe.apply_moe(leaves, x, cfg)
                (out.float().sum() + aux).backward()
        else:
            def step():
                with torch.no_grad():
                    moe.apply_moe(p, x, cfg)
        dev, host = timed(step)
        cells.append(f"{name} ({t} tokens) {dev:.4f} ms device, "
                     f"{host:.4f} ms host")
    print(f"{src}: " + "; ".join(cells), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--run"]:
        run(sys.argv[2])
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for src in sys.argv[1:] or [str(ROOT / "src")]:
        subprocess.run([sys.executable, __file__, "--run", src], check=True)


if __name__ == "__main__":
    main()
