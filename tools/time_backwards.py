"""The recurrences' torch-ops backwards, timed on one NVIDIA GPU.

  python3 tools/time_backwards.py

Times ``wkv6_bwd`` and ``mamba_scan_bwd`` at the training microbatches
that chip_smoke.py trains (WKV6: rwkv6-3b's B=2, S=4096, H=40, hd=64,
fp32; the fused Mamba scan: hymba-1.5b's B=4, S=4096, di=1600, n=16,
bf16), with chip_smoke.py's inputs and time_ms, for each sub-chunk length
T of the chunked form (``SUB_CHUNK``) and each number of steps recomputed
at once (``RECOMPUTE_STEPS``: 256 recomputes the kept 256-step chunks one
by one), each with the peak memory it allocates beyond its inputs. The
variants run in two rounds, so that a difference between them can be told
from the spread.
"""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SUBS = (8, 16, 32)
STEPS = (256, 1024, 4096)


def variants(mod):
    """{label: (sub, steps)}: the shipped setting, each other T at it, and
    each other number of steps at the shipped T."""
    out = {f"T={mod.SUB_CHUNK}, {mod.RECOMPUTE_STEPS} steps at once (as "
           f"shipped)": (mod.SUB_CHUNK, mod.RECOMPUTE_STEPS)}
    out.update({f"T={t}": (t, mod.RECOMPUTE_STEPS) for t in SUBS
                if t != mod.SUB_CHUNK})
    out.update({f"{n} steps at once": (mod.SUB_CHUNK, n) for n in STEPS
                if n != mod.RECOMPUTE_STEPS})
    return out


def timed(cs, mod, chunked: str, bwd, args: list) -> None:
    real = getattr(mod, chunked)
    results: dict = {}
    for _ in range(2):
        for label, (sub, steps) in variants(mod).items():
            setattr(mod, chunked, functools.partial(real, sub=sub))
            try:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ms = cs.time_ms(lambda: bwd(*args, steps=steps), 3,
                                warmup=1)
                peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            finally:
                setattr(mod, chunked, real)
            results.setdefault(label, []).append((ms, peak))
    for label, runs in results.items():
        cs.log(f"  {bwd.__name__}, {label}: " + ", ".join(
            f"{ms:.4f} ms" for ms, _ in runs)
            + f"; {max(p for _, p in runs):.2f} GB beyond its inputs")


def main() -> int:
    if not torch.cuda.is_available():
        print("time_backwards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.environment()
    gen = torch.Generator("cuda").manual_seed(7)
    # each model's microbatch: TRAIN_BATCH sequences in grad_accum parts
    b, s = cs.TRAIN_BATCH // get_arch("rwkv6-3b").grad_accum, \
        cs.TRAIN_SEQ
    inputs = cs.decay(cs.wkv6_train_inputs(gen, b, s))
    dy = cs.randn(gen, (b, s, cs.RWKV_HEADS, cs.RWKV_HD), torch.float32,
                  1.0)
    starts = wk.wkv6_chunk_states(*inputs)[2]
    cs.log(f"wkv6_bwd, B={b}, S={s}, H={cs.RWKV_HEADS}, hd={cs.RWKV_HD}, "
           f"fp32:")
    timed(cs, wk, "wkv6_chunked", wk.wkv6_bwd, [*inputs, starts, dy])
    del inputs, dy, starts
    b = cs.TRAIN_BATCH // get_arch("hymba-1.5b").grad_accum
    inputs = cs.mamba_train_inputs(gen, b, s, torch.bfloat16)
    dout = cs.randn(gen, (b, s, cs.MAMBA_DI), torch.bfloat16, 1.0)
    starts = ms.mamba_chunk_states(*inputs)[2]
    cs.log(f"mamba_scan_bwd, B={b}, S={s}, di={cs.MAMBA_DI}, "
           f"n={cs.MAMBA_N}, bf16:")
    timed(cs, ms, "mamba_scan_chunked", ms.mamba_scan_bwd,
          [*inputs, starts, dout])
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
