"""The training path's backwards, timed on one NVIDIA GPU.

  python3 tools/time_backwards.py

At the training microbatches that chip_smoke.py trains, with its inputs
and time_ms:

* the attention backward kernels (``flash_attention_backward``) beside
  their plain version from the training forward's out and log-sum-exp and
  beside the torch-ops backward from q, k, v alone (``flash_attention_bwd``,
  what the card ran before the kernels), at each of chip_smoke.py's
  ATTENTION_TRAINED shapes: qwen3-8b's (B=2, S=4096, 32/8 heads of 128),
  hymba-1.5b's (B=4, 25/5 heads of 64, window 1024), moonshot-v1-16b-a3b's
  (B=2, 16/16 heads of 128), phi3-mini-3.8b's (B=2, 32/32 heads of 96)
  and h2o-danube-1.8b's (B=4, 32/8 heads of 80, window 4096), bf16;
* the fused Mamba scan's backward kernel (``mamba_scan_backward``) beside
  its torch-ops plain version (``mamba_scan_bwd``) at hymba-1.5b's (B=4,
  S=4096, di=1600, n=16, bf16);
* WKV6's backward kernel (``wkv6_backward``) beside its torch-ops plain
  version (``wkv6_bwd``) at rwkv6-3b's (B=2, S=4096, H=40, hd=64, fp32),
  with the model's decays.

Each variant runs in two rounds, in the order A, B, ..., then reversed,
so that a difference between them can be told from the spread, each with
the peak memory it allocates beyond its inputs.

  python3 tools/time_backwards.py --previous DIR

also builds ``DIR/flash_attention_bwd.cu``, ``DIR/wkv6_bwd.cu`` and
``DIR/mamba_scan_bwd.cu`` (another checkout's
``src/repro_torch/kernels/csrc``, with its own common.cuh, e.g. the parent
commit's unpacked by ``git archive HEAD src | tar -x -C build/parent``)
into build/previous/ and times each beside the shipped kernel on the same
inputs. The three C entry points keep their arguments, so each previous
library runs behind the current wrapper.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def rounds(cs, what: str, variants: dict, iters: int = 3) -> None:
    """Time each of ``variants`` ({label: fn}) in two rounds, the second in
    reverse order, with the memory each allocates beyond what exists."""
    results: dict = {}
    order = list(variants)
    for labels in (order, order[::-1]):
        for label in labels:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = cs.time_ms(variants[label], iters, warmup=1)
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            results.setdefault(label, []).append((ms, peak))
    for label in order:
        runs = results[label]
        cs.log(f"  {what}, {label}: " + ", ".join(
            f"{ms:.4f} ms" for ms, _ in runs)
            + f"; {max(p for _, p in runs):.2f} GB beyond its inputs")


def build_previous(csrc: Path) -> dict:
    """{kernel: library} of csrc's backward kernels, built in parallel with
    the shipped flags into build/previous/."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "previous"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("flash_attention_bwd", "wkv6_bwd", "mamba_scan_bwd"):
        lib = out / f"{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the previous {name}:\n"
                               f"{log[-3000:]}")
        print(f"previous {name}: ptxas " + "; ".join(
            line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "registers" in line or "spill stores" in line))
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].repro_cuda_error_string.argtypes = [ctypes.c_int]
        libs[name].repro_cuda_error_string.restype = ctypes.c_char_p
    return libs


def behind(module, lib, wrapper):
    """``wrapper`` of ``module`` (its backward, which loads its library by
    ``module._bwd_lib``) run with the previous library ``lib`` in the
    current one's place: each C function the current wrapper declared
    gets the same argument and result types there."""
    current = module._bwd_lib()
    for name, fn in vars(current).items():
        if isinstance(fn, ctypes._CFuncPtr) and hasattr(lib, name):
            getattr(lib, name).argtypes = fn.argtypes
            getattr(lib, name).restype = fn.restype

    def run(*args):
        module._bwd_lib = lambda: lib
        try:
            return wrapper(*args)
        finally:
            module._bwd_lib = lambda: current
    return run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--previous", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_backwards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import wkv6 as wk
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.environment()
    previous = build_previous(args.previous) if args.previous else {}
    gen = torch.Generator("cuda").manual_seed(7)
    for arch in cs.ATTENTION_TRAINED.values():
        sh = cs.attention_train_shape(arch)
        b, s, h, hkv, hd, window = (sh[k] for k in ("b", "s", "h", "hkv",
                                                    "hd", "window"))
        q = cs.randn(gen, (b, s, h, hd), torch.bfloat16)
        k = cs.randn(gen, (b, s, hkv, hd), torch.bfloat16)
        v = cs.randn(gen, (b, s, hkv, hd), torch.bfloat16, 1.0)
        dout = cs.randn(gen, (b, s, h, hd), torch.bfloat16, 1.0)
        out, lse = fa.flash_attention_train(q, k, v, window)
        given = (q, k, v, out, lse, dout, window)
        variants = {f"flash_attention_backward (the kernels, "
                    f"{fa.backward_body(hd, q.dtype)})":
                    lambda: fa.flash_attention_backward(*given)}
        if previous:
            old = behind(fa, previous["flash_attention_bwd"],
                         fa.flash_attention_backward)
            variants["the previous design"] = lambda: old(*given)
        variants["flash_attention_bwd from out and lse (plain version)"] = \
            lambda: fa.flash_attention_bwd(q, k, v, dout, window, out=out,
                                           lse=lse)
        variants["flash_attention_bwd from q, k, v (torch ops before)"] = \
            lambda: fa.flash_attention_bwd(q, k, v, dout, window)
        rounds(cs, f"attention backward, {arch} B={b} S={s} {h}/{hkv} heads "
               f"of {hd}, window {window}, bf16", variants)
        del q, k, v, dout, out, lse, given, variants
    s = cs.TRAIN_SEQ
    b = cs.TRAIN_BATCH // get_arch("hymba-1.5b").grad_accum
    inputs = cs.mamba_train_inputs(gen, b, s, torch.bfloat16)
    dout = cs.randn(gen, (b, s, cs.MAMBA_DI), torch.bfloat16, 1.0)
    starts = ms.mamba_chunk_states(*inputs)[2]
    variants = {"mamba_scan_backward (the kernel)":
                lambda: ms.mamba_scan_backward(*inputs, starts, dout)}
    if previous:
        old = behind(ms, previous["mamba_scan_bwd"], ms.mamba_scan_backward)
        variants["the previous design"] = lambda: old(*inputs, starts,
                                                      dout)
    variants["mamba_scan_bwd (torch ops)"] = \
        lambda: ms.mamba_scan_bwd(*inputs, starts, dout)
    rounds(cs, f"Mamba scan backward, B={b}, S={s}, di={cs.MAMBA_DI}, "
           f"n={cs.MAMBA_N}, bf16", variants)
    del inputs, dout, starts, variants
    b = cs.TRAIN_BATCH // get_arch("rwkv6-3b").grad_accum
    inputs = cs.decay(cs.wkv6_train_inputs(gen, b, s))
    dy = cs.randn(gen, (b, s, cs.RWKV_HEADS, cs.RWKV_HD), torch.float32,
                  1.0)
    starts = wk.wkv6_chunk_states(*inputs)[2]
    variants = {"wkv6_backward (the kernel)":
                lambda: wk.wkv6_backward(*inputs, starts, dy)}
    if previous:
        old = behind(wk, previous["wkv6_bwd"], wk.wkv6_backward)
        variants["the previous design"] = lambda: old(*inputs, starts,
                                                      dy)
    variants["wkv6_bwd (torch ops)"] = \
        lambda: wk.wkv6_bwd(*inputs, starts, dy)
    rounds(cs, f"WKV6 backward, B={b}, S={s}, H={cs.RWKV_HEADS}, "
           f"hd={cs.RWKV_HD}, fp32", variants)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
