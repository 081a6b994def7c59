"""The training path's backwards, timed on one NVIDIA GPU.

  python3 tools/time_backwards.py

At the training microbatches that chip_smoke.py trains, with its inputs
and time_ms:

* the attention backward kernels (``flash_attention_backward``) beside
  their plain version from the training forward's out and log-sum-exp and
  beside the torch-ops backward from q, k, v alone (``flash_attention_bwd``,
  what the card ran before the kernels), at qwen3-8b's (B=2, S=4096, 32/8
  heads of 128), hymba-1.5b's (B=4, 25/5 heads of 64, window 1024) and
  moonshot-v1-16b-a3b's (B=2, 16/16 heads of 128) shapes, bf16;
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

also builds ``DIR/wkv6_bwd.cu`` and ``DIR/mamba_scan_bwd.cu`` (another
checkout's ``src/repro_torch/kernels/csrc``, with its own common.cuh, e.g.
the parent commit's unpacked by ``git archive HEAD src | tar -x -C
build/parent``) into build/previous/ and times each beside the shipped
kernel on the same inputs. WKV6's C entry point kept its arguments, so
the previous library runs behind the current wrapper; the scan's previous
design is called through ``previous_mamba_scan_backward``, its wrapper as
it was.
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
    """{kernel: library} of csrc's wkv6_bwd.cu and mamba_scan_bwd.cu, built
    in parallel with the shipped flags into build/previous/."""
    from repro_torch.kernels import _build
    out = ROOT / "build" / "previous"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("wkv6_bwd", "mamba_scan_bwd"):
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


def previous_wkv6_backward(wk, lib):
    """``wkv6_backward`` through the previous library (the same C
    arguments; its scratch sized by its own wkv6_bwd_sub_chunk())."""
    current = wk._bwd_lib()
    lib.wkv6_bwd_launch.argtypes = current.wkv6_bwd_launch.argtypes
    lib.wkv6_bwd_launch.restype = ctypes.c_int
    lib.wkv6_bwd_sub_chunk.restype = ctypes.c_int

    def run(*args):
        wk._bwd_lib = lambda: lib
        try:
            return wk.wkv6_backward(*args)
        finally:
            wk._bwd_lib = lambda: current
    return run


def previous_mamba_scan_backward(ms, lib):
    """The scan's previous design (one block per 8 channels and batch row
    walking every chunk, its db/dc partials per block in device memory and
    summed by a second kernel), called as its wrapper called it."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mamba_scan_bwd_launch.argtypes = [vp] * 21 + [
        ctypes.POINTER(ctypes.c_int64), i32, i32, i32, i32, i32, i32, vp]
    lib.mamba_scan_bwd_launch.restype = i32
    lib.mamba_scan_bwd_channels.restype = i32

    def run(dt, dt_bias, b, c, x, z, a_log, d_skip, starts, dout, dh=None,
            chunk=ms.TIME_CHUNK):
        bsz, s, di = dt.shape
        n = a_log.shape[-1]
        f32 = torch.float32
        new = dict(device=dt.device)
        d_dt, d_x, d_z = (torch.empty((bsz, s, di), dtype=dt.dtype, **new)
                          for _ in range(3))
        d_b, d_c = (torch.empty((bsz, s, n), dtype=dt.dtype, **new)
                    for _ in range(2))
        parts = -(-di // lib.mamba_scan_bwd_channels())
        partials = torch.empty((2, parts, bsz, s, n), dtype=f32, **new)
        p_alog = torch.empty((bsz, di, n), dtype=f32, **new)
        p_bias, p_skip = (torch.empty((bsz, di), dtype=f32, **new)
                          for _ in range(2))
        strides = (ctypes.c_int64 * 12)(
            *dt.stride()[:2], *b.stride()[:2], *c.stride()[:2],
            *x.stride()[:2], *z.stride()[:2], *dout.stride()[:2])
        err = lib.mamba_scan_bwd_launch(
            dt.data_ptr(), dt_bias.data_ptr(), b.data_ptr(), c.data_ptr(),
            x.data_ptr(), z.data_ptr(), a_log.data_ptr(), d_skip.data_ptr(),
            starts.data_ptr(), dout.data_ptr(),
            None if dh is None else dh.data_ptr(), d_dt.data_ptr(),
            d_x.data_ptr(), d_z.data_ptr(), partials[0].data_ptr(),
            partials[1].data_ptr(), d_b.data_ptr(), d_c.data_ptr(),
            p_bias.data_ptr(), p_skip.data_ptr(), p_alog.data_ptr(), strides,
            ms.DTYPES[dt.dtype], bsz, s, di, n, chunk,
            torch.cuda.current_stream(dt.device).cuda_stream)
        if err:
            raise RuntimeError(f"previous mamba_scan_bwd: CUDA error {err}")
        return (d_dt, p_bias.sum(0), d_b, d_c, d_x, d_z, p_alog.sum(0),
                p_skip.sum(0))
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
        rounds(cs, f"attention backward, {arch} B={b} S={s} {h}/{hkv} heads "
               f"of {hd}, window {window}, bf16", {
                   "flash_attention_backward (the kernels)":
                   lambda: fa.flash_attention_backward(q, k, v, out, lse,
                                                       dout, window),
                   "flash_attention_bwd from out and lse (plain version)":
                   lambda: fa.flash_attention_bwd(q, k, v, dout, window,
                                                  out=out, lse=lse),
                   "flash_attention_bwd from q, k, v (torch ops before)":
                   lambda: fa.flash_attention_bwd(q, k, v, dout, window)})
        del q, k, v, dout, out, lse
    s = cs.TRAIN_SEQ
    b = cs.TRAIN_BATCH // get_arch("hymba-1.5b").grad_accum
    inputs = cs.mamba_train_inputs(gen, b, s, torch.bfloat16)
    dout = cs.randn(gen, (b, s, cs.MAMBA_DI), torch.bfloat16, 1.0)
    starts = ms.mamba_chunk_states(*inputs)[2]
    variants = {"mamba_scan_backward (the kernel)":
                lambda: ms.mamba_scan_backward(*inputs, starts, dout)}
    if previous:
        old = previous_mamba_scan_backward(ms, previous["mamba_scan_bwd"])
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
        old = previous_wkv6_backward(wk, previous["wkv6_bwd"])
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
