"""Where the attention kernels' time goes, by ablation, on one NVIDIA GPU.

  python3 tools/ablate_kernels.py

Builds variants of src/repro_torch/kernels/csrc/flash_attention.cu and
decode_attention.cu, each with one part of the kernel taken out by a text
edit, into build/ablate/ (one nvcc per variant, in parallel). A variant's
output is wrong; only its time counts. Each is timed at chip_smoke.py's
serving shapes (flash attention: B=4, S=512, H=32, Hkv=8, hd=128; flash
decode: B=4 x Hkv=8, grp 4, 544 slots, and batch 1 against 32,768 slots;
bf16), beside the unedited kernel, in two rounds, with chip_smoke.py's
time_ms. Flash decode is also timed on the same cache laid out head-major
(B, Hkv, S, hd), which the kernel reads through its strides. An edit that
no longer applies to the sources raises.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate"

# kernel -> {variant: [(text, replacement), ...]}
VARIANTS = {
    "flash_attention": {
        "as shipped": [],
        "no tile loads after the first": [
            ("    stage_kv(n + NSTAGE - 1);\n", "    cp_async_commit();\n")],
        "no Q K^T mma": [
            ("          mma_bf16(s[2 * j], qf[kk], kf[0], kf[1]);\n"
             "          mma_bf16(s[2 * j + 1], qf[kk], kf[2], kf[3]);\n", "")],
        "no P V mma": [
            ("          mma_bf16(o[2 * dd], a, vf[0], vf[1]);\n"
             "          mma_bf16(o[2 * dd + 1], a, vf[2], vf[3]);\n", "")],
        "no exp2 of the scores": [
            ("          s[j][2 * r] = fast_exp2(fmaf(s[j][2 * r], sl2, -base));\n"
             "          s[j][2 * r + 1] = fast_exp2(fmaf(s[j][2 * r + 1], sl2, "
             "-base));\n", "")],
        "no masks": [("        if (edge) {", "        if (false) {")],
        "2-stage ring": [("constexpr int NSTAGE = 3;",
                          "constexpr int NSTAGE = 2;")],
    },
    "decode_attention": {
        "as shipped": [],
        "no tile loads after the first": [
            ("    if (s0 + BS < s_end) stage(buf ^ 1, s0 + BS);\n", "")],
        "no score FMAs": [
            ("          s[g] = fmaf(qv.x, kf[e], s[g]);\n"
             "          s[g] = fmaf(qv.y, kf[e + 1], s[g]);\n"
             "          s[g] = fmaf(qv.z, kf[e + 2], s[g]);\n"
             "          s[g] = fmaf(qv.w, kf[e + 3], s[g]);\n",
             "          s[g] += kf[e];\n")],
        "no P V": [("    for (int j = warp * SPW; j < (warp + 1) * SPW; ++j) {",
                    "    for (int j = 0; j < 0; ++j) {")],
        "no merge kernel": [("  fd_merge_kernel<T><<<",
                             "  if (false) fd_merge_kernel<T><<<")],
    },
}


def build() -> dict:
    """{(kernel, variant): loaded library}, all variants built in parallel."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for kernel, variants in VARIANTS.items():
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        for i, (name, edits) in enumerate(variants.items()):
            text = src
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{kernel}, {name}: edit does not "
                                       f"apply: {old.strip()[:60]!r}")
                text = text.replace(old, new)
            cu = OUT / f"{kernel}_{i}.cu"
            cu.write_text(text)
            lib = cu.with_suffix(".so")
            procs[kernel, name] = (lib, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                 str(lib), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-3000:]}")
        libs[key] = ctypes.CDLL(str(lib))
        libs[key].repro_cuda_error_string.argtypes = [ctypes.c_int]
        libs[key].repro_cuda_error_string.restype = ctypes.c_char_p
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as dam
    from repro_torch.kernels import flash_attention as fam
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    libs = build()
    # the wrappers set each library's argument types on first load
    fa_types = fam._lib().flash_attention_launch.argtypes
    fd_types = dam._lib().decode_attention_launch.argtypes
    for (kernel, _), lib in libs.items():
        fn = getattr(lib, f"{kernel}_launch")
        fn.argtypes = fa_types if kernel == "flash_attention" else fd_types
        fn.restype = ctypes.c_int

    gen = torch.Generator("cuda").manual_seed(0)
    bf16 = torch.bfloat16
    q = cs.randn(gen, (4, 512, 32, 128), bf16)
    k = cs.randn(gen, (4, 512, 8, 128), bf16)
    v = cs.randn(gen, (4, 512, 8, 128), bf16, 1.0)
    decode = {}
    for label, b, s, lens in (("B=4, 544 slots", 4, 544, [544, 528, 520, 513]),
                              ("B=1, 32768 slots", 1, 32768, [32768])):
        kc = cs.randn(gen, (b, s, 8, 128), bf16)
        vc = cs.randn(gen, (b, s, 8, 128), bf16, 1.0)
        decode[label] = (cs.randn(gen, (b, 8, 4, 128), bf16), kc, vc,
                         torch.tensor(lens, device="cuda", dtype=torch.int32))

    times = {}
    for _ in range(2):
        for (kernel, name), lib in libs.items():
            if kernel == "flash_attention":
                fam._lib = lambda lib=lib: lib
                times.setdefault(f"flash attention: {name}", []).append(
                    cs.time_ms(lambda: fam.flash_attention(q, k, v), 50))
                continue
            dam._lib = lambda lib=lib: lib
            for label, (qd, kc, vc, lens) in decode.items():
                times.setdefault(f"flash decode {label}: {name}", []).append(
                    cs.time_ms(lambda: dam.decode_attention(qd, kc, vc, lens),
                               100))
                if name == "as shipped":
                    kh, vh = (t.transpose(1, 2).contiguous().transpose(1, 2)
                              for t in (kc, vc))
                    times.setdefault(
                        f"flash decode {label}: head-major cache", []).append(
                        cs.time_ms(lambda: dam.decode_attention(qd, kh, vh,
                                                                lens), 100))
    for key, ts in times.items():
        print(f"{key}: {' '.join(f'{t:.5f}' for t in ts)} ms")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
