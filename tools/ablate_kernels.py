"""Where the kernels' time goes, by ablation, on one NVIDIA GPU.

  python3 tools/ablate_kernels.py [flash_attention] [decode_attention] [wkv6]
                                  [mamba_scan] [flash_attention_bwd]
                                  [wkv6_bwd] [mamba_scan_bwd]
                                  [--previous DIR] [--match TEXT]

Builds variants of the named sources under src/repro_torch/kernels/csrc/
(all seven when none is named), each with one part of the kernel taken
out, or one tile size changed, by a text edit, into build/ablate/ (one
nvcc per variant, in parallel). A variant that takes a part out gives a
wrong output; only its time counts. Each is timed at chip_smoke.py's
serving shapes (flash attention: FA_SHAPES, the serving prefills of
qwen3-8b, phi3-mini-3.8b, pixtral-12b, h2o-danube-1.8b and hymba-1.5b
and the training forward at qwen3-8b's, phi3-mini-3.8b's and
h2o-danube-1.8b's microbatches; flash decode: B=4 x Hkv=8, grp 4, 544 slots, and batch 1 against 32,768 slots;
bf16; WKV6's chunked body: B=4, S=1024, H=40, hd=64, fp32, its
training forward at rwkv6-3b's B=2, S=4096, the model's decays, and its
token body at the decode shape B=4, H=40, hd=64 from a state, S=1 and
S=15 L2-warm and S=1 a layer walking a 32-layer (84 MB) cache, cold; the fused
Mamba scan: hymba's B=4, S=4096, di=1600, n=16, bf16, and its token body
at the decode shape B=4, di=1600, n=16 from a state, S=1 and S=15 L2-warm
and S=1 a layer walking a 192-layer (78.6 MB) stack of states, cold; the
backward kernels at the training microbatches: attention's at qwen3-8b's
B=2, S=4096, 32/8 heads of 128, hymba-1.5b's B=4, 25/5 heads of 64, window
1024, phi3-mini-3.8b's B=2, 32/32 heads of 96 and h2o-danube-1.8b's B=4,
32/8 heads of 80, window 4096, pixtral-12b's B=1, 32/8 heads of 160
and musicgen-large's B=2, 32/32 heads of 64, bf16; WKV6's at rwkv6-3b's
B=2, S=4096, H=40, hd=64, fp32, the model's decays; the scan's at
hymba-1.5b's B=4, S=4096, bf16), beside the unedited kernel, in two rounds (the second in
reverse order), with chip_smoke.py's time_ms. With ``--previous DIR``
(another checkout's ``src/repro_torch/kernels/csrc``, e.g. the parent
commit's unpacked by ``git archive HEAD src | tar -x -C build/parent``)
each named kernel's source there is built with that directory's headers
and timed in the same rounds behind the current wrapper, its C entry
point keeping its arguments (the scan's gained two with its training
forward's starts: an older scan raises; an older WKV6 without the
training entry is timed at training through one launch a chunk). Flash decode
is also timed on the same cache laid out head-major (B, Hkv, S, hd), which
the kernel reads through its strides. Each WKV6 variant's relative L2
error against an fp64 recurrence is printed too (B=2, S=1024, H=5, hd=64
from a nonzero state, decays in the model's range 0.99-0.9999), beside
the plain fp32 version's, and at S=15 (B=4, H=40: the token body). An
edit that no longer applies to the sources raises. ``--match TEXT``
builds only the variants whose name holds TEXT, beside the unedited
kernel (e.g. ``wkv6 --match "token body"``).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "ablate"

# every 3xTF32 product of a source as one plain TF32 mma (hi * hi)
TF32_ONLY = [
    ('#include "common.cuh"\n',
     '#include "common.cuh"\n__device__ __forceinline__ void mma1(float* c, '
     'const FragA& a, const FragB& b) {\n  mma_tf32(c, a.hi, b.hi[0], '
     'b.hi[1]);\n}\n'),
    ("mma3(", "mma1(")]

# kernel -> {variant: [(text, replacement), ...]}
VARIANTS = {
    "flash_attention": {
        "as shipped": [],
        # the producer still completes each stage's full barrier, so the
        # consumers run on stale bytes
        "no K/V tile loads after each item's first": [
            ("      mbar_expect_tx(full + st, 2 * C::KTILE);\n",
             "      if (n > 0) {\n        mbar_arrive(full + st);\n"
             "        continue;\n      }\n"
             "      mbar_expect_tx(full + st, 2 * C::KTILE);\n")],
        "no Q K^T wgmma": [
            ("      wgmma_ss<KN>(s, kmajor(sQ, kk, C::QBOX), "
             "kmajor(sK, kk, C::KBOX),\n                   kk > 0);\n",
             "      (void)kk;\n")],
        "no P V wgmma": [
            ("wgmma_rs<HD, C::KBOX>(o, pa[kk], sV, kk);", "(void)pa[kk];")],
        "no turns between the consumer warpgroups": [
            ('  asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");',
             "  (void)id;"),
            ('  asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");',
             "  (void)id;")],
        "the softmax after P V (no overlap)": [
            ("        pass_turn();\n        wg_wait<1>();\n",
             "        pass_turn();\n        wg_wait0();\n")],
        "no exp2 of the scores": [
            ("        sj[0] = fast_exp2(fmaf(sj[0], sl2, -base));\n"
             "        sj[1] = fast_exp2(fmaf(sj[1], sl2, -base));\n", "")],
        "no masks": [("      if (edge) {", "      if (false) {")],
        "one ring stage fewer": [
            ("      hopper_bytes(QTILE, KTILE, 4) <= MAX_SMEM   ? 4\n"
             "      : hopper_bytes(QTILE, KTILE, 3) <= MAX_SMEM ? 3\n"
             "                                                  : 2;",
             "      (hopper_bytes(QTILE, KTILE, 4) <= MAX_SMEM   ? 4\n"
             "       : hopper_bytes(QTILE, KTILE, 3) <= MAX_SMEM ? 3\n"
             "                                                   : 2) - 1;")],
        "64-key tiles at every hd": [
            ("  static constexpr int BN = HD > 128 ? 64 : 128;",
             "  static constexpr int BN = 64;")],
        # without setmaxnreg no warpgroup waits for registers, and every
        # thread keeps the 168 of the launch bounds (ptxas may use fewer)
        "no setmaxnreg (consumers keep 168 registers)": [
            ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");\n',
             ""),
            ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");\n',
             ""),
            ("check_entry_registers(fa_hopper_kernel<HD>, ENTRY_REGS)",
             "check_entry_registers(fa_hopper_kernel<HD>, 0)")],
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
    "wkv6": {
        "as shipped": [],
        "the token-by-token body at every S": [
            ("  return p.S >= CT ? launch_chunk<HD, false>(p, B, 1, stream)",
             "  return false ? launch_chunk<HD, false>(p, B, 1, stream)")],
        "no chunk loads after the first": [
            ("    if (t0 + T < run_length<CHUNKS>(p)) stage(buf ^ 1, t0 + T);\n",
             "")],
        "no 3xTF32 lo terms": TF32_ONLY,
        "no pairwise M": [
            ("      build_m<HD>(sr, sk, sw, uu, sM, tid);\n", "      (void)0;\n")],
        "no decay products D, E, A": [
            ("    for (int x = tid - C::DE0; x >= 0 && x < C::DET; "
             "x += NT - C::DE0) {",
             "    for (int x = 0; false;) {")],
        "no y products": [
            ("        mma3(y[hs], frag_a(a[0], a[2], a[1], a[3]), "
             "frag_b(bv.x, bv.y));\n", "        (void)a;\n"),
            ("        mma3(y[hs], fv, frag_b(mrow[0], mrow[4]));\n",
             "        (void)mrow;\n")],
        "the state as the update's mma accumulator": [
            ("        float ds[4] = {0.f, 0.f, 0.f, 0.f};\n"
             "        mma3(ds, fv, frag_b(ke[0], ke[4 * LDR]));\n"
             "        const float2 a2 = *reinterpret_cast<const float2*>(\n"
             "            sA + hs * HD + 16 * wr + 8 * nn + 2 * tq);\n",
             "        const float2 a2 = *reinterpret_cast<const float2*>(\n"
             "            sA + hs * HD + 16 * wr + 8 * nn + 2 * tq);\n"
             "        float ds[4] = {a2.x * st[nn][0], a2.y * st[nn][1],\n"
             "                       a2.x * st[nn][2], a2.y * st[nn][3]};\n"
             "        mma3(ds, fv, frag_b(ke[0], ke[4 * LDR]));\n"),
            ("        st[nn][0] = fmaf(a2.x, st[nn][0], ds[0]);\n"
             "        st[nn][1] = fmaf(a2.y, st[nn][1], ds[1]);\n"
             "        st[nn][2] = fmaf(a2.x, st[nn][2], ds[2]);\n"
             "        st[nn][3] = fmaf(a2.y, st[nn][3], ds[3]);\n",
             "        st[nn][0] = ds[0];\n"
             "        st[nn][1] = ds[1];\n"
             "        st[nn][2] = ds[2];\n"
             "        st[nn][3] = ds[3];\n")],
        "no state-update product": [
            ("        mma3(ds, fv, frag_b(ke[0], ke[4 * LDR]));\n", "")],
        "T = 32": [("constexpr int CT = 16;", "constexpr int CT = 32;")],
        "COLS = 16": [("constexpr int CCOLS = 32;",
                       "constexpr int CCOLS = 16;")],
        "training summaries' copies three sub-chunks ahead (a ring of 4)": [
            ("constexpr int SST = 2;", "constexpr int SST = 4;")],
        "training summaries at 3 blocks an SM (80 registers)": [
            ("__launch_bounds__(SumShape<HD>::NT, 2)",
             "__launch_bounds__(SumShape<HD>::NT, 3)")],
        "chunked body at 2 blocks an SM": [
            ("  static constexpr int MIN_BLOCKS = (20 + NW - 1) / NW;",
             "  static constexpr int MIN_BLOCKS = 2;")],

        "training forward without its summaries kernel": [
            ("  wkv6_summary_kernel<HD><<<",
             "  if (false) wkv6_summary_kernel<HD><<<")],
        "training forward without its carry kernel": [
            ("  wkv6_carry_kernel<<<", "  if (false) wkv6_carry_kernel<<<")],
        # the token body (decode): its layouts, its launch's cost, and what
        # it no longer does
        "token body: 16 row groups (4 key rows a thread)": [
            ("constexpr int TRG = 8;", "constexpr int TRG = 16;")],
        "token body: 4 row groups (16 key rows a thread)": [
            ("constexpr int TRG = 8;", "constexpr int TRG = 4;")],
        "token body: one block a head (all its columns, the first design)": [
            ("constexpr int TSPLIT = 2;", "constexpr int TSPLIT = 1;")],
        "token body: four blocks a head": [
            ("constexpr int TSPLIT = 2;", "constexpr int TSPLIT = 4;")],
        "token body: launch only (returns at once)": [
            ("  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;\n",
             "  if (p.H > 0) return;\n"
             "  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;\n")],
        "token body: no state loads": [
            ("    s[e] = p.has_state ? ld4(St + e * p.st_si)",
             "    s[e] = false ? ld4(St + e * p.st_si)")],
        "token body: no state stores": [
            ("    *reinterpret_cast<float4*>(St + e * p.st_si) = s[e];\n",
             "    if (s[e].x == 12345.f)\n"
             "      *reinterpret_cast<float4*>(St + e * p.st_si) = s[e];\n")],
        "token body: u as scalars": [
            ("  load_run<R>(u, p.u + h * p.u_sh + i0);\n",
             "#pragma unroll\n  for (int e = 0; e < R; ++e) u[e] = "
             "p.u[h * p.u_sh + i0 + e];\n")],
        "token body: no look-ahead loads": [
            ("  load(cur, 0);\n", ""),
            ("    if (t + 1 < p.S) load(nxt, t + 1);\n", "    load(cur, t);\n"),
            ("    cur = nxt;\n", "")],
        # each step's r, k, w, v by cp.async through shared memory, behind
        # a barrier before the copies and one after them
        "token body: the steps staged in shared memory": [
            ("""  auto load = [&](TokenStep<R>& x, int t) {
    load_run<R>(x.r, Rg + t * p.r_ss);
    load_run<R>(x.k, Kg + t * p.k_ss);
    load_run<R>(x.w, Wg + t * p.w_ss);
    x.v = ld4(Vg + t * p.v_ss);
  };
""", """  __shared__ __align__(16) float sStep[3 * HD + C::COLS];
  auto load = [&](TokenStep<R>& x, int t) {
    constexpr int Q = HD / 4;
    __syncthreads();
    for (int q = tid; q < 3 * Q + C::COLS / 4; q += C::NT) {
      const float* src = q < Q ? Rg - i0 + t * p.r_ss + 4 * q
          : q < 2 * Q ? Kg - i0 + t * p.k_ss + 4 * (q - Q)
          : q < 3 * Q ? Wg - i0 + t * p.w_ss + 4 * (q - 2 * Q)
          : Vg - 4 * (tid % LR) + t * p.v_ss + 4 * (q - 3 * Q);
      cp_async16(sStep + 4 * q, src);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    load_run<R>(x.r, sStep + i0);
    load_run<R>(x.k, sStep + HD + i0);
    load_run<R>(x.w, sStep + 2 * HD + i0);
    x.v = ld4(sStep + 3 * HD + 4 * (tid % LR));
  };
""")],
    },
    "mamba_scan": {
        "as shipped": [],
        "no carveout preference": [
            ("    return e ? e\n             : cudaFuncSetAttribute(\n"
             "                   mamba_scan_chunked_kernel<TIn, N>,\n"
             "                   cudaFuncAttributePreferredSharedMemoryCarveout,\n"
             "                   cudaSharedmemCarveoutMaxShared);\n",
             "    return e;\n")],
        "no cross-lane scan": [
            ("for (int o = 1; o < L; o <<= 1) {",
             "for (int o = L; o < L; o <<= 1) {"),
            ("          const float h_prev = __shfl_up_sync(0xffffffffu, h_end, 1, L);\n"
             "          const float h_last = __shfl_sync(0xffffffffu, h_end, L - 1, L);\n",
             "          const float h_prev = h_end, h_last = h_end;\n")],
        "no in-thread state sum (y of the last state only)": [
            ("              y[i] = fmaf(fmaf(Ac[i], h0, Uc[i]), cq[e], y[i]);\n",
             "              y[i] = fmaf(Ac[i], h0, Uc[i]) * cq[e];\n")],
        "loads not one tile ahead": [
            ("  stage(0, 0);\n  for (int k = 0; k < ntiles; ++k) {\n"
             "    const int t0 = k * T, buf = k & 1;\n",
             "  for (int k = 0; k < ntiles; ++k) {\n"
             "    const int t0 = k * T, buf = k & 1;\n"
             "    __syncthreads();\n    stage(buf, t0);\n"),
            ("    if (k + 1 < ntiles) stage(buf ^ 1, t0 + T);  "
             "// in flight under tile k\n", "")],
        "no epilogue arithmetic (y stored)": [
            ("          o[e] = gate(yv, zv[e], TIn());\n",
             "          o[e] = yv;\n")],
        "no softplus": [
            ("? softplus(__fadd_rn(dv[e], sBias[c0 + e]))",
             "? __fadd_rn(dv[e], sBias[c0 + e])")],
        "__expf in the scan": [
            ("const float da = expf(__fmul_rn(dtv[i], aj));",
             "const float da = __expf(__fmul_rn(dtv[i], aj));")],
        "6 blocks an SM (85 registers)": [
            ("constexpr int MIN_BLOCKS = 7;", "constexpr int MIN_BLOCKS = 6;")],
        "no block minimum in the launch bounds": [
            ("__launch_bounds__(NT, MIN_BLOCKS)", "__launch_bounds__(NT)")],
        "1 state a pass": [("constexpr int JU = 4;", "constexpr int JU = 1;")],
        "2 states a pass": [("constexpr int JU = 4;", "constexpr int JU = 2;")],
        "states not split (G = 1)": [("constexpr int G = 2;", "constexpr int G = 1;")],
        "L = 4, R = 16, 2 warps a block": [
            ("constexpr int L = 8;", "constexpr int L = 4;"),
            ("constexpr int R = 8;", "constexpr int R = 16;"),
            ("constexpr int NW = 4;", "constexpr int NW = 2;")],
        "8 warps a block (16 channels)": [
            ("constexpr int NW = 4;", "constexpr int NW = 8;"),
            ("constexpr int MIN_BLOCKS = 7;", "constexpr int MIN_BLOCKS = 3;")],
        "the token body at every S": [("  if (p.S < T && !p.starts) {",
                                       "  if (true) {")],
        # the token body (decode): its launch's cost, its state traffic,
        # its lanes a channel (TSL states a lane), its look-ahead, and the
        # parts of a step's chain
        "token body: launch only (returns at once)": [
            ("  const int bi = blockIdx.y, tid = threadIdx.x;\n",
             "  if (p.S > 0) return;\n"
             "  const int bi = blockIdx.y, tid = threadIdx.x;\n")],
        "token body: no state loads": [
            ("  if (p.has_state) load_k<K>(hg, h);\n", "")],
        "token body: no state stores": [
            ("  store_k<K>(hg, h);\n",
             "  if (h[0] == 12345.f) store_k<K>(hg, h);\n")],
        "token body: 2 lanes a channel at n 16 (8 states a lane)": [
            ("constexpr int TSL = 4;", "constexpr int TSL = 8;")],
        "token body: 8 lanes a channel at n 16 (2 states a lane)": [
            ("constexpr int TSL = 4;", "constexpr int TSL = 2;")],
        "token body: no look-ahead loads": [
            ("    if (t + 1 < p.S) load(raw, t + 1);\n", ""),
            ("    // step t's operands into fp32,",
             "    if (t > 0) load(raw, t);\n    // step t's operands into fp32,")],
        "token body: no out stores": [
            ("    if (j0 == 0)\n      from_float(og + t * p.o_ss,",
             "    if (j0 == 0 && y == 12345.f)\n"
             "      from_float(og + t * p.o_ss,")],
        "token body: no y shuffles": [
            ("    for (int o = 1; o < LPC; o <<= 1) y += __shfl_xor_sync(",
             "    for (int o = LPC; o < LPC; o <<= 1) y += __shfl_xor_sync(")],
        "token body: no softplus": [
            ("    const float dt = softplus(__fadd_rn(to_float(raw.dt), bias));",
             "    const float dt = __fadd_rn(to_float(raw.dt), bias);")],
    },
    "flash_attention_bwd": {
        "as shipped": [],
        # hd 160's design choices: 64-row streamed tiles (S^T and dP^T 32 +
        # 32 registers beside dK and dV's 160: ptxas' spills show), and its
        # ring one stage shallower or deeper (three: one block an SM)
        "hd 160 with 64-row streamed tiles": [
            ("return HD > 128 ? 32 : 64;", "return 64;")],
        "hd 160 with a ring of 1 stage": [
            ("return HD > BOX ? 2 : 3;",
             "return HD > 128 ? 1 : HD > BOX ? 2 : 3;")],
        "hd 160 with a ring of 3 stages (one block an SM)": [
            ("return HD > BOX ? 2 : 3;",
             "return HD > 128 ? 3 : HD > BOX ? 2 : 3;")],
        # dQ's own key tiles at hd 160: 64 keys (80 + 32 + 32 registers;
        # 144 KB, one block an SM), and 64 keys on a one-stage ring (96 KB,
        # two blocks an SM)
        "dQ at hd 160 on 64-key tiles": [
            ("constexpr int KT = ST;", "constexpr int KT = HT;")],
        "dQ at hd 160 on 64-key tiles, a ring of 1 stage": [
            ("constexpr int KT = ST;", "constexpr int KT = HT;"),
            ("<HD, KT, NST>", "<HD, KT, (KT == ST ? NST : 1)>")],
        "no dQ kernel": [
            ("  fa_bwd_dq_hopper_kernel<HD, KT, NST>\n"
             "      <<<dq_grid, HNT, CQ::BYTES, stream>>>(kept[0], keys[1], "
             "keys[2],\n                                            kept[3], "
             "p);",
             "  (void)dq_grid; (void)keys;")],
        "no dK/dV kernel": [
            ("  fa_bwd_dkdv_hopper_kernel<HD, ST, NST>\n"
             "      <<<dkdv_grid, HNT, C::BYTES, stream>>>(streamed[0], kept[1], "
             "kept[2],\n                                              "
             "streamed[3], p);",
             "  (void)dkdv_grid;")],
        "no delta kernel": [
            ("    fa_bwd_delta_kernel<__nv_bfloat16>\n"
             "        <<<delta_grid, 32 * DELTA_WARPS, 0, stream>>>(p, rows);",
             "    (void)rows;")],
        "TMA ring of 2 stages at every hd": [
            ("return HD > BOX ? 2 : 3;", "return HD > BOX ? 2 : 2;")],
        "TMA ring of 3 stages at every hd (hd 80-160: one block an SM)": [
            ("return HD > BOX ? 2 : 3;", "return HD > BOX ? 3 : 3;")],
        "no setmaxnreg (consumers keep 128 registers)": [
            ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");\n',
             ""),
            ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n");\n',
             ""),
            # without setmaxnreg no block waits for registers, and ptxas
            # may use fewer than 128 at entry (127 at hd 80 and 96)
            ("<HD, ST, NST>,\n                                  128);",
             "<HD, ST, NST>,\n                                  0);"),
            ("<HD, KT, NST>, 128);", "<HD, KT, NST>, 0);")],
    },
    "wkv6_bwd": {
        "as shipped": [],
        "kernel 1 alone (the states every 32 steps, G_c, A_c)": [
            ("  wkv6_bwd_carry_kernel<<<",
             "  if (false) wkv6_bwd_carry_kernel<<<"),
            ("  wkv6_bwd_grads_kernel<HD><<<",
             "  if (false) wkv6_bwd_grads_kernel<HD><<<")],
        "kernel 2 alone (the carry over chunks)": [
            ("  wkv6_bwd_states_kernel<HD><<<",
             "  if (false) wkv6_bwd_states_kernel<HD><<<"),
            ("  wkv6_bwd_grads_kernel<HD><<<",
             "  if (false) wkv6_bwd_grads_kernel<HD><<<")],
        "kernel 3 alone (the sub-chunks' gradients)": [
            ("  wkv6_bwd_states_kernel<HD><<<",
             "  if (false) wkv6_bwd_states_kernel<HD><<<"),
            ("  wkv6_bwd_carry_kernel<<<",
             "  if (false) wkv6_bwd_carry_kernel<<<")],
        "kernel 3 at one block an SM": [
            ("__launch_bounds__(Shape<HD>::NT, 2)\n    wkv6_bwd_grads_kernel",
             "__launch_bounds__(Shape<HD>::NT, 1)\n    wkv6_bwd_grads_kernel")],
        "kernel 3's phase-1 products in one chain each": [
            ("        mma3(z2[kk & 1], ady,", "        mma3(z2[0], ady,"),
            ("        mma3(x2[kk & 1], av,", "        mma3(x2[0], av,"),
            ("          mma3(q2[kk & 1], ady,", "          mma3(q2[0], ady,")],
        "kernel 3 without Z, X and Q (phase 1's products)": [
            ("      for (int kk = 0; kk < HD / 8; ++kk) {\n"
             "        const FragA ady",
             "      for (int kk = 0; kk < 0; ++kk) {\n"
             "        const FragA ady")],
        "kernel 3 without dv's products with dS": [
            ("      for (int kk = 0; kk < HD / 8; ++kk)\n        mma3(d2[",
             "      for (int kk = 0; kk < 0; ++kk)\n        mma3(d2[")],
        "kernel 3 without the dS update": [
            ("    mat_update<HD>(ds, sRD, LDP, bdy, sA, g, tq);\n", "")],
        "kernel 3 without the up and down walks": [
            ("        if (tp > t) {\n", "        if (false) {\n"),
            ("      for (int s = t - 1; s >= 0; --s) {\n",
             "      for (int s = -1; s >= 0; --s) {\n")],
        "kernel 3 without W's walk (dw's last term)": [
            ("    switch (part) {\n", "    if (part < 0) switch (part) {\n")],
        "kernels 1 and 3's rebuild without the decays D, E": [
            ("      if (tau < t) dd[x] *= wv[x];\n"
             "      if (tau > t) ee[x] *= wv[x];\n", "")],
        "no 3xTF32 lo terms (plain TF32)": TF32_ONLY,
    },
    "mamba_scan_bwd": {
        "as shipped": [],
        "kernel 1 alone (forward pass, the adjoint's composition)": [
            ("  mamba_scan_bwd_carry_kernel<<<",
             "  if (false) mamba_scan_bwd_carry_kernel<<<"),
            ("  err = cudaLaunchKernelEx(", "  if (false) err = "
             "cudaLaunchKernelEx("),
            ("  mamba_scan_bwd_reduce_kernel<TIn>\n", "  if (false)\n"
             "  mamba_scan_bwd_reduce_kernel<TIn>\n")],
        "kernel 3 alone (the tiles' gradients)": [
            ("  mamba_scan_bwd_chunk_kernel<TIn, N><<<",
             "  if (false) mamba_scan_bwd_chunk_kernel<TIn, N><<<"),
            ("  mamba_scan_bwd_carry_kernel<<<",
             "  if (false) mamba_scan_bwd_carry_kernel<<<"),
            ("  mamba_scan_bwd_reduce_kernel<TIn>\n", "  if (false)\n"
             "  mamba_scan_bwd_reduce_kernel<TIn>\n")],
        "no db/dc reduction kernel": [
            ("  mamba_scan_bwd_reduce_kernel<TIn>\n", "  if (false)\n"
             "  mamba_scan_bwd_reduce_kernel<TIn>\n")],
        "clusters of 1 (a partial per block)": [
            ("  for (int cs = 8; cs > 1; cs /= 2)",
             "  for (int cs = 1; cs > 1; cs /= 2)")],
        "no cluster sum (a rank's own slices only)": [
            ("        for (int q = 0; q < p.CS; ++q) {",
             "        for (int q = rank; q <= rank; ++q) {")],
        "no epilogue": [
            ("        if (t0 + t >= p.S) continue;\n        float dv[4]",
             "        if (true) continue;\n        float dv[4]")],
        "__expf in the passes": [
            ("A[i] = expf(__fmul_rn(dtv[i], aj));",
             "A[i] = __expf(__fmul_rn(dtv[i], aj));")],
        "clusters of at most 4": [
            ("  for (int cs = 8; cs > 1; cs /= 2)",
             "  for (int cs = 4; cs > 1; cs /= 2)")],
        "kernel 3's state loop unrolled by 2": [
            ("#pragma unroll 1\n    for (int j = g * C::NS; j < (g + 1) * C::NS; "
             "++j) {\n      const float aj = sA[ch * N + j];\n"
             "      const float h_tile = hs[",
             "#pragma unroll 2\n    for (int j = g * C::NS; j < (g + 1) * C::NS; "
             "++j) {\n      const float aj = sA[ch * N + j];\n"
             "      const float h_tile = hs[")],
        "kernel 1 at 5 blocks an SM": [
            ("__launch_bounds__(NT, 4)\n    mamba_scan_bwd_chunk_kernel",
             "__launch_bounds__(NT, 5)\n    mamba_scan_bwd_chunk_kernel")],
        "kernel 3 at 4 blocks an SM (128 registers)": [
            ("__launch_bounds__(NT, 3)\n    mamba_scan_bwd_kernel",
             "__launch_bounds__(NT, 4)\n    mamba_scan_bwd_kernel")],
    },
}
# the variant built from another checkout's source (--previous)
PREVIOUS = "the previous design"
# flash attention's shapes, {label: (B, S, H, Hkv, hd, window, training)}:
# chip_smoke.py's serving prefills (qwen3-8b, phi3-mini-3.8b, pixtral-12b;
# h2o-danube-1.8b's and hymba-1.5b's past their windows) and the training
# forward (with its log-sum-exp) at the microbatches it trains
FA_SHAPES = {
    "serving qwen3-8b": (4, 512, 32, 8, 128, None, False),
    "serving phi3-mini-3.8b": (4, 512, 32, 32, 96, None, False),
    "serving pixtral-12b": (4, 512, 32, 8, 160, None, False),
    "serving h2o-danube-1.8b": (4, 5120, 32, 8, 80, 4096, False),
    "serving hymba-1.5b": (4, 4096, 25, 5, 64, 1024, False),
    "training qwen3-8b": (2, 4096, 32, 8, 128, None, True),
    "training phi3-mini-3.8b": (2, 4096, 32, 32, 96, None, True),
    "training h2o-danube-1.8b": (4, 4096, 32, 8, 80, 4096, True)}
# where each kernel's wrapper module loads its library: {kernel: (module
# name, loader)}
LOADERS = {"flash_attention": ("flash_attention", "_lib"),
           "decode_attention": ("decode_attention", "_lib"),
           "wkv6": ("wkv6", "_lib"), "mamba_scan": ("mamba_scan", "_lib"),
           "flash_attention_bwd": ("flash_attention", "_bwd_lib"),
           "wkv6_bwd": ("wkv6", "_bwd_lib"),
           "mamba_scan_bwd": ("mamba_scan", "_bwd_lib")}


def build(kernels, previous: Path | None = None, match: str = "") -> dict:
    """{(kernel, variant): loaded library}, all variants whose name holds
    ``match`` (and the unedited kernel) built in parallel; with
    ``previous`` (another checkout's csrc) also each kernel's source
    there, with that directory's headers, as the variant PREVIOUS."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for kernel in kernels:
        variants = VARIANTS[kernel]
        src = (_build.CSRC / f"{kernel}.cu").read_text()
        for i, (name, edits) in enumerate(variants.items()):
            if match not in name and edits:
                continue
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
        if previous is not None:
            if kernel == "mamba_scan" and "float* starts" not in (
                    previous / f"{kernel}.cu").read_text():
                raise RuntimeError("mamba_scan_launch has taken starts and "
                                   "chunk arguments since the training "
                                   "forward kept its starts: an older "
                                   "source cannot run behind this wrapper")
            lib = OUT / f"{kernel}_previous.so"
            procs[kernel, PREVIOUS] = (lib, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", str(previous), "-o",
                 str(lib), str(previous / f"{kernel}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode and key[1] in ("as shipped", PREVIOUS):
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-3000:]}")
        if proc.returncode:
            print(f"{key[0]}, {key[1]}: nvcc failed, variant skipped:\n"
                  f"{log[-1500:]}")
            continue
        print(f"{key[0]}, {key[1]}: ptxas " + "; ".join(
            line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "registers" in line or "spill stores" in line))
        libs[key] = ctypes.CDLL(str(lib))
        libs[key].repro_cuda_error_string.argtypes = [ctypes.c_int]
        libs[key].repro_cuda_error_string.restype = ctypes.c_char_p
    return libs


def wkv6_errors(libs: dict, wkm) -> None:
    """Relative L2 error of y and of the final state against an fp64
    recurrence, for the plain fp32 version and each WKV6 variant: the
    chunked body at S=1024 and the token body at S=15."""
    import numpy as np
    gen = torch.Generator("cuda").manual_seed(3)

    def rel(a, b):
        return float(np.linalg.norm((a.double() - b).cpu().numpy())
                     / np.linalg.norm(b.cpu().numpy()))

    runs = {"plain fp32": wkm.wkv6_plain}
    for (kernel, name), lib in libs.items():
        if kernel == "wkv6":
            runs[name] = lambda *a, lib=lib: (
                setattr(wkm, "_lib", lambda: lib), wkm.wkv6(*a))[1]
    for shape in ((2, 1024, 5, 64), (4, 15, 40, 64)):
        r, k, v = (0.5 * torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        w = 0.99 + 0.0099 * torch.rand(shape, generator=gen, device="cuda")
        u = 0.5 * torch.randn(shape[2:], generator=gen, device="cuda")
        start = torch.randn((shape[0], *shape[2:], shape[3]), generator=gen,
                            device="cuda")
        cur = start.double()
        ys = []
        for t in range(shape[1]):
            kv = k[:, t, :, :, None].double() * v[:, t, :, None, :].double()
            ys.append(torch.einsum("bhi,bhij->bhj", r[:, t].double(),
                                   cur + u.double()[None, :, :, None] * kv))
            cur = w[:, t, :, :, None].double() * cur + kv
        y64 = torch.stack(ys, dim=1)
        for name, fn in runs.items():
            state = start.clone()
            y, _ = fn(r, k, v, w, u, state)
            print(f"wkv6 vs fp64, decays 0.99-0.9999, S={shape[1]}: {name}: "
                  f"y {rel(y, y64):.3e}, state {rel(state, cur):.3e}")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("kernels", nargs="*")
    parser.add_argument("--previous", type=Path, default=None)
    parser.add_argument("--match", default="")
    args = parser.parse_args()
    kernels = args.kernels or list(VARIANTS)
    unknown = set(kernels) - set(VARIANTS)
    if unknown:
        print(f"ablate_kernels: no variants of {sorted(unknown)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ablate_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]
    import chip_smoke as cs
    from time_train_forwards import wkv6_chain
    from repro_torch.kernels import decode_attention as dam
    from repro_torch.kernels import flash_attention as fam
    from repro_torch.kernels import mamba_scan as msm
    from repro_torch.kernels import wkv6 as wkm
    modules = {"flash_attention": fam, "decode_attention": dam, "wkv6": wkm,
               "mamba_scan": msm}
    mods = {k: modules[m] for k, (m, _) in LOADERS.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    libs = build(kernels, args.previous, args.match)
    # the wrappers set each library's argument types on first load: every
    # entry point they declared gets the same types in each variant
    shipped = {name: getattr(mods[name], LOADERS[name][1])()
               for name in kernels}
    for (kernel, _), lib in libs.items():
        for attr, fn in vars(shipped[kernel]).items():
            if isinstance(fn, ctypes._CFuncPtr) and hasattr(lib, attr):
                getattr(lib, attr).argtypes = fn.argtypes
                getattr(lib, attr).restype = fn.restype

    gen = torch.Generator("cuda").manual_seed(0)
    bf16 = torch.bfloat16
    fa_inputs = {}
    if "flash_attention" in kernels:
        for label, (b, s, h, hkv, hd, window, train) in FA_SHAPES.items():
            fa_inputs[label] = (cs.randn(gen, (b, s, h, hd), bf16),
                                cs.randn(gen, (b, s, hkv, hd), bf16),
                                cs.randn(gen, (b, s, hkv, hd), bf16, 1.0),
                                window, train)
    decode = {}
    for label, b, s, lens in (("B=4, 544 slots", 4, 544, [544, 528, 520, 513]),
                              ("B=1, 32768 slots", 1, 32768, [32768])):
        kc = cs.randn(gen, (b, s, 8, 128), bf16)
        vc = cs.randn(gen, (b, s, 8, 128), bf16, 1.0)
        decode[label] = (cs.randn(gen, (b, 8, 4, 128), bf16), kc, vc,
                         torch.tensor(lens, device="cuda", dtype=torch.int32))
    wkv = [cs.randn(gen, (4, 1024, 40, 64), torch.float32, 0.5)
           for _ in range(3)]
    wkv.append(torch.exp(-torch.exp(
        cs.randn(gen, (4, 1024, 40, 64), torch.float32, 2.0) - 5)))
    wkv.append(cs.randn(gen, (40, 64), torch.float32, 0.5))
    wkv_state = torch.zeros((4, 40, 64, 64), device="cuda")
    # the token body at the decode shape, S=1 and S=15, from a carried
    # state; and S=1 over rwkv6-3b's 32 layers of a stacked cache, 84 MB,
    # past the L2, walked as decode_step walks it (cold)
    wkv_steps = {}
    for steps in (1, 15):
        ops4 = [cs.randn(gen, (4, steps, 40, 64), torch.float32, 0.5)
                for _ in range(3)]
        ops4.append(torch.exp(-torch.exp(
            cs.randn(gen, (4, steps, 40, 64), torch.float32, 2.0) - 5)))
        wkv_steps[steps] = (*ops4, wkv[4])
    wkv_layers = cs.randn(gen, (32, 4, 40, 64, 64), torch.float32, 1.0) \
        if "wkv6" in kernels else None
    # the training forward at rwkv6-3b's microbatch
    wkv_train = cs.decay(cs.wkv6_train_inputs(gen, 2, 4096)) \
        if "wkv6" in kernels else None
    mbc = cs.randn(gen, (4, 4096, 32), bf16, 1.0)
    mzz = cs.randn(gen, (4, 4096, 3200), bf16, 1.0)
    mamba = ((cs.randn(gen, (4, 4096, 1600), torch.float32, 2.0) - 2.0)
             .to(bf16), torch.zeros(1600, device="cuda"), mbc[..., :16],
             mbc[..., 16:], cs.randn(gen, (4, 4096, 1600), bf16, 1.0),
             mzz[..., 1600:], torch.log(torch.arange(
                 1, 17, device="cuda").float()).expand(1600, 16).contiguous(),
             torch.ones(1600, device="cuda"),
             torch.zeros((4, 1600, 16), device="cuda"))
    # the scan's token body at hymba's decode shape, S=1 and S=15, bf16,
    # from a carried state; and S=1 a layer walking a stack of
    # chip_smoke.py's MAMBA_COLD_LAYERS (4, 1600, 16) states, 78.6 MB,
    # past the L2 (cold)
    mamba_steps = {}
    for steps in (1, 15):
        mbc_s = cs.randn(gen, (4, steps, 32), bf16, 1.0)
        mzz_s = cs.randn(gen, (4, steps, 3200), bf16, 1.0)
        mamba_steps[steps] = (
            (cs.randn(gen, (4, steps, 1600), torch.float32, 2.0) - 2.0)
            .to(bf16), mamba[1], mbc_s[..., :16], mbc_s[..., 16:],
            cs.randn(gen, (4, steps, 1600), bf16, 1.0), mzz_s[..., 1600:],
            mamba[6], mamba[7])
    mamba_layers = cs.randn(gen, (cs.MAMBA_COLD_LAYERS, 4, 1600, 16),
                            torch.float32, 1.0) \
        if "mamba_scan" in kernels else None
    attention = {}
    if "flash_attention_bwd" in kernels:
        # qwen3-8b's training microbatch (hd 128), hymba-1.5b's (hd 64, a
        # 1024-token window), phi3-mini-3.8b's (hd 96), h2o-danube-1.8b's
        # (hd 80, a 4096-token window), pixtral-12b's (hd 160) and
        # musicgen-large's (hd 64, MHA)
        for label, b, h, hkv, hd, window in (
                ("qwen3-8b", 2, 32, 8, 128, None),
                ("hymba-1.5b", 4, 25, 5, 64, 1024),
                ("phi3-mini-3.8b", 2, 32, 32, 96, None),
                ("h2o-danube-1.8b", 4, 32, 8, 80, 4096),
                ("pixtral-12b", 1, 32, 8, 160, None),
                ("musicgen-large", 2, 32, 32, 64, None)):
            aq, ak, av, ado = (cs.randn(gen, shape, bf16, scale)
                               for shape, scale in (
                                   ((b, 4096, h, hd), 1.5),
                                   ((b, 4096, hkv, hd), 1.5),
                                   ((b, 4096, hkv, hd), 1.0),
                                   ((b, 4096, h, hd), 1.0)))
            attention[label] = (aq, ak, av, *fam.flash_attention_train(
                aq, ak, av, window), ado, window)
    if "wkv6_bwd" in kernels:
        wkv_bwd_in = cs.decay(cs.wkv6_train_inputs(gen, 2, 4096))
        wkv_bwd_dy = cs.randn(gen, (2, 4096, 40, 64), torch.float32, 1.0)
        wkv_bwd_starts = wkm.wkv6_chunk_states(*wkv_bwd_in)[2]
    if "mamba_scan_bwd" in kernels:
        scan_in = cs.mamba_train_inputs(gen, 4, 4096, bf16)
        scan_dout = cs.randn(gen, (4, 4096, 1600), bf16, 1.0)
        scan_starts = msm.mamba_chunk_states(*scan_in)[2]

    times = {}
    for rnd in range(2):   # the second round in reverse order
        for (kernel, name), lib in (list(libs.items())[::-1] if rnd
                                    else libs.items()):
            setattr(mods[kernel], LOADERS[kernel][1], lambda lib=lib: lib)
            if kernel == "flash_attention_bwd":
                for label, args in attention.items():
                    times.setdefault(f"attention backward, {label}: {name}",
                                     []).append(cs.time_ms(
                        lambda: fam.flash_attention_backward(*args), 10))
                continue
            if kernel == "wkv6_bwd":
                times.setdefault(f"wkv6 backward: {name}", []).append(
                    cs.time_ms(lambda: wkm.wkv6_backward(
                        *wkv_bwd_in, wkv_bwd_starts, wkv_bwd_dy), 10))
                continue
            if kernel == "mamba_scan_bwd":
                times.setdefault(f"mamba scan backward: {name}", []).append(
                    cs.time_ms(lambda: msm.mamba_scan_backward(
                        *scan_in, scan_starts, scan_dout), 10))
                continue
            if kernel == "flash_attention":
                for label, (q, k, v, window, train) in fa_inputs.items():
                    fn = fam.flash_attention_train if train \
                        else fam.flash_attention
                    times.setdefault(f"flash attention, {label}: {name}",
                                     []).append(cs.time_ms(
                        lambda: fn(q, k, v, window), 10))
                continue
            if kernel == "wkv6":
                times.setdefault(f"wkv6 prefill: {name}", []).append(
                    cs.time_ms(lambda: wkm.wkv6(*wkv, wkv_state), 20))
                # a library without the training entry (an older
                # checkout's) trains through the chain it replaced
                train = (lambda: wkm.wkv6_chunk_states(*wkv_train)) \
                    if hasattr(lib, "wkv6_train_launch") \
                    else (lambda: wkv6_chain(wkm, *wkv_train))
                times.setdefault(f"wkv6 training forward: {name}",
                                 []).append(cs.time_ms(train, 10))
                for steps, args in wkv_steps.items():
                    times.setdefault(f"wkv6 token body, S={steps} (warm): "
                                     f"{name}", []).append(cs.time_ms(
                        lambda: wkm.wkv6(*args, wkv_layers[0]), 200))

                def walk(args=wkv_steps[1]):
                    for layer in wkv_layers:
                        wkm.wkv6(*args, layer)
                times.setdefault(f"wkv6 token body, S=1 a layer over 32 "
                                 f"layers (cold): {name}", []).append(
                    cs.time_ms(walk, 10) / len(wkv_layers))
                continue
            if kernel == "mamba_scan":
                times.setdefault(f"mamba scan prefill: {name}", []).append(
                    cs.time_ms(lambda: msm.mamba_scan(*mamba), 20))
                for steps, args in mamba_steps.items():
                    times.setdefault(f"mamba scan token body, S={steps} "
                                     f"(warm): {name}", []).append(
                        cs.time_ms(lambda: msm.mamba_scan(
                            *args, mamba_layers[0]), 200))

                def walk(args=mamba_steps[1]):
                    for layer in mamba_layers:
                        msm.mamba_scan(*args, layer)
                # 3 walks, as chip_smoke.py times them
                times.setdefault(f"mamba scan token body, S=1 a layer over "
                                 f"{len(mamba_layers)} layers (cold): "
                                 f"{name}", []).append(
                    cs.time_ms(walk, 3) / len(mamba_layers))
                continue
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
    if "wkv6" in kernels:
        wkv6_errors(libs, wkm)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
