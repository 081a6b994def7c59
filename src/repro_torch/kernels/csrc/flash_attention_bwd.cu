// Flash attention backward (training) for Hopper, sm_90a.
//
// No Pallas kernel stands behind it: the JAX package trains through XLA's
// gradient of the checkpointed vmemkernel_flash_attention chunk of
// repro/models/layers.py:causal_attention_ref (:91-112), which XLA fuses
// on the TPU. The port's plain version of that gradient is
// flash_attention.py:flash_attention_bwd (torch operations); this kernel
// computes what it computes, FlashAttention-2's backward, from the
// forward's output O and its row log-sum-exp (the training forward writes
// lse = m + log l of the scaled scores, flash_attention.cu), for
// causal GQA attention with an optional window, Sq == Sk:
//
//   P  = exp(Q K^T scale - lse)      recomputed, in fp32
//   dV = sum over the group's heads of T(P)^T dO
//   dP = dO V^T,   D = rowsum(dO o O),   dS = P o (dP - D)
//   dQ = T(dS) K scale,   dK = sum over the group's heads of T(dS)^T Q scale
//
// T rounds to the inputs' dtype where the plain version rounds: P before
// the dV product (JAX casts P to v's dtype), dS before both of its
// products; every product accumulates in fp32, dK and dV over the heads
// of a KV head's group too. One change of rounding point: D is the row sum
// of dO o O (O as the forward wrote it, in the dtype), where the plain
// version sums P o dP in fp32. The two are equal in exact arithmetic; in
// bf16 D then carries O's rounding (PERF.md holds both paths to fp32).
//
// What bounds it: operations. At qwen3-8b's training shape (B=2, S=4096,
// 32/8 heads, hd 128, bf16) the backward's four products over the causal
// pairs are 550 GFLOP, 0.556 ms at the bf16 tensor-core peak, against
// 0.10 GB to move (q, k, v, dO read once, dq, dk, dv written once). The
// first design, all on mma.sync with cp.async, took 4.99 ms there; the
// Hopper bodies' times are in PERF.md.
//
// Three kernels in one C call, on one stream: 1. delta: D = rowsum(dO o
// O) in fp32, one warp a (batch, row, head); 2. dK/dV: a block per (batch,
// KV head, 64-key tile) keeps its dK and dV in fp32 registers for the
// whole block and loops over the g query heads of the group and the query
// tiles that see its keys (from the tile's first key to the end, or to its
// last key + window - 1), so it needs no atomics; 3. dQ: a block per
// (batch, head, 64-query tile) loops over the key tiles from the window's
// edge to the causal limit, recomputing P and dP: deterministic, where
// atomics into dQ from kernel 2 would sum in a different order each run
// (phase 6 of chip_smoke.py holds the sharded step bit-equal). Kernels 2
// and 3 thus run seven products where the bound counts four (S and dP
// twice). Only tiles that straddle the diagonal, S or the window's edge
// are masked.
//
// Hopper bodies, bf16 at every head dim (32, 64, 80, 96, 128, 160; the
// trained ones: hymba-1.5b and musicgen-large 64; h2o-danube-1.8b 80;
// phi3-mini-3.8b 96; qwen3-8b and moonshot 128; pixtral-12b 160): each
// block is two warpgroups. Warpgroup 0 gives up its registers (setmaxnreg
// 24) and its first warp loads: K and V (dK/dV) or Q and dO (dQ) once, 64
// rows each, then the streamed tiles of ST rows (Q, dO, with lse and D by
// the warp's lanes; or K, V) by TMA into a ring of NST stages, each stage
// a full and an empty mbarrier, in the 128-byte swizzle that the wgmma
// descriptors name: a tile's row of hd bf16 is ceil(hd / 64) boxes of 128
// bytes, each box R rows x 128 bytes. The consumer warpgroup (setmaxnreg
// 232) runs the products on wgmma m64nNk16 (bf16 in, fp32 accumulate), 64
// rows a warpgroup: dK/dV takes S^T = K Q^T and dP^T = V dO^T with both
// operands in shared memory (K-major, N = ST), forms P^T and dS^T = P^T o
// (dP^T - D) in registers, then dV += T(P^T) dO and dK += T(dS^T) Q with
// P^T and dS^T as the register A operand and dO, Q MN-major (ST / 16
// k-steps); dQ takes S = Q K^T, dP = dO V^T and dQ += T(dS) K the same
// way. Launch bounds hold a thread to 128 registers at entry (two blocks
// an SM), which setmaxnreg then moves from the producer warpgroup (24) to
// the consumer one (232); a build with fewer is refused before its first
// launch (check_entry_registers).
//
// Registers a consumer thread (fp32 words): dK and dV hd / 2 each, S^T and
// dP^T ST / 2 each: hd 128 64 + 64 + 32 + 32; hd 96 48 + 48 + 32 + 32; hd
// 160 80 + 80 + 16 + 16, which is why hd 160 streams 32-row tiles (ST =
// 32; a 64-row one would give 224 words before the A fragments and
// addresses); hd 32 16 + 16 + 32 + 32. dQ holds hd / 2 and its S and dP,
// over ST-key tiles too (launch_hopper says why).
// Shared memory: two 64 x hd tiles kept and NST stages of two ST x hd
// tiles, 8 KB a 64-row box and 4 KB a 32-row one: hd 80 to 128 two boxes,
// NST 2, 98 KB; hd 160 three boxes, 48 KB kept and NST 2 of 24 KB, 98 KB;
// hd 32 and 64 one box, NST 3, 66 KB: two blocks an SM at every hd.
//
// Where hd is not a multiple of 64 (80, 96: 1.25 and 1.5 boxes; 160: 2.5;
// 32: 0.5) the tiles are laid out as whole boxes, and the last box's
// columns past hd are TMA's zero fill (the map's innermost extent is hd),
// so one layout, one ring and whole-box transaction counts serve every
// head dim. The K-major products (S^T, dP^T; S, dP) step hd / 16 k-steps
// (hd 160: 10, hd 32: 2) and never read the fill; the MN-major ones (dV,
// dK; dQ), N = hd, run N = 64 or 128 over the whole boxes and an N = 16
// or 32 tail from the last box's start (hd 32: one N = 32), so no product
// runs over the zero columns either, and dK, dV and dQ hold hd columns of
// accumulators. The forward lays out hd 160 and 32 the same way
// (flash_attention.cu); the helpers are hopper.cuh's.
//
// fp32 bodies (tests, compare_paths; not a training dtype): CUDA cores, 256
// threads of 8-lane row groups, each thread two rows (keys in dK/dV,
// queries in dQ) and four columns of a 32-wide tile; P and dS go through
// shared memory to the products, as the forward's fp32 body does.
//
// Every instance of the forward's head dims (32, 64, 80, 96, 128, 160);
// operands read through their strides, head dim contiguous, rows 16-byte
// aligned (the wrapper checks); dq, dk, dv written in the inputs' dtype.

#include "hopper.cuh"

namespace {

// fp32 bodies' tiles (the Hopper bodies' are in section 4)
constexpr int KB = 64;   // dK/dV: keys a block
constexpr int QB = 32;   // dK/dV: queries a tile
constexpr int QR = 64;   // dQ: query rows a block
constexpr int KT = 32;   // dQ: keys a tile
constexpr int NT32 = 256;  // fp32 kernels: 32 row groups of 8 lanes
constexpr int DELTA_WARPS = 8;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, S): m + log l of the scaled scores
  float* delta;      // (B, H, S): rowsum(dO o O), written by kernel 1
  void* dq;
  void* dk;
  void* dv;
  int64_t q_sb, q_ss, q_sh;  // element strides (batch, seq, head)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t dq_sb, dq_ss, dq_sh;
  int64_t dk_sb, dk_ss, dk_sh;
  int64_t dv_sb, dv_ss, dv_sh;
  int H, Hkv, S, hd;
  int window;  // <= 0: no window
  float scale;
};

__device__ __forceinline__ int64_t row_index(const BwdParams& p, int b,
                                             int h, int s) {
  return ((int64_t)b * p.H + h) * p.S + s;
}

// ------------------------------------------------------------ 1. delta
template <typename T>
__global__ void __launch_bounds__(32 * DELTA_WARPS)
    fa_bwd_delta_kernel(const BwdParams p, int64_t rows) {
  const int64_t row =
      (int64_t)blockIdx.x * DELTA_WARPS + threadIdx.x / 32;  // (b, s, h)
  if (row >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const int h = row % p.H;
  const int s = (row / p.H) % p.S;
  const int b = row / ((int64_t)p.H * p.S);
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + s * p.o_ss +
               h * p.o_sh;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + s * p.do_ss +
               h * p.do_sh;
  float acc = 0.f;
  for (int i = lane; i < p.hd; i += 32)
    acc = fmaf(to_float(o[i]), to_float(d[i]), acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[row_index(p, b, h, s)] = acc;
}

// the queries that a block of 64 keys from k0 sees: [k0, q_end)
__device__ __forceinline__ int query_end(const BwdParams& p, int k0) {
  return p.window > 0 ? min(p.S, k0 + KB - 1 + p.window) : p.S;
}

// the key tiles a query tile's block walks: [k_begin, k_end), KT at a time
__device__ __forceinline__ int key_begin(const BwdParams& p, int q0) {
  const int k = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  return k / KT * KT;
}

// ------------------------------------------------- 2./3. fp32 bodies
template <int HD>
struct BwdF32Shape {
  static constexpr int LD = HD + 4;  // padded smem row (floats)
  static constexpr int LDP = QB + 4;
  static constexpr int LDS = KT + 4;
  // dK/dV: K, V (KB rows), Q, dO (QB rows), lse and D (QB), P and dS (KB x
  // LDP)
  static constexpr size_t DKDV =
      (size_t(2) * KB * LD + size_t(2) * QB * LD + 2 * QB +
       size_t(2) * KB * LDP) * sizeof(float);
  // dQ: Q, dO (QR rows), K, V (KT rows), dS (QR x LDS)
  static constexpr size_t DQ =
      (size_t(2) * QR * LD + size_t(2) * KT * LD + size_t(QR) * LDS) *
      sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(NT32) fa_bwd_dkdv_f32_kernel(
    const BwdParams p) {
  constexpr int LD = BwdF32Shape<HD>::LD;
  constexpr int LDP = BwdF32Shape<HD>::LDP;
  constexpr int NU = HD / 16;  // column pairs a lane in the products
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + KB * LD;
  float* sQ = sV + KB * LD;
  float* sO = sQ + QB * LD;
  float* sL = sO + QB * LD;
  float* sD = sL + QB;
  float* sP = sD + QB;
  float* sS = sP + KB * LDP;

  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int grp = p.H / p.Hkv;
  const int k0 = blockIdx.x * KB;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: keys rg, rg + 32
  const int c = tid & 7;    // lane in the row group: queries c + 8 j
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<float, HD, LD, KB, NT32>(sK, K, p.k_ss, k0, p.S);
  load_tile<float, HD, LD, KB, NT32>(sV, V, p.v_ss, k0, p.S);

  const int per_head = (query_end(p, k0) - k0 + QB - 1) / QB;
  float dk[2][2 * NU], dv[2][2 * NU];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < 2 * NU; ++u) dk[i][u] = dv[i][u] = 0.f;

  for (int n = 0; n < per_head * grp; ++n) {
    const int h = hk * grp + n / per_head, q0 = k0 + (n % per_head) * QB;
    __syncthreads();  // the previous tile's readers are done
    load_tile<float, HD, LD, QB, NT32>(
        sQ, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
        q0, p.S);
    load_tile<float, HD, LD, QB, NT32>(
        sO, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
        p.do_ss, q0, p.S);
    if (tid < QB) {
      const int q = q0 + tid;
      const bool ok = q < p.S;
      sL[tid] = ok ? p.lse[row_index(p, b, h, q)] : INFINITY;
      sD[tid] = ok ? p.delta[row_index(p, b, h, q)] : 0.f;
    }
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 2) {
      float2 kv[2], vv[2], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        kv[i] = load2(sK + (rg + 32 * i) * LD + d);
        vv[i] = load2(sV + (rg + 32 * i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = load2(sQ + (c + 8 * j) * LD + d);
        ov[j] = load2(sO + (c + 8 * j) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i].x, qv[j].x, fmaf(kv[i].y, qv[j].y, s[i][j]));
          dp[i][j] = fmaf(vv[i].x, ov[j].x, fmaf(vv[i].y, ov[j].y, dp[i][j]));
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = rg + 32 * i, col = c + 8 * j;
        const int dq = q0 + col - (k0 + row);  // query - key
        const bool ok = dq >= 0 && (p.window <= 0 || dq < p.window);
        const float pv = ok ? expf(s[i][j] * p.scale - sL[col]) : 0.f;
        sP[row * LDP + col] = pv;
        sS[row * LDP + col] = pv * (dp[i][j] - sD[col]);
      }
    __syncwarp();  // a row group's P and dS are its own 8 lanes'

#pragma unroll 2
    for (int j = 0; j < QB; ++j) {
      float pr[2], dr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pr[i] = sP[(rg + 32 * i) * LDP + j];
        dr[i] = sS[(rg + 32 * i) * LDP + j];
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float2 ov = load2(sO + j * LD + 2 * c + 16 * u);
        const float2 qv = load2(sQ + j * LD + 2 * c + 16 * u);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dv[i][2 * u] = fmaf(pr[i], ov.x, dv[i][2 * u]);
          dv[i][2 * u + 1] = fmaf(pr[i], ov.y, dv[i][2 * u + 1]);
          dk[i][2 * u] = fmaf(dr[i], qv.x, dk[i][2 * u]);
          dk[i][2 * u + 1] = fmaf(dr[i], qv.y, dk[i][2 * u + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + rg + 32 * i;
    if (key >= p.S) continue;
    float* dkr = static_cast<float*>(p.dk) + b * p.dk_sb +
                 (int64_t)key * p.dk_ss + hk * p.dk_sh + 2 * c;
    float* dvr = static_cast<float*>(p.dv) + b * p.dv_sb +
                 (int64_t)key * p.dv_ss + hk * p.dv_sh + 2 * c;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      store2(dkr + 16 * u, dk[i][2 * u] * p.scale,
             dk[i][2 * u + 1] * p.scale);
      store2(dvr + 16 * u, dv[i][2 * u], dv[i][2 * u + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT32) fa_bwd_dq_f32_kernel(
    const BwdParams p) {
  constexpr int LD = BwdF32Shape<HD>::LD;
  constexpr int LDS = BwdF32Shape<HD>::LDS;
  constexpr int NU = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sO = sQ + QR * LD;
  float* sK = sO + QR * LD;
  float* sV = sK + KT * LD;
  float* sS = sV + KT * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * QR;
  const int tid = threadIdx.x, rg = tid >> 3, c = tid & 7;
  const float* K = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* V = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile<float, HD, LD, QR, NT32>(
      sQ, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh, p.q_ss,
      q0, p.S);
  load_tile<float, HD, LD, QR, NT32>(
      sO, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
      p.do_ss, q0, p.S);
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + rg + 32 * i;
    const bool ok = q < p.S;
    lse[i] = ok ? p.lse[row_index(p, b, h, q)] : INFINITY;
    dl[i] = ok ? p.delta[row_index(p, b, h, q)] : 0.f;
  }
  float dq[2][2 * NU];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int u = 0; u < 2 * NU; ++u) dq[i][u] = 0.f;

  const int k_end = min(p.S, q0 + QR);
  for (int k0 = key_begin(p, q0); k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<float, HD, LD, KT, NT32>(sK, K, p.k_ss, k0, p.S);
    load_tile<float, HD, LD, KT, NT32>(sV, V, p.v_ss, k0, p.S);
    __syncthreads();
    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 2) {
      float2 qv[2], ov[2], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        qv[i] = load2(sQ + (rg + 32 * i) * LD + d);
        ov[i] = load2(sO + (rg + 32 * i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = load2(sK + (c + 8 * j) * LD + d);
        vv[j] = load2(sV + (c + 8 * j) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, s[i][j]));
          dp[i][j] = fmaf(ov[i].x, vv[j].x, fmaf(ov[i].y, vv[j].y, dp[i][j]));
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = rg + 32 * i, key = k0 + c + 8 * j;
        const int d = q0 + row - key;  // query - key
        const bool ok =
            d >= 0 && key < p.S && (p.window <= 0 || d < p.window);
        const float pv = ok ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        sS[row * LDS + c + 8 * j] = pv * (dp[i][j] - dl[i]);
      }
    __syncwarp();
#pragma unroll 2
    for (int j = 0; j < KT; ++j) {
      float dr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) dr[i] = sS[(rg + 32 * i) * LDS + j];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float2 kv = load2(sK + j * LD + 2 * c + 16 * u);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dq[i][2 * u] = fmaf(dr[i], kv.x, dq[i][2 * u]);
          dq[i][2 * u + 1] = fmaf(dr[i], kv.y, dq[i][2 * u + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + rg + 32 * i;
    if (q >= p.S) continue;
    float* row = static_cast<float*>(p.dq) + b * p.dq_sb +
                 (int64_t)q * p.dq_ss + h * p.dq_sh + 2 * c;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      store2(row + 16 * u, dq[i][2 * u] * p.scale,
             dq[i][2 * u + 1] * p.scale);
  }
}

// ------------------------------------- 4. Hopper bf16 bodies (every hd)
// wgmma with its operands in shared memory by TMA (128-byte swizzle) and a
// producer warp; the header says why. HT rows a consumer warpgroup keeps
// (keys in dK/dV, queries in dQ), ST rows a streamed tile; a tile's row of
// HD bf16 is NB = ceil(HD / 64) boxes of 128 bytes, each box R rows x 128
// bytes (box_bytes(R): 8 KB at 64 rows, 4 KB at 32), which the swizzle's
// 8-row x 128-byte atoms tile with no padding. Where HD is not a multiple
// of 64 the last box's columns past hd are TMA's zero fill.
constexpr int HT = 64;
constexpr int HNT = 256;   // a producer and a consumer warpgroup
static_assert(HT == KB, "query_end counts the keys of a 64-key block");
// rows of a streamed tile: 64, but 32 at hd 160, where a 64-row tile's
// S^T and dP^T (32 + 32 registers a consumer thread) beside dK and dV (80
// + 80) would not fit the consumer's 232
template <int HD>
constexpr int stream_rows() { return HD > 128 ? 32 : 64; }
// TMA ring depth of the streamed tiles: two where a row is more than one
// box, where a third stage would leave room for one block an SM
// (tools/ablate_kernels.py)
template <int HD>
constexpr int hopper_stages() { return HD > BOX ? 2 : 3; }

template <int HD, int ST, int NST>
struct HopperShape {
  static constexpr int NB = (HD + BOX - 1) / BOX;  // boxes a tile row
  static constexpr int TILE = NB * BOX64;  // bytes of a kept 64-row tile
  static constexpr int SBOX = box_bytes(ST);  // of a streamed tile's box
  static constexpr int STILE = NB * SBOX;     // of a streamed tile
  // dK/dV: K, V, then NST x (Q, dO); dQ: Q, dO, then NST x (K, V); then
  // (dK/dV) NST x (lse, D) floats; then the mbarriers
  static constexpr int OFF_STAGE = 2 * TILE;
  static constexpr int OFF_LD = OFF_STAGE + NST * 2 * STILE;
  static constexpr int OFF_BAR = OFF_LD + NST * 2 * ST * 4;
  static constexpr int BYTES = OFF_BAR + (2 * NST + 1) * 8 + 1024;  // + align
};

// dK/dV: a block per (batch, KV head, 64-key tile). Warpgroup 0 is the
// producer: its warp 0 loads K and V once, then walks the (query head,
// ST-query tile) pairs that see the keys, putting Q and dO by TMA and lse
// and D by its lanes into an NST-stage ring. Warpgroup 1 computes: per
// tile S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared
// memory), P^T and dS^T in registers, then dV += T(P^T) dO and dK +=
// T(dS^T) Q with P^T and dS^T as the register A operand; dK and dV stay
// in its registers for the whole block. mq and mdo are the streamed maps
// (ST-row boxes), mk and mv the kept ones (64-row boxes).
template <int HD, int ST, int NST>
__global__ void __launch_bounds__(HNT, 2) fa_bwd_dkdv_hopper_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mdo, const BwdParams p) {
  using C = HopperShape<HD, ST, NST>;
  using T = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + NST;
  uint64_t* kv_bar = empty + NST;
  float* sLD = reinterpret_cast<float*>(smem + C::OFF_LD);

  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int grp = p.H / p.Hkv;
  const int k0 = blockIdx.x * HT;  // the first key tiles see the most
  const int per_head = (query_end(p, k0) - k0 + ST - 1) / ST;
  const int n_tiles = per_head * grp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + s, 32);    // the producer warp's lanes
      mbar_init(empty + s, 128);  // the consumers
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp != 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * C::TILE);
      for (int c = 0; c < C::NB; ++c) {
        tma_box(smem + c * BOX64, &mk, kv_bar, BOX * c, hk, k0, b);
        tma_box(smem + C::TILE + c * BOX64, &mv, kv_bar, BOX * c, hk, k0, b);
      }
    }
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % NST;
      if (n >= NST) mbar_wait(empty + st, ((n / NST) & 1) ^ 1);
      const int h = hk * grp + n / per_head, q0 = k0 + (n % per_head) * ST;
      float* ld = sLD + st * 2 * ST;
      for (int i = lane; i < ST; i += 32) {
        // a query past S gets lse = +inf: its P is 0
        const int q = q0 + i;
        const bool ok = q < p.S;
        ld[i] = ok ? p.lse[row_index(p, b, h, q)] * LOG2E : INFINITY;
        ld[ST + i] = ok ? p.delta[row_index(p, b, h, q)] : 0.f;
      }
      if (lane == 0) {
        unsigned char* dst = smem + C::OFF_STAGE + st * 2 * C::STILE;
        mbar_expect_tx(full + st, 2 * C::STILE);
        for (int c = 0; c < C::NB; ++c) {
          tma_box(dst + c * C::SBOX, &mq, full + st, BOX * c, h, q0, b);
          tma_box(dst + C::STILE + c * C::SBOX, &mdo, full + st, BOX * c, h,
                  q0, b);
        }
      } else {
        mbar_arrive(full + st);
      }
    }
    return;
  }

  // ---- consumer: warp cw of the warpgroup holds keys wk0 + [0, 16)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  constexpr int NA = HD / 2;  // a 64 x HD accumulator's floats a thread
  constexpr int NS = ST / 2;  // a 64 x ST accumulator's
  constexpr int KS = ST / 16;  // 16-query k-steps of dV and dK
  const int cw = warp - 4, g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + 16 * cw;
  const uint32_t sK = smem_addr(smem), sV = sK + C::TILE;
  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk[i] = dv[i] = 0.f;
  const float sl2 = p.scale * LOG2E;
  mbar_wait(kv_bar, 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % NST;
    mbar_wait(full + st, (n / NST) & 1);
    const int q0 = k0 + (n % per_head) * ST;
    const uint32_t sQ = sK + C::OFF_STAGE + st * 2 * C::STILE;
    const uint32_t sO = sQ + C::STILE;
    const float* lb = sLD + st * 2 * ST;
    const float* db = lb + ST;

    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<ST>(s, kmajor(sK, kk), kmajor(sQ, kk, C::SBOX));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<ST>(dp, kmajor(sV, kk), kmajor(sO, kk, C::SBOX));
    wg_commit();
    wg_wait0();
    keep<NS>(s);
    keep<NS>(dp);

    // P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T = P^T o (dP^T - D);
    // s[4 j + 2 r + e] is key wk0 + g + 8 r, query q0 + 8 j + 2 t + e
    const bool edge = q0 < wk0 + 15 ||
                      (p.window > 0 && q0 + ST - 1 - wk0 >= p.window);
#pragma unroll
    for (int j = 0; j < ST / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        const float l2 = lb[c], dl = db[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * j + 2 * r + e;
          float pv = fast_exp2(fmaf(s[i], sl2, -l2));
          if (edge) {
            const int dq = q0 + c - (wk0 + g + 8 * r);  // query - key
            if (dq < 0 || (p.window > 0 && dq >= p.window)) pv = 0.f;
          }
          s[i] = pv;
          dp[i] = pv * (dp[i] - dl);
        }
      }
    uint32_t pa[KS][4], sa[KS][4];
    to_frags<KS>(s, pa);
    to_frags<KS>(dp, sa);
    // dV += T(P^T) dO and dK += T(dS^T) Q, 16 queries a step
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD, C::SBOX>(dv, pa[kk], sO, kk);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD, C::SBOX>(dk, sa[kk], sQ, kk);
    wg_commit();
    wg_wait0();
    keep<NA>(dv);
    keep<NA>(dk);
    keep_frags<KS>(pa);
    keep_frags<KS>(sa);
    mbar_arrive(empty + st);
  }

  // dv[4 d + 2 r + e] is key wk0 + g + 8 r, column 8 d + 2 t + e
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wk0 + g + 8 * r;
    if (key >= p.S) continue;
    T* dkr = static_cast<T*>(p.dk) + b * p.dk_sb + (int64_t)key * p.dk_ss +
             hk * p.dk_sh + 2 * t;
    T* dvr = static_cast<T*>(p.dv) + b * p.dv_sb + (int64_t)key * p.dv_ss +
             hk * p.dv_sh + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      store2(dkr + 8 * d, dk[4 * d + 2 * r] * p.scale,
             dk[4 * d + 2 * r + 1] * p.scale);
      store2(dvr + 8 * d, dv[4 * d + 2 * r], dv[4 * d + 2 * r + 1]);
    }
  }
}

// dQ: a block per (batch, head, 64-query tile), the heaviest tiles first.
// The producer loads Q and dO once, then the ST-key tiles from the
// window's edge to the causal limit, K and V by TMA into the ring; the
// consumer warpgroup runs S = Q K^T and dP = dO V^T, P and dS in
// registers, and dQ += T(dS) K with dS as the register A operand. mq and
// mdo are the kept maps (64-row boxes), mk and mv the streamed ones.
template <int HD, int ST, int NST>
__global__ void __launch_bounds__(HNT, 2) fa_bwd_dq_hopper_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mdo, const BwdParams p) {
  using C = HopperShape<HD, ST, NST>;
  using T = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + NST;
  uint64_t* q_bar = empty + NST;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * HT;
  const int k_begin =
      p.window > 0 ? max(0, q0 - p.window + 1) / ST * ST : 0;
  const int k_end = min(p.S, q0 + HT);  // causal limit (Sq == Sk)
  const int n_tiles = (k_end - k_begin + ST - 1) / ST;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    mbar_expect_tx(q_bar, 2 * C::TILE);
    for (int c = 0; c < C::NB; ++c) {
      tma_box(smem + c * BOX64, &mq, q_bar, BOX * c, h, q0, b);
      tma_box(smem + C::TILE + c * BOX64, &mdo, q_bar, BOX * c, h, q0, b);
    }
    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % NST;
      if (n >= NST) mbar_wait(empty + st, ((n / NST) & 1) ^ 1);
      unsigned char* dst = smem + C::OFF_STAGE + st * 2 * C::STILE;
      const int k0 = k_begin + n * ST;
      mbar_expect_tx(full + st, 2 * C::STILE);
      for (int c = 0; c < C::NB; ++c) {
        tma_box(dst + c * C::SBOX, &mk, full + st, BOX * c, hk, k0, b);
        tma_box(dst + C::STILE + c * C::SBOX, &mv, full + st, BOX * c, hk,
                k0, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  constexpr int NA = HD / 2;
  constexpr int NS = ST / 2;
  constexpr int KS = ST / 16;  // 16-key k-steps of dQ
  const int cw = warp - 4, g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 16 * cw;
  const uint32_t sQ = smem_addr(smem), sO = sQ + C::TILE;
  // rows g and g + 8 of the warp: lse (exp2 domain) and D
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = wq0 + g + 8 * r;
    const bool ok = q < p.S;
    l2[r] = ok ? p.lse[row_index(p, b, h, q)] * LOG2E : INFINITY;
    dl[r] = ok ? p.delta[row_index(p, b, h, q)] : 0.f;
  }
  float dq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;
  const float sl2 = p.scale * LOG2E;
  mbar_wait(q_bar, 0);

  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % NST;
    mbar_wait(full + st, (n / NST) & 1);
    const int k0 = k_begin + n * ST;
    const uint32_t sKt = sQ + C::OFF_STAGE + st * 2 * C::STILE;
    const uint32_t sVt = sKt + C::STILE;
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<ST>(s, kmajor(sQ, kk), kmajor(sKt, kk, C::SBOX));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<ST>(dp, kmajor(sO, kk), kmajor(sVt, kk, C::SBOX));
    wg_commit();
    wg_wait0();
    keep<NS>(s);
    keep<NS>(dp);
    // dS = P o (dP - D), P recomputed; s[4 j + 2 r + e] is query wq0 + g +
    // 8 r, key k0 + 8 j + 2 t + e
    const bool edge = k0 + ST - 1 > wq0 || k0 + ST > p.S ||
                      (p.window > 0 && wq0 + 15 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < ST / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * r + e;
          float pv = fast_exp2(fmaf(s[i], sl2, -l2[r]));
          if (edge) {
            const int key = k0 + 8 * j + 2 * t + e;
            const int d = wq0 + g + 8 * r - key;  // query - key
            if (d < 0 || key >= p.S || (p.window > 0 && d >= p.window))
              pv = 0.f;
          }
          dp[i] = pv * (dp[i] - dl[r]);
        }
    uint32_t sa[KS][4];
    to_frags<KS>(dp, sa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD, C::SBOX>(dq, sa[kk], sKt, kk);
    wg_commit();
    wg_wait0();
    keep<NA>(dq);
    keep_frags<KS>(sa);
    mbar_arrive(empty + st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = wq0 + g + 8 * r;
    if (q >= p.S) continue;
    T* row = static_cast<T*>(p.dq) + b * p.dq_sb + (int64_t)q * p.dq_ss +
             h * p.dq_sh + 2 * t;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      store2(row + 8 * d, dq[4 * d + 2 * r] * p.scale,
             dq[4 * d + 2 * r + 1] * p.scale);
  }
}

// the TMA maps of q, k, v and dout at `rows`-row boxes
int make_maps(CUtensorMap* m, const BwdParams& p, int B, int hd, int rows) {
  int err = make_map(&m[0], p.q, p.q_sb, p.q_ss, p.q_sh, B, p.S, p.H, hd,
                     rows);
  if (!err)
    err = make_map(&m[1], p.k, p.k_sb, p.k_ss, p.k_sh, B, p.S, p.Hkv, hd,
                   rows);
  if (!err)
    err = make_map(&m[2], p.v, p.v_sb, p.v_ss, p.v_sh, B, p.S, p.Hkv, hd,
                   rows);
  if (!err)
    err = make_map(&m[3], p.dout, p.do_sb, p.do_ss, p.do_sh, B, p.S, p.H,
                   hd, rows);
  return err;
}

template <int HD>
int launch_hopper(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr int ST = stream_rows<HD>();
  // dQ's key tiles: as dK/dV's query tiles. At hd 160 its 80 + 32 + 32
  // registers would take 64-key tiles, but two stages of them (144 KB)
  // leave one block an SM and one stage loads nothing ahead: both were
  // slower at pixtral-12b's shape (tools/ablate_kernels.py)
  constexpr int KT = ST;
  constexpr int NST = hopper_stages<HD>();
  using C = HopperShape<HD, ST, NST>;
  using CQ = HopperShape<HD, KT, NST>;
  // q, k, v, dout at the kept tiles' 64-row boxes, and at the streamed
  // tiles' ST-row ones where those differ (hd 160)
  CUtensorMap kept[4], rows_st[4];
  int err = make_maps(kept, p, B, HD, HT);
  if (!err && ST != HT) err = make_maps(rows_st, p, B, HD, ST);
  if (err) return err;
  const CUtensorMap* streamed = ST != HT ? rows_st : kept;
  const CUtensorMap* keys = KT != HT ? rows_st : kept;
  static_assert(KT == ST || KT == HT, "dQ's key tiles have no maps");
  static const int attr = [] {
    // 256 threads x 128 = 128 x (24 + 232): see check_entry_registers
    int e = check_entry_registers(fa_bwd_dkdv_hopper_kernel<HD, ST, NST>,
                                  128);
    if (!e)
      e = check_entry_registers(fa_bwd_dq_hopper_kernel<HD, KT, NST>, 128);
    if (!e)
      e = cudaFuncSetAttribute(fa_bwd_dkdv_hopper_kernel<HD, ST, NST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::BYTES);
    if (!e)
      e = cudaFuncSetAttribute(fa_bwd_dq_hopper_kernel<HD, KT, NST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               CQ::BYTES);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 dkdv_grid((p.S + HT - 1) / HT, B * p.Hkv);
  fa_bwd_dkdv_hopper_kernel<HD, ST, NST>
      <<<dkdv_grid, HNT, C::BYTES, stream>>>(streamed[0], kept[1], kept[2],
                                              streamed[3], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((p.S + HT - 1) / HT, B * p.H);
  fa_bwd_dq_hopper_kernel<HD, KT, NST>
      <<<dq_grid, HNT, CQ::BYTES, stream>>>(kept[0], keys[1], keys[2],
                                            kept[3], p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ launch
// the bodies a (hd, dtype) pair runs: the Hopper bodies for bf16, the
// CUDA-core bodies for fp32 (flash_attention_bwd_body below reports it)
enum : int { BODY_CUDA_CORES = 0, BODY_WGMMA = 1 };

template <typename Kernel>
int launch(Kernel kernel, size_t smem, dim3 grid, int threads,
           const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
int launch_hd(const BwdParams& p, int B, bool bf16, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * p.S * p.H;
  const dim3 delta_grid(static_cast<unsigned>(
      (rows + DELTA_WARPS - 1) / DELTA_WARPS));
  if (bf16)
    fa_bwd_delta_kernel<__nv_bfloat16>
        <<<delta_grid, 32 * DELTA_WARPS, 0, stream>>>(p, rows);
  else
    fa_bwd_delta_kernel<float>
        <<<delta_grid, 32 * DELTA_WARPS, 0, stream>>>(p, rows);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bf16) return launch_hopper<HD>(p, B, stream);
  const dim3 dkdv_grid((p.S + KB - 1) / KB, B * p.Hkv);
  const dim3 dq_grid((p.S + QR - 1) / QR, B * p.H);
  err = launch(fa_bwd_dkdv_f32_kernel<HD>, BwdF32Shape<HD>::DKDV, dkdv_grid,
               NT32, p, stream);
  if (err != cudaSuccess) return err;
  return launch(fa_bwd_dq_f32_kernel<HD>, BwdF32Shape<HD>::DQ, dq_grid, NT32,
                p, stream);
}

bool is_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 80 || hd == 96 || hd == 128 ||
         hd == 160;
}

}  // namespace

// The body that flash_attention_bwd_launch runs for head dim `hd` and
// `dtype`: 0 the fp32 CUDA-core bodies, 1 the Hopper (wgmma, TMA) bodies;
// -1 for a pair it refuses.
extern "C" int flash_attention_bwd_body(int hd, int dtype) {
  if (!is_head_dim(hd) || (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return -1;
  return dtype == DTYPE_BF16 ? BODY_WGMMA : BODY_CUDA_CORES;
}

// q, o, dout, dq: (B, S, H, hd); k, v, dk, dv: (B, S, Hkv, hd), one dtype
// (`dtype`: DTYPE_F32 or DTYPE_BF16), each given by its data pointer and
// its (batch, seq, head) element strides in `strides` (q, k, v, o, dout,
// dq, dk, dv in that order); the head dim is contiguous. lse: (B, H, S)
// fp32 from the training forward; delta: (B, H, S) fp32 scratch. Sq == Sk
// == S. One call launches the delta, dK/dV and dQ kernels in order on
// `stream`. Returns the first CUDA error, 0 on success.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const int64_t* strides, int B, int H, int Hkv, int S, int hd,
    int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = lse; p.delta = delta; p.dq = dq; p.dk = dk; p.dv = dv;
  int64_t* fields[24] = {
      &p.q_sb, &p.q_ss, &p.q_sh, &p.k_sb, &p.k_ss, &p.k_sh,
      &p.v_sb, &p.v_ss, &p.v_sh, &p.o_sb, &p.o_ss, &p.o_sh,
      &p.do_sb, &p.do_ss, &p.do_sh, &p.dq_sb, &p.dq_ss, &p.dq_sh,
      &p.dk_sb, &p.dk_ss, &p.dk_sh, &p.dv_sb, &p.dv_ss, &p.dv_sh};
  for (int i = 0; i < 24; ++i) *fields[i] = strides[i];
  p.H = H; p.Hkv = Hkv; p.S = S; p.hd = hd;
  p.window = window;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == DTYPE_BF16;
  switch (hd) {
    case 32: return launch_hd<32>(p, B, bf16, s);
    case 64: return launch_hd<64>(p, B, bf16, s);
    case 80: return launch_hd<80>(p, B, bf16, s);
    case 96: return launch_hd<96>(p, B, bf16, s);
    case 128: return launch_hd<128>(p, B, bf16, s);
    case 160: return launch_hd<160>(p, B, bf16, s);
    default: return cudaErrorInvalidValue;
  }
}
