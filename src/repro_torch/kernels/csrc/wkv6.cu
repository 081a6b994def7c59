// RWKV6 (Finch) WKV recurrence for Hopper, sm_90a, in fp32:
//
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6.py (wkv6_chunked ->
// _wkv_kernel), which keeps each head's (hd x hd) state in VMEM across a
// sequential grid of chunks and always starts from zero. This kernel also
// starts from a given state and writes the final state back into the same
// buffer, which is what the model's decode needs; with a zero start state
// its y is the Pallas kernel's. Any S >= 1 (no S % chunk rule).
//
// What bounds it: bytes. The function needs 5 hd^2 fp32 flops per token
// and head (y_t = r_t^T S + (r_t . (u * k_t)) v_t is 2 hd^2, the state
// update 3 hd^2) on ~5 hd floats of input; at the serving prefill shape
// (B=4, S=1024, H=40, hd=64) that is 3.4 GFLOP (50 us at the H100 SXM's
// 67 TFLOP/s) against 215 MB (0.064170 ms at its 3.35 TB/s). A decode
// step (S=1) moves the (B, H, hd, hd) state in and out: 0.001629 ms.
//
// Two bodies behind the one wkv6_launch, chosen by S:
//
// Chunked body, S >= CT. Token by token the recurrence is a chain of 3
// dependent FMAs per state element per token, and only the (b, h, value
// column) axes are parallel: run at the serving prefill, the token body
// waits on that chain (tools/ablate_kernels.py wkv6, "the token-by-token
// body at every S"). The chunked form cuts the chain. For a
// run of L tokens with D[t][i] = prod_{tau<t} w[tau][i], E[s][i] =
// prod_{s<tau<L} w[tau][i], A[i] = prod_tau w[tau][i] (running products:
// every factor <= 1, so no division, no log, nothing to overflow, and a
// decay of 0 wipes the state as the recurrence does) and the L x L matrix
// M (M[t][s] = sum_i r[t][i] k[s][i] prod_{s<tau<t} w[tau][i] below the
// diagonal, sum_i r[t][i] u[i] k[t][i] on it, 0 above),
//
//   y = (r * D) S + M V,        S <- diag(A) S + (k * E)^T V:
//
// three matrix products, and the sequential loop runs S / L times. Here
// L = 8, the k depth of a TF32 mma: a chunk of T = 16 tokens (one round
// of copies and barriers) is two such 8-token sub-chunks, the second
// taking the first's tokens through the state, so only M's diagonal
// 8 x 8 blocks are built, pairwise in fp32 FFMA (7 steps a lane, not
// T - 1). A block owns one (b, h) and COLS value columns of its state and
// keeps them on chip for the whole sequence (in place is safe: no two
// blocks share a slice); each of its warps holds 16 key rows x 16
// columns of S^T in registers, in the mma accumulator layout. The
// products run on the tensor cores (mma.sync m16n8k8 TF32) in the
// transposed form y^T = S^T (r*D)^T + V^T M^T, S^T <- S^T diag(A) +
// V^T (k*E): S^T's registers are the A operand of the y product as they
// stand (the k index permuted inside each 8-block, the same for B), so S
// is never staged through shared memory. Each warp's y^T covers its own
// 16 key rows; the partials are summed through shared memory.
//
// Why 3xTF32: plain TF32 keeps ~11 significant bits, ~1e-3 relative, and
// the fp32 limits (1e-5 relative L2, atol 2e-5 / rtol 1e-4) need fp32.
// Each operand is split into hi = tf32(x) and lo = x - hi, and lo*hi +
// hi*lo + hi*hi is accumulated in fp32: ~22 bits per operand, the dropped
// lo*lo below 2^-22 relative. The state is never an mma accumulator: each
// update (k * E)^T V goes into fresh accumulators and is added to the
// decayed state by FFMA. Held in the accumulators, the state took the
// tensor cores' accumulation rounding at every sub-chunk, which compounds
// over a sequence when decays are near 1 (PERF.md).
//
// A chunk: r, k, w (T x hd) and v (T x COLS) arrive by cp.async in one of
// two shared-memory buffers (the next chunk's copies run under this one;
// rows past S are zero-filled and their decay taken as 1, so a ragged
// last chunk needs no other case); barrier; half the threads build M
// (two columns of a diagonal block for 4 key rows, summed over 16 lanes
// by a reduce-scatter; the column pair is a warp's, known at compile
// time), the other half D, E and A (2 key rows of one sub-chunk in one
// direction each); barrier; each warp runs the two sub-chunks' products
// and writes its y partial where r, k, w were; barrier; the partials
// are summed into y. COLS and T were chosen by timing (tools/ablate_kernels.py, PERF.md):
// COLS 32 (320 blocks of 8 warps at the serving shape, all resident at 3
// an SM: 40.7 KB of shared memory, 80 registers) builds M, D and E once
// per 32 columns, beside each other on two halves of the block, and beat
// COLS 16 (640 blocks of 4 warps, 5 an SM); T 32 needs twice the shared
// memory and was slower. What the time is spent on: PERF.md.
//
// Training forward (wkv6_train_launch, one call from zeros): the chain of
// chunks is cut too, at JAX's TIME_CHUNK = 256-token remat boundaries,
// whose start states the backward reads. Run chunk after chunk, the
// chunked body's grid is (B * H, hd / COLS): 160 blocks at rwkv6-3b's
// training microbatch (B = 2, H = 40), 40 % of the card's resident slots,
// each walking 16 rounds in sequence. Here every chunk is in flight at
// once, in three kernels on one stream:
//   1. summaries, a block per (b, h, chunk), 4 hd threads: the chunk's
//      own state from zeros, G_c = (K o E)^T V summed over 16-token
//      sub-chunks by S <- diag(A) S + (K o E)^T V (the backward's kernel
//      1 update; E and A running products of w inside the sub-chunk;
//      3xTF32 products into fresh accumulators added by FFMA), and its
//      fade A_c = prod_t w_t;
//   2. carry, a thread per state element: start_0 = 0, start_{c+1} = A_c o
//      start_c + G_c, written over G in `starts` (exactly what the
//      backward reads), and the final state;
//   3. y: the chunked body above from each chunk's start (its CHUNKS
//      instance), grid (B * H, hd / COLS, chunks): 2560 blocks at
//      rwkv6-3b's microbatch, not 160.
// A decay of exactly 0 wipes G and the carried start as the recurrence
// wipes its state; a decay of 1 leaves both as they are.
//
// Token body, S < CT (every decode step, S = 1, and a prompt shorter
// than a chunk): the chunked form has nothing to batch, and a step is
// bytes: it reads and writes the (B, H, hd, hd) state, 96 % of the 5.46
// MB a decode step moves at rwkv6-3b's shape (B=4, H=40, hd=64). The body
// this one replaced ran 3.3x that bound: its thread held one value column
// of 8 key rows, so the 8 lanes of a column touched 8 rows 1 KB apart and
// used 16 of each 32-byte sector; it staged the steps by cp.async in
// shared memory behind barriers, with y's round trip through shared
// memory, for a single token; it read u as scalars and held 8 state
// values a thread.
//
// Here a block of NT threads owns COLS = hd / TSPLIT value columns of one
// (b, h) state (two blocks a head: 320 blocks of 64 threads at rwkv6-3b's
// batch of 4, all resident). A thread owns a float4 of neighbouring value
// columns for a run of R = hd / RG neighbouring key rows: the LR = COLS / 4
// lanes of a row group lie along the value dim, so a warp reads and writes
// whole rows of the block's columns, 16 bytes a thread (full 32-byte
// sectors). The thread's whole slice (32 values at hd 64, 8 KB a block) is
// loaded before any arithmetic, all of it in flight at once. r, k, w of its
// rows and u come straight into registers by 16-byte loads (the lanes of a
// row group read the same bytes), v as one float4; nothing is staged. A
// step: y_j = sum_i r_i S_ij + (sum_i r_i u_i k_i) v_j over the thread's
// rows, and S_ij <- fmaf(w_i, S_ij, k_i v_j); the row groups' partials are
// summed by shuffles inside a warp and across warps through shared memory
// behind one barrier (a buffer a step parity: a step's readers are done
// before the next step's barrier); y is stored as a float4. Steps 2 to 15
// keep the state in registers, each step's operands loaded while the one
// before it computes.
//
// A launch costs about what the step's own work does (an empty kernel
// back to back takes 0.0019 ms on the H100): what the body's work adds
// to it is about the bound. TRG and TSPLIT were chosen by timing their
// alternatives (tools/ablate_kernels.py wkv6; PERF.md).

#include "common.cuh"

namespace {

constexpr int TRG = 8;     // token body: key-row groups of a head
constexpr int TSPLIT = 2;  // token body: blocks a head, by value columns

template <int HD>
struct TokenShape {
  // value columns a block: a warp's lanes must find a row each
  static constexpr int COLS = HD / TSPLIT >= 128 / HD ? HD / TSPLIT
                                                       : 128 / HD;
  static constexpr int SPLIT = HD / COLS;   // blocks a head
  static constexpr int LR = COLS / 4;       // lanes along a row, a float4 each
  // row groups: at least a warp's worth of lanes
  static constexpr int RG = TRG * LR >= 32 ? TRG : 32 / LR;
  static constexpr int R = HD / RG;  // key rows a thread
  static constexpr int NT = LR * RG;
  static constexpr int NW = NT / 32;
  static_assert(RG <= HD && R * RG == HD && NT % 32 == 0, "token lanes");
  static_assert(R % 4 == 0 || R <= 2, "token rows");
};

struct WkvParams {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  float* y;
  float* state;
  int64_t r_sb, r_ss, r_sh;  // element strides (batch, step, head)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh;
  int64_t y_sb, y_ss, y_sh;
  int64_t u_sh;
  int64_t st_sb, st_sh, st_si;  // (batch, head, key row)
  int64_t st_sc;  // training: the stride of chunk z's start state
  int H, S, has_state;
  int chunk;      // training: tokens of grid z's chunk
};

// N neighbouring floats into registers, 16 bytes a load where N allows
template <int N>
__device__ __forceinline__ void load_run(float* dst, const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N; e += 4) to4(dst + e, ld4(src + e));
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(src);
    dst[0] = f.x;
    dst[1] = f.y;
  } else {
    dst[0] = src[0];
  }
}

__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// a step's operands for one thread: r, k, w of its key rows, v of its
// four value columns
template <int R>
struct TokenStep {
  float r[R], k[R], w[R];
  float4 v;
};

template <int HD>
__global__ void __launch_bounds__(TokenShape<HD>::NT) wkv6_token_kernel(
    const WkvParams p) {
  using C = TokenShape<HD>;
  constexpr int R = C::R, LR = C::LR, NW = C::NW;
  // the warps' y partials, a buffer a step parity
  __shared__ __align__(16) float sY[2][NW][C::COLS];

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = R * (tid / LR);                        // first key row
  const int j = blockIdx.y * C::COLS + 4 * (tid % LR);  // first value column
  float* St = p.state + b * p.st_sb + h * p.st_sh + i0 * p.st_si + j;

  // the thread's state slice first, every load issued before any use
  float4 s[R];
#pragma unroll
  for (int e = 0; e < R; ++e)
    s[e] = p.has_state ? ld4(St + e * p.st_si)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  const float* Rg = p.r + b * p.r_sb + h * p.r_sh + i0;
  const float* Kg = p.k + b * p.k_sb + h * p.k_sh + i0;
  const float* Wg = p.w + b * p.w_sb + h * p.w_sh + i0;
  const float* Vg = p.v + b * p.v_sb + h * p.v_sh + j;
  float* Yg = p.y + b * p.y_sb + h * p.y_sh + j;
  // step t's operands, straight into registers
  auto load = [&](TokenStep<R>& x, int t) {
    load_run<R>(x.r, Rg + t * p.r_ss);
    load_run<R>(x.k, Kg + t * p.k_ss);
    load_run<R>(x.w, Wg + t * p.w_ss);
    x.v = ld4(Vg + t * p.v_ss);
  };
  TokenStep<R> cur, nxt;
  load(cur, 0);
  float u[R];
  load_run<R>(u, p.u + h * p.u_sh + i0);

#pragma unroll 1
  for (int t = 0; t < p.S; ++t) {
    if (t + 1 < p.S) load(nxt, t + 1);
    // this thread's rows: r^T S and a = r . (u * k), then the update
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const float ke = cur.k[e], we = cur.w[e];
      a = fmaf(cur.r[e], u[e] * ke, a);
      y = fma4(cur.r[e], s[e], y);
      s[e] = make_float4(fmaf(we, s[e].x, ke * cur.v.x),
                         fmaf(we, s[e].y, ke * cur.v.y),
                         fmaf(we, s[e].z, ke * cur.v.z),
                         fmaf(we, s[e].w, ke * cur.v.w));
    }
    y = fma4(a, cur.v, y);
    // summed over the row groups: a warp's by shuffles, then the warps'
#pragma unroll
    for (int o = LR; o < 32; o <<= 1) {
      y.x += __shfl_xor_sync(0xffffffffu, y.x, o);
      y.y += __shfl_xor_sync(0xffffffffu, y.y, o);
      y.z += __shfl_xor_sync(0xffffffffu, y.z, o);
      y.w += __shfl_xor_sync(0xffffffffu, y.w, o);
    }
    if constexpr (NW > 1) {
      float(*part)[C::COLS] = sY[t & 1];
      if (lane < LR) *reinterpret_cast<float4*>(part[warp] + 4 * lane) = y;
      __syncthreads();
      if (tid < LR) {
        y = ld4(part[0] + 4 * tid);
#pragma unroll
        for (int q = 1; q < NW; ++q) {
          const float4 o = ld4(part[q] + 4 * tid);
          y.x += o.x;
          y.y += o.y;
          y.z += o.z;
          y.w += o.w;
        }
      }
    }
    if (tid < LR) *reinterpret_cast<float4*>(Yg + t * p.y_ss) = y;
    cur = nxt;
  }

#pragma unroll
  for (int e = 0; e < R; ++e)
    *reinterpret_cast<float4*>(St + e * p.st_si) = s[e];
}

template <int HD>
int launch_token(const WkvParams& p, int B, cudaStream_t stream) {
  const dim3 grid(B * p.H, TokenShape<HD>::SPLIT);
  wkv6_token_kernel<HD><<<grid, TokenShape<HD>::NT, 0, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------------ chunked body
constexpr int CT = 16;     // chunked body: tokens per chunk (T)
constexpr int CCOLS = 32;  // chunked body: value columns per block

template <int HD>
struct ChunkShape {
  static constexpr int T = CT;
  static constexpr int COLS = CCOLS < HD ? CCOLS : HD;
  // warp (wr, wc) = (w % NWR, w / NWR) holds key rows [16 wr, +16) of
  // value columns [16 wc, +16) of the block's COLS
  static constexpr int NWR = HD / 16;
  static constexpr int NWC = COLS / 16;
  static constexpr int NW = NWR * NWC;
  static constexpr int NT = 32 * NW;
  static constexpr int KT = T / 8;  // 8-token sub-chunks
  // Phase A: threads [0, 2 HD) build M's diagonal 8 x 8 blocks, KT x 4
  // column pairs (s, 7-s) x IG lanes of RI key rows each; the DET tasks
  // of r * D, k * E and A, DW key rows of one sub-chunk in one direction
  // each, go to the threads from DE0 on: all of them after M, or the
  // ones beside M's if the block has them
  static constexpr int RI = T / 4;
  static constexpr int IG = HD / RI;
  static constexpr int DW = 2;
  static constexpr int DET = 2 * KT * (HD / DW);
  static constexpr int DE0 = NT >= 2 * HD + DET ? 2 * HD : 0;
  // row strides in shared memory: r, k, w as copied; the fragment
  // operands padded so that a warp's reads fall in 32 different banks
  static constexpr int LDG = HD;        // r, k, w
  static constexpr int LDR = HD + 8;    // r * D, k * E
  static constexpr int LDV = COLS + 8;  // v
  static constexpr int LDM = T + 4;     // M
  static constexpr int LDY = COLS + 4;  // y partials, one (T x COLS) a row
                                        // of warps
  // layout in floats: two buffers of r, k, w, v; r * D; k * E; M; A (one
  // row a sub-chunk)
  static constexpr int RKW = 3 * T * LDG;
  static constexpr int STAGE = RKW + T * LDV;
  static constexpr int OFF_RD = 2 * STAGE;
  static constexpr int OFF_KE = OFF_RD + T * LDR;
  static constexpr int OFF_M = OFF_KE + T * LDR;
  static constexpr int OFF_A = OFF_M + T * LDM;
  static constexpr int FLOATS = OFF_A + KT * HD;
  // blocks an SM for 20 warps: the serving shape's 2560 warps (160 heads
  // of 16) all resident on 132 SMs
  static constexpr int MIN_BLOCKS = (20 + NW - 1) / NW;
  static_assert(COLS % 16 == 0 && T % 8 == 0 && HD % 16 == 0, "tiles");
  static_assert(RI % 4 == 0 && IG <= 32 && 2 * HD <= NT, "M lanes");
  // a chunk's y partials go where its r, k, w were
  static_assert(NWR * T * LDY <= RKW, "y partials");
};

// N floats from shared memory, 16 bytes a load
template <int N>
__device__ __forceinline__ void load_row(float* dst, const float* src) {
#pragma unroll
  for (int e = 0; e < N; e += 4) {
    const float4 f = *reinterpret_cast<const float4*>(src + e);
    dst[e] = f.x; dst[e + 1] = f.y; dst[e + 2] = f.z; dst[e + 3] = f.w;
  }
}

// M's diagonal 8 x 8 blocks, one a sub-chunk, in fp32 FFMA (the y of a
// sub-chunk takes the earlier ones' tokens through the state). Inside a
// block, below the diagonal M[t][s] = sum_i r[t][i] k[s][i] prod_{s<tau<t}
// w[tau][i], by a running product over t; on it sum_i r[t][i] u[i]
// k[t][i]. A lane group takes the columns s = PR and 7-PR of one block
// for RI key rows each: 7 steps for every lane, step q on column PR for
// q < 7-PR, then on 7-PR. The IG lanes sum their rows once at the end.
template <int HD, int PR>
__device__ __forceinline__ void build_m_pair(const float* sr,
                                             const float* sk,
                                             const float* sw,
                                             const float* uu, float* sM,
                                             int h0, int gl) {
  using C = ChunkShape<HD>;
  constexpr int RI = C::RI, IG = C::IG, LDG = C::LDG, LDM = C::LDM;
  constexpr int NV = 8;  // 7 steps and one diagonal
  constexpr int TURN = 7 - PR;
  const int i0 = RI * gl, sa = h0 + PR, sb = h0 + 7 - PR;
  float ka[RI], kb[RI], kp[RI], rt[RI], wt[RI];
  load_row<RI>(ka, sk + sa * LDG + i0);
  load_row<RI>(kb, sk + sb * LDG + i0);
  // acc[q]: step q's partial sum; acc[7]: the diagonal at t = sa
  float acc[NV], db = 0.f;
  acc[NV - 1] = 0.f;
  load_row<RI>(rt, sr + sa * LDG + i0);
#pragma unroll
  for (int e = 0; e < RI; ++e)
    acc[NV - 1] = fmaf(rt[e], uu[e] * ka[e], acc[NV - 1]);
  load_row<RI>(rt, sr + sb * LDG + i0);
#pragma unroll
  for (int e = 0; e < RI; ++e) db = fmaf(rt[e], uu[e] * kb[e], db);
#pragma unroll
  for (int e = 0; e < RI; ++e) kp[e] = ka[e];
  // step q reads row t = h0 + q + 1 (+ PR before the turn)
  const float* rq = sr + (h0 + 1) * LDG + i0;
  const float* wq = sw + (h0 + 1) * LDG + i0;
#pragma unroll
  for (int q = 0; q < NV - 1; ++q) {
    if (q == TURN) {
#pragma unroll
      for (int e = 0; e < RI; ++e) kp[e] = kb[e];
    }
    const int off = ((q < TURN ? PR : 0) + q) * LDG;
    load_row<RI>(rt, rq + off);
    load_row<RI>(wt, wq + off);
    float a = 0.f;
#pragma unroll
    for (int e = 0; e < RI; ++e) {
      a = fmaf(rt[e], kp[e], a);
      kp[e] *= wt[e];
    }
    acc[q] = a;
  }
  // the group's own lanes: a warp's groups may take other cases of
  // build_m's switch (below hd 64)
  const unsigned group = IG == 32 ? 0xffffffffu
      : ((1u << IG) - 1u) << ((threadIdx.x % 32) / IG * IG);
  db = sum_lanes<IG>(db, group);
  reduce_scatter<NV, IG>(acc, gl, group);
  if (gl == 0) sM[sb * LDM + sb] = db;
  constexpr int LANES = IG < NV ? IG : NV, PER = NV / LANES;
  if (gl < LANES) {
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int q = gl * PER + e;
      if (q == NV - 1)
        sM[sa * LDM + sa] = acc[e];
      else if (q < TURN)
        sM[(sa + 1 + q) * LDM + sa] = acc[e];
      else
        sM[(h0 + q + 1) * LDM + sb] = acc[e];
    }
  }
}

// M by all 2 HD threads: pair (pr, sub-chunk) = (pair / KT, pair % KT),
// so that the column pair is known at compile time in each case and, at
// hd 64, a warp takes one case
template <int HD>
__device__ __forceinline__ void build_m(const float* sr, const float* sk,
                                        const float* sw, const float* uu,
                                        float* sM, int tid) {
  using C = ChunkShape<HD>;
  const int pair = tid / C::IG, gl = tid % C::IG;
  const int h0 = 8 * (pair % C::KT);
  switch (pair / C::KT) {
    case 0: build_m_pair<HD, 0>(sr, sk, sw, uu, sM, h0, gl); break;
    case 1: build_m_pair<HD, 1>(sr, sk, sw, uu, sM, h0, gl); break;
    case 2: build_m_pair<HD, 2>(sr, sk, sw, uu, sM, h0, gl); break;
    default: build_m_pair<HD, 3>(sr, sk, sw, uu, sM, h0, gl); break;
  }
}

// r * D, k * E and A of each 8-token sub-chunk, by running products
// from the sub-chunk's start or to its end, DW key rows a thread: x =
// (direction, sub-chunk, row group), so that a warp walks one way. Up:
// r * D and A; down: k * E. Past the last step n the decay is 1 (only
// the last chunk can be ragged).
template <int HD, bool UP, bool RAGGED>
__device__ __forceinline__ void decay_walk(const float* src, const float* w,
                                           float* dst, float* a, int n) {
  using C = ChunkShape<HD>;
  constexpr int LDG = C::LDG, LDR = C::LDR;
  float2 d = make_float2(1.f, 1.f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int t = UP ? j : 7 - j;
    const float2 v = *reinterpret_cast<const float2*>(src + t * LDG);
    *reinterpret_cast<float2*>(dst + t * LDR) =
        make_float2(v.x * d.x, v.y * d.y);
    float2 wv = *reinterpret_cast<const float2*>(w + t * LDG);
    if (RAGGED && t >= n) wv = make_float2(1.f, 1.f);
    d.x *= wv.x;
    d.y *= wv.y;
  }
  if (UP) *reinterpret_cast<float2*>(a) = d;
}

template <int HD, bool RAGGED>
__device__ __forceinline__ void decay_products(const float* sr,
                                               const float* sk,
                                               const float* sw, int n,
                                               float* sRD, float* sKE,
                                               float* sA, int x) {
  using C = ChunkShape<HD>;
  constexpr int KT = C::KT, LDG = C::LDG, LDR = C::LDR, DW = C::DW;
  const int i0 = DW * (x % (HD / DW)), h = (x / (HD / DW)) % KT;
  const int g = 8 * h * LDG + i0, o = 8 * h * LDR + i0;
  if (x < KT * (HD / DW))
    decay_walk<HD, true, RAGGED>(sr + g, sw + g, sRD + o, sA + h * HD + i0,
                                 n - 8 * h);
  else
    decay_walk<HD, false, RAGGED>(sk + g, sw + g, sKE + o, nullptr,
                                  n - 8 * h);
}

// V^T's A fragment for value columns [16 mt, +16) and tokens [8 ks, +8):
// V is [token][column] in shared memory
template <int LDV>
__device__ __forceinline__ FragA v_frag(const float* sv, int mt, int ks,
                                        int g, int tq) {
  const float* v0 = sv + (8 * ks + tq) * LDV + 16 * mt + g;
  return frag_a(v0[0], v0[8], v0[4 * LDV], v0[4 * LDV + 8]);
}

// The block's run of tokens in the chunked body: the whole sequence, or
// in training (CHUNKS) chunk z of p.chunk tokens. A chunk's length is read
// anew at each use (the volatile read of the block index is not hoisted),
// which keeps it out of the registers held across the loop: at 80
// registers a thread, one more is a spill.
template <bool CHUNKS>
__device__ __forceinline__ int run_length(const WkvParams& p) {
  if (!CHUNKS) return p.S;
  unsigned z;
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  return min(p.S - (int)z * p.chunk, p.chunk);
}

// CHUNKS: a block runs chunk blockIdx.z from its start state in p.state
// (stride st_sc) and writes no final state (training); else the whole
// sequence, from p.state or zeros, writing the final state back
template <int HD, bool CHUNKS>
__global__ void __launch_bounds__(ChunkShape<HD>::NT,
                                  ChunkShape<HD>::MIN_BLOCKS)
    wkv6_chunk_kernel(const WkvParams p) {
  using C = ChunkShape<HD>;
  constexpr int T = C::T, COLS = C::COLS, NWR = C::NWR, NT = C::NT;
  constexpr int KT = C::KT, RI = C::RI, IG = C::IG;
  constexpr int LDG = C::LDG, LDR = C::LDR, LDV = C::LDV, LDY = C::LDY;
  extern __shared__ __align__(16) float smem[];
  float* sRD = smem + C::OFF_RD;
  float* sKE = smem + C::OFF_KE;
  float* sM = smem + C::OFF_M;
  float* sA = smem + C::OFF_A;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int col0 = blockIdx.y * COLS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % NWR, wc = warp / NWR;
  const int g = lane / 4, tq = lane % 4;
  const int64_t z0 = CHUNKS ? (int64_t)blockIdx.z * p.chunk : 0;
  const float* Rg = p.r + b * p.r_sb + h * p.r_sh + z0 * p.r_ss;
  const float* Kg = p.k + b * p.k_sb + h * p.k_sh + z0 * p.k_ss;
  const float* Vg = p.v + b * p.v_sb + h * p.v_sh + z0 * p.v_ss + col0;
  const float* Wg = p.w + b * p.w_sb + h * p.w_sh + z0 * p.w_ss;
  float* Yg = p.y + b * p.y_sb + h * p.y_sh + z0 * p.y_ss + col0;
  float* St = p.state + b * p.st_sb + h * p.st_sh +
              (CHUNKS ? blockIdx.z * p.st_sc : 0);

  // S^T in the mma accumulator layout: st[nn][e] is S[i][j] for value
  // column j = col0 + 16 wc + g (+8 for e >= 2) and key row i = 16 wr +
  // 8 nn + 2 tq (+1 for odd e)
  float st[2][4];
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * wr + 8 * nn + 2 * tq + (e & 1);
      const int j = col0 + 16 * wc + g + 8 * (e >> 1);
      st[nn][e] = p.has_state ? St[i * p.st_si + j] : 0.f;
    }
  float uu[RI];  // u of this thread's key rows in M
#pragma unroll
  for (int e = 0; e < RI; ++e)
    uu[e] = p.u[h * p.u_sh + RI * (tid % IG) + e];
  for (int idx = tid; idx < T * C::LDM; idx += NT) sM[idx] = 0.f;

  // The copies of a chunk: a thread copies 16 bytes of rows ct + RS it
  // of r, k and w, and of v through a loop.
  constexpr int CPR = HD / 4, VPR = COLS / 4, RS = NT / CPR;
  static_assert(T % RS == 0, "copies");
  const int ct = tid / CPR, cq = 4 * (tid % CPR);
  const float* gr = Rg + ct * p.r_ss + cq;
  const float* gk = Kg + ct * p.k_ss + cq;
  const float* gw = Wg + ct * p.w_ss + cq;
  const int64_t rr = RS * p.r_ss, kr = RS * p.k_ss, wr_ = RS * p.w_ss;
  // start the copies of chunk [t0, t0 + T) into buffer `buf` as one
  // group; rows past S are zero-filled
  auto stage = [&](int buf, int t0) {
    float* sr = smem + buf * C::STAGE + ct * LDG + cq;
    const int n = min(T, run_length<CHUNKS>(p) - t0);
#pragma unroll
    for (int it = 0; it < T / RS; ++it) {
      const bool ok = ct + RS * it < n;
      // (a row past S reads nothing: any mapped address, the tensor's
      // own, will do)
      cp_async16(sr + RS * it * LDG, ok ? gr + it * rr : p.r, ok);
      cp_async16(sr + (T + RS * it) * LDG, ok ? gk + it * kr : p.k, ok);
      cp_async16(sr + (2 * T + RS * it) * LDG, ok ? gw + it * wr_ : p.w,
                 ok);
    }
    gr += T * p.r_ss;
    gk += T * p.k_ss;
    gw += T * p.w_ss;
    float* sv = smem + buf * C::STAGE + C::RKW;
    for (int idx = tid; idx < T * VPR; idx += NT) {
      const int t = idx / VPR, q = 4 * (idx % VPR);
      const bool ok = t < n;
      cp_async16(sv + t * LDV + q, Vg + (ok ? t0 + t : 0) * p.v_ss + q, ok);
    }
    cp_async_commit();
  };

  // chunk t0 / T in buffer (t0 / T) & 1
  stage(0, 0);
  for (int t0 = 0; t0 < run_length<CHUNKS>(p); t0 += T) {
    const int n = min(T, run_length<CHUNKS>(p) - t0), buf = (t0 / T) & 1;
    float* sr = smem + buf * C::STAGE;
    const float* sk = sr + T * LDG;
    const float* sw = sk + T * LDG;
    const float* sv = sr + C::RKW;
    cp_async_wait<0>();
    __syncthreads();  // this chunk landed; the last one is done everywhere
    if (t0 + T < run_length<CHUNKS>(p)) stage(buf ^ 1, t0 + T);

    if (NT == 2 * HD || tid < 2 * HD)
      build_m<HD>(sr, sk, sw, uu, sM, tid);
    for (int x = tid - C::DE0; x >= 0 && x < C::DET; x += NT - C::DE0) {
      if (n == T)
        decay_products<HD, false>(sr, sk, sw, n, sRD, sKE, sA, x);
      else
        decay_products<HD, true>(sr, sk, sw, n, sRD, sKE, sA, x);
    }
    __syncthreads();

    // Sub-chunk by sub-chunk (8 tokens, h): y_h^T = S^T (r * D_h)^T over
    // this warp's key rows + V_h^T M_hh^T, then S^T <- S^T diag(A_h) +
    // V_h^T (k * E_h). S^T's registers are the A operand of the first
    // product with k = i permuted in each 8-block (logical k tq is i 2 tq,
    // k tq + 4 is i 2 tq + 1), and B reads r * D the same way; M_hh V_h
    // is dealt round the warps of a column tile.
    float y[KT][4];
#pragma unroll
    for (int hs = 0; hs < KT; ++hs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) y[hs][e] = 0.f;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const float2 bv = *reinterpret_cast<const float2*>(
            sRD + (8 * hs + g) * LDR + 16 * wr + 8 * nn + 2 * tq);
        const float* a = st[nn];
        mma3(y[hs], frag_a(a[0], a[2], a[1], a[3]), frag_b(bv.x, bv.y));
      }
      const FragA fv = v_frag<LDV>(sv, wc, hs, g, tq);
      if (hs % NWR == wr) {
        const float* mrow = sM + (8 * hs + g) * C::LDM + 8 * hs + tq;
        mma3(y[hs], fv, frag_b(mrow[0], mrow[4]));
      }
      // the update (k * E)^T V into fresh accumulators, then added to the
      // decayed state in fp32 FFMA: the state is never the accumulator of
      // an mma, whose rounding would compound over the sequence
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const float* ke = sKE + (8 * hs + tq) * LDR + 16 * wr + 8 * nn + g;
        float ds[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(ds, fv, frag_b(ke[0], ke[4 * LDR]));
        const float2 a2 = *reinterpret_cast<const float2*>(
            sA + hs * HD + 16 * wr + 8 * nn + 2 * tq);
        st[nn][0] = fmaf(a2.x, st[nn][0], ds[0]);
        st[nn][1] = fmaf(a2.y, st[nn][1], ds[1]);
        st[nn][2] = fmaf(a2.x, st[nn][2], ds[2]);
        st[nn][3] = fmaf(a2.y, st[nn][3], ds[3]);
      }
    }

    // each warp's y partial, [token][column], where r, k, w were: one
    // (T x COLS) partial a row of warps
    float* yp = sr + wr * T * LDY + 16 * wc;
#pragma unroll
    for (int hs = 0; hs < KT; ++hs) {
      float* o = yp + (8 * hs + 2 * tq) * LDY + g;
      o[0] = y[hs][0];
      o[LDY] = y[hs][1];
      o[8] = y[hs][2];
      o[LDY + 8] = y[hs][3];
    }
    __syncthreads();
    for (int idx = tid; idx < n * VPR; idx += NT) {
      const int t = idx / VPR, q = 4 * (idx % VPR);
      float4 acc = *reinterpret_cast<const float4*>(sr + t * LDY + q);
#pragma unroll
      for (int w = 1; w < NWR; ++w) {
        const float4 o =
            *reinterpret_cast<const float4*>(sr + (w * T + t) * LDY + q);
        acc.x += o.x; acc.y += o.y; acc.z += o.z; acc.w += o.w;
      }
      *reinterpret_cast<float4*>(Yg + (int64_t)(t0 + t) * p.y_ss + q) = acc;
    }
  }

  if (CHUNKS) return;
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * wr + 8 * nn + 2 * tq + (e & 1);
      const int j = col0 + 16 * wc + g + 8 * (e >> 1);
      St[i * p.st_si + j] = st[nn][e];
    }
}

template <int HD, bool CHUNKS>
int launch_chunk(const WkvParams& p, int B, int chunks, cudaStream_t stream) {
  using C = ChunkShape<HD>;
  constexpr int bytes = C::FLOATS * sizeof(float);
  static const int attr = [] {
    const int e = cudaFuncSetAttribute(
        wkv6_chunk_kernel<HD, CHUNKS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return e ? e
             : cudaFuncSetAttribute(
                   wkv6_chunk_kernel<HD, CHUNKS>,
                   cudaFuncAttributePreferredSharedMemoryCarveout,
                   cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * p.H, HD / C::COLS, chunks);
  wkv6_chunk_kernel<HD, CHUNKS><<<grid, C::NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

// the body by S: chunks of CT tokens, or token by token below that
template <int HD>
int launch(const WkvParams& p, int B, cudaStream_t stream) {
  return p.S >= CT ? launch_chunk<HD, false>(p, B, 1, stream)
                   : launch_token<HD>(p, B, stream);
}

// ------------------------------------------------------ training forward
// wkv6_train_launch: the sequence from zeros in chunks of p.chunk tokens,
// every chunk in flight at once (see the header). Kernel 1 (summaries)
// walks a chunk in SL-token sub-chunks by the state update of the
// backward's kernel 1, S <- diag(A) S + (K o E)^T V, from zeros.
constexpr int SL = 16;  // summaries: tokens a sub-chunk (two mma k-steps)
constexpr int SST = 2;  // summaries: buffers in the ring of copies

template <int HD>
struct SumShape {
  static constexpr int NT = 4 * HD;   // threads: a (token, 4 key rows) each
  static constexpr int G4 = HD / 4;   // key-row groups of 4
  static constexpr int LDI = HD + 8;  // staged k, v, w rows ([t][i]: v is
                                      // read as k-major B fragments)
  static constexpr int LDP = HD + 8;  // k o E [t][i] (k-major A)
  static constexpr int IN = 3 * SL * LDI;  // one buffer: k, v, w
  static constexpr int FLOATS = SST * IN + SL * LDP + 2 * HD;
  static_assert(NT / G4 == SL, "a token a row of threads");
};

// Start the copies of tokens [t0, t0 + SL) of k, v, w into `dst` (three
// arrays of SL rows of LDI). Rows at or past `lim` are zero-filled, w's
// with 1 (a decay of 1 and k = v = 0 leave the state as it is), stored by
// the thread that owns the 16 bytes.
template <int HD>
__device__ __forceinline__ void stage_kvw(const WkvParams& p, float* dst,
                                          int b, int h, int t0, int lim) {
  using C = SumShape<HD>;
  constexpr int CPR = HD / 4;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* src = a == 0 ? p.k + b * p.k_sb + h * p.k_sh
                     : a == 1 ? p.v + b * p.v_sb + h * p.v_sh
                              : p.w + b * p.w_sb + h * p.w_sh;
    const int64_t ss = a == 0 ? p.k_ss : a == 1 ? p.v_ss : p.w_ss;
    for (int idx = threadIdx.x; idx < SL * CPR; idx += C::NT) {
      const int t = idx / CPR, c = 4 * (idx % CPR);
      float* d = dst + (a * SL + t) * C::LDI + c;
      const bool ok = t0 + t < lim;
      if (a == 2 && !ok)
        *reinterpret_cast<float4*>(d) = make_float4(1.f, 1.f, 1.f, 1.f);
      else
        cp_async16(d, ok ? src + (int64_t)(t0 + t) * ss + c : src, ok);
    }
  }
}

// 1. A block per (b * H + h, chunk c): G_c, the state after the chunk from
// zeros, written where the carry reads it (the chunk's slot of p.state,
// which becomes its start), and the chunk's fade A_c = prod_t w_t. Warp w
// keeps value columns [8w, 8w + 8) of G in registers (common.cuh's Mat);
// E_t = prod_{t < tau < SL} w_tau inside the sub-chunk and A (the
// sub-chunk's product) are running products of w, every factor <= 1 (no
// log, no division: a decay of 0 zeroes them exactly).
template <int HD>
__global__ void __launch_bounds__(SumShape<HD>::NT, 2)
    wkv6_summary_kernel(const WkvParams p, float* fade) {
  using C = SumShape<HD>;
  constexpr int NT = C::NT, LDI = C::LDI, LDP = C::LDP;
  extern __shared__ __align__(16) float smem[];
  float* sKE = smem + SST * C::IN;  // k o E [t][i]
  float* sA = sKE + SL * LDP;       // the sub-chunk's A [i]
  float* sF = sA + HD;              // the product of A over the sub-chunks
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, c = blockIdx.y;
  const int tid = threadIdx.x, w = tid / 32, g = tid % 32 / 4, tq = tid % 4;
  const int t = tid / C::G4, r0 = 4 * (tid % C::G4);
  const int c0 = c * p.chunk, c1 = min(p.S, c0 + p.chunk);

  Mat<HD> s;
#pragma unroll
  for (int e = 0; e < HD / 16; ++e)
    s[e][0] = s[e][1] = s[e][2] = s[e][3] = 0.f;
  for (int i = tid; i < HD; i += NT) sF[i] = 1.f;

  // a ring of SST buffers, SST - 1 sub-chunks in flight ahead of the one
  // computed; one commit group a sub-chunk (empty past the end)
  const int subs = (c1 - c0 + SL - 1) / SL;
#pragma unroll
  for (int q = 0; q < SST - 1; ++q) {
    if (q < subs) stage_kvw<HD>(p, smem + q * C::IN, b, h, c0 + q * SL, c1);
    cp_async_commit();
  }
  for (int q = 0; q < subs; ++q) {
    const float* buf = smem + (q % SST) * C::IN;
    cp_async_wait<SST - 2>();
    __syncthreads();  // this sub-chunk landed; sF of the last one is set
    // into the buffer the last sub-chunk used
    if (q + SST - 1 < subs)
      stage_kvw<HD>(p, smem + ((q + SST - 1) % SST) * C::IN, b, h,
                    c0 + (q + SST - 1) * SL, c1);
    cp_async_commit();
    {
      // E_t by a running product over the later tokens; A = w_0 E_0
      const float* sW = buf + 2 * SL * LDI;
      float ee[4] = {1.f, 1.f, 1.f, 1.f}, kt[4];
#pragma unroll
      for (int tau = 1; tau < SL; ++tau) {
        float wv[4];
        to4(wv, ld4(sW + tau * LDI + r0));
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (tau > t) ee[x] *= wv[x];
      }
      to4(kt, ld4(buf + t * LDI + r0));
#pragma unroll
      for (int x = 0; x < 4; ++x) kt[x] *= ee[x];
      st4(sKE + t * LDP + r0, kt);
      if (t == 0) {
        float w0[4];
        to4(w0, ld4(sW + r0));
#pragma unroll
        for (int x = 0; x < 4; ++x) w0[x] *= ee[x];
        st4(sA + r0, w0);
      }
    }
    __syncthreads();
    FragB bf[2];
    b_frags(bf, buf + SL * LDI, LDI, w, g, tq);
    mat_update<HD>(s, sKE, LDP, bf, sA, g, tq);
    __syncthreads();  // every read of this sub-chunk's buffers is done
    for (int i = tid; i < HD; i += NT) sF[i] *= sA[i];
  }
  __syncthreads();
  const int64_t at = (int64_t)(b * gridDim.y + c) * p.H + h;
  mat_store<HD>(p.state + b * p.st_sb + c * p.st_sc + h * p.st_sh,
                (int)p.st_si, s, w, g, tq);
  for (int i = tid; i < HD; i += NT) fade[at * HD + i] = sF[i];
}

// 2. A thread per (b, h, i, j): start_0 = 0, start_{c+1} = A_c[i] start_c
// + G_c, each G_c read from its slot and the start written over it; the
// state after the last chunk to `final_state` (B, H, hd, hd) contiguous.
// `starts` is (B, NC, H, hd, hd) contiguous, `fade` (B, NC, H, hd).
__global__ void __launch_bounds__(256) wkv6_carry_kernel(
    float* starts, const float* fade, float* final_state, int B, int NC,
    int H, int hd) {
  const int64_t per = (int64_t)H * hd * hd;  // (h, i, j)
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * per) return;
  const int64_t b = idx / per, rem = idx % per, hi = rem / hd;
  float* slot = starts + b * NC * per + rem;
  const float* a = fade + b * NC * H * hd + hi;
  // CU chunks' G and A loaded before any start is stored: the loads of a
  // group are in flight together, not one latency a chunk
  constexpr int CU = 16;
  float carry = 0.f;
  for (int c0 = 0; c0 < NC; c0 += CU) {
    float g[CU], f[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (c0 + u < NC) {
        g[u] = slot[(c0 + u) * per];
        f[u] = a[(int64_t)(c0 + u) * H * hd];
      }
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (c0 + u < NC) {
        slot[(c0 + u) * per] = carry;
        carry = fmaf(f[u], carry, g[u]);
      }
  }
  final_state[idx] = carry;
}

template <int HD>
int launch_train(WkvParams p, int B, float* fade, float* final_state,
                 cudaStream_t stream) {
  using C = SumShape<HD>;
  constexpr int bytes = C::FLOATS * sizeof(float);
  static const int attr = [] {
    const int e = cudaFuncSetAttribute(
        wkv6_summary_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    return e ? e
             : cudaFuncSetAttribute(
                   wkv6_summary_kernel<HD>,
                   cudaFuncAttributePreferredSharedMemoryCarveout,
                   cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  const int nc = (p.S + p.chunk - 1) / p.chunk;
  wkv6_summary_kernel<HD><<<dim3(B * p.H, nc), C::NT, bytes, stream>>>(p,
                                                                      fade);
  int err = cudaGetLastError();
  if (err) return err;
  const int64_t n = (int64_t)B * p.H * HD * HD;
  wkv6_carry_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      p.state, fade, final_state, B, nc, p.H, HD);
  err = cudaGetLastError();
  if (err) return err;
  // 3. every chunk's y from its start, by the chunked body (grid z)
  p.has_state = 1;
  return launch_chunk<HD, true>(p, B, nc, stream);
}

WkvParams make_params(const float* r, const float* k, const float* v,
                      const float* w, const float* u, float* y, float* state,
                      const int64_t* strides) {
  WkvParams p{};
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.y = y; p.state = state;
  p.r_sb = strides[0]; p.r_ss = strides[1]; p.r_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.w_sb = strides[9]; p.w_ss = strides[10]; p.w_sh = strides[11];
  p.y_sb = strides[12]; p.y_ss = strides[13]; p.y_sh = strides[14];
  p.u_sh = strides[15];
  return p;
}

}  // namespace

// r, k, v, w and y: (B, S, H, hd) fp32, each given by its data pointer and
// element strides (batch, step, head) in `strides`; u: (H, hd) with head
// stride strides[15]; state: (B, H, hd, hd) fp32 with strides (batch, head,
// key row) in strides[16..18]. The head dim and the state's value dim are
// contiguous, and rows of r, k, v, w, y are 16-byte aligned. has_state = 0
// starts from zero without reading `state`; the final state is written
// into `state` either way. One call is one launch: the chunked body for
// S >= CT, the token body below. Returns cudaGetLastError() after it.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, float* y,
                           float* state, int has_state,
                           const int64_t* strides, int B, int H, int S,
                           int hd, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  WkvParams p = make_params(r, k, v, w, u, y, state, strides);
  p.st_sb = strides[16]; p.st_sh = strides[17]; p.st_si = strides[18];
  p.H = H; p.S = S; p.has_state = has_state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, B, s);
    case 32: return launch<32>(p, B, s);
    case 64: return launch<64>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// the chunked body's T: wkv6_launch takes it for S >= this
extern "C" int wkv6_chunk_tokens() { return CT; }

// The training forward from zeros, in chunks of `chunk` tokens, every
// chunk in flight at once: r, k, v, w, y and u as for wkv6_launch
// (strides[0..15]); `starts` (B, NC, H, hd, hd) fp32 contiguous, NC =
// ceil(S / chunk), gets the state at each chunk's start (zeros for the
// first); `final_state` (B, H, hd, hd) contiguous the state after the
// last; `fade` (B, NC, H, hd) fp32 is scratch. Three kernels on `stream`
// (summaries, carry, y) in one call. Returns the first launch's error, or
// cudaGetLastError() after the last.
extern "C" int wkv6_train_launch(const float* r, const float* k,
                                 const float* v, const float* w,
                                 const float* u, float* y, float* final_state,
                                 float* starts, float* fade,
                                 const int64_t* strides, int B, int H, int S,
                                 int hd, int chunk, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || chunk <= 0) return cudaErrorInvalidValue;
  WkvParams p = make_params(r, k, v, w, u, y, starts, strides);
  const int nc = (S + chunk - 1) / chunk;
  p.st_si = hd;
  p.st_sh = (int64_t)hd * hd;
  p.st_sc = p.st_sh * H;
  p.st_sb = p.st_sc * nc;
  p.H = H; p.S = S; p.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_train<16>(p, B, fade, final_state, s);
    case 32: return launch_train<32>(p, B, fade, final_state, s);
    case 64: return launch_train<64>(p, B, fade, final_state, s);
    default: return cudaErrorInvalidValue;
  }
}
