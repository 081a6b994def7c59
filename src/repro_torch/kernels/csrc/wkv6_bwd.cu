// RWKV6 WKV recurrence, backward (training), for Hopper, sm_90a, in fp32.
//
// No Pallas kernel stands behind it: the JAX package trains through XLA's
// gradient of chunked_time_scan(wkv_step) (repro/models/ssm.py:30-47,
// :97-103, :129-131). The port's plain version of that gradient is
// wkv6.py:wkv6_bwd (torch operations); this kernel computes what it
// computes. With S_t the state after step t, dS_t its gradient (dS after
// the last step = dstate, zeros when none is given) and, for each (b, h),
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// the gradients are
//
//   dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
//   dr_t = S_{t-1} dy_t + u o k_t (v_t . dy_t)
//   dk_t = dS_t v_t + u o r_t (v_t . dy_t)
//   dv_t = dS_t^T k_t + (r_t . (u o k_t)) dy_t
//   dw_t[i] = sum_j dS_t[i][j] S_{t-1}[i][j]
//   du = sum over b, t of r_t o k_t (v_t . dy_t)
//
// from r, k, v, w, dy (B, S, H, hd), u (H, hd) and the state kept at each
// CH-step chunk's start by the forward (`starts`, B x chunks x H x hd x
// hd). dw is taken in this direct form, exact at any w, 0 included, with
// no division anywhere; where w < FLT_MIN it is set to 0, the plain
// version's convention (it works in clamped log decays; the model's
// exp(-exp(x)) passes neither on to x).
//
// What bounds it: bytes. r, k, v, w, dy read and dr, dk, dv, dw written
// (9 x 84 MB at rwkv6-3b's microbatch, B=2, S=4096, H=40, hd=64) plus the
// kept states (21 MB): 0.2316 ms at the H100 SXM's 3.35 TB/s. Its ~16 hd^2
// fp32 flops a (token, head) are 0.32 ms at 67 TFLOP/s in FFMA: the
// products with the hd x hd states go to the tensor cores.
//
// Three kernels in one C call, on one stream, in the chunk-parallel form,
// a block per (b, h, chunk) in kernels 1 and 3, 4 hd threads; warp w owns
// value columns [8w, 8w + 8) of every hd x hd matrix it keeps in
// registers (a state, its gradient, G), in the mma accumulator layout:
//   1. states: a block walks its chunk forward in L = 16-token sub-chunks
//      by the forward's update, S <- diag(A) S + (K o E)^T V (D_t =
//      prod_{tau<t} w_tau, E_t = prod_{tau>t} w_tau and A = prod_tau w_tau
//      inside the sub-chunk, running products: every factor <= 1), writes
//      S at every KEEP = 32-token pair's start to `ckpt`, and sums the
//      chunk's own part of dS at its start, G_c = sum_t (prod_{tau<t}
//      w_tau) o r_t dy_t^T = sum over sub-chunks of (R o D o Dg)^T dY (Dg
//      the product of w before the sub-chunk), and its fade A_c = prod_t
//      w_t: the carry's inputs. No token-by-token walk.
//   2. carry: a thread per state element walks the chunks backwards,
//      dS_end(c-1) = A_c o dS_end(c) + G_c, from dstate; in place of G.
//   3. grads: a block walks its chunk's pairs of sub-chunks backwards
//      from dS_end(c), dS (hd x hd) in registers. Of a pair, the kept
//      state S0 is loaded, the second sub-chunk's start state S1 rebuilt
//      on chip by one forward update, then each sub-chunk of L tokens is
//      taken from its start state S0 and its end's dS, which need no state
//      per step: with P(s, t) = prod_{s<tau<t} w_tau, Q = dY V^T (L x L),
//      Z = dY S0^T, X = V dS^T (L x hd), q = rowsum(dS o S0),
//        dr_t = D_t Z_t + sum_{s<t} Q[t][s] k_s P(s,t) + u k_t Q[t][t]
//        dk_s = E_s X_s + sum_{t>s} Q[t][s] r_t P(s,t) + u r_s Q[s][s]
//        dV   = (K o E) dS + M^T dY     (M the forward's pairwise matrix)
//        dw_t = D_t E_t q + E_t sum_{s<t} P(s,t) k_s X_s
//               + D_t sum_{t'>t} P(t,t') r_t' Z_t'
//               + sum_{s<t} P(s,t) k_s W_t[s],
//        W_t[s] = sum_{t'>t} P(t,t') r_t' Q[t'][s]
//               = r_{t+1} Q[t+1][s] + w_{t+1} W_{t+1}[s]   (W_{L-1} = 0)
//        dS  <- A o dS + (R o D)^T dY
//      (tests/test_torch_wkv6_bwd.py transcribes this in torch and holds
//      it to fp64 autograd). Every per-row sum is O(L) for a thread of
//      (token, 4 key rows); W is carried by its recurrence, a thread per
//      (key row, range of t), so each key row costs O(L^2).
// du is summed per block in a fixed order and over blocks by the caller:
// no atomics, so two runs give the same bits.
//
// Products on the tensor cores in 3xTF32 (mma.sync m16n8k8, hi/lo split,
// common.cuh), as the forward's: Z, X, Q, dV's two, the dS update and
// kernel 1's two updates. dS, S and G are never an mma accumulator: each
// update goes into fresh accumulators and is added to the decayed matrix
// by FFMA, as the forward adds to its state. Why a pair per kept state:
// kernel 3 at hd 64 holds two blocks an SM in 104 KB of shared memory
// each (two input buffers, one state slot, dS, Z, X, r o D, k o E, Q, M,
// W's sums); keeping the state every 16 steps cost 0.34 GB of traffic at
// rwkv6-3b's microbatch, every 32 costs half, and rebuilding S1 takes one
// update of 16 tokens whose inputs the pair's second buffer holds anyway.
// What the time is spent on: PERF.md, tools/ablate_kernels.py wkv6_bwd.

#include "common.cuh"

namespace {

constexpr int L = 16;        // tokens a sub-chunk
constexpr int KEEP = 2 * L;  // tokens between the states kernel 1 keeps
constexpr int NIN = 5;       // staged inputs: r, k, v, w, dy, in this order
enum { IN_R = 0, IN_K = 1, IN_V = 2, IN_W = 3, IN_DY = 4 };
constexpr float FLT_MIN_ = 1.17549435e-38f;

struct BwdParams {
  const float* in[NIN];       // r, k, v, w, dy: (B, S, H, hd)
  int64_t sb[NIN], ss[NIN], sh[NIN];  // their element strides
  const float* u;             // (H, hd), head stride u_sh
  int64_t u_sh;
  const float* starts;  // (B, NC, H, hd, hd): S at each chunk's start
  const float* dstate;  // (B, H, hd, hd) or null (zeros)
  float* ckpt;          // (B, NKEEP, H, hd, hd): S every KEEP tokens, [i][j]
  float* acc;           // (B, NC, H, hd, hd): G_c, then dS at each chunk's end
  float* fade;          // (B, NC, H, hd): A_c
  float* grad[4];       // dr, dk, dv, dw: (B, S, H, hd) contiguous
  float* du_part;       // (B, NC, H, hd)
  int B, H, S, chunk, NC, NKEEP;
};

template <int HD>
struct Shape {
  static constexpr int NT = 4 * HD;   // threads: a (token, 4 key rows) each
  static constexpr int NW = HD / 8;   // warps: warp w, value columns 8w..
  static constexpr int G4 = HD / 4;   // key-row groups of 4
  static constexpr int LDI = HD + 4;  // staged input rows
  static constexpr int LDS = HD + 4;  // S0 and dS, [i][j]
  static constexpr int LDP = HD + 8;  // Z, X, r o D, [t][i] (k-major A)
  static constexpr int LDK = HD + 4;  // k o E, [s][i] (row-major A)
  static constexpr int LDQ = L + 8;   // Q and M, [t][s]
  static constexpr int IN = NIN * L * LDI;  // one buffer of inputs
  static_assert(G4 <= L && L % G4 == 0, "lane groups");
};

// Start the copies of tokens [t0, t0 + L) of r, k, v, w, dy into `dst`
// (NIN arrays of L rows of LDI). Rows at or past `lim` are zero-filled,
// w's with 1 (a decay of 1 and k = v = 0 leave the state as it is), stored
// by the thread that owns the 16 bytes, so no other write races the fill.
template <int HD>
__device__ __forceinline__ void stage_inputs(const BwdParams& p, float* dst,
                                             int b, int h, int t0, int lim) {
  using C = Shape<HD>;
  constexpr int CPR = HD / 4;
  for (int idx = threadIdx.x; idx < NIN * L * CPR; idx += C::NT) {
    const int a = idx / (L * CPR), rem = idx % (L * CPR);
    const int t = rem / CPR, c = 4 * (rem % CPR);
    float* d = dst + (a * L + t) * C::LDI + c;
    const bool ok = t0 + t < lim;
    if (a == IN_W && !ok) {
      *reinterpret_cast<float4*>(d) = make_float4(1.f, 1.f, 1.f, 1.f);
      continue;
    }
    const float* src = p.in[a];
    cp_async16(d, ok ? src + b * p.sb[a] + (int64_t)(t0 + t) * p.ss[a] +
                           h * p.sh[a] + c
                     : src, ok);
  }
}

// The forward update's operands of a staged sub-chunk for the thread of
// token t and key rows r0..r0+3, from D_t and E_t (running products, w =
// 1 past the end): k o E to sKE [t][i] (ld ldk), r o D (times dg, if
// given) to sRD [t][i] (if given), A to sA (by token L - 1).
template <int HD>
__device__ __forceinline__ void sub_decays(const float* buf, int t, int r0,
                                           const float* dg, float* sRD,
                                           float* sKE, int ldk, float* sA) {
  using C = Shape<HD>;
  const float* sW = buf + IN_W * L * C::LDI;
  float dd[4], ee[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) dd[x] = ee[x] = 1.f;
#pragma unroll
  for (int tau = 0; tau < L; ++tau) {
    float wv[4];
    to4(wv, ld4(sW + tau * C::LDI + r0));
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (tau < t) dd[x] *= wv[x];
      if (tau > t) ee[x] *= wv[x];
    }
  }
  float kt[4], ke[4];
  to4(kt, ld4(buf + (IN_K * L + t) * C::LDI + r0));
#pragma unroll
  for (int x = 0; x < 4; ++x) ke[x] = kt[x] * ee[x];
  st4(sKE + t * ldk + r0, ke);
  if (sRD) {
    float rt[4], rd[4];
    to4(rt, ld4(buf + (IN_R * L + t) * C::LDI + r0));
#pragma unroll
    for (int x = 0; x < 4; ++x)
      rd[x] = dg ? rt[x] * dd[x] * dg[r0 + x] : rt[x] * dd[x];
    st4(sRD + t * C::LDP + r0, rd);
  }
  if (t == L - 1) {
    float wt[4], a4[4];
    to4(wt, ld4(sW + t * C::LDI + r0));
#pragma unroll
    for (int x = 0; x < 4; ++x) a4[x] = dd[x] * wt[x];
    st4(sA + r0, a4);
  }
}

// ---------------------------------------------------------------- 1. states
template <int HD>
__global__ void __launch_bounds__(Shape<HD>::NT, 2) wkv6_bwd_states_kernel(
    const BwdParams p) {
  using C = Shape<HD>;
  constexpr int NT = C::NT;
  extern __shared__ __align__(16) float smem[];
  float* sRD = smem + 2 * C::IN;        // r o D o Dg [t][i], ld LDP
  float* sKE = sRD + L * C::LDP;        // k o E [t][i], ld LDP
  float* sA = sKE + L * C::LDP;         // A [i]
  float* sDg = sA + HD;                 // prod of w before the sub-chunk [i]
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, c = blockIdx.y;
  const int tid = threadIdx.x, w = tid / 32, g = tid % 32 / 4, tq = tid % 4;
  const int t = tid / C::G4, r0 = 4 * (tid % C::G4);
  const int c0 = c * p.chunk, c1 = min(p.S, c0 + p.chunk);
  const int64_t head = (int64_t)HD * HD;

  Mat<HD> s, gc;
  mat_load<HD>(s, p.starts + ((int64_t)(b * p.NC + c) * p.H + h) * head, HD,
               w, g, tq);
#pragma unroll
  for (int e = 0; e < HD / 16; ++e)
    gc[e][0] = gc[e][1] = gc[e][2] = gc[e][3] = 0.f;
  for (int i = tid; i < HD; i += NT) sDg[i] = 1.f;

  const int subs = (c1 - c0 + L - 1) / L;
  stage_inputs<HD>(p, smem, b, h, c0, c1);
  cp_async_commit();
  for (int q = 0; q < subs; ++q) {
    const int t0 = c0 + q * L;
    const float* buf = smem + (q & 1) * C::IN;
    if (q + 1 < subs)
      stage_inputs<HD>(p, smem + ((q + 1) & 1) * C::IN, b, h, t0 + L,
                           c1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this sub-chunk landed; Dg of the last one is set
    if (t0 % KEEP == 0)
      mat_store<HD>(p.ckpt + ((int64_t)(b * p.NKEEP + t0 / KEEP) * p.H + h) *
                                 head, HD, s, w, g, tq);
    sub_decays<HD>(buf, t, r0, sDg, sRD, sKE, C::LDP, sA);
    __syncthreads();
    FragB bf[2];
    b_frags(bf, buf + IN_DY * L * C::LDI, C::LDI, w, g, tq);
    mat_update<HD>(gc, sRD, C::LDP, bf, nullptr, g, tq);
    b_frags(bf, buf + IN_V * L * C::LDI, C::LDI, w, g, tq);
    mat_update<HD>(s, sKE, C::LDP, bf, sA, g, tq);
    __syncthreads();  // every read of this sub-chunk's buffers is done
    for (int i = tid; i < HD; i += NT) sDg[i] *= sA[i];
  }
  __syncthreads();
  const int64_t at = ((int64_t)(b * p.NC + c) * p.H + h);
  mat_store<HD>(p.acc + at * head, HD, gc, w, g, tq);
  for (int i = tid; i < HD; i += NT) p.fade[at * HD + i] = sDg[i];
}

// ----------------------------------------------------------------- 2. carry
__global__ void __launch_bounds__(256) wkv6_bwd_carry_kernel(
    const BwdParams p, int hd) {
  const int64_t per = (int64_t)p.H * hd * hd;  // (h, i, j)
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * per) return;
  const int64_t b = idx / per, rem = idx % per, hi = rem / hd;
  float carry = p.dstate ? p.dstate[idx] : 0.f;
  for (int c = p.NC - 1; c >= 0; --c) {
    float* a = p.acc + (b * p.NC + c) * per + rem;
    const float g = *a;
    *a = carry;
    carry = fmaf(p.fade[(b * p.NC + c) * p.H * hd + hi], carry, g);
  }
}

// ----------------------------------------------------------------- 3. grads
template <int HD>
struct GradShape : Shape<HD> {
  using C = Shape<HD>;
  // shared memory in floats: two input buffers; the state slot S0 [i][j];
  // dS [i][j]; Z, X [t][i]; r o D [t][i] (also k o E of the rebuild); k o
  // E [s][i]; Q, M [t][s]; W's sums [t][i]; q's partials a warp; A [i]
  static constexpr int OFF_SLOT = 2 * C::IN;
  static constexpr int OFF_DS = OFF_SLOT + HD * C::LDS;
  static constexpr int OFF_Z = OFF_DS + HD * C::LDS;
  static constexpr int OFF_X = OFF_Z + L * C::LDP;
  static constexpr int OFF_RD = OFF_X + L * C::LDP;
  static constexpr int OFF_KE = OFF_RD + L * C::LDP;
  static constexpr int OFF_Q = OFF_KE + L * C::LDK;
  static constexpr int OFF_M = OFF_Q + L * C::LDQ;
  static constexpr int OFF_T4 = OFF_M + L * C::LDQ;
  static constexpr int OFF_QP = OFF_T4 + L * HD;
  static constexpr int OFF_A = OFF_QP + C::NW * HD;
  static constexpr int FLOATS = OFF_A + HD;
  static_assert(OFF_Z % 4 == 0 && OFF_KE % 4 == 0 && OFF_T4 % 4 == 0 &&
                OFF_QP % 4 == 0 && OFF_A % 4 == 0, "float4 alignment");
};

// The last term of dw for key row i and tokens t in [LO, HI): W_t carried
// down from W_{L-1} = 0 by its recurrence (only s < HI kept), then
// T4_t = sum_{s<t} P(s,t) k_s W_t[s] by a running product down from s =
// t - 1, into sT4 [t][i]: O(L^2) for the row, split four ways.
template <int HD, int LO, int HI>
__device__ __forceinline__ void t4_walk(const float* buf, const float* sQ,
                                        float* sT4, int i) {
  using C = Shape<HD>;
  const float* sR = buf + IN_R * L * C::LDI + i;
  const float* sK = buf + IN_K * L * C::LDI + i;
  const float* sW = buf + IN_W * L * C::LDI + i;
  float W[HI], ks[HI], ws[HI];
#pragma unroll
  for (int s = 0; s < HI; ++s) {
    W[s] = 0.f;
    ks[s] = sK[s * C::LDI];
    ws[s] = sW[s * C::LDI];
  }
  if (HI == L) sT4[(L - 1) * HD + i] = 0.f;
#pragma unroll
  for (int t = L - 2; t >= LO; --t) {
    const float rn = sR[(t + 1) * C::LDI], wn = sW[(t + 1) * C::LDI];
    const float* qrow = sQ + (t + 1) * C::LDQ;
#pragma unroll
    for (int s = 0; s < HI; ++s)
      if (s < t) W[s] = fmaf(wn, W[s], rn * qrow[s]);
    if (t < HI) {
      float a = 0.f, pp = 1.f;
#pragma unroll
      for (int s = HI - 1; s >= 0; --s) {
        if (s < t) {
          a = fmaf(pp * ks[s], W[s], a);
          pp *= ws[s];
        }
      }
      sT4[t * HD + i] = a;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Shape<HD>::NT, 2)
    wkv6_bwd_grads_kernel(const BwdParams p) {
  using C = GradShape<HD>;
  constexpr int NT = C::NT, G4 = C::G4, LDI = C::LDI, LDS = C::LDS;
  constexpr int LDP = C::LDP, LDK = C::LDK, LDQ = C::LDQ, NW = C::NW;
  extern __shared__ __align__(16) float smem[];
  float* sSlot = smem + C::OFF_SLOT;
  float* sDS = smem + C::OFF_DS;
  float* sZ = smem + C::OFF_Z;
  float* sX = smem + C::OFF_X;
  float* sRD = smem + C::OFF_RD;
  float* sKE = smem + C::OFF_KE;
  float* sQ = smem + C::OFF_Q;
  float* sM = smem + C::OFF_M;
  float* sT4 = smem + C::OFF_T4;
  float* sQP = smem + C::OFF_QP;
  float* sA = smem + C::OFF_A;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const int c0 = c * p.chunk, c1 = min(p.S, c0 + p.chunk);
  const int64_t head = (int64_t)HD * HD;
  // row role: token t, key rows [r0, +4)
  const int t = tid / G4, r0 = 4 * (tid % G4);
  const unsigned group = ((1u << G4) - 1u) << (lane / G4 * G4);
  // W's role: key row wi, tokens of part tid / HD
  const int wi = tid % HD, part = tid / HD;

  Mat<HD> ds;
  mat_load<HD>(ds, p.acc + ((int64_t)(b * p.NC + c) * p.H + h) * head, HD,
               w, g, tq);
  mat_store<HD>(sDS, LDS, ds, w, g, tq);
  float u[4], du[4] = {0.f, 0.f, 0.f, 0.f};
  to4(u, ld4(p.u + h * p.u_sh + r0));

  const int subs = (c1 - c0 + L - 1) / L, pairs = (subs + 1) / 2;
  auto stage_slot = [&](int pair) {
    const float* ck = p.ckpt + ((int64_t)(b * p.NKEEP + (c0 + pair * KEEP) /
                                          KEEP) * p.H + h) * head;
    for (int idx = tid; idx < HD * HD / 4; idx += NT) {
      const int i = idx / (HD / 4), j = 4 * (idx % (HD / 4));
      cp_async16(sSlot + i * LDS + j, ck + i * HD + j);
    }
  };
  auto stage_sub = [&](int q) {
    stage_inputs<HD>(p, smem + (q & 1) * C::IN, b, h, c0 + q * L, c1);
  };

  // One sub-chunk q of the buffer q & 1 from S0 in the slot and dS (the
  // registers and sDS) at its end. `after_reads` runs once the slot is
  // read (phase 1 done), `after` once the sub-chunk's buffers are.
  auto sub_chunk = [&](int q, auto after_reads, auto after) {
    const float* buf = smem + (q & 1) * C::IN;
    const float* sR = buf + IN_R * L * LDI;
    const float* sK = buf + IN_K * L * LDI;
    const float* sV = buf + IN_V * L * LDI;
    const float* sW = buf + IN_W * L * LDI;
    const float* sDY = buf + IN_DY * L * LDI;
    const int t0 = c0 + q * L, n = min(L, c1 - t0);

    // ---- phase 1: Z, X (warp w: key rows 8w..), Q (warps 0, 1: tokens
    // s in 8w..), q's partials over the warp's value columns
    {
      // two sums a product, even and odd k-steps: shorter mma chains
      float z2[2][4] = {}, x2[2][4] = {}, q2[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const FragA ady = lda_rm(sDY + 8 * kk, LDI, g, tq);
        const FragA av = lda_rm(sV + 8 * kk, LDI, g, tq);
        mma3(z2[kk & 1], ady,
             ldb_nm(sSlot + 8 * w * LDS + 8 * kk, LDS, g, tq));
        mma3(x2[kk & 1], av, ldb_nm(sDS + 8 * w * LDS + 8 * kk, LDS, g, tq));
        if (w < 2)
          mma3(q2[kk & 1], ady,
               ldb_nm(sV + 8 * w * LDI + 8 * kk, LDI, g, tq));
      }
      float z[4], x[4], qq[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[e] = z2[0][e] + z2[1][e];
        x[e] = x2[0][e] + x2[1][e];
        qq[e] = q2[0][e] + q2[1][e];
      }
      const int o = g * LDP + 8 * w + 2 * tq, o8 = o + 8 * LDP;
      *reinterpret_cast<float2*>(sZ + o) = make_float2(z[0], z[1]);
      *reinterpret_cast<float2*>(sZ + o8) = make_float2(z[2], z[3]);
      *reinterpret_cast<float2*>(sX + o) = make_float2(x[0], x[1]);
      *reinterpret_cast<float2*>(sX + o8) = make_float2(x[2], x[3]);
      if (w < 2) {
        const int oq = g * LDQ + 8 * w + 2 * tq;
        *reinterpret_cast<float2*>(sQ + oq) = make_float2(qq[0], qq[1]);
        *reinterpret_cast<float2*>(sQ + oq + 8 * LDQ) =
            make_float2(qq[2], qq[3]);
      }
#pragma unroll
      for (int e = 0; e < HD / 16; ++e) {
        const float2 a = *reinterpret_cast<const float2*>(
            sSlot + (16 * e + g) * LDS + 8 * w + 2 * tq);
        const float2 b2 = *reinterpret_cast<const float2*>(
            sSlot + (16 * e + g + 8) * LDS + 8 * w + 2 * tq);
        float q0 = fmaf(ds[e][1], a.y, ds[e][0] * a.x);
        float q1 = fmaf(ds[e][3], b2.y, ds[e][2] * b2.x);
        q0 += __shfl_xor_sync(0xffffffffu, q0, 1);
        q1 += __shfl_xor_sync(0xffffffffu, q1, 1);
        q0 += __shfl_xor_sync(0xffffffffu, q0, 2);
        q1 += __shfl_xor_sync(0xffffffffu, q1, 2);
        if (tq == 0) {
          sQP[w * HD + 16 * e + g] = q0;
          sQP[w * HD + 16 * e + g + 8] = q1;
        }
      }
    }
    __syncthreads();
    after_reads();

    // ---- phase 2, per (token t, key rows r0..r0+3): dr, dk, M's column,
    // the sums of dw but W's, and D and E, which the walks' running
    // products end at; per (key row, part of t): W's sum
    float dd[4], ee[4];
    float rt[4], kt[4], wt[4], qv[4], z[4], xx[4];
    to4(rt, ld4(sR + t * LDI + r0));
    to4(kt, ld4(sK + t * LDI + r0));
    to4(wt, ld4(sW + t * LDI + r0));
    to4(z, ld4(sZ + t * LDP + r0));
    to4(xx, ld4(sX + t * LDP + r0));
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float a = sQP[r0 + x];
#pragma unroll
      for (int v = 1; v < NW; ++v) a += sQP[v * HD + r0 + x];
      qv[x] = a;
    }
    const float qtt = sQ[t * LDQ + t];
    float dr[4], dk[4], t2[4] = {0.f, 0.f, 0.f, 0.f};
    float t3[4] = {0.f, 0.f, 0.f, 0.f};
    float m[L];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      dr[x] = u[x] * kt[x] * qtt;
      dk[x] = u[x] * rt[x] * qtt;
      du[x] = fmaf(rt[x] * kt[x], qtt, du[x]);
    }
    // up: t' > t, p = P(t, t'), at the end E_t
    {
      float* pp = ee;
#pragma unroll
      for (int x = 0; x < 4; ++x) pp[x] = 1.f;
#pragma unroll
      for (int tp = 0; tp < L; ++tp) {
        if (tp > t) {
          float rp[4], zp[4], wp[4];
          to4(rp, ld4(sR + tp * LDI + r0));
          to4(zp, ld4(sZ + tp * LDP + r0));
          to4(wp, ld4(sW + tp * LDI + r0));
          const float qpt = sQ[tp * LDQ + t];
          float a = 0.f;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const float rpp = rp[x] * pp[x];
            dk[x] = fmaf(qpt, rpp, dk[x]);
            t3[x] = fmaf(rpp, zp[x], t3[x]);
            a = fmaf(rpp, kt[x], a);
            pp[x] *= wp[x];
          }
          m[tp] = a;
        } else if (tp == t) {
          float a = 0.f;
#pragma unroll
          for (int x = 0; x < 4; ++x) a = fmaf(rt[x], u[x] * kt[x], a);
          m[tp] = a;
        } else {
          m[tp] = 0.f;
        }
      }
    }
    // M[t'][t] summed over the G4 lanes of this token's key rows
    reduce_scatter<L, G4>(m, tid % G4, group);
#pragma unroll
    for (int e = 0; e < L / G4; ++e)
      sM[((tid % G4) * (L / G4) + e) * LDQ + t] = m[e];
    // down: s < t, p = P(s, t), at the end D_t
    {
      float* pp = dd;
#pragma unroll
      for (int x = 0; x < 4; ++x) pp[x] = 1.f;
      for (int s = t - 1; s >= 0; --s) {
        float ks[4], ws[4], xs[4];
        to4(ks, ld4(sK + s * LDI + r0));
        to4(ws, ld4(sW + s * LDI + r0));
        to4(xs, ld4(sX + s * LDP + r0));
        const float qts = sQ[t * LDQ + s];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float kp = ks[x] * pp[x];
          dr[x] = fmaf(qts, kp, dr[x]);
          t2[x] = fmaf(kp, xs[x], t2[x]);
          pp[x] *= ws[x];
        }
      }
    }
    {
      float rd[4], ke[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        dr[x] = fmaf(dd[x], z[x], dr[x]);
        dk[x] = fmaf(ee[x], xx[x], dk[x]);
        rd[x] = rt[x] * dd[x];
        ke[x] = kt[x] * ee[x];
      }
      st4(sRD + t * LDP + r0, rd);
      st4(sKE + t * LDK + r0, ke);
      if (t == L - 1) {
        float a4[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) a4[x] = dd[x] * wt[x];
        st4(sA + r0, a4);
      }
    }
    if (t < n) {
      const int64_t o = ((int64_t)(b * p.S + t0 + t) * p.H + h) * HD + r0;
      st4(p.grad[0] + o, dr);
      st4(p.grad[1] + o, dk);
    }
    // W's sums, the tokens split four ways by the cost of their walks
    switch (part) {
      case 0: t4_walk<HD, 0, 7>(buf, sQ, sT4, wi); break;
      case 1: t4_walk<HD, 7, 10>(buf, sQ, sT4, wi); break;
      case 2: t4_walk<HD, 10, 13>(buf, sQ, sT4, wi); break;
      default: t4_walk<HD, 13, L>(buf, sQ, sT4, wi); break;
    }
    __syncthreads();

    // ---- phase 3: dw; dv = (K o E) dS + M^T dY (warp w: value columns
    // 8w..); dS <- A o dS + (R o D)^T dY in registers
    {
      float t4[4], dw[4];
      to4(t4, ld4(sT4 + t * HD + r0));
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float de = dd[x] * ee[x];
        dw[x] = fmaf(de, qv[x], fmaf(ee[x], t2[x], fmaf(dd[x], t3[x],
                                                        t4[x])));
        if (wt[x] < FLT_MIN_) dw[x] = 0.f;  // as the plain version
      }
      if (t < n)
        st4(p.grad[3] + ((int64_t)(b * p.S + t0 + t) * p.H + h) * HD + r0,
            dw);
    }
    FragB bdy[2];
    b_frags(bdy, sDY, LDI, w, g, tq);
    {
      float d2[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk)
        mma3(d2[kk & 1], lda_rm(sKE + 8 * kk, LDK, g, tq),
             ldb_km(sDS + 8 * kk * LDS + 8 * w, LDS, g, tq));
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma3(d2[kk], lda_km(sM + 8 * kk * LDQ, LDQ, g, tq), bdy[kk]);
      float dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[e] = d2[0][e] + d2[1][e];
      float* gv = p.grad[2] + ((int64_t)(b * p.S + t0) * p.H + h) * HD +
                  8 * w + 2 * tq;
      const int64_t row = (int64_t)p.H * HD;
      if (g < n)
        *reinterpret_cast<float2*>(gv + g * row) = make_float2(dv[0], dv[1]);
      if (g + 8 < n)
        *reinterpret_cast<float2*>(gv + (g + 8) * row) =
            make_float2(dv[2], dv[3]);
    }
    mat_update<HD>(ds, sRD, LDP, bdy, sA, g, tq);
    __syncthreads();  // every read of this sub-chunk's buffers and dS done
    mat_store<HD>(sDS, LDS, ds, w, g, tq);
    after();
  };

  const auto nothing = [] {};
  {
    const int q0 = 2 * (pairs - 1);
    stage_sub(q0);
    if (q0 + 1 < subs) stage_sub(q0 + 1);
    stage_slot(pairs - 1);
    cp_async_commit();
  }
  for (int pr = pairs - 1; pr >= 0; --pr) {
    const int q0 = 2 * pr;
    cp_async_wait<0>();
    __syncthreads();  // the pair's inputs and kept state landed
    if (q0 + 1 < subs) {
      // S1 = A o S0 + (K o E)^T V of the first sub-chunk, into the slot
      // (a warp reads and writes only its own columns)
      sub_decays<HD>(smem, t, r0, nullptr, nullptr, sRD, LDP, sA);
      __syncthreads();
      Mat<HD> s1;
      mat_load<HD>(s1, sSlot, LDS, w, g, tq);
      FragB bv[2];
      b_frags(bv, smem + IN_V * L * LDI, LDI, w, g, tq);
      mat_update<HD>(s1, sRD, LDP, bv, sA, g, tq);
      mat_store<HD>(sSlot, LDS, s1, w, g, tq);
      __syncthreads();
      // the second sub-chunk; then S0 again into the slot (from L2)
      sub_chunk(q0 + 1, [&] {
        stage_slot(pr);
        cp_async_commit();
      }, nothing);
      cp_async_wait<0>();
      __syncthreads();
    }
    // the first: the next pair's second buffer fills under it, then its
    // kept state once the slot is read, then its first buffer
    if (pr > 0) {
      stage_sub(q0 - 1);
      cp_async_commit();
    }
    sub_chunk(q0, [&] {
      if (pr > 0) {
        stage_slot(pr - 1);
        cp_async_commit();
      }
    }, [&] {
      if (pr > 0) {
        stage_sub(q0 - 2);
        cp_async_commit();
      }
    });
  }

  // du: this block's sum over its tokens, in a fixed order
  st4(sZ + t * LDP + r0, du);
  __syncthreads();
  if (tid < HD) {
    float a = 0.f;
    for (int tt = 0; tt < L; ++tt) a += sZ[tt * LDP + tid];
    p.du_part[((int64_t)(b * p.NC + c) * p.H + h) * HD + tid] = a;
  }
}

template <int HD>
int launch(const BwdParams& p, cudaStream_t stream) {
  using C = GradShape<HD>;
  constexpr int states_bytes = (2 * C::IN + 2 * L * C::LDP + 2 * HD) * 4;
  constexpr int grads_bytes = C::FLOATS * 4;
  static const int attr = [] {
    const int e = cudaFuncSetAttribute(
        wkv6_bwd_states_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, states_bytes);
    return e ? e
             : cudaFuncSetAttribute(
                   wkv6_bwd_grads_kernel<HD>,
                   cudaFuncAttributeMaxDynamicSharedMemorySize, grads_bytes);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.B * p.H, p.NC);
  wkv6_bwd_states_kernel<HD><<<grid, C::NT, states_bytes, stream>>>(p);
  int err = cudaGetLastError();
  if (err) return err;
  const int64_t cells = (int64_t)p.B * p.H * HD * HD;
  wkv6_bwd_carry_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(
      p, HD);
  err = cudaGetLastError();
  if (err) return err;
  wkv6_bwd_grads_kernel<HD><<<grid, C::NT, grads_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy: (B, S, H, hd) fp32, each given by its data pointer and
// element strides (batch, step, head) in strides[3 a .. 3 a + 2] in that
// order; u (H, hd) with head stride strides[15]; starts (B, NC, H, hd, hd)
// and dstate (B, H, hd, hd, or null) contiguous; chunk the steps between
// kept states (a multiple of wkv6_bwd_sub_chunk()). Scratch: ckpt (B,
// ceil(S / wkv6_bwd_sub_chunk()), H, hd, hd), acc (B, NC, H, hd, hd), fade
// (B, NC, H, hd). Writes dr, dk, dv, dw (B, S, H, hd) contiguous and
// du_part (B, NC, H, hd), du summed per (batch row, chunk). Head dims and
// rows as the forward's (hd 16, 32, 64; head dim contiguous, rows 16-byte
// aligned). Three launches; returns the first CUDA error.
extern "C" int wkv6_bwd_launch(const float* r, const float* k,
                               const float* v, const float* w,
                               const float* dy, const float* u,
                               const int64_t* strides, const float* starts,
                               const float* dstate, float* ckpt, float* acc,
                               float* fade, float* dr, float* dk, float* dv,
                               float* dw, float* du_part, int B, int H, int S,
                               int hd, int chunk, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || chunk <= 0 || chunk % KEEP)
    return cudaErrorInvalidValue;
  BwdParams p;
  const float* in[NIN] = {r, k, v, w, dy};
  for (int a = 0; a < NIN; ++a) {
    p.in[a] = in[a];
    p.sb[a] = strides[3 * a];
    p.ss[a] = strides[3 * a + 1];
    p.sh[a] = strides[3 * a + 2];
  }
  p.u = u; p.u_sh = strides[15];
  p.starts = starts; p.dstate = dstate;
  p.ckpt = ckpt; p.acc = acc; p.fade = fade;
  p.grad[0] = dr; p.grad[1] = dk; p.grad[2] = dv; p.grad[3] = dw;
  p.du_part = du_part;
  p.B = B; p.H = H; p.S = S; p.chunk = chunk;
  p.NC = (S + chunk - 1) / chunk;
  p.NKEEP = (S + KEEP - 1) / KEEP;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// the tokens between the states kept inside the backward
extern "C" int wkv6_bwd_sub_chunk() { return KEEP; }
