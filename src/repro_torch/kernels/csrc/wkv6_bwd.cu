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
// hd). dw is taken in this direct form, exact at any w, 0 included; where
// w < FLT_MIN it is set to 0, the plain version's convention (it works in
// clamped log decays; the model's exp(-exp(x)) passes neither on to x).
//
// What bounds it: bytes. r, k, v, w, dy read and dr, dk, dv, dw written
// (9 x 84 MB at rwkv6-3b's microbatch, B=2, S=4096, H=40, hd=64) plus the
// kept states (21 MB): 0.2316 ms at the H100 SXM's 3.35 TB/s. Its ~16 hd^2
// fp32 flops a (token, head) are 0.32 ms at 67 TFLOP/s in FFMA, so the
// work has to be cut, not only streamed: the state's chain of dependent
// steps is the problem, as in the forward.
//
// Three kernels in one C call, on one stream, in the chunk-parallel form:
//   1. states: a block per (b, h, chunk) walks the chunk forward token by
//      token from its kept start (4 hd threads, each a key row i and hd/4
//      value columns of S in registers) and writes S at every L-token
//      sub-chunk's start to `ckpt` (transposed, [j][i]), and the chunk's
//      own part of dS at its start, G_c = sum_t (prod_{tau<t} w_tau) o
//      r_t dy_t^T, and its fade A_c = prod_t w_t: the carry's inputs.
//   2. carry: a thread per state element walks the chunks backwards,
//      dS_end(c-1) = A_c o dS_end(c) + G_c, from dstate; in place of G.
//   3. grads: a block per (b, h, chunk) walks its sub-chunks backwards
//      from dS_end(c), carrying dS (hd x hd) in registers. A sub-chunk of
//      L tokens from its kept start S0 and its end's dS needs no state per
//      step: with D_t = prod_{tau<t} w_tau, E_t = prod_{tau>t} w_tau and
//      P(s, t) = prod_{s<tau<t} w_tau (running products inside the
//      sub-chunk: every factor <= 1, no division, a decay of 0 cuts as the
//      recurrence does), Q = dY V^T (L x L), Z = dY S0^T, X = V dS^T (L x
//      hd) and q = rowsum(dS o S0),
//        dr_t = D_t Z_t + sum_{s<t} Q[t][s] k_s P(s,t) + u k_t Q[t][t]
//        dk_s = E_s X_s + sum_{t>s} Q[t][s] r_t P(s,t) + u r_s Q[s][s]
//        dV   = (K o E) dS + M^T dY     (M the forward's pairwise matrix)
//        dw_t = D_t E_t q + E_t sum_{s<t} P(s,t) k_s X_s
//               + D_t sum_{t'>t} P(t,t') r_t' Z_t'
//               + sum_{s<t<t'} P(s,t) P(t,t') k_s r_t' Q[t'][s]
//        dS  <- A o dS + (R o D)^T dY
//      (tests/test_torch_wkv6_bwd.py transcribes this in torch and holds
//      it to fp64 autograd). The products with the hd x hd states are
//      three L x hd x hd a sub-chunk; the per-row sums are O(L^2) per key
//      row, walked by a thread per (token, 4 key rows).
// du is summed per block in a fixed order and over blocks by the caller:
// no atomics, so two runs give the same bits.
//
// Products in fp32 FFMA (no tensor cores): chain and sums in full fp32, as
// the plain version. L = 16 tokens (a checkpoint of S every 16 steps).
// Kernel 3's block is 4 hd threads with 90 KB of shared memory at hd 64
// (inputs, S0^T, dS and dS^T, Z, X, r o D, k o E, Q, M): two blocks an SM
// at 128 registers a thread, which spills ~150 bytes; one block an SM
// without the cap, and double-buffered inputs, both timed slower
// (tools/ablate_kernels.py wkv6_bwd). At rwkv6-3b's microbatch the three
// kernels take ~2.1 ms, kernel 3 ~1.5 of it, ~0.5 in its per-row walks and
// ~0.6 in its products with the states (PERF.md).

#include "common.cuh"

namespace {

constexpr int L = 16;  // tokens a sub-chunk
constexpr int NIN = 5;  // staged inputs: r, k, v, w, dy, in this order
enum { IN_R = 0, IN_K = 1, IN_V = 2, IN_W = 3, IN_DY = 4 };

struct BwdParams {
  const float* in[NIN];       // r, k, v, w, dy: (B, S, H, hd)
  int64_t sb[NIN], ss[NIN], sh[NIN];  // their element strides
  const float* u;             // (H, hd), head stride u_sh
  int64_t u_sh;
  const float* starts;  // (B, NC, H, hd, hd): S at each chunk's start
  const float* dstate;  // (B, H, hd, hd) or null (zeros)
  float* ckpt;          // (B, NSUB, H, hd, hd): S at each sub-chunk's start, [j][i]
  float* acc;           // (B, NC, H, hd, hd): G_c, then dS at each chunk's end
  float* fade;          // (B, NC, H, hd): A_c
  float* grad[4];       // dr, dk, dv, dw: (B, S, H, hd) contiguous
  float* du_part;       // (B, NC, H, hd)
  int B, H, S, chunk, NC, NSUB;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void to4(float* x, float4 f) {
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

// Start the copies of tokens [t0, t0 + L) of r, k, v, w, dy into `dst`
// (NIN arrays of L x HD). Rows at or past `lim` are zero-filled, w's with
// 1 (a decay of 1 and k = v = 0 leave the state as it is), stored by the
// thread that owns the 16 bytes, so no other write races the fill.
template <int HD, int NT>
__device__ __forceinline__ void stage_inputs(const BwdParams& p, float* dst,
                                             int b, int h, int t0, int lim) {
  constexpr int CPR = HD / 4;
  for (int idx = threadIdx.x; idx < NIN * L * CPR; idx += NT) {
    const int a = idx / (L * CPR), rem = idx % (L * CPR);
    const int t = rem / CPR, c = 4 * (rem % CPR);
    float* d = dst + (a * L + t) * HD + c;
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

// ---------------------------------------------------------------- 1. states
// a thread: key row i = tid % HD, value columns [CJ jq, +CJ), jq = tid / HD
template <int HD>
__global__ void __launch_bounds__(4 * HD) wkv6_bwd_states_kernel(
    const BwdParams p) {
  constexpr int NT = 4 * HD, CJ = HD / 4;
  __shared__ __align__(16) float sm[2][NIN * L * HD];
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, c = blockIdx.y;
  const int i = threadIdx.x % HD, j0 = CJ * (threadIdx.x / HD);
  const int c0 = c * p.chunk, c1 = min(p.S, c0 + p.chunk);
  const int64_t head = (int64_t)HD * HD;

  float s[CJ], g[CJ];
  const float* st = p.starts + ((int64_t)(b * p.NC + c) * p.H + h) * head +
                    i * HD + j0;
#pragma unroll
  for (int e = 0; e < CJ; e += 4) {
    to4(s + e, ld4(st + e));
    g[e] = g[e + 1] = g[e + 2] = g[e + 3] = 0.f;
  }
  float d = 1.f;  // prod of w over the chunk's steps so far, row i

  const int pieces = (c1 - c0 + L - 1) / L;
  stage_inputs<HD, NT>(p, sm[0], b, h, c0, c1);
  cp_async_commit();
  for (int q = 0; q < pieces; ++q) {
    const int t0 = c0 + q * L, n = min(L, c1 - t0);
    if (q + 1 < pieces) stage_inputs<HD, NT>(p, sm[(q + 1) & 1], b, h,
                                             t0 + L, c1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* ck = p.ckpt + ((int64_t)(b * p.NSUB + t0 / L) * p.H + h) * head +
                i;
#pragma unroll
    for (int e = 0; e < CJ; ++e) ck[(j0 + e) * HD] = s[e];
    const float* cur = sm[q & 1];
    for (int t = 0; t < n; ++t) {
      const float rt = cur[(IN_R * L + t) * HD + i];
      const float kt = cur[(IN_K * L + t) * HD + i];
      const float wt = cur[(IN_W * L + t) * HD + i];
      const float* vv = cur + (IN_V * L + t) * HD + j0;
      const float* dd = cur + (IN_DY * L + t) * HD + j0;
      const float dr = d * rt;
#pragma unroll
      for (int e = 0; e < CJ; e += 4) {
        float v4[4], d4[4];
        to4(v4, ld4(vv + e));
        to4(d4, ld4(dd + e));
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          g[e + x] = fmaf(dr, d4[x], g[e + x]);
          s[e + x] = fmaf(wt, s[e + x], kt * v4[x]);
        }
      }
      d *= wt;
    }
    __syncthreads();  // before the buffer is refilled
  }
  float* gc = p.acc + ((int64_t)(b * p.NC + c) * p.H + h) * head + i * HD +
              j0;
#pragma unroll
  for (int e = 0; e < CJ; e += 4) st4(gc + e, g + e);
  if (j0 == 0) p.fade[((int64_t)(b * p.NC + c) * p.H + h) * HD + i] = d;
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
struct GradShape {
  static constexpr int NT = 4 * HD;  // = L x HD / 4: a thread per (token,
                                     // 4 key rows), or per (key row, HD/4
                                     // value columns) of dS
  static constexpr int CJ = HD / 4;
  static constexpr int G4 = HD / 4;   // row groups of 4
  static constexpr int LDS = HD + 4;  // dS rows: float4 stores 4-way at most
  static constexpr int LDQ = L + 1;
  // shared memory in floats
  static constexpr int OFF_S0T = NIN * L * HD;  // S0 transposed, [j][i]
  static constexpr int OFF_DS = OFF_S0T + HD * HD;    // dS [i][j]
  static constexpr int OFF_DST = OFF_DS + HD * LDS;   // dS^T [j][i]
  static constexpr int OFF_Z = OFF_DST + HD * HD;     // Z [t][i]
  static constexpr int OFF_X = OFF_Z + L * HD;        // X [t][i]
  static constexpr int OFF_RD = OFF_X + L * HD;       // r o D [t][i]
  static constexpr int OFF_KE = OFF_RD + L * HD;      // k o E [t][i]
  static constexpr int OFF_Q = OFF_KE + L * HD;       // Q [t][s]
  static constexpr int OFF_M = OFF_Q + L * LDQ;       // M [t][s]
  static constexpr int OFF_QP = OFF_M + L * LDQ;  // q's 4 partials
  static constexpr int OFF_A = OFF_QP + 4 * HD;       // A [i]
  static constexpr int FLOATS = OFF_A + HD;
  static_assert(OFF_QP % 4 == 0 && OFF_M % 4 == 0, "float4 alignment");
  static_assert(G4 <= 16 && L % G4 == 0, "lane groups");
};

template <int HD>
__global__ void __launch_bounds__(GradShape<HD>::NT, 2)
    wkv6_bwd_grads_kernel(const BwdParams p) {
  using C = GradShape<HD>;
  constexpr int NT = C::NT, CJ = C::CJ, G4 = C::G4, LDS = C::LDS;
  constexpr int LDQ = C::LDQ;
  extern __shared__ __align__(16) float smem[];
  const float* sR = smem + IN_R * L * HD;
  const float* sK = smem + IN_K * L * HD;
  const float* sW = smem + IN_W * L * HD;
  const float* sV = smem + IN_V * L * HD;
  const float* sDY = smem + IN_DY * L * HD;
  float* sS0T = smem + C::OFF_S0T;
  float* sDS = smem + C::OFF_DS;
  float* sDST = smem + C::OFF_DST;
  float* sZ = smem + C::OFF_Z;
  float* sX = smem + C::OFF_X;
  float* sRD = smem + C::OFF_RD;
  float* sKE = smem + C::OFF_KE;
  float* sQ = smem + C::OFF_Q;
  float* sM = smem + C::OFF_M;
  float* sQP = smem + C::OFF_QP;
  float* sA = smem + C::OFF_A;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H, c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32;
  const int c0 = c * p.chunk, c1 = min(p.S, c0 + p.chunk);
  const int64_t head = (int64_t)HD * HD;
  // dS role: key row si, value columns [sj0, +CJ)
  const int si = tid % HD, sjq = tid / HD, sj0 = CJ * sjq;
  // row role: token t, key rows [4 g, +4)
  const int t = tid / G4, g = tid % G4, r0 = 4 * g;
  const unsigned group = ((1u << G4) - 1u) << (lane / G4 * G4);

  float ds[CJ];
  {
    const float* a = p.acc + ((int64_t)(b * p.NC + c) * p.H + h) * head +
                     si * HD + sj0;
#pragma unroll
    for (int e = 0; e < CJ; e += 4) to4(ds + e, ld4(a + e));
  }
  auto store_ds = [&]() {
#pragma unroll
    for (int e = 0; e < CJ; e += 4) st4(sDS + si * LDS + sj0 + e, ds + e);
#pragma unroll
    for (int e = 0; e < CJ; ++e) sDST[(sj0 + e) * HD + si] = ds[e];
  };
  auto stage = [&](int t0) {
    stage_inputs<HD, NT>(p, smem, b, h, t0, c1);
    const float* ck = p.ckpt + ((int64_t)(b * p.NSUB + t0 / L) * p.H + h) *
                               head;
    for (int idx = tid; idx < HD * HD / 4; idx += NT)
      cp_async16(sS0T + 4 * idx, ck + 4 * idx);
    cp_async_commit();
  };
  float u[4], du[4] = {0.f, 0.f, 0.f, 0.f};
  to4(u, ld4(p.u + h * p.u_sh + r0));

  const int subs = (c1 - c0 + L - 1) / L;
  store_ds();
  stage(c0 + (subs - 1) * L);
  for (int q = subs - 1; q >= 0; --q) {
    const int t0 = c0 + q * L, n = min(L, c1 - t0);
    cp_async_wait<0>();
    __syncthreads();  // inputs, S0 and dS of this sub-chunk in place

    // ---- Q = dY V^T (a rotated start spreads a warp's rows over banks),
    // Z = dY S0^T and X = V dS^T (this thread's token and rows), q's parts
    for (int idx = tid; idx < L * L; idx += NT) {
      const int tt = idx / L, ss = idx % L;
      float a = 0.f;
      for (int jj = 0; jj < HD; jj += 4) {
        const int j = (jj + 4 * ss) % HD;
        const float4 x = ld4(sDY + tt * HD + j), y = ld4(sV + ss * HD + j);
        a = fmaf(x.x, y.x, a); a = fmaf(x.y, y.y, a);
        a = fmaf(x.z, y.z, a); a = fmaf(x.w, y.w, a);
      }
      sQ[tt * LDQ + ss] = a;
    }
    float z[4] = {0.f, 0.f, 0.f, 0.f}, xx[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < HD; j += 4) {
      float dy4[4], v4[4];
      to4(dy4, ld4(sDY + t * HD + j));
      to4(v4, ld4(sV + t * HD + j));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s0[4], dt[4];
        to4(s0, ld4(sS0T + (j + e) * HD + r0));
        to4(dt, ld4(sDST + (j + e) * HD + r0));
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          z[x] = fmaf(dy4[e], s0[x], z[x]);
          xx[x] = fmaf(v4[e], dt[x], xx[x]);
        }
      }
    }
    st4(sZ + t * HD + r0, z);
    st4(sX + t * HD + r0, xx);
    {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < CJ; ++e)
        a = fmaf(ds[e], sS0T[(sj0 + e) * HD + si], a);
      sQP[sjq * HD + si] = a;
    }
    __syncthreads();

    // ---- per (token t, key rows r0..r0+3): D, E, dr, dk, dw, M's column
    float dd[4] = {1.f, 1.f, 1.f, 1.f}, ee[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
    for (int tau = 0; tau < L; ++tau) {
      float wv[4];
      to4(wv, ld4(sW + tau * HD + r0));
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (tau < t) dd[x] *= wv[x];
        if (tau > t) ee[x] *= wv[x];
      }
    }
    float rt[4], kt[4], wt[4], qv[4];
    to4(rt, ld4(sR + t * HD + r0));
    to4(kt, ld4(sK + t * HD + r0));
    to4(wt, ld4(sW + t * HD + r0));
#pragma unroll
    for (int x = 0; x < 4; ++x)
      qv[x] = ((sQP[r0 + x] + sQP[HD + r0 + x]) + sQP[2 * HD + r0 + x]) +
              sQP[3 * HD + r0 + x];
    const float qtt = sQ[t * LDQ + t];
    float dr[4], dk[4], t2[4] = {0.f, 0.f, 0.f, 0.f};
    float t3[4] = {0.f, 0.f, 0.f, 0.f}, t4[4] = {0.f, 0.f, 0.f, 0.f};
    float m[L];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      dr[x] = fmaf(dd[x], z[x], u[x] * kt[x] * qtt);
      dk[x] = fmaf(ee[x], xx[x], u[x] * rt[x] * qtt);
      du[x] = fmaf(rt[x] * kt[x], qtt, du[x]);
    }
    // up: t' > t, p = P(t, t')
    {
      float pp[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
      for (int tp = 0; tp < L; ++tp) {
        if (tp > t) {
          float rp[4], zp[4], wp[4];
          to4(rp, ld4(sR + tp * HD + r0));
          to4(zp, ld4(sZ + tp * HD + r0));
          to4(wp, ld4(sW + tp * HD + r0));
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
    // M[t'][t] summed over the G4 lanes of this token's key rows (m dies
    // here, before the down walk's registers)
    reduce_scatter<L, G4>(m, g, group);
#pragma unroll
    for (int e = 0; e < L / G4; ++e) sM[(g * (L / G4) + e) * LDQ + t] = m[e];
    // down: s < t, p = P(s, t); W = sum_{t'>t} P(t, t') r_t' Q[t'][s]
    {
      float pp[4] = {1.f, 1.f, 1.f, 1.f};
      for (int s = t - 1; s >= 0; --s) {
        float ks[4], ws[4], xs[4], wsum[4] = {0.f, 0.f, 0.f, 0.f};
        to4(ks, ld4(sK + s * HD + r0));
        to4(ws, ld4(sW + s * HD + r0));
        to4(xs, ld4(sX + s * HD + r0));
        float p2[4] = {1.f, 1.f, 1.f, 1.f};
        for (int tp = t + 1; tp < L; ++tp) {
          float rp[4], wp[4];
          to4(rp, ld4(sR + tp * HD + r0));
          to4(wp, ld4(sW + tp * HD + r0));
          const float qps = sQ[tp * LDQ + s];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            wsum[x] = fmaf(p2[x] * rp[x], qps, wsum[x]);
            p2[x] *= wp[x];
          }
        }
        const float qts = sQ[t * LDQ + s];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float kp = ks[x] * pp[x];
          dr[x] = fmaf(qts, kp, dr[x]);
          t2[x] = fmaf(kp, xs[x], t2[x]);
          t4[x] = fmaf(kp, wsum[x], t4[x]);
          pp[x] *= ws[x];
        }
      }
    }
    float dw[4], rd[4], ke[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float de = dd[x] * ee[x];
      dw[x] = fmaf(de, qv[x], fmaf(ee[x], t2[x], fmaf(dd[x], t3[x], t4[x])));
      if (wt[x] < 1.17549435e-38f) dw[x] = 0.f;  // FLT_MIN: as the plain version
      rd[x] = rt[x] * dd[x];
      ke[x] = kt[x] * ee[x];
    }
    st4(sRD + t * HD + r0, rd);
    st4(sKE + t * HD + r0, ke);
    if (t == L - 1) {
      float a4[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) a4[x] = dd[x] * wt[x];
      st4(sA + r0, a4);
    }
    if (t < n) {
      const int64_t o = ((int64_t)(b * p.S + t0 + t) * p.H + h) * HD + r0;
      st4(p.grad[0] + o, dr);
      st4(p.grad[1] + o, dk);
      st4(p.grad[3] + o, dw);
    }
    __syncthreads();

    // ---- dv = (K o E) dS + M^T dY (token t, value columns r0..r0+3), and
    // dS <- A o dS + (R o D)^T dY in registers
    {
      float dv[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < HD; i += 4) {
        float ke4[4];
        to4(ke4, ld4(sKE + t * HD + i));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float row[4];
          to4(row, ld4(sDS + (i + e) * LDS + r0));
#pragma unroll
          for (int x = 0; x < 4; ++x) dv[x] = fmaf(ke4[e], row[x], dv[x]);
        }
      }
#pragma unroll
      for (int tt = 0; tt < L; ++tt) {
        const float mts = sM[tt * LDQ + t];
        float dy4[4];
        to4(dy4, ld4(sDY + tt * HD + r0));
#pragma unroll
        for (int x = 0; x < 4; ++x) dv[x] = fmaf(mts, dy4[x], dv[x]);
      }
      if (t < n)
        st4(p.grad[2] + ((int64_t)(b * p.S + t0 + t) * p.H + h) * HD + r0,
            dv);
    }
    {
      const float a = sA[si];
#pragma unroll
      for (int e = 0; e < CJ; ++e) ds[e] *= a;
#pragma unroll
      for (int tt = 0; tt < L; ++tt) {
        const float rdv = sRD[tt * HD + si];
#pragma unroll
        for (int e = 0; e < CJ; e += 4) {
          float dy4[4];
          to4(dy4, ld4(sDY + tt * HD + sj0 + e));
#pragma unroll
          for (int x = 0; x < 4; ++x) ds[e + x] = fmaf(rdv, dy4[x], ds[e + x]);
        }
      }
    }
    __syncthreads();  // every read of this sub-chunk's buffers is done
    if (q > 0) stage(t0 - L);
    store_ds();
  }

  // du: this block's sum over its tokens, in a fixed order
  st4(sZ + t * HD + r0, du);
  __syncthreads();
  if (tid < HD) {
    float a = 0.f;
    for (int tt = 0; tt < L; ++tt) a += sZ[tt * HD + tid];
    p.du_part[((int64_t)(b * p.NC + c) * p.H + h) * HD + tid] = a;
  }
}

template <int HD>
int launch(const BwdParams& p, cudaStream_t stream) {
  using C = GradShape<HD>;
  constexpr int bytes = C::FLOATS * sizeof(float);
  static const int attr = cudaFuncSetAttribute(
      wkv6_bwd_grads_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.B * p.H, p.NC);
  wkv6_bwd_states_kernel<HD><<<grid, 4 * HD, 0, stream>>>(p);
  int err = cudaGetLastError();
  if (err) return err;
  const int64_t cells = (int64_t)p.B * p.H * HD * HD;
  wkv6_bwd_carry_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(
      p, HD);
  err = cudaGetLastError();
  if (err) return err;
  wkv6_bwd_grads_kernel<HD><<<grid, C::NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy: (B, S, H, hd) fp32, each given by its data pointer and
// element strides (batch, step, head) in strides[3 a .. 3 a + 2] in that
// order; u (H, hd) with head stride strides[15]; starts (B, NC, H, hd, hd)
// and dstate (B, H, hd, hd, or null) contiguous; chunk the steps between
// kept states (a multiple of 16). Scratch: ckpt (B, ceil(S / 16), H, hd,
// hd), acc (B, NC, H, hd, hd), fade (B, NC, H, hd). Writes dr, dk, dv, dw
// (B, S, H, hd) contiguous and du_part (B, NC, H, hd), du summed per
// (batch row, chunk). Head dims and rows as the forward's (hd 16, 32, 64;
// head dim contiguous, rows 16-byte aligned). Three launches; returns the
// first CUDA error.
extern "C" int wkv6_bwd_launch(const float* r, const float* k,
                               const float* v, const float* w,
                               const float* dy, const float* u,
                               const int64_t* strides, const float* starts,
                               const float* dstate, float* ckpt, float* acc,
                               float* fade, float* dr, float* dk, float* dv,
                               float* dw, float* du_part, int B, int H, int S,
                               int hd, int chunk, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || chunk <= 0 || chunk % L)
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
  p.NSUB = (S + L - 1) / L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, s);
    case 32: return launch<32>(p, s);
    case 64: return launch<64>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

// the tokens between the states kept inside the backward
extern "C" int wkv6_bwd_sub_chunk() { return L; }
