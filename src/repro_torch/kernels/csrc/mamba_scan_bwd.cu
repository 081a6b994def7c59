// Mamba selective scan backward (training) for Hopper, sm_90a: the
// gradient of the fused scan of mamba_scan.cu (dt's softplus, the scan,
// the skip term and the gating) from the states kept at every chunk's
// start, in one launch.
//
// No Pallas kernel stands behind it: the JAX package trains through XLA's
// gradient of chunked_time_scan (repro/models/ssm.py:30-47) around `step`
// (:208-218), with the softplus at :198, the skip at :219 and the gating at
// :220, which XLA fuses on the TPU. The port's plain version of that
// gradient is mamba_scan.py:mamba_scan_bwd (torch operations through
// _remat.py); this kernel computes what it computes, at the forward's
// rounding points. With the forward's names (dt = softplus(dt_raw +
// dt_bias), a = -exp(a_log), A_t = exp(dt_t a), u_t = dt_t x_t, y_t =
// sum_j h_t c_t + d_skip x_t, out_t = T(T(y_t) T(silu(z_t)))):
//
//   dy_t = T(dout_t T(silu z_t)),  dz_t = T(T(dout_t T(y_t)) silu'(z_t))
//   G_t  = dy_t c_t + E_{t+1},     E_t = A_t G_t   (E_S = dh, the final
//          state's gradient: the adjoint runs backwards in time)
//   w_t  = G_t h_{t-1} A_t:  d dt_t = sum_j w_t a + (sum_j G_t b_t) x_t,
//          d a_log = a sum_t w_t dt_t,  db_t = sum_d G_t u_t,
//          dc_t = sum_d dy_t h_t,  dx_t = T(dy_t d_skip + (sum_j G_t b_t)
//          dt_t),  d dt_raw = T(softplus'(.) d dt_t), d dt_bias = its sum,
//          d d_skip = sum_t dy_t x_t
//
// (T rounds to the model's dtype as autograd through the plain version
// does; softplus' is F.softplus's: the sigmoid below the threshold 20, 1
// above.) Steps past S have dt = 0 and dout = 0, so they pass the state
// and its adjoint on unchanged.
//
// What bounds it: bytes. At hymba-1.5b's training microbatch (B=4, S=4096,
// di=1600, n=16, bf16) it reads dt_raw, x, z and dout and writes their
// three gradients (52.4 MB each), with b, c, the kept states and their
// gradients beside: ~0.48 GB, 0.144 ms at 3.35 TB/s, against ~12 GFLOP of
// fp32 work. As in the forward, no tensor cores: the decay differs from
// state to state.
//
// Layout: the forward's chunked body (mamba_scan.cu: tiles of T = 64
// steps, L = 8 lanes of R = 8 consecutive steps each per (channel, state
// group), G = 2 state groups a channel, 8 channels a block of 4 warps, one
// batch row a block). A block walks its chunks from the last to the first
// and, in each, runs two passes over the chunk's tiles:
//   forward, tile by tile from the kept start state: each lane composes
//     its R steps (A, U) in registers, the L lanes scan across by warp
//     shuffles (the forward's inclusive scan), and the state at every
//     tile's start is kept in shared memory;
//   backward, tile by tile from the last: from its start state each lane
//     rebuilds its R states; the adjoint E has the same associative form
//     run backwards (E_t = A_t E_{t+1} + A_t dy_t c_t), so each lane
//     composes its steps from the last, the L lanes scan with shuffles
//     down, and each lane then walks its steps backwards once, summing
//     every gradient term in registers. E at the tile's first step is
//     carried to the tile before, and from the chunk's first tile to the
//     previous chunk's last, inside the kernel.
// Sums: d dt and dx over the states inside a thread and over the G groups
// by one shuffle; d a_log over a lane's steps in registers, its L lanes by
// shuffles and the tiles in shared memory; d_skip and dt_bias over a
// thread's steps in registers; all three written per batch row, which the
// wrapper sums over the rows. db and dc sum over channels: the two
// channels of a warp by a shuffle, the block's four warps through a slice
// of shared memory each (plain stores, summed in the epilogue: shared-
// memory float atomics, which compile to compare-and-swap loops, took 10.8
// of 13.1 ms, tools/ablate_kernels.py), and the blocks by a second kernel
// in the same C call, which sums each block's fp32 partial (B, S, n) in
// block order and writes db and dc in the model's dtype: deterministic,
// where fp32 atomics across blocks summed in another order each run (the
// card's sharded and unsharded hymba steps then parted by 1.4e-4, over
// chip_smoke.py's 1e-4). The partials are 2 x di / 8 x B x S x n fp32
// (0.42 GB at hymba's microbatch), written once and read once. The
// tile's raw inputs go into shared memory by cp.async one tile ahead, as
// in the forward. Three blocks an SM: 168 registers a thread, and 73 KB
// of shared memory a block (bf16).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int L = 8;    // lanes that share a channel's tile
constexpr int R = 8;    // consecutive steps a lane owns
constexpr int T = L * R;  // steps a tile
constexpr int G = 2;    // lane groups that split a channel's states
constexpr int NW = 4;   // warps a block
constexpr int CH = NW * 32 / (L * G);  // channels a block
constexpr int NT = 32 * NW;
constexpr unsigned FULL = 0xffffffffu;
static_assert(R % 4 == 0 && 32 % (L * G) == 0 && CH % 4 == 0, "tile shape");
static_assert(32 / (L * G) == 2, "the db/dc shuffle pairs a warp's two "
                                 "channels");

struct BwdParams {
  const void* dt;        // dt_raw (B, S, di)
  const float* dt_bias;  // (di)
  const void* b;         // (B, S, n)
  const void* c;
  const void* x;         // (B, S, di)
  const void* z;
  const float* a_log;    // (di, n) contiguous
  const float* d_skip;   // (di)
  const float* starts;   // (B, chunks, di, n) contiguous: kept states
  const void* dout;      // (B, S, di)
  const float* dh;       // (B, di, n) contiguous, or null (zeros)
  void* d_dt;            // (B, S, di) contiguous, the model's dtype
  void* d_x;
  void* d_z;
  float* part_b;         // (di / CH, B, S, n) fp32: each block's db, dc
  float* part_c;
  void* d_b;             // (B, S, n) contiguous, the model's dtype
  void* d_c;
  float* p_bias;         // (B, di): per batch row, summed by the wrapper
  float* p_skip;
  float* p_alog;         // (B, di, n)
  int64_t dt_sb, dt_ss;  // element strides (batch, step)
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int64_t x_sb, x_ss;
  int64_t z_sb, z_ss;
  int64_t do_sb, do_ss;
  int S, di, chunk;
};

// F.softplus with beta 1 and threshold 20, as the forward
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}
// its backward, as PyTorch's: g e^v / (e^v + 1) below the threshold
__device__ __forceinline__ float softplus_grad(float g, float v) {
  if (v > 20.f) return g;
  const float e = expf(v);
  return g * e / (e + 1.f);
}

// rounding to the model's dtype
__device__ __forceinline__ float rnd(float v, float) { return v; }
__device__ __forceinline__ float rnd(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

// the forward's T(silu(z)): PyTorch's z / (1 + exp(-z)), rounded
template <typename TIn>
__device__ __forceinline__ float silu_t(float z) {
  return rnd(__fdiv_rn(z, __fadd_rn(1.f, expf(-z))), TIn());
}

// four neighbouring elements (16 bytes of fp32, 8 of bf16) as floats, and
// back
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// the forward's layout of a tile's per-step rows: step t = l * R + 4 q + e
// at q * 4L + 4 l + e, so that a lane reads 4 of its steps as one float4
__device__ __forceinline__ int perm(int t) {
  return ((t % R) / 4) * (4 * L) + (t / R) * 4 + t % 4;
}

// a lane's R values of a permuted row
__device__ __forceinline__ void load_steps(const float* row, int l,
                                           float* v) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 f =
        *reinterpret_cast<const float4*>(row + q * 4 * L + 4 * l);
    v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <typename TIn, int N>
struct BwdShape {
  static constexpr int V = Vec<TIn>::N;  // elements a 16-byte vector
  static constexpr int NS = N / G;       // states a lane
  static constexpr int LY = CH + 1;      // y's rows: conflict-free stores
  static constexpr int LB = T + 1;       // db's and dc's rows (per state)
  static_assert(CH % V == 0 && N % V == 0, "vector shape");
  static_assert(2 * (4 * T * CH + 2 * T * N) * sizeof(TIn) / 4 >= NT * 8,
                "the final sums reuse the raw buffers");
  // shared memory, in floats: two raw buffers (dt, x, z, dout as T x CH
  // and b, c as T x N, in the model's dtype); dt, u = dt x and dy (CH x T,
  // permuted); b and c (N x T, permuted); y, sum_j w a and sum_j G b
  // (T x LY); db and dc of the tile, a slice a warp (NW x N x LB,
  // permuted); the bias, the skip, a (CH x N), d a_log's sums (CH x N),
  // two buffers of the adjoint carry (CH x N); then the kept state at each
  // tile's start of a chunk (tiles x CH x N)
  static constexpr int RAW = (4 * T * CH + 2 * T * N) * sizeof(TIn) / 4;
  static constexpr int FIXED = 2 * RAW + 3 * CH * T + 2 * N * T +
                               3 * T * LY + 2 * NW * N * LB + 2 * CH +
                               4 * CH * N;
  static size_t bytes(int tiles) {
    return size_t(FIXED + tiles * CH * N) * 4;
  }
};

// the job n of a block: chunks from the last, each a forward pass over its
// tiles and then a backward pass from its last tile. `ntc` tiles a chunk,
// `ntl` in the last chunk (S may end inside it).
__device__ __forceinline__ void job_of(int n, int nch, int ntc, int ntl,
                                       int& ci, int& tt, bool& bwd) {
  int r, nt;
  if (n < 2 * ntl) {
    ci = nch - 1;
    r = n;
    nt = ntl;
  } else {
    n -= 2 * ntl;
    ci = nch - 2 - n / (2 * ntc);
    r = n % (2 * ntc);
    nt = ntc;
  }
  bwd = r >= nt;
  tt = bwd ? 2 * nt - 1 - r : r;
}

template <typename TIn, int N>
__global__ void __launch_bounds__(NT, 3)
    mamba_scan_bwd_kernel(const BwdParams p) {
  using C = BwdShape<TIn, N>;
  constexpr int V = C::V;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sDt = smem + 2 * C::RAW;
  float* sU = sDt + CH * T;
  float* sDy = sU + CH * T;
  float* sB = sDy + CH * T;
  float* sC = sB + N * T;
  float* sY = sC + N * T;        // y summed over the states (no skip)
  float* sAW = sY + T * C::LY;   // sum_j w a
  float* sGB = sAW + T * C::LY;  // sum_j G b
  float* sDB = sGB + T * C::LY;  // db of the tile, a warp's two channels
  float* sDC = sDB + NW * N * C::LB;
  float* sBias = sDC + NW * N * C::LB;
  float* sSkip = sBias + CH;
  float* sA = sSkip + CH;     // a[ch][j]
  float* sDa = sA + CH * N;   // d a: sum over steps of w dt
  float* sE = sDa + CH * N;   // two buffers of the adjoint carry
  float* sHs = sE + 2 * CH * N;   // the state at each tile's start

  const int bi = blockIdx.y, d0 = blockIdx.x * CH, tid = threadIdx.x;
  const int lane = tid % 32, l = lane % L, g = lane / L % G;
  const int ch = (tid / 32) * (32 / (L * G)) + lane / (L * G);
  const TIn* dtg = static_cast<const TIn*>(p.dt) + bi * p.dt_sb + d0;
  const TIn* xg = static_cast<const TIn*>(p.x) + bi * p.x_sb + d0;
  const TIn* zg = static_cast<const TIn*>(p.z) + bi * p.z_sb + d0;
  const TIn* og = static_cast<const TIn*>(p.dout) + bi * p.do_sb + d0;
  const TIn* bg = static_cast<const TIn*>(p.b) + bi * p.b_sb;
  const TIn* cg = static_cast<const TIn*>(p.c) + bi * p.c_sb;

  const int nch = (p.S + p.chunk - 1) / p.chunk;
  const int ntc = p.chunk / T;
  const int ntl = (p.S - (nch - 1) * p.chunk + T - 1) / T;
  const int jobs = 2 * (ntl + (nch - 1) * ntc);

  auto raw = [&](int buf, int which) {  // 0 dt, 1 x, 2 z, 3 dout, 4 b, 5 c
    TIn* base = reinterpret_cast<TIn*>(smem + buf * C::RAW);
    return which < 4 ? base + which * T * CH
                     : base + 4 * T * CH + (which - 4) * T * N;
  };
  // rows t0 .. t0+T-1 of a (rows, W) operand by 16-byte cp.async copies;
  // rows past S and columns past `cols` zero-filled without a read
  auto stage_rows = [&](auto w_tag, TIn* dst, const TIn* src, int64_t ss,
                        int t0, int cols) {
    constexpr int W = decltype(w_tag)::value, CPR = W / V;
#pragma unroll
    for (int r = 0; r < (T * CPR + NT - 1) / NT; ++r) {
      const int i = tid + r * NT, t = i / CPR, c = i % CPR * V;
      if (T * CPR % NT != 0 && i >= T * CPR) break;
      const bool ok = t0 + t < p.S && c < cols;
      cp_async16(dst + t * W + c, ok ? src + (t0 + t) * ss + c : src, ok);
    }
  };
  // job n's tile into buffer buf: dt, x and b for a forward pass, and z,
  // dout and c besides for a backward pass
  auto stage = [&](int buf, int n) {
    if (n < jobs) {
      int ci, tt;
      bool bwd;
      job_of(n, nch, ntc, ntl, ci, tt, bwd);
      const int t0 = ci * p.chunk + tt * T;
      using Wc = std::integral_constant<int, CH>;
      using Wn = std::integral_constant<int, N>;
      stage_rows(Wc(), raw(buf, 0), dtg, p.dt_ss, t0, p.di - d0);
      stage_rows(Wc(), raw(buf, 1), xg, p.x_ss, t0, p.di - d0);
      stage_rows(Wn(), raw(buf, 4), bg, p.b_ss, t0, N);
      if (bwd) {
        stage_rows(Wc(), raw(buf, 2), zg, p.z_ss, t0, p.di - d0);
        stage_rows(Wc(), raw(buf, 3), og, p.do_ss, t0, p.di - d0);
        stage_rows(Wn(), raw(buf, 5), cg, p.c_ss, t0, N);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < CH; i += NT) {
    sBias[i] = d0 + i < p.di ? p.dt_bias[d0 + i] : 0.f;
    sSkip[i] = d0 + i < p.di ? p.d_skip[d0 + i] : 0.f;
  }
  for (int i = tid; i < CH * N; i += NT) {
    const bool ok = d0 + i / N < p.di;
    sA[i] = ok ? -expf(p.a_log[(int64_t)d0 * N + i]) : 0.f;
    sDa[i] = 0.f;
    sE[i] = ok && p.dh != nullptr
                ? p.dh[((int64_t)bi * p.di + d0) * N + i] : 0.f;
  }
  // this thread's epilogue columns: channels c0 .. c0+3 (fixed: NT is a
  // multiple of CH / 4), their d_skip and dt_bias sums
  float skip_acc[4] = {0.f, 0.f, 0.f, 0.f}, bias_acc[4] = {0.f, 0.f, 0.f,
                                                          0.f};
  int e_buf = 0;  // the adjoint carry's read buffer

  stage(0, 0);
  for (int n = 0; n < jobs; ++n) {
    const int buf = n & 1;
    int ci, tt;
    bool bwd;
    job_of(n, nch, ntc, ntl, ci, tt, bwd);
    const int t0 = ci * p.chunk + tt * T;
    const int nt = ci == nch - 1 ? ntl : ntc;
    cp_async_wait<0>();
    __syncthreads();  // job n landed; job n-1's epilogue is done
    stage(buf ^ 1, n + 1);  // in flight under job n

    // convert: dt's bias and softplus, u = dt x, and in a backward pass
    // dy; b (and c) as fp32 rows; four elements a thread at a time
    if (!bwd && tt == 0) {
      const float* st = p.starts +
                        (((int64_t)bi * nch + ci) * p.di + d0) * N;
      for (int i = tid; i < CH * N; i += NT)
        sHs[i] = d0 + i / N < p.di ? st[i] : 0.f;
    }
    {
      const TIn* rdt = raw(buf, 0);
      const TIn* rx = raw(buf, 1);
      const TIn* rz = raw(buf, 2);
      const TIn* ro = raw(buf, 3);
#pragma unroll
      for (int r = 0; r < (T * CH / 4 + NT - 1) / NT; ++r) {
        const int i = tid + r * NT, t = i / (CH / 4), c0 = i % (CH / 4) * 4;
        if (T * CH / 4 % NT != 0 && i >= T * CH / 4) break;
        const bool live = t0 + t < p.S;
        float dv[4], xv[4], zv[4], ov[4];
        load4(rdt + t * CH + c0, dv);
        load4(rx + t * CH + c0, xv);
        if (bwd) {
          load4(rz + t * CH + c0, zv);
          load4(ro + t * CH + c0, ov);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dtv =
              live ? softplus(__fadd_rn(dv[e], sBias[c0 + e])) : 0.f;
          sDt[(c0 + e) * T + perm(t)] = dtv;
          sU[(c0 + e) * T + perm(t)] = __fmul_rn(dtv, xv[e]);
          if (bwd)
            sDy[(c0 + e) * T + perm(t)] =
                live ? rnd(ov[e] * silu_t<TIn>(zv[e]), TIn()) : 0.f;
        }
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w == 1 && !bwd) break;
#pragma unroll
        for (int r = 0; r < (T * N / 4 + NT - 1) / NT; ++r) {
          const int i = tid + r * NT, j0 = i / T * 4, t = i % T;
          if (T * N / 4 % NT != 0 && i >= T * N / 4) break;
          float v[4];
          load4(raw(buf, 4 + w) + t * N + j0, v);
          float* dst = (w == 0 ? sB : sC) + perm(t);
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(j0 + e) * T] = v[e];
        }
      }
    }
    __syncthreads();

    float dtv[R], uv[R];
    load_steps(sDt + ch * T, l, dtv);
    load_steps(sU + ch * T, l, uv);
    float* hs = sHs + tt * CH * N;
    if (!bwd) {
      // forward pass: the state at the next tile's start
      if (tt + 1 < nt) {
#pragma unroll 1
        for (int j = g * C::NS; j < (g + 1) * C::NS; ++j) {
          const float aj = sA[ch * N + j];
          float bq[R];
          load_steps(sB + j * T, l, bq);
          float A = 1.f, U = 0.f;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float da = expf(__fmul_rn(dtv[i], aj));
            U = fmaf(da, U, __fmul_rn(uv[i], bq[i]));
            A *= da;
          }
#pragma unroll
          for (int o = 1; o < L; o <<= 1) {
            const float Ap = __shfl_up_sync(FULL, A, o, L);
            const float Up = __shfl_up_sync(FULL, U, o, L);
            U = fmaf(A, l >= o ? Up : 0.f, U);
            A *= l >= o ? Ap : 1.f;
          }
          const float h_last = __shfl_sync(
              FULL, fmaf(A, hs[ch * N + j], U), L - 1, L);
          if (l == 0) hs[CH * N + ch * N + j] = h_last;
        }
      }
      continue;  // the next job's barrier orders the kept state
    }

    // backward pass over tile tt
    float dyv[R], yv[R], aw[R], gb[R];
    load_steps(sDy + ch * T, l, dyv);
#pragma unroll
    for (int i = 0; i < R; ++i) yv[i] = aw[i] = gb[i] = 0.f;
    const float* e_in = sE + e_buf * CH * N;
    float* e_out = sE + (e_buf ^ 1) * CH * N;
#pragma unroll 1
    for (int j = g * C::NS; j < (g + 1) * C::NS; ++j) {
      const float aj = sA[ch * N + j];
      const float h_tile = hs[ch * N + j], e_tile = e_in[ch * N + j];
      float bq[R], cq[R], A[R];
      load_steps(sB + j * T, l, bq);
      load_steps(sC + j * T, l, cq);
      // this lane's steps composed: forward (Af, Uf), and backward from
      // its last step, E_first = Af E_after + Qb
      float Af = 1.f, Uf = 0.f, Qb = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        A[i] = expf(__fmul_rn(dtv[i], aj));
        Uf = fmaf(A[i], Uf, __fmul_rn(uv[i], bq[i]));
        Af *= A[i];
      }
#pragma unroll
      for (int i = R - 1; i >= 0; --i) Qb = A[i] * fmaf(dyv[i], cq[i], Qb);
      // inclusive scans over the L lanes: lanes 0..l forwards (shuffles
      // up), lanes l..L-1 backwards (shuffles down); out-of-range lanes
      // compose with the identity (1, 0)
      float Ac = Af, Uc = Uf, Pr = Af, Qr = Qb;
#pragma unroll
      for (int o = 1; o < L; o <<= 1) {
        const float Ap = __shfl_up_sync(FULL, Ac, o, L);
        const float Up = __shfl_up_sync(FULL, Uc, o, L);
        const float Pn = __shfl_down_sync(FULL, Pr, o, L);
        const float Qn = __shfl_down_sync(FULL, Qr, o, L);
        Uc = fmaf(Ac, l >= o ? Up : 0.f, Uc);
        Ac *= l >= o ? Ap : 1.f;
        if (l + o < L) {
          Qr = fmaf(Pr, Qn, Qr);
          Pr *= Pn;
        }
      }
      // the state before this lane's first step, and the adjoint after
      // its last
      const float h_up = __shfl_up_sync(FULL, fmaf(Ac, h_tile, Uc), 1, L);
      const float e_first = fmaf(Pr, e_tile, Qr);
      const float e_dn = __shfl_down_sync(FULL, e_first, 1, L);
      const float h0 = l == 0 ? h_tile : h_up;
      float E = l == L - 1 ? e_tile : e_dn;
      if (l == 0) e_out[ch * N + j] = e_first;  // to the tile before
      // the lane's states, then its steps backwards
      float hv[R];
      float h = h0;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        h = fmaf(A[i], h, __fmul_rn(uv[i], bq[i]));
        hv[i] = h;
        yv[i] = fmaf(h, cq[i], yv[i]);
      }
      float da = 0.f, dbv[R], dcv[R];
#pragma unroll
      for (int i = R - 1; i >= 0; --i) {
        const float gi = fmaf(dyv[i], cq[i], E);
        const float w = gi * (i ? hv[i - 1] : h0) * A[i];
        aw[i] = fmaf(w, aj, aw[i]);
        da = fmaf(w, dtv[i], da);
        gb[i] = fmaf(gi, bq[i], gb[i]);
        dbv[i] = gi * uv[i];
        dcv[i] = dyv[i] * hv[i];
        E = A[i] * gi;
      }
      // d a over the L lanes; db and dc over the warp's two channels into
      // the warp's slice of the permuted rows
#pragma unroll
      for (int o = 1; o < L; o <<= 1) da += __shfl_xor_sync(FULL, da, o);
      if (l == 0) sDa[ch * N + j] += da;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        dbv[i] += __shfl_xor_sync(FULL, dbv[i], L * G);
        dcv[i] += __shfl_xor_sync(FULL, dcv[i], L * G);
      }
      if ((lane & (L * G)) == 0) {
        const int at = (tid / 32) * N * C::LB + j * C::LB;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          sDB[at + perm(l * R + i)] = dbv[i];
          sDC[at + perm(l * R + i)] = dcv[i];
        }
      }
    }
    e_buf ^= 1;
    // over the G state groups of the channel
#pragma unroll
    for (int o = L; o < L * G; o <<= 1)
#pragma unroll
      for (int i = 0; i < R; ++i) {
        yv[i] += __shfl_xor_sync(FULL, yv[i], o);
        aw[i] += __shfl_xor_sync(FULL, aw[i], o);
        gb[i] += __shfl_xor_sync(FULL, gb[i], o);
      }
    if (g == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int at = (l * R + i) * C::LY + ch;
        sY[at] = yv[i];
        sAW[at] = aw[i];
        sGB[at] = gb[i];
      }
    }
    __syncthreads();

    // epilogue: the gating's, the skip's and the softplus's gradients,
    // four elements a thread at a time; db and dc of the tile to the
    // global sums
    {
      const TIn* rdt = raw(buf, 0);
      const TIn* rx = raw(buf, 1);
      const TIn* rz = raw(buf, 2);
      const TIn* ro = raw(buf, 3);
      TIn* gdt = static_cast<TIn*>(p.d_dt) + (int64_t)bi * p.S * p.di + d0;
      TIn* gx = static_cast<TIn*>(p.d_x) + (int64_t)bi * p.S * p.di + d0;
      TIn* gz = static_cast<TIn*>(p.d_z) + (int64_t)bi * p.S * p.di + d0;
#pragma unroll
      for (int r = 0; r < (T * CH / 4 + NT - 1) / NT; ++r) {
        const int i = tid + r * NT, t = i / (CH / 4), c0 = i % (CH / 4) * 4;
        if (T * CH / 4 % NT != 0 && i >= T * CH / 4) break;
        if (t0 + t >= p.S || d0 + c0 >= p.di) continue;
        float dv[4], xv[4], zv[4], ov[4], odt[4], ox[4], oz[4];
        load4(rdt + t * CH + c0, dv);
        load4(rx + t * CH + c0, xv);
        load4(rz + t * CH + c0, zv);
        load4(ro + t * CH + c0, ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = t * C::LY + c0 + e;
          const float v = __fadd_rn(dv[e], sBias[c0 + e]);
          const float dtv = softplus(v);
          const float y = __fadd_rn(sY[at], __fmul_rn(sSkip[c0 + e], xv[e]));
          const float dy = rnd(ov[e] * silu_t<TIn>(zv[e]), TIn());
          const float gsz = rnd(ov[e] * rnd(y, TIn()), TIn());
          const float sig = 1.f / (1.f + expf(-zv[e]));
          oz[e] = gsz * sig * (1.f + zv[e] * (1.f - sig));
          const float gb_ = sGB[at];
          ox[e] = fmaf(dy, sSkip[c0 + e], gb_ * dtv);
          const float ddt = fmaf(gb_, xv[e], sAW[at]);
          odt[e] = softplus_grad(ddt, v);
          skip_acc[e] = fmaf(dy, xv[e], skip_acc[e]);
          bias_acc[e] += odt[e];
        }
        const int64_t at = (int64_t)(t0 + t) * p.di + c0;
        store4(gdt + at, odt);
        store4(gx + at, ox);
        store4(gz + at, oz);
      }
      // this block's partial db and dc of the tile
      const int64_t part = ((int64_t)blockIdx.x * gridDim.y + bi) * p.S + t0;
      float* gb_out = p.part_b + part * N;
      float* gc_out = p.part_c + part * N;
      for (int i = tid; i < T * N; i += NT) {
        const int t = i / N, at = (i % N) * C::LB + perm(t);
        if (t0 + t >= p.S) continue;
        float db = 0.f, dc = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          db += sDB[w * N * C::LB + at];
          dc += sDC[w * N * C::LB + at];
        }
        gb_out[i] = db;
        gc_out[i] = dc;
      }
    }
  }

  // per batch row: d a_log = a sum(w dt); d_skip and dt_bias by this
  // thread's columns c0..c0+3, summed over the block's threads in thread
  // order through the raw buffers, idle now
  __syncthreads();  // the last job's epilogue is done with them
  float* sRed = smem;  // NT x 8: each thread's skip and bias sums
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sRed[tid * 8 + e] = skip_acc[e];
    sRed[tid * 8 + 4 + e] = bias_acc[e];
  }
  __syncthreads();
  for (int i = tid; i < CH * N; i += NT)
    if (d0 + i / N < p.di)
      p.p_alog[((int64_t)bi * p.di + d0) * N + i] = sDa[i] * sA[i];
  if (tid < CH && d0 + tid < p.di) {
    // the threads whose columns hold channel tid: tid / 4 + k CH / 4
    float skip = 0.f, bias = 0.f;
    for (int t = tid / 4; t < NT; t += CH / 4) {
      skip += sRed[t * 8 + tid % 4];
      bias += sRed[t * 8 + 4 + tid % 4];
    }
    p.p_skip[(int64_t)bi * p.di + d0 + tid] = skip;
    p.p_bias[(int64_t)bi * p.di + d0 + tid] = bias;
  }
}

// db and dc: the blocks' partials summed in block order, four (step,
// state) elements a thread, written in the model's dtype
template <typename TIn>
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_reduce_kernel(const BwdParams p, int parts,
                                 int64_t quads) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  float db[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < parts; ++k) {
    float vb[4], vc[4];
    load4(p.part_b + (k * quads + q) * 4, vb);
    load4(p.part_c + (k * quads + q) * 4, vc);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      db[e] += vb[e];
      dc[e] += vc[e];
    }
  }
  store4(static_cast<TIn*>(p.d_b) + q * 4, db);
  store4(static_cast<TIn*>(p.d_c) + q * 4, dc);
}

template <typename TIn, int N>
int launch(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t bytes = BwdShape<TIn, N>::bytes(p.chunk / T);
  const int e = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<TIn, N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.di + CH - 1) / CH, B);
  mamba_scan_bwd_kernel<TIn, N><<<grid, NT, bytes, stream>>>(p);
  const int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t quads = (int64_t)B * p.S * N / 4;
  mamba_scan_bwd_reduce_kernel<TIn>
      <<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(
          p, grid.x, quads);
  return cudaGetLastError();
}

template <typename TIn>
int launch_n(const BwdParams& p, int B, int n, cudaStream_t stream) {
  switch (n) {
    case 8: return launch<TIn, 8>(p, B, stream);
    case 16: return launch<TIn, 16>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Inputs as mamba_scan_launch takes them (dt_raw, b, c, x, z and dout in
// one dtype, `dtype`, each given by its data pointer and (batch, step)
// element strides in `strides`: dt, b, c, x, z, dout), plus starts (B,
// chunks, di, n) fp32 contiguous, the state at the start of every `chunk`
// steps (a multiple of mamba_scan_bwd_time_tile()), and dh (B, di, n) fp32
// contiguous or null. Outputs: d_dt, d_x, d_z (B, S, di) and d_b, d_c (B,
// S, n) contiguous in the dtype; p_bias, p_skip (B, di) and p_alog (B, di,
// n) fp32, each batch row's sums. Scratch: part_b, part_c (di / 8, B, S,
// n) fp32 (mamba_scan_bwd_channels() channels a block). One call launches
// the backward kernel, one block per 8 channels and batch row, and the
// reduction of db and dc. Returns the first CUDA error, 0 on success.
extern "C" int mamba_scan_bwd_launch(
    const void* dt, const float* dt_bias, const void* b, const void* c,
    const void* x, const void* z, const float* a_log, const float* d_skip,
    const float* starts, const void* dout, const float* dh, void* d_dt,
    void* d_x, void* d_z, float* part_b, float* part_c, void* d_b,
    void* d_c, float* p_bias, float* p_skip, float* p_alog,
    const int64_t* strides, int dtype, int B,
    int S, int di, int n, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || di % 8 || chunk <= 0 || chunk % T)
    return cudaErrorInvalidValue;
  BwdParams p;
  p.dt = dt; p.dt_bias = dt_bias; p.b = b; p.c = c; p.x = x; p.z = z;
  p.a_log = a_log; p.d_skip = d_skip; p.starts = starts; p.dout = dout;
  p.dh = dh; p.d_dt = d_dt; p.d_x = d_x; p.d_z = d_z;
  p.part_b = part_b; p.part_c = part_c; p.d_b = d_b; p.d_c = d_c;
  p.p_bias = p_bias; p.p_skip = p_skip; p.p_alog = p_alog;
  p.dt_sb = strides[0]; p.dt_ss = strides[1];
  p.b_sb = strides[2]; p.b_ss = strides[3];
  p.c_sb = strides[4]; p.c_ss = strides[5];
  p.x_sb = strides[6]; p.x_ss = strides[7];
  p.z_sb = strides[8]; p.z_ss = strides[9];
  p.do_sb = strides[10]; p.do_ss = strides[11];
  p.S = S; p.di = di; p.chunk = chunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32: return launch_n<float>(p, B, n, s);
    case DTYPE_BF16: return launch_n<__nv_bfloat16>(p, B, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// the tile T of the backward's passes: `chunk` must be a multiple of it
extern "C" int mamba_scan_bwd_time_tile() { return T; }

// channels a block: the partials of db and dc are (ceil(di / this), B, S,
// n)
extern "C" int mamba_scan_bwd_channels() { return CH; }
