// Mamba selective scan backward (training) for Hopper, sm_90a: the
// gradient of the fused scan of mamba_scan.cu (dt's softplus, the scan,
// the skip term and the gating) from the states kept at every chunk's
// start, chunk-parallel, in one C call.
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
// The adjoint is linear in its value at a chunk's end: E_start(c) = F_c o
// E_end(c) + H_c, F_c the product of A over the chunk and H_c the chunk's
// own part from dy c. Four kernels in one C call; the two that walk the
// steps run a block per (8 channels, batch row, chunk), 16x the blocks of
// one per (channels, batch row) at 256-step chunks, so no wave tail and
// no idle card at B = 1:
//   1. chunk: walks its chunk's tiles forward from the kept start state:
//      the forward pass (the state at every tile's start, kept in device
//      memory, 26 MB at hymba's microbatch, so that kernel 3 runs no
//      forward pass) and the composition (F_c, H_c) of the adjoint's steps;
//   2. carry: a thread per (batch row, channel, state) walks the chunks
//      backwards from dh, E_end(c-1) = F_c E_end(c) + H_c, in place of H;
//   3. grads: walks its chunk's tiles backwards from E_end(c), each tile
//      from its kept start state (the backward pass below), and sums db and
//      dc over channels through the cluster's shared memory;
//   4. reduce: sums the clusters' db/dc partials in order.
// Layout of a tile, as the forward's chunked body (mamba_scan.cu): T = 64
// steps, L = 8 lanes of R = 8 consecutive steps each per (channel, state
// group), G = 2 state groups a channel, 8 channels a block of 4 warps.
// Each lane composes its R steps (A, U) in registers and the L lanes scan
// across by warp shuffles; the adjoint has the same associative form run
// backwards (E_t = A_t E_{t+1} + A_t dy_t c_t), scanned with shuffles down.
// In kernel 3 each lane then rebuilds its R states and walks its steps
// backwards once, summing every gradient term in registers; E at the
// tile's first step is carried to the tile before inside the block.
// Sums: d dt and dx over the states inside a thread and over the G groups
// by one shuffle; d a_log over a lane's steps in registers, its L lanes by
// shuffles and the tiles in shared memory; d_skip and dt_bias over a
// thread's steps in registers; all three written per (batch row, chunk),
// which the wrapper sums. db and dc sum over channels: the two channels of
// a warp by a shuffle, the block's four warps through a slice of shared
// memory each (plain stores: shared-memory float atomics, compare-and-swap
// loops, took 10.8 of 13.1 ms in the first design), then the blocks of a
// thread-block cluster (CS neighbouring channel blocks, the largest of 8,
// 4, 2, 1 that divides the launch's channel blocks, as a rank's share under
// a mesh may not be a multiple of 8 blocks) through distributed shared
// memory: each block sums its warps' slices into one (step, state) tile,
// and each rank sums a CS-th of it over the cluster's ranks, four
// elements a load, in a fixed order and writes one fp32
// partial per cluster (di / 8 / CS, B, S, n: 52 MB at hymba's microbatch,
// where one per block took 0.42 GB); kernel 4 sums the partials in order
// and writes db and dc in the model's dtype. Deterministic: no
// atomics (float atomics across blocks summed in another order each run,
// and the card's sharded and unsharded hymba steps parted by 1.4e-4, over
// chip_smoke.py's 1e-4). Cluster barriers are split (arrive, then wait
// after independent work: the epilogue runs while the peers catch up).
// Remote shared memory is read four floats a load after each block has
// summed its own warps: 64 scalar remote loads a thread a tile made a
// call 6.7 ms, against 2.4 ms this way. What the time is spent on: PERF.md, tools/ablate_kernels.py
// mamba_scan_bwd.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

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
  const float* starts;   // (B, NC, di, n) contiguous: kept states
  const void* dout;      // (B, S, di)
  const float* dh;       // (B, di, n) contiguous, or null (zeros)
  void* d_dt;            // (B, S, di) contiguous, the model's dtype
  void* d_x;
  void* d_z;
  float* part_b;         // (di / CH / CS, B, S, n) fp32: a cluster's db, dc
  float* part_c;
  void* d_b;             // (B, S, n) contiguous, the model's dtype
  void* d_c;
  float* p_bias;         // (B, NC, di): per (batch row, chunk), summed by
  float* p_skip;         //   the wrapper
  float* p_alog;         // (B, NC, di, n)
  float* tiles;          // (B, ceil(S / T), di, n): the state at each tile
  float* fh;             // (2, B, NC, di, n): F_c; H_c, then E_end(c)
  int64_t dt_sb, dt_ss;  // element strides (batch, step)
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int64_t x_sb, x_ss;
  int64_t z_sb, z_ss;
  int64_t do_sb, do_ss;
  int B, S, di, chunk, NC, NTILE, CS;
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

// split cluster barrier: arrive (releasing this thread's shared-memory
// writes to the cluster), later wait (acquiring the others')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename TIn, int N>
struct Shape {
  static constexpr int V = Vec<TIn>::N;  // elements a 16-byte vector
  static constexpr int NS = N / G;       // states a lane
  static constexpr int LY = CH + 1;      // y's rows: conflict-free stores
  static constexpr int LB = T + 1;       // db's and dc's rows (per state)
  static_assert(CH % V == 0 && N % V == 0, "vector shape");
  static_assert(2 * (4 * T * CH + 2 * T * N) * sizeof(TIn) / 4 >= NT * 8,
                "the final sums reuse the raw buffers");
  // a raw buffer: dt, x, z, dout as T x CH and b, c as T x N, in the
  // model's dtype, in floats
  static constexpr int RAW = (4 * T * CH + 2 * T * N) * sizeof(TIn) / 4;
  // shared memory of both walking kernels, in floats: two raw buffers; dt,
  // u = dt x and dy (CH x T, permuted); b and c (N x T, permuted); the
  // bias, the skip (CH); a (CH x N); then each kernel's own
  static constexpr int OFF_DT = 2 * RAW;
  static constexpr int OFF_U = OFF_DT + CH * T;
  static constexpr int OFF_DY = OFF_U + CH * T;
  static constexpr int OFF_B = OFF_DY + CH * T;
  static constexpr int OFF_C = OFF_B + N * T;
  static constexpr int OFF_BIAS = OFF_C + N * T;
  static constexpr int OFF_SKIP = OFF_BIAS + CH;
  static constexpr int OFF_A = OFF_SKIP + CH;
  static constexpr int OFF_OWN = OFF_A + CH * N;
  static_assert(OFF_BIAS - OFF_B >= 2 * T * N && OFF_B % 4 == 0,
                "kernel 3's block sums of db and dc lie on b's and c's rows");
  // kernel 1: the state at the tile's start and the next's (2 x CH x N),
  // F and H of the chunk so far (CH x N each)
  static constexpr int CHUNK_FLOATS = OFF_OWN + 4 * CH * N;
  // kernel 3: y, sum_j w a and sum_j G b (T x LY); db and dc of the tile, a
  // slice a warp (NW x N x LB, permuted); d a_log's sums (CH x N); two
  // buffers of the adjoint carry and of the tile's start state (CH x N)
  static constexpr int OFF_Y = OFF_OWN;
  static constexpr int OFF_AW = OFF_Y + T * LY;
  static constexpr int OFF_GB = OFF_AW + T * LY;
  static constexpr int OFF_DB = OFF_GB + T * LY;
  static constexpr int OFF_DC = OFF_DB + NW * N * LB;
  static constexpr int OFF_DA = OFF_DC + NW * N * LB;
  static constexpr int OFF_E = OFF_DA + CH * N;
  static constexpr int OFF_HS = OFF_E + 2 * CH * N;
  static constexpr int GRADS_FLOATS = OFF_HS + 2 * CH * N;
};

// The pieces both walking kernels share: the block's channels, batch row
// and chunk, its tiles, and a tile's copies and conversion.
template <typename TIn, int N>
struct Walk {
  using C = Shape<TIn, N>;
  const BwdParams& p;
  float* smem;
  int bi, ci, d0, tid, t_first, t_end, nt;
  const TIn *dtg, *xg, *zg, *og, *bg, *cg_;

  __device__ Walk(const BwdParams& p_, float* smem_) : p(p_), smem(smem_) {
    d0 = blockIdx.x * CH;
    bi = blockIdx.y;
    ci = blockIdx.z;
    tid = threadIdx.x;
    t_first = ci * p.chunk;
    t_end = min(p.S, t_first + p.chunk);
    nt = (t_end - t_first + T - 1) / T;
    dtg = static_cast<const TIn*>(p.dt) + bi * p.dt_sb + d0;
    xg = static_cast<const TIn*>(p.x) + bi * p.x_sb + d0;
    zg = static_cast<const TIn*>(p.z) + bi * p.z_sb + d0;
    og = static_cast<const TIn*>(p.dout) + bi * p.do_sb + d0;
    bg = static_cast<const TIn*>(p.b) + bi * p.b_sb;
    cg_ = static_cast<const TIn*>(p.c) + bi * p.c_sb;
  }

  // 0 dt, 1 x, 2 z, 3 dout, 4 b, 5 c of raw buffer buf
  __device__ TIn* raw(int buf, int which) const {
    TIn* base = reinterpret_cast<TIn*>(smem + buf * C::RAW);
    return which < 4 ? base + which * T * CH
                     : base + 4 * T * CH + (which - 4) * T * N;
  }

  // rows t0 .. t0+T-1 of a (rows, W) operand by 16-byte cp.async copies;
  // rows past S zero-filled without a read
  template <int W>
  __device__ void stage_rows(TIn* dst, const TIn* src, int64_t ss,
                             int t0) const {
    constexpr int V = C::V, CPR = W / V;
#pragma unroll
    for (int r = 0; r < (T * CPR + NT - 1) / NT; ++r) {
      const int i = tid + r * NT, t = i / CPR, c = i % CPR * V;
      if (T * CPR % NT != 0 && i >= T * CPR) break;
      const bool ok = t0 + t < p.S;
      cp_async16(dst + t * W + c, ok ? src + (t0 + t) * ss + c : src, ok);
    }
  }

  // the tile at t0 into raw buffer buf (not committed)
  __device__ void stage(int buf, int t0) const {
    stage_rows<CH>(raw(buf, 0), dtg, p.dt_ss, t0);
    stage_rows<CH>(raw(buf, 1), xg, p.x_ss, t0);
    stage_rows<CH>(raw(buf, 2), zg, p.z_ss, t0);
    stage_rows<CH>(raw(buf, 3), og, p.do_ss, t0);
    stage_rows<N>(raw(buf, 4), bg, p.b_ss, t0);
    stage_rows<N>(raw(buf, 5), cg_, p.c_ss, t0);
  }

  // the bias, the skip and a of the block's channels
  __device__ void constants() const {
    float* sBias = smem + C::OFF_BIAS;
    float* sSkip = smem + C::OFF_SKIP;
    float* sA = smem + C::OFF_A;
    for (int i = tid; i < CH; i += NT) {
      sBias[i] = p.dt_bias[d0 + i];
      sSkip[i] = p.d_skip[d0 + i];
    }
    for (int i = tid; i < CH * N; i += NT)
      sA[i] = -expf(p.a_log[(int64_t)d0 * N + i]);
  }

  // raw buffer buf of the tile at t0 converted: dt's bias and softplus, u
  // = dt x and dy; b and c as fp32 rows; four elements a thread at a time
  __device__ void convert(int buf, int t0) const {
    float* sDt = smem + C::OFF_DT;
    float* sU = smem + C::OFF_U;
    float* sDy = smem + C::OFF_DY;
    const float* sBias = smem + C::OFF_BIAS;
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
      load4(rz + t * CH + c0, zv);
      load4(ro + t * CH + c0, ov);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dtv =
            live ? softplus(__fadd_rn(dv[e], sBias[c0 + e])) : 0.f;
        sDt[(c0 + e) * T + perm(t)] = dtv;
        sU[(c0 + e) * T + perm(t)] = __fmul_rn(dtv, xv[e]);
        sDy[(c0 + e) * T + perm(t)] =
            live ? rnd(ov[e] * silu_t<TIn>(zv[e]), TIn()) : 0.f;
      }
    }
#pragma unroll
    for (int w = 0; w < 2; ++w) {
#pragma unroll
      for (int r = 0; r < (T * N / 4 + NT - 1) / NT; ++r) {
        const int i = tid + r * NT, j0 = i / T * 4, t = i % T;
        if (T * N / 4 % NT != 0 && i >= T * N / 4) break;
        float v[4];
        load4(raw(buf, 4 + w) + t * N + j0, v);
        float* dst = smem + (w == 0 ? C::OFF_B : C::OFF_C) + perm(t);
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(j0 + e) * T] = v[e];
      }
    }
  }
};

// ------------------------------------------------------------ 1. chunk
// The forward pass over the chunk from its kept start state, keeping the
// state at every tile's start, and the adjoint's composition over the
// chunk: E_start = F E_end + H, tile by tile (H += F Q_tile, F *= P_tile).
template <typename TIn, int N>
__global__ void __launch_bounds__(NT, 4)
    mamba_scan_bwd_chunk_kernel(const BwdParams p) {
  using C = Shape<TIn, N>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Walk<TIn, N> wk(p, smem);
  const float* sDt = smem + C::OFF_DT;
  const float* sU = smem + C::OFF_U;
  const float* sDy = smem + C::OFF_DY;
  const float* sB = smem + C::OFF_B;
  const float* sC = smem + C::OFF_C;
  const float* sA = smem + C::OFF_A;
  float* sH = smem + C::OFF_OWN;          // two buffers of the tile state
  float* sF = sH + 2 * CH * N;
  float* sQ = sF + CH * N;
  const int tid = threadIdx.x, lane = tid % 32, l = lane % L;
  const int g = lane / L % G;
  const int ch = (tid / 32) * (32 / (L * G)) + lane / (L * G);
  const int64_t cn = (int64_t)p.di * N;   // a (batch row, chunk)'s states

  wk.constants();
  {
    const float* st = p.starts + ((int64_t)wk.bi * p.NC + wk.ci) * cn +
                      (int64_t)wk.d0 * N;
    for (int i = tid; i < CH * N; i += NT) {
      sH[i] = st[i];
      sF[i] = 1.f;
      sQ[i] = 0.f;
    }
  }
  wk.stage(0, wk.t_first);
  cp_async_commit();
  for (int k = 0; k < wk.nt; ++k) {
    const int t0 = wk.t_first + k * T, buf = k & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile k landed; tile k-1's reads are done
    if (k + 1 < wk.nt) wk.stage(buf ^ 1, t0 + T);
    cp_async_commit();
    wk.convert(buf, t0);
    __syncthreads();

    float dtv[R], uv[R], dyv[R];
    load_steps(sDt + ch * T, l, dtv);
    load_steps(sU + ch * T, l, uv);
    load_steps(sDy + ch * T, l, dyv);
    const float* h_in = sH + buf * CH * N;
    float* h_out = sH + (buf ^ 1) * CH * N;
    float* tile = p.tiles + ((int64_t)wk.bi * p.NTILE + t0 / T) * cn +
                  (int64_t)wk.d0 * N;
#pragma unroll 1
    for (int j = g * C::NS; j < (g + 1) * C::NS; ++j) {
      const float aj = sA[ch * N + j];
      float bq[R], cq[R], A[R];
      load_steps(sB + j * T, l, bq);
      load_steps(sC + j * T, l, cq);
      // this lane's steps composed: forward (Af, Uf), and the adjoint
      // backward from its last step, E_first = Af E_after + Qb
      float Af = 1.f, Uf = 0.f, Qb = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        A[i] = expf(__fmul_rn(dtv[i], aj));
        Uf = fmaf(A[i], Uf, __fmul_rn(uv[i], bq[i]));
        Af *= A[i];
      }
#pragma unroll
      for (int i = R - 1; i >= 0; --i) Qb = A[i] * fmaf(dyv[i], cq[i], Qb);
      // inclusive scans over the L lanes: lanes 0..l forwards, lanes
      // l..L-1 backwards; out-of-range lanes compose with (1, 0)
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
      const float h_tile = h_in[ch * N + j];
      const float h_end = __shfl_sync(FULL, fmaf(Ac, h_tile, Uc), L - 1, L);
      if (l == 0) {
        tile[ch * N + j] = h_tile;
        h_out[ch * N + j] = h_end;
        // lane 0 holds the tile's whole adjoint composition (Pr, Qr)
        const float f = sF[ch * N + j];
        sQ[ch * N + j] = fmaf(f, Qr, sQ[ch * N + j]);
        sF[ch * N + j] = f * Pr;
      }
    }
  }
  __syncthreads();
  const int64_t at = ((int64_t)wk.bi * p.NC + wk.ci) * cn +
                     (int64_t)wk.d0 * N;
  const int64_t half = (int64_t)p.B * p.NC * cn;
  for (int i = tid; i < CH * N; i += NT) {
    p.fh[at + i] = sF[i];
    p.fh[half + at + i] = sQ[i];
  }
}

// ----------------------------------------------------------------- 2. carry
__global__ void __launch_bounds__(256)
    mamba_scan_bwd_carry_kernel(const BwdParams p, int n) {
  const int64_t per = (int64_t)p.di * n;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.B * per) return;
  const int64_t b = idx / per, rem = idx % per;
  const int64_t half = (int64_t)p.B * p.NC * per;
  float e = p.dh ? p.dh[idx] : 0.f;
  for (int c = p.NC - 1; c >= 0; --c) {
    const int64_t at = (b * p.NC + c) * per + rem;
    const float h = p.fh[half + at];
    p.fh[half + at] = e;
    e = fmaf(p.fh[at], e, h);
  }
}

// ----------------------------------------------------------------- 3. grads
template <typename TIn, int N>
__global__ void __launch_bounds__(NT, 3)
    mamba_scan_bwd_kernel(const BwdParams p) {
  using C = Shape<TIn, N>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Walk<TIn, N> wk(p, smem);
  const float* sDt = smem + C::OFF_DT;
  const float* sU = smem + C::OFF_U;
  const float* sDy = smem + C::OFF_DY;
  const float* sB = smem + C::OFF_B;
  const float* sC = smem + C::OFF_C;
  const float* sBias = smem + C::OFF_BIAS;
  const float* sSkip = smem + C::OFF_SKIP;
  const float* sA = smem + C::OFF_A;
  float* sY = smem + C::OFF_Y;     // y summed over the states (no skip)
  float* sAW = smem + C::OFF_AW;   // sum_j w a
  float* sGB = smem + C::OFF_GB;   // sum_j G b
  float* sDB = smem + C::OFF_DB;   // db of the tile, a warp's two channels
  float* sDC = smem + C::OFF_DC;
  float* sDa = smem + C::OFF_DA;   // d a: sum over steps of w dt
  float* sE = smem + C::OFF_E;     // two buffers of the adjoint carry
  float* sHs = smem + C::OFF_HS;   // two buffers of the tile's start state
  float* sSum = smem + C::OFF_B;   // db, dc of the tile [t][j], a block's

  const int bi = wk.bi, d0 = wk.d0, tid = threadIdx.x;
  const int lane = tid % 32, l = lane % L, g = lane / L % G;
  const int ch = (tid / 32) * (32 / (L * G)) + lane / (L * G);
  const int64_t cn = (int64_t)p.di * N;
  const int rank = blockIdx.x % p.CS, share = T * N / p.CS;
  cg::cluster_group cluster = cg::this_cluster();

  // the tile state of job k into buffer buf (not committed)
  auto stage_state = [&](int buf, int k) {
    const int tt = wk.nt - 1 - k;
    const float* src = p.tiles + ((int64_t)bi * p.NTILE +
                                  (wk.t_first + tt * T) / T) * cn +
                       (int64_t)d0 * N;
    for (int i = tid; i < CH * N / 4; i += NT)
      cp_async16(sHs + buf * CH * N + 4 * i, src + 4 * i);
  };

  wk.constants();
  {
    const float* e_end = p.fh + (int64_t)p.B * p.NC * cn +
                         ((int64_t)bi * p.NC + wk.ci) * cn +
                         (int64_t)d0 * N;
    for (int i = tid; i < CH * N; i += NT) {
      sDa[i] = 0.f;
      sE[i] = e_end[i];
    }
  }
  // this thread's epilogue columns: channels c0 .. c0+3 (fixed: NT is a
  // multiple of CH / 4), their d_skip and dt_bias sums
  float skip_acc[4] = {0.f, 0.f, 0.f, 0.f}, bias_acc[4] = {0.f, 0.f, 0.f,
                                                          0.f};
  int e_buf = 0;  // the adjoint carry's read buffer

  wk.stage(0, wk.t_first + (wk.nt - 1) * T);
  stage_state(0, 0);
  cp_async_commit();
  for (int k = 0; k < wk.nt; ++k) {
    const int buf = k & 1, tt = wk.nt - 1 - k;
    const int t0 = wk.t_first + tt * T;
    cp_async_wait<0>();
    __syncthreads();  // job k landed; job k-1's epilogue is done
    if (k + 1 < wk.nt) {
      wk.stage(buf ^ 1, t0 - T);
      stage_state(buf ^ 1, k + 1);
    }
    cp_async_commit();
    // the cluster's ranks have read this block's db/dc sums of the last
    // tile, which lie where the conversion writes b and c
    if (k > 0) cluster_wait();
    wk.convert(buf, t0);
    __syncthreads();

    // backward pass over the tile
    float dtv[R], uv[R], dyv[R], yv[R], aw[R], gb[R];
    load_steps(sDt + ch * T, l, dtv);
    load_steps(sU + ch * T, l, uv);
    load_steps(sDy + ch * T, l, dyv);
#pragma unroll
    for (int i = 0; i < R; ++i) yv[i] = aw[i] = gb[i] = 0.f;
    const float* hs = sHs + buf * CH * N;
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
    // db and dc of the tile summed over the block's warps, in warp order,
    // [t][j] where b's and c's rows were (read no more in this tile)
    for (int i = tid; i < T * N; i += NT) {
      const int at = (i % N) * C::LB + perm(i / N);
      float db = 0.f, dc = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        db += sDB[w * N * C::LB + at];
        dc += sDC[w * N * C::LB + at];
      }
      sSum[i] = db;
      sSum[T * N + i] = dc;
    }
    __syncthreads();
    cluster_arrive();  // this block's db/dc sums of the tile are written

    // epilogue: the gating's, the skip's and the softplus's gradients,
    // four elements a thread at a time, dt and dy from their converted
    // rows
    {
      const TIn* rdt = wk.raw(buf, 0);
      const TIn* rx = wk.raw(buf, 1);
      const TIn* rz = wk.raw(buf, 2);
      const TIn* ro = wk.raw(buf, 3);
      TIn* gdt = static_cast<TIn*>(p.d_dt) + (int64_t)bi * p.S * p.di + d0;
      TIn* gx = static_cast<TIn*>(p.d_x) + (int64_t)bi * p.S * p.di + d0;
      TIn* gz = static_cast<TIn*>(p.d_z) + (int64_t)bi * p.S * p.di + d0;
#pragma unroll
      for (int r = 0; r < (T * CH / 4 + NT - 1) / NT; ++r) {
        const int i = tid + r * NT, t = i / (CH / 4), c0 = i % (CH / 4) * 4;
        if (T * CH / 4 % NT != 0 && i >= T * CH / 4) break;
        if (t0 + t >= p.S) continue;
        float dv[4], xv[4], zv[4], ov[4], odt[4], ox[4], oz[4];
        load4(rdt + t * CH + c0, dv);
        load4(rx + t * CH + c0, xv);
        load4(rz + t * CH + c0, zv);
        load4(ro + t * CH + c0, ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = t * C::LY + c0 + e;
          const float v = __fadd_rn(dv[e], sBias[c0 + e]);
          const float dtv = sDt[(c0 + e) * T + perm(t)];
          const float y = __fadd_rn(sY[at], __fmul_rn(sSkip[c0 + e], xv[e]));
          const float dy = sDy[(c0 + e) * T + perm(t)];
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
    }
    // db and dc of the tile: this rank's share of the (step, state)
    // elements, four at a time, summed over the cluster's ranks in rank
    // order, into the cluster's partial
    cluster_wait();
    {
      const int64_t part = ((int64_t)(blockIdx.x / p.CS) * p.B + bi) *
                               p.S + t0;
      for (int v = tid; v < 2 * share / 4; v += NT) {
        const int which = v / (share / 4);
        const int i = rank * share + 4 * (v % (share / 4));
        if (t0 + i / N >= p.S) continue;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < p.CS; ++q) {
          const float4 r = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(sSum + which * T * N + i, q));
          s.x += r.x; s.y += r.y; s.z += r.z; s.w += r.w;
        }
        *reinterpret_cast<float4*>((which ? p.part_c : p.part_b) +
                                   part * N + i) = s;
      }
    }
    cluster_arrive();  // this rank is done reading the others' sums
  }

  // per (batch row, chunk): d a_log = a sum(w dt); d_skip and dt_bias by
  // this thread's columns c0..c0+3, summed over the block's threads in
  // thread order through the raw buffers, idle now
  __syncthreads();  // the last job's epilogue is done with them
  float* sRed = smem;  // NT x 8: each thread's skip and bias sums
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sRed[tid * 8 + e] = skip_acc[e];
    sRed[tid * 8 + 4 + e] = bias_acc[e];
  }
  __syncthreads();
  const int64_t pc = (int64_t)bi * p.NC + wk.ci;
  for (int i = tid; i < CH * N; i += NT)
    p.p_alog[pc * cn + (int64_t)d0 * N + i] = sDa[i] * sA[i];
  if (tid < CH) {
    // the threads whose columns hold channel tid: tid / 4 + k CH / 4
    float skip = 0.f, bias = 0.f;
    for (int t = tid / 4; t < NT; t += CH / 4) {
      skip += sRed[t * 8 + tid % 4];
      bias += sRed[t * 8 + 4 + tid % 4];
    }
    p.p_skip[pc * p.di + d0 + tid] = skip;
    p.p_bias[pc * p.di + d0 + tid] = bias;
  }
  cluster_wait();  // no rank reads this block's shared memory any more
}

// db and dc: the clusters' partials summed in order, four (step, state)
// elements a thread, written in the model's dtype
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

// the cluster size for `blocks` channel blocks: the largest of 8, 4, 2, 1
// that divides it
int cluster_size(int blocks) {
  for (int cs = 8; cs > 1; cs /= 2)
    if (blocks % cs == 0) return cs;
  return 1;
}

template <typename TIn, int N>
int launch(BwdParams p, int B, cudaStream_t stream) {
  using C = Shape<TIn, N>;
  constexpr int chunk_bytes = C::CHUNK_FLOATS * 4;
  constexpr int grads_bytes = C::GRADS_FLOATS * 4;
  static const int attr = [] {
    const int e = cudaFuncSetAttribute(
        mamba_scan_bwd_chunk_kernel<TIn, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, chunk_bytes);
    return e ? e
             : cudaFuncSetAttribute(
                   mamba_scan_bwd_kernel<TIn, N>,
                   cudaFuncAttributeMaxDynamicSharedMemorySize, grads_bytes);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.di / CH, B, p.NC);
  mamba_scan_bwd_chunk_kernel<TIn, N><<<grid, NT, chunk_bytes, stream>>>(p);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t cells = (int64_t)B * p.di * N;
  mamba_scan_bwd_carry_kernel<<<static_cast<unsigned>((cells + 255) / 256),
                                256, 0, stream>>>(p, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = grads_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cl[1];
  cl[0].id = cudaLaunchAttributeClusterDimension;
  cl[0].val.clusterDim.x = p.CS;
  cl[0].val.clusterDim.y = 1;
  cl[0].val.clusterDim.z = 1;
  cfg.attrs = cl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, mamba_scan_bwd_kernel<TIn, N>, p);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t quads = (int64_t)B * p.S * N / 4;
  mamba_scan_bwd_reduce_kernel<TIn>
      <<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(
          p, grid.x / p.CS, quads);
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
// S, n) contiguous in the dtype; p_bias, p_skip (B, chunks, di) and p_alog
// (B, chunks, di, n) fp32, each (batch row, chunk)'s sums. Scratch, fp32:
// part_b, part_c (mamba_scan_bwd_parts(di), B, S, n); tiles (B, ceil(S /
// time tile), di, n); fh (2, B, chunks, di, n). One call launches the
// chunk kernel, the carry, the gradients' kernel (one block per 8
// channels, batch row and chunk, in clusters of mamba_scan_bwd_parts'
// divisor) and the reduction of db and dc. Returns the first CUDA error, 0
// on success.
extern "C" int mamba_scan_bwd_launch(
    const void* dt, const float* dt_bias, const void* b, const void* c,
    const void* x, const void* z, const float* a_log, const float* d_skip,
    const float* starts, const void* dout, const float* dh, void* d_dt,
    void* d_x, void* d_z, float* part_b, float* part_c, void* d_b,
    void* d_c, float* p_bias, float* p_skip, float* p_alog, float* tiles,
    float* fh, const int64_t* strides, int dtype, int B, int S, int di,
    int n, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || di % CH || chunk <= 0 || chunk % T)
    return cudaErrorInvalidValue;
  BwdParams p;
  p.dt = dt; p.dt_bias = dt_bias; p.b = b; p.c = c; p.x = x; p.z = z;
  p.a_log = a_log; p.d_skip = d_skip; p.starts = starts; p.dout = dout;
  p.dh = dh; p.d_dt = d_dt; p.d_x = d_x; p.d_z = d_z;
  p.part_b = part_b; p.part_c = part_c; p.d_b = d_b; p.d_c = d_c;
  p.p_bias = p_bias; p.p_skip = p_skip; p.p_alog = p_alog;
  p.tiles = tiles; p.fh = fh;
  p.dt_sb = strides[0]; p.dt_ss = strides[1];
  p.b_sb = strides[2]; p.b_ss = strides[3];
  p.c_sb = strides[4]; p.c_ss = strides[5];
  p.x_sb = strides[6]; p.x_ss = strides[7];
  p.z_sb = strides[8]; p.z_ss = strides[9];
  p.do_sb = strides[10]; p.do_ss = strides[11];
  p.B = B; p.S = S; p.di = di; p.chunk = chunk;
  p.NC = (S + chunk - 1) / chunk;
  p.NTILE = (S + T - 1) / T;
  p.CS = cluster_size(di / CH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32: return launch_n<float>(p, B, n, s);
    case DTYPE_BF16: return launch_n<__nv_bfloat16>(p, B, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// the tile T of the backward's passes: `chunk` must be a multiple of it
extern "C" int mamba_scan_bwd_time_tile() { return T; }

// the db/dc partials for di channels: one per cluster of channel blocks
extern "C" int mamba_scan_bwd_parts(int di) {
  return di / CH / cluster_size(di / CH);
}
