// Mamba selective scan (hymba's SSM heads) for Hopper, sm_90a, fused with
// the elementwise work around it. Inputs in the model's dtype (fp32 or
// bf16) unless named fp32; arithmetic in fp32:
//
//   dt_t[d]  = softplus(dt_raw_t[d] + dt_bias[d])     (F.softplus, threshold 20)
//   a[d][j]  = -exp(a_log[d][j])
//   h[d][j] <- exp(dt_t[d] * a[d][j]) * h[d][j] + (dt_t[d] * x_t[d]) * b_t[j]
//   y_t[d]   = sum_j h[d][j] * c_t[j] + d_skip[d] * x_t[d]
//   out_t[d] = T(T(y_t[d]) * T(silu(z_t[d])))         (T: round to the dtype)
//
// No Pallas kernel stands behind it. JAX computes this in
// repro/models/ssm.py:apply_mamba: the softplus at :198, `step` at :208,
// the lax.scan of the vmemkernel_mamba_scan scope at :217 (XLA compiles it
// into one loop on the device), the skip at :219 and the gating at :220.
// Every rounding point is the port's plain version's (mamba_scan.py); only
// the order in which the prefill body composes the steps, and sums y over
// the states, differs.
//
// What bounds it: bytes. At hymba's serving prefill (B=4, S=4096, di=1600,
// n=16, bf16) it reads dt_raw, x and z and writes out (52.4 MB each), reads
// b and c (1.0 MB) and a_log and the state: ~212 MB, 0.063 ms at the H100
// SXM's 3.35 TB/s, against ~2.9 GFLOP of fp32 work (7 flops per token,
// channel and state; 0.044 ms at 67 TFLOP/s). A decode step (S=1) moves the
// (B, di, n) state in and out. No tensor cores: the decay exp(dt * a[d][j])
// differs from state to state, so y is no product of matrices (Mamba-2's
// SSD needs one scalar decay a head; hymba's Mamba-1 heads have none).
//
// Two bodies behind the one mamba_scan_launch, chosen by S:
//
// Chunked body, S >= T (every prefill). The steps of a channel compose
// associatively: with A = exp(dt * a) and U = (dt * x) * b, step after
// step is (A1, U1) o (A2, U2) = (A2 A1, A2 U1 + U2). A channel's steps run
// in tiles of T = L * R, and its n states in G groups: lane l of the L
// neighbouring lanes of one warp that own a (channel, state group) owns R
// consecutive steps of the tile. For each of its states in turn a lane
// composes its R steps in registers, keeping every prefix (A and U after
// each step), the L lanes compose across by warp shuffles (an inclusive
// scan, log2 L rounds), each lane hands the state after its last step to
// the next lane (one shuffle) and the last lane's to the next tile, and
// each lane then has the state after each of its steps from its start
// state and the prefixes, independently, adding h * c_t[j] into its R
// outputs: y is summed over the states inside the thread, and over the G
// groups by one shuffle a step at the end of the tile. A pass of the state
// loop takes JU states, whose chains interleave; the loop is not unrolled,
// so that its body stays in the instruction cache. The running state of
// every (channel, state) and a = -exp(a_log) stay in shared memory from
// tile to tile. A block owns CH channels of one batch row. dt_raw, x, z,
// b and c of a tile go into shared memory by 16-byte cp.async copies in
// the model's dtype, one tile ahead of the steps; then the block converts
// them once: dt's bias and softplus once per (step, channel), dt * x, and
// b and c as fp32 laid out so that a lane reads 4 of its steps as one
// float4 (a broadcast across the channels, conflict-free across the L
// lanes). y of the tile goes through shared memory to the epilogue, which
// adds the skip term, gates by silu(z) and writes out. Steps past S get
// dt = 0 (A = 1, U = 0), so the carried state is the state at step S-1.
// What holds it (tools/ablate_kernels.py mamba_scan; PERF.md): instruction
// issue, ~21 SASS instructions a (step, channel, state) in the scan loop,
// 8 of them the exact expf, beside the staging, softplus and epilogue;
// taking out any one part saves at most 15 %.
//
// Token body, S < T (every decode step, and a prompt shorter than a tile):
// the chunked form has nothing to batch, and a step is bytes: it reads and
// writes the (B, di, n) fp32 state, 0.82 of the 0.98 MB a decode step
// moves at hymba's shape (B=4, di=1600, n=16, bf16), and reads a_log. The
// body this one replaced gave a thread a (batch row, channel) with all n
// states: 52 blocks of 128 threads on 132 SMs, each reading its 16 states
// and 16 a_log values one scalar at a time, 64 bytes from its neighbour's,
// into one serial chain of 32 expf a step.
//
// Here a group of N / TSL neighbouring lanes owns a (batch row, channel),
// a lane TSL = 4 consecutive states (4 lanes a channel at n 16, 2 at n 8):
// a warp reads and writes 8 channels' 512 contiguous bytes of the state at
// n 16 as float4s, and a_log alike; hymba's decode runs 25,600 threads,
// 200 blocks of 128. Every load of a launch (the lane's states and a_log,
// dt_raw, x, z, its b and c as one vector each, the bias and the skip) is
// issued before any arithmetic. Each state keeps JAX's step order exactly:
// da = exp(dt * a), h = da * h + (dt * x) * b, each product and the sum
// rounded on its own (__fmul_rn / __fadd_rn: no FMA contraction), expf and
// not __expf, so the state equals the plain loop's bit for bit. Only y's
// order of summation differs: a lane sums its states' h * c, xor shuffles
// sum over the group, and the group's first lane adds the skip term, gates
// by silu(z) and stores out. A step's operands are kept as loaded, in the
// model's dtype, until the step converts them and takes what of it does
// not depend on the state (the softplus, the decays, silu(z)); then the
// next step's loads go out while this one updates the state (S >= 2). A
// plain launch.
//
// What holds it (tools/ablate_kernels.py mamba_scan; PERF.md): at S = 1
// the launch (an empty kernel is two thirds of its time) and one step's
// chain behind the loads; cold, the state's reads too. From S = 2 on each
// step's chain of dependent instructions, the softplus, a decay's expf,
// the update, the shuffles and the gating, which loading further ahead
// does not shorten.

// Training (MambaScanFn's forward, one launch a layer from zeros): given
// `starts`, the chunked body also writes the state it hands from tile to
// tile at the start of every `chunk` steps (JAX's 256-step remat
// boundaries, which the backward reads), whatever S. A chunk edge is a
// tile edge, so the tiles are those of a chain of one launch a chunk, each
// from the last one's state: out, the final state and every start equal
// the chain's bit for bit (where its last chunk, at least T steps long,
// also runs the chunked body).
//
// A given state is read at the start and the final state written back over
// it (no two threads share an element, so in place is safe). Inputs are
// read through their strides (b and c may be the two halves of one
// (B, S, 2n) projection, z the second half of (B, S, 2 di)); rows are
// 16-byte aligned and di is a multiple of 8 (the wrapper checks).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int L = 8;    // chunked body: lanes that share a channel's tile
constexpr int R = 8;    // chunked body: consecutive steps a lane owns
constexpr int T = L * R;  // steps per tile; the chunked body runs for S >= T
constexpr int G = 2;    // chunked body: lane groups that split a channel's states
constexpr int NW = 4;   // chunked body: warps a block
constexpr int CH = NW * 32 / (L * G);  // channels a block
constexpr int NT = 32 * NW;
constexpr int JU = 4;   // chunked body: states a pass of the state loop
// chunked body: blocks an SM must hold (at most 65536 / (7 * 128) = 73
// registers a thread): all 800 blocks of hymba's serving prefill (B=4,
// di=1600) are then resident on the H100's 132 SMs at once, none left for
// a second wave
constexpr int MIN_BLOCKS = 7;
constexpr int TOKEN_NT = 128;  // token body: threads a block
constexpr int TSL = 4;         // token body: states a lane
static_assert(R % 4 == 0 && 32 % (L * G) == 0 && CH % 4 == 0, "tile shape");

struct ScanParams {
  const void* dt;  // dt_raw (B, S, di)
  const float* dt_bias;  // (di)
  const void* b;   // (B, S, n)
  const void* c;
  const void* x;   // (B, S, di)
  const void* z;
  const float* a_log;  // (di, n) contiguous
  const float* d_skip;  // (di)
  void* out;       // (B, S, di)
  float* h;        // (B, di, n), (di, n) contiguous per batch row
  float* starts;   // training: (B, NC, di, n) contiguous, or null
  int64_t dt_sb, dt_ss;  // element strides (batch, step)
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int64_t x_sb, x_ss;
  int64_t z_sb, z_ss;
  int64_t o_sb, o_ss;
  int64_t h_sb;
  int S, di, has_state;
  int chunk;  // training: steps between the starts kept (a multiple of T)
};

// F.softplus with beta 1 and threshold 20, as PyTorch's CUDA kernel does it
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// out = T(T(y) * T(silu(z))): the gating of the plain version, with
// PyTorch's silu z / (1 + exp(-z)) and each rounding to the dtype T; its
// factor T(silu(z)) apart, which the token body takes before y is known
__device__ __forceinline__ float silu(float z, float) {
  return __fdiv_rn(z, __fadd_rn(1.f, expf(-z)));
}
__device__ __forceinline__ float silu(float z, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(silu(z, 0.f)));
}
__device__ __forceinline__ float gated(float y, float g, float) {
  return __fmul_rn(y, g);
}
__device__ __forceinline__ float gated(float y, float g, __nv_bfloat16) {
  return __fmul_rn(__bfloat162float(__float2bfloat16(y)), g);
}
template <typename TIn>
__device__ __forceinline__ float gate(float y, float z, TIn) {
  return gated(y, silu(z, TIn()), TIn());
}

// four neighbouring elements (16 bytes of fp32, 8 of bf16) as floats,
// and back
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

// K neighbouring fp32 values (K of 2, 4 or 8) into registers and back,
// 16 bytes a load or store where K allows
template <int K>
__device__ __forceinline__ void load_k(const float* p, float* v) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int e = 0; e < K; e += 4) load4(p + e, v + e);
  } else {
    static_assert(K == 2, "values a lane");
    const float2 f = load2(p);
    v[0] = f.x;
    v[1] = f.y;
  }
}
template <int K>
__device__ __forceinline__ void store_k(float* p, const float* v) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int e = 0; e < K; e += 4) store4(p + e, v + e);
  } else {
    static_assert(K == 2, "values a lane");
    store2(p, v[0], v[1]);
  }
}

// K neighbouring elements of the model's dtype, as they lie in memory:
// copied by vector loads of up to 16 bytes, converted where used
template <typename TIn, int K>
struct alignas(K * sizeof(TIn) < 16 ? K * sizeof(TIn) : 16) Elems {
  TIn v[K];
};

// ------------------------------------------------------------ token body
template <int N>
struct TokenShape {
  static constexpr int K = TSL < N ? TSL : N;  // states a lane
  static constexpr int LPC = N / K;            // lanes a channel
  static constexpr int CPB = TOKEN_NT / LPC;   // channels a block
  static_assert(N % K == 0 && 32 % LPC == 0, "a channel's lanes in a warp");
};

// a step's operands for one lane as they lie in memory: dt_raw, x and z
// of its channel, b and c of its states
template <typename TIn, int K>
struct ScanStep {
  TIn dt, x, z;
  Elems<TIn, K> b, c;
};

template <typename TIn, int N>
__global__ void __launch_bounds__(TOKEN_NT)
    mamba_scan_token_kernel(const ScanParams p) {
  using C = TokenShape<N>;
  constexpr int K = C::K, LPC = C::LPC;
  const int bi = blockIdx.y, tid = threadIdx.x;
  const int d = blockIdx.x * C::CPB + tid / LPC, j0 = tid % LPC * K;
  // a channel's lanes leave together, so each group's shuffles below name
  // only lanes that run them
  if (d >= p.di) return;
  const unsigned group = ((1u << LPC) - 1u) << (tid % 32 / LPC * LPC);
  float* hg = p.h + bi * p.h_sb + (int64_t)d * N + j0;
  const TIn* dtg = static_cast<const TIn*>(p.dt) + bi * p.dt_sb + d;
  const TIn* xg = static_cast<const TIn*>(p.x) + bi * p.x_sb + d;
  const TIn* zg = static_cast<const TIn*>(p.z) + bi * p.z_sb + d;
  const TIn* bg = static_cast<const TIn*>(p.b) + bi * p.b_sb + j0;
  const TIn* cg = static_cast<const TIn*>(p.c) + bi * p.c_sb + j0;
  TIn* og = static_cast<TIn*>(p.out) + bi * p.o_sb + d;

  // every load of the first step issued before any arithmetic
  float h[K], al[K];
#pragma unroll
  for (int e = 0; e < K; ++e) h[e] = 0.f;
  if (p.has_state) load_k<K>(hg, h);
  load_k<K>(p.a_log + (int64_t)d * N + j0, al);
  auto load = [&](ScanStep<TIn, K>& s, int t) {
    s.dt = dtg[t * p.dt_ss];
    s.x = xg[t * p.x_ss];
    s.z = zg[t * p.z_ss];
    s.b = *reinterpret_cast<const Elems<TIn, K>*>(bg + t * p.b_ss);
    s.c = *reinterpret_cast<const Elems<TIn, K>*>(cg + t * p.c_ss);
  };
  ScanStep<TIn, K> raw;
  load(raw, 0);
  const float bias = p.dt_bias[d], skip = p.d_skip[d];
  float a[K];
#pragma unroll
  for (int e = 0; e < K; ++e) a[e] = -expf(al[e]);

#pragma unroll 1
  for (int t = 0; t < p.S; ++t) {
    // step t's operands into fp32, its softplus, decays and silu(z); then
    // the next step's loads go out while this one updates the state
    const float dt = softplus(__fadd_rn(to_float(raw.dt), bias));
    const float xv = to_float(raw.x), g = silu(to_float(raw.z), TIn());
    const float dtx = __fmul_rn(dt, xv);
    float da[K], bv[K], cv[K];
#pragma unroll
    for (int e = 0; e < K; ++e) {
      da[e] = expf(__fmul_rn(dt, a[e]));
      bv[e] = to_float(raw.b.v[e]);
      cv[e] = to_float(raw.c.v[e]);
    }
    if (t + 1 < p.S) load(raw, t + 1);
    float y = 0.f;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      h[e] = __fadd_rn(__fmul_rn(da[e], h[e]), __fmul_rn(dtx, bv[e]));
      y = fmaf(h[e], cv[e], y);
    }
#pragma unroll
    for (int o = 1; o < LPC; o <<= 1) y += __shfl_xor_sync(group, y, o);
    if (j0 == 0)
      from_float(og + t * p.o_ss,
                 gated(__fadd_rn(y, __fmul_rn(skip, xv)), g, TIn()));
  }
  store_k<K>(hg, h);
}

// ---------------------------------------------------------- chunked body
// a tile's step t = l * R + 4 q + e sits at q * 4L + 4 l + e of a (channel
// or state) row of T floats: lane l's steps 4q..4q+3 are one float4, and
// the L lanes' float4s of one q are neighbours
__device__ __forceinline__ int perm(int t) {
  return ((t % R) / 4) * (4 * L) + (t / R) * 4 + t % 4;
}

template <typename TIn, int N>
struct ChunkShape {
  static constexpr int V = Vec<TIn>::N;  // elements a 16-byte vector
  static constexpr int NS = N / G;       // states a lane
  static_assert(CH % V == 0 && N % V == 0, "vector shape");
  static_assert(NS % JU == 0, "state passes");
  // shared memory, in floats: the raw tiles (two buffers of dt, x, z as
  // T x CH and b, c as T x N, in the model's dtype), then dt and dt * x
  // (CH x T), b and c (N x T), y (T x CH + 4), the bias and the skip, a
  // (CH x N) and two buffers of the carried state (CH x N): a tile reads
  // one and writes the other
  static constexpr int RAW = (3 * T * CH + 2 * T * N) * sizeof(TIn) / 4;
  static constexpr int FLOATS = 2 * RAW + 2 * CH * T + 2 * N * T +
                                T * (CH + 4) + 2 * CH + 3 * CH * N;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename TIn, int N>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    mamba_scan_chunked_kernel(const ScanParams p) {
  using C = ChunkShape<TIn, N>;
  constexpr int V = C::V;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sDt = smem + 2 * C::RAW;
  float* sDtx = sDt + CH * T;
  float* sB = sDtx + CH * T;
  float* sC = sB + N * T;
  float* sY = sC + N * T;
  float* sBias = sY + T * (CH + 4);
  float* sSkip = sBias + CH;
  float* sA = sSkip + CH;       // a[ch][j]
  float* sH = sA + CH * N;      // the state carried from tile to tile

  // a lane owns time part l of state group g of channel ch; the L lanes of
  // a (channel, group) are neighbours, the G groups of a channel next to
  // each other
  const int bi = blockIdx.y, d0 = blockIdx.x * CH, tid = threadIdx.x;
  const int lane = tid % 32, l = lane % L, g = lane / L % G;
  const int ch = (tid / 32) * (32 / (L * G)) + lane / (L * G);
  const TIn* dtg = static_cast<const TIn*>(p.dt) + bi * p.dt_sb + d0;
  const TIn* xg = static_cast<const TIn*>(p.x) + bi * p.x_sb + d0;
  const TIn* zg = static_cast<const TIn*>(p.z) + bi * p.z_sb + d0;
  const TIn* bg = static_cast<const TIn*>(p.b) + bi * p.b_sb;
  const TIn* cg = static_cast<const TIn*>(p.c) + bi * p.c_sb;
  TIn* og = static_cast<TIn*>(p.out) + bi * p.o_sb + d0;

  auto raw = [&](int buf, int which) {  // 0 dt, 1 x, 2 z, 3 b, 4 c
    TIn* base = reinterpret_cast<TIn*>(smem + buf * C::RAW);
    return which < 3 ? base + which * T * CH
                     : base + 3 * T * CH + (which - 3) * T * N;
  };
  // rows t0 .. t0+T-1 of a (rows, W) operand, W elements a row, by
  // 16-byte cp.async copies; rows past S and columns past `cols` are
  // zero-filled without a read
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
  // the tile from step t0 into buffer buf
  auto stage = [&](int buf, int t0) {
    using Wc = std::integral_constant<int, CH>;
    using Wn = std::integral_constant<int, N>;
    stage_rows(Wc(), raw(buf, 0), dtg, p.dt_ss, t0, p.di - d0);
    stage_rows(Wc(), raw(buf, 1), xg, p.x_ss, t0, p.di - d0);
    stage_rows(Wc(), raw(buf, 2), zg, p.z_ss, t0, p.di - d0);
    stage_rows(Wn(), raw(buf, 3), bg, p.b_ss, t0, N);
    stage_rows(Wn(), raw(buf, 4), cg, p.c_ss, t0, N);
    cp_async_commit();
  };

  for (int i = tid; i < CH; i += NT) {
    sBias[i] = d0 + i < p.di ? p.dt_bias[d0 + i] : 0.f;
    sSkip[i] = d0 + i < p.di ? p.d_skip[d0 + i] : 0.f;
  }
  float* hg = p.h + bi * p.h_sb + (int64_t)d0 * N;
  for (int i = tid; i < CH * N; i += NT) {
    const bool ok = d0 + i / N < p.di;
    sA[i] = ok ? -expf(p.a_log[(int64_t)d0 * N + i]) : 0.f;
    sH[i] = ok && p.has_state ? hg[i] : 0.f;
  }

  const int ntiles = (p.S + T - 1) / T;
  stage(0, 0);
  for (int k = 0; k < ntiles; ++k) {
    const int t0 = k * T, buf = k & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile k landed; tile k-1's epilogue is done
    if (k + 1 < ntiles) stage(buf ^ 1, t0 + T);  // in flight under tile k
    if (p.starts && t0 % p.chunk == 0) {
      // training: the state at this chunk's start, as tile k-1 left it
      const int nc = (p.S + p.chunk - 1) / p.chunk;
      float* st = p.starts +
                  ((int64_t)bi * nc + t0 / p.chunk) * p.di * N +
                  (int64_t)d0 * N;
      for (int i = tid; i < CH * N; i += NT)
        if (d0 + i / N < p.di) st[i] = sH[buf * CH * N + i];
    }

    // convert: dt's bias and softplus, dt * x, b and c, into fp32 rows;
    // four elements a thread at a time
    {
      const TIn* rdt = raw(buf, 0);
      const TIn* rx = raw(buf, 1);
#pragma unroll
      for (int r = 0; r < (T * CH / 4 + NT - 1) / NT; ++r) {
        const int i = tid + r * NT, t = i / (CH / 4), c0 = i % (CH / 4) * 4;
        if (T * CH / 4 % NT != 0 && i >= T * CH / 4) break;
        float dv[4], xv[4];
        load4(rdt + t * CH + c0, dv);
        load4(rx + t * CH + c0, xv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dtv = t0 + t < p.S
                                ? softplus(__fadd_rn(dv[e], sBias[c0 + e]))
                                : 0.f;
          sDt[(c0 + e) * T + perm(t)] = dtv;
          sDtx[(c0 + e) * T + perm(t)] = __fmul_rn(dtv, xv[e]);
        }
      }
      // steps fastest: neighbouring threads store to neighbouring banks
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int r = 0; r < (T * N / 4 + NT - 1) / NT; ++r) {
          const int i = tid + r * NT, j0 = i / T * 4, t = i % T;
          if (T * N / 4 % NT != 0 && i >= T * N / 4) break;
          float v[4];
          load4(raw(buf, 3 + w) + t * N + j0, v);
          float* dst = (w == 0 ? sB : sC) + perm(t);
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[(j0 + e) * T] = v[e];
        }
    }
    __syncthreads();

    // the scan: lane l's steps l*R .. l*R+R-1 of channel ch
    {
      const float* hin = sH + buf * CH * N;
      float* hout = sH + (buf ^ 1) * CH * N;
      float dtv[R], dtx[R], y[R];
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            sDt + ch * T + q * 4 * L + 4 * l);
        const float4 w = *reinterpret_cast<const float4*>(
            sDtx + ch * T + q * 4 * L + 4 * l);
        dtv[4 * q] = v.x; dtv[4 * q + 1] = v.y;
        dtv[4 * q + 2] = v.z; dtv[4 * q + 3] = v.w;
        dtx[4 * q] = w.x; dtx[4 * q + 1] = w.y;
        dtx[4 * q + 2] = w.z; dtx[4 * q + 3] = w.w;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) y[i] = 0.f;
      // this lane's NS states, JU a pass; a loop and not unrolled, so that
      // its body stays in the instruction cache
#pragma unroll 1
      for (int j0 = g * C::NS; j0 < (g + 1) * C::NS; j0 += JU) {
#pragma unroll
        for (int jj = 0; jj < JU; ++jj) {
          const int j = j0 + jj;
          const float aj = sA[ch * N + j], carry = hin[ch * N + j];
          // this lane's steps composed from its first: the state after
          // step i is Ac[i] h0 + Uc[i] for a start state h0
          float Ac[R], Uc[R];
#pragma unroll
          for (int q = 0; q < R / 4; ++q) {
            const float4 bv = *reinterpret_cast<const float4*>(
                sB + j * T + q * 4 * L + 4 * l);
            const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * q + e;
              const float da = expf(__fmul_rn(dtv[i], aj));
              const float u = __fmul_rn(dtx[i], bq[e]);
              Ac[i] = i ? Ac[i - 1] * da : da;
              Uc[i] = i ? fmaf(da, Uc[i - 1], u) : u;
            }
          }
          // inclusive scan over the L lanes: lane l gets lanes 0..l composed
          float A = Ac[R - 1], U = Uc[R - 1];
#pragma unroll
          for (int o = 1; o < L; o <<= 1) {
            // lanes below o compose with the identity (1, 0), exactly
            const float Ap = __shfl_up_sync(0xffffffffu, A, o, L);
            const float Up = __shfl_up_sync(0xffffffffu, U, o, L);
            U = fmaf(A, l >= o ? Up : 0.f, U);
            A *= l >= o ? Ap : 1.f;
          }
          // the state after this lane's last step; the lane before hands
          // its own over as this lane's start, the last lane the next tile's
          const float h_end = fmaf(A, carry, U);
          const float h_prev = __shfl_up_sync(0xffffffffu, h_end, 1, L);
          const float h_last = __shfl_sync(0xffffffffu, h_end, L - 1, L);
          const float h0 = l == 0 ? carry : h_prev;
          if (l == 0) hout[ch * N + j] = h_last;
#pragma unroll
          for (int q = 0; q < R / 4; ++q) {
            const float4 cv = *reinterpret_cast<const float4*>(
                sC + j * T + q * 4 * L + 4 * l);
            const float cq[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 4 * q + e;
              y[i] = fmaf(fmaf(Ac[i], h0, Uc[i]), cq[e], y[i]);
            }
          }
        }
      }
      // y over the G state groups of the channel
#pragma unroll
      for (int o = L; o < L * G; o <<= 1)
#pragma unroll
        for (int i = 0; i < R; ++i)
          y[i] += __shfl_xor_sync(0xffffffffu, y[i], o);
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) sY[(l * R + i) * (CH + 4) + ch] = y[i];
      }
    }
    __syncthreads();

    // epilogue: the skip term and the gating, four elements of out a
    // thread at a time
    {
      const TIn* rx = raw(buf, 1);
      const TIn* rz = raw(buf, 2);
#pragma unroll
      for (int r = 0; r < (T * CH / 4 + NT - 1) / NT; ++r) {
        const int i = tid + r * NT, t = i / (CH / 4), c0 = i % (CH / 4) * 4;
        if (T * CH / 4 % NT != 0 && i >= T * CH / 4) break;
        if (t0 + t >= p.S || d0 + c0 >= p.di) continue;
        float xv[4], zv[4], o[4];
        load4(rx + t * CH + c0, xv);
        load4(rz + t * CH + c0, zv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float yv = __fadd_rn(sY[t * (CH + 4) + c0 + e],
                                     __fmul_rn(sSkip[c0 + e], xv[e]));
          o[e] = gate(yv, zv[e], TIn());
        }
        store4(og + (t0 + t) * p.o_ss + c0, o);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < CH * N; i += NT)
    if (d0 + i / N < p.di) hg[i] = sH[(ntiles & 1) * CH * N + i];
}

template <typename TIn, int N>
int launch(const ScanParams& p, int B, cudaStream_t stream) {
  if (p.S < T && !p.starts) {
    constexpr int cpb = TokenShape<N>::CPB;
    const dim3 grid((p.di + cpb - 1) / cpb, B);
    mamba_scan_token_kernel<TIn, N><<<grid, TOKEN_NT, 0, stream>>>(p);
    return cudaGetLastError();
  }
  constexpr int bytes = ChunkShape<TIn, N>::BYTES;
  // the largest carveout, so that shared memory never limits the blocks an
  // SM holds (all of the serving prefill's are resident at once)
  static const int attr = [] {
    const int e = cudaFuncSetAttribute(
        mamba_scan_chunked_kernel<TIn, N>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return e ? e
             : cudaFuncSetAttribute(
                   mamba_scan_chunked_kernel<TIn, N>,
                   cudaFuncAttributePreferredSharedMemoryCarveout,
                   cudaSharedmemCarveoutMaxShared);
  }();
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.di + CH - 1) / CH, B);
  mamba_scan_chunked_kernel<TIn, N><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename TIn>
int launch_n(const ScanParams& p, int B, int n, cudaStream_t stream) {
  switch (n) {
    case 8: return launch<TIn, 8>(p, B, stream);
    case 16: return launch<TIn, 16>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dt (dt_raw), b, c, x, z and out in one dtype (`dtype`: DTYPE_F32 or
// DTYPE_BF16), each given by its data pointer and element strides (batch,
// step) in `strides` (dt, b, c, x, z, out, then the batch stride of h); the
// last dim of each is contiguous and its rows 16-byte aligned. dt, x, z and
// out: (B, S, di); b, c: (B, S, n). dt_bias, d_skip (di) and a_log (di, n)
// fp32 contiguous. h: (B, di, n) fp32, its (di, n) block contiguous;
// has_state = 0 starts from zero without reading it, and the final state
// is written into h either way. n is 8 or 16, di a multiple of 8.
// `starts` (training; null: none): (B, ceil(S / chunk), di, n) fp32
// contiguous, gets the state at the start of every `chunk` steps (a
// multiple of mamba_scan_time_tile(), so every chunk edge is a tile edge),
// the start state first; the call then runs the chunked body at any S. One
// call is one launch: the chunked body for S >= mamba_scan_time_tile() or
// with starts, the token body otherwise. Returns cudaGetLastError() after
// it.
extern "C" int mamba_scan_launch(const void* dt, const float* dt_bias,
                                 const void* b, const void* c, const void* x,
                                 const void* z, const float* a_log,
                                 const float* d_skip, void* out, float* h,
                                 int has_state, float* starts, int chunk,
                                 const int64_t* strides, int dtype, int B,
                                 int S, int di, int n, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0 || di % 8 ||
      (starts && (chunk <= 0 || chunk % T)))
    return cudaErrorInvalidValue;
  ScanParams p;
  p.dt = dt; p.dt_bias = dt_bias; p.b = b; p.c = c; p.x = x; p.z = z;
  p.a_log = a_log; p.d_skip = d_skip; p.out = out; p.h = h;
  p.starts = starts; p.chunk = chunk;
  p.dt_sb = strides[0]; p.dt_ss = strides[1];
  p.b_sb = strides[2]; p.b_ss = strides[3];
  p.c_sb = strides[4]; p.c_ss = strides[5];
  p.x_sb = strides[6]; p.x_ss = strides[7];
  p.z_sb = strides[8]; p.z_ss = strides[9];
  p.o_sb = strides[10]; p.o_ss = strides[11];
  p.h_sb = strides[12];
  p.S = S; p.di = di; p.has_state = has_state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32: return launch_n<float>(p, B, n, s);
    case DTYPE_BF16: return launch_n<__nv_bfloat16>(p, B, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// the chunked body's tile T: mamba_scan_launch takes it for S >= this, and
// its tile edges are at multiples of it
extern "C" int mamba_scan_time_tile() { return T; }
