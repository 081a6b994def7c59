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
// What bounds it: the chain over time. The function needs 5 hd^2 fp32
// flops per token and head (y_t = r_t^T S + (r_t . (u * k_t)) v_t is
// 2 hd^2, the state update 3 hd^2) on ~5 hd floats of input; at the
// serving prefill shape (B=4, S=1024, H=40, hd=64) that is 3.4 GFLOP
// (50 us at the H100 SXM's 67 TFLOP/s) against 215 MB (64 us at its
// 3.35 TB/s). This kernel evaluates the form above as written, 7 hd^2
// flops (4.7 GFLOP, 70 us), and neither rate is the wall: the recurrence
// is sequential in t, and only the (b, h, value column) axes are parallel.
// PERF.md has the measured time.
//
// Design: each value column j of a head's state updates on its own, so a
// grid of (B * H, hd / COLS) blocks each owns COLS columns of one head's
// state, held in registers for the whole sequence: no traffic between
// blocks, and each block reads its state slice before it writes it, so the
// state is updated in place safely. Inside a block, KS = hd / 8 neighbouring
// lanes share a column, each holding 8 key rows, and a shuffle sum over the
// KS lanes gives y_j: at hd = 64 that is 128 threads per block and 640
// blocks for 160 (b, h) pairs on 132 SMs, all resident at once (the
// launch bounds hold a thread to 102 registers so that 5 blocks fit an
// SM), so no other block hides a block's load latency: chunks of T steps
// of r, k, w
// (all hd) and v (the block's columns) are copied into shared memory by
// cp.async, 16 bytes a copy, into two buffers, so that the next chunk's
// copies run while the per-token loop works on this one out of shared
// memory; y is staged there too and stored 16 bytes at a time.
// A thread's 8 rows are two runs of 4, placed so that the 8 lanes of a
// quarter warp read 128 contiguous bytes: no bank conflicts. The chunked
// form on tensor cores is the known next step.

#include "common.cuh"

namespace {

constexpr int T = 16;  // timesteps staged per chunk, in each of 2 buffers
constexpr int R = 8;   // key rows of the state per thread
constexpr int G = R / 4;

template <int HD>
struct WkvShape {
  static constexpr int KS = HD / R;  // lanes per value column
  static constexpr int COLS = HD < 128 / KS ? HD : 128 / KS;
  static constexpr int NT = COLS * KS;
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
  int H, S, has_state;
};

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

template <int HD>
__global__ void __launch_bounds__(WkvShape<HD>::NT, 5) wkv6_kernel(
    const WkvParams p) {
  constexpr int KS = WkvShape<HD>::KS;
  constexpr int COLS = WkvShape<HD>::COLS;
  constexpr int NT = WkvShape<HD>::NT;
  __shared__ __align__(16) float sR[2][T * HD];
  __shared__ __align__(16) float sK[2][T * HD];
  __shared__ __align__(16) float sW[2][T * HD];
  __shared__ __align__(16) float sV[2][T * COLS];
  __shared__ __align__(16) float sY[T * COLS];

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int col0 = blockIdx.y * COLS;
  const int tid = threadIdx.x, ks = tid % KS, c = tid / KS, j = col0 + c;
  const float* Rg = p.r + b * p.r_sb + h * p.r_sh;
  const float* Kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* Vg = p.v + b * p.v_sb + h * p.v_sh + col0;
  const float* Wg = p.w + b * p.w_sb + h * p.w_sh;
  float* Yg = p.y + b * p.y_sb + h * p.y_sh + col0;
  float* St = p.state + b * p.st_sb + h * p.st_sh;

  // rows of this thread: 4 * (g * KS + ks) + e for g < G, e < 4
  float s[R], u[R];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (g * KS + ks) + e;
      u[4 * g + e] = p.u[h * p.u_sh + i];
      s[4 * g + e] = p.has_state ? St[i * p.st_si + j] : 0.f;
    }

  constexpr int CPR = HD / 4;    // 16-byte chunks per r, k, w row
  constexpr int VPR = COLS / 4;  // 16-byte chunks per v, y row
  // issue the copies of steps [t0, t0 + T) into buffer `buf` as one group
  auto stage = [&](int buf, int t0) {
    const int n = min(T, p.S - t0);
    for (int idx = tid; idx < n * CPR; idx += NT) {
      const int t = idx / CPR, q = 4 * (idx % CPR);
      const int64_t step = t0 + t;
      cp_async16(sR[buf] + t * HD + q, Rg + step * p.r_ss + q);
      cp_async16(sK[buf] + t * HD + q, Kg + step * p.k_ss + q);
      cp_async16(sW[buf] + t * HD + q, Wg + step * p.w_ss + q);
    }
    for (int idx = tid; idx < n * VPR; idx += NT) {
      const int t = idx / VPR, q = 4 * (idx % VPR);
      cp_async16(sV[buf] + t * COLS + q,
                  Vg + (int64_t)(t0 + t) * p.v_ss + q);
    }
    cp_async_commit();
  };

  stage(0, 0);
  for (int t0 = 0, cur = 0; t0 < p.S; t0 += T, cur ^= 1) {
    const int n = min(T, p.S - t0);
    // the other buffer's readers finished before the last chunk's y store
    if (t0 + T < p.S)
      stage(cur ^ 1, t0 + T);
    else
      cp_async_commit();  // keep the count
    cp_async_wait<1>();  // this chunk's copies
    __syncthreads();
    const float* cR = sR[cur];
    const float* cK = sK[cur];
    const float* cW = sW[cur];
    const float* cV = sV[cur];

#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const float vj = cV[t * COLS + c];
      float yp = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int off = t * HD + 4 * (g * KS + ks);
        const float4 r4 = *reinterpret_cast<const float4*>(cR + off);
        const float4 k4 = *reinterpret_cast<const float4*>(cK + off);
        const float4 w4 = *reinterpret_cast<const float4*>(cW + off);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 4 * g + e;
          const float kv = kk[e] * vj;
          yp = fmaf(rr[e], fmaf(u[m], kv, s[m]), yp);
          s[m] = fmaf(ww[e], s[m], kv);
        }
      }
#pragma unroll
      for (int o = KS / 2; o > 0; o >>= 1)
        yp += __shfl_xor_sync(0xffffffffu, yp, o);
      if (ks == 0) sY[t * COLS + c] = yp;
    }
    __syncthreads();
    for (int idx = tid; idx < n * VPR; idx += NT) {
      const int t = idx / VPR, q = 4 * (idx % VPR);
      copy4(Yg + (int64_t)(t0 + t) * p.y_ss + q, sY + t * COLS + q);
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      St[(4 * (g * KS + ks) + e) * p.st_si + j] = s[4 * g + e];
}

template <int HD>
int launch(const WkvParams& p, int B, cudaStream_t stream) {
  const dim3 grid(B * p.H, HD / WkvShape<HD>::COLS);
  wkv6_kernel<HD><<<grid, WkvShape<HD>::NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// r, k, v, w and y: (B, S, H, hd) fp32, each given by its data pointer and
// element strides (batch, step, head) in `strides`; u: (H, hd) with head
// stride strides[15]; state: (B, H, hd, hd) fp32 with strides (batch, head,
// key row) in strides[16..18]. The head dim and the state's value dim are
// contiguous, and rows of r, k, v, w, y are 16-byte aligned. has_state = 0
// starts from zero without reading `state`; the final state is written
// into `state` either way. Returns cudaGetLastError() after the launch.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, float* y,
                           float* state, int has_state,
                           const int64_t* strides, int B, int H, int S,
                           int hd, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return cudaErrorInvalidValue;
  WkvParams p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u; p.y = y; p.state = state;
  p.r_sb = strides[0]; p.r_ss = strides[1]; p.r_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.w_sb = strides[9]; p.w_ss = strides[10]; p.w_sh = strides[11];
  p.y_sb = strides[12]; p.y_ss = strides[13]; p.y_sh = strides[14];
  p.u_sh = strides[15];
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
