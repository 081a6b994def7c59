// Mamba selective scan (hymba's SSM heads) for Hopper, sm_90a, in fp32:
//
//   h[d][j] <- exp(dt_t[d] * a[d][j]) * h[d][j] + (dt_t[d] * x_t[d]) * b_t[j]
//   y_t[d]   = sum_j h[d][j] * c_t[j]
//
// No Pallas kernel stands behind it. JAX runs the recurrence as a lax.scan
// of `step` in repro/models/ssm.py:apply_mamba (the vmemkernel_mamba_scan
// scope, ssm.py:208-218), which XLA compiles into one loop on the device.
// Eager PyTorch would launch ~5 kernels a step (4096 steps a layer at the
// serving prefill); this kernel is the port's form of that loop. Each
// step's arithmetic keeps JAX's order and roundings: da = exp(dt * a),
// h = da * h + (dt * x) * b, each product and the sum rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), expf and not __expf; only
// the sum over j for y runs in another order (a shuffle tree).
//
// What bounds it: bytes. Per (batch, step) it reads dt and x (di floats
// each) and b and c (n each) and writes y (di), and needs ~7 fp32 flops
// per (channel, state); at hymba's serving prefill (B=4, S=4096, di=1600,
// n=16) that is 317 MB (0.095 ms at the H100 SXM's 3.35 TB/s) against 2.9
// GFLOP (0.044 ms at 67 TFLOP/s). A decode step (S=1) moves the (B, di, n)
// state in and out.
//
// Design (a simple kernel that is right; the chunked parallel form is
// later work): one thread per (batch row, channel d, state j), the n
// states of a channel in n neighbouring lanes, so the state lives in one
// register for the whole sequence and the y sum is a shuffle tree over n
// lanes. A block owns CH = 32 channels of one batch row (32 n threads:
// 512 at n = 16, 200 blocks at the serving shape). The launch bounds hold
// a thread to 64 registers (a few spill), so that an SM takes 2 such
// blocks and all 200 are resident at once, with no block left for a
// second sequential pass; without them ptxas gives the n = 16 body 114
// registers, which at 16 channels a block ran 15 % slower. 32 channels a
// block beat 16: b and c are staged once for twice the channels
// (tools/ablate_kernels.py mamba_scan; PERF.md). Time runs in tiles of
// T = 64 steps: dt, x (T x CH) and b, c (T x n, shared by every channel
// of the row) are staged in shared memory, and the next tile's loads go
// out into registers before this tile's steps run, so their latency hides
// under the steps; y of the tile is gathered in shared memory and written
// as T rows of CH floats. Inputs are read through their strides (b and c
// may be the two halves of one (B, S, 2n) projection); rows past S and
// channels past di read 0 and are not written. A given state is read at
// the start and the final state written back over it (each thread its own
// element, so in place is safe).

#include "common.cuh"

namespace {

constexpr int T = 64;   // steps staged per tile
constexpr int CH = 32;  // channels per block

template <int N>
struct ScanShape {
  static constexpr int NT = CH * N;          // threads: (channel, state)
  // blocks an SM must hold: 32 warps, so at most 64 registers a thread
  static constexpr int MIN_BLOCKS = 1024 / NT;
  static constexpr int LD = T * CH / NT;     // dt (and x) loads a thread
  static constexpr int LB = T * N / NT;      // b (and c) loads a thread
  static_assert(T * CH % NT == 0 && T * N % NT == 0, "tile shape");
};

struct ScanParams {
  const float* dt;
  const float* b;
  const float* c;
  const float* x;
  const float* a;  // (di, n) contiguous
  float* y;
  float* h;  // (B, di, n), (di, n) contiguous per batch row
  int64_t dt_sb, dt_ss;  // element strides (batch, step)
  int64_t b_sb, b_ss;
  int64_t c_sb, c_ss;
  int64_t x_sb, x_ss;
  int64_t y_sb, y_ss;
  int64_t h_sb;
  int S, di, has_state;
};

template <int N>
__global__ void __launch_bounds__(ScanShape<N>::NT, ScanShape<N>::MIN_BLOCKS)
    mamba_scan_kernel(const ScanParams p) {
  constexpr int NT = ScanShape<N>::NT;
  constexpr int LD = ScanShape<N>::LD;
  constexpr int LB = ScanShape<N>::LB;
  __shared__ float sDt[T][CH];
  __shared__ float sX[T][CH];
  __shared__ float sY[T][CH];
  __shared__ float sB[T][N];
  __shared__ float sC[T][N];

  const int bi = blockIdx.y, d0 = blockIdx.x * CH;
  const int tid = threadIdx.x, j = tid % N, ch = tid / N, d = d0 + ch;
  const bool live = d < p.di;
  const float* dtg = p.dt + bi * p.dt_sb + d0;
  const float* xg = p.x + bi * p.x_sb + d0;
  const float* bg = p.b + bi * p.b_sb;
  const float* cg = p.c + bi * p.c_sb;
  float* yg = p.y + bi * p.y_sb + d0;

  // a thread stages elements tid + i * NT of a tile: (step e / CH,
  // channel e % CH) of dt and x, (step e / N, state e % N) of b and c
  float rdt[LD], rx[LD], rb[LB], rc[LB];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < LD; ++i) {
      const int e = tid + i * NT, t = t0 + e / CH, cc = e % CH;
      const bool ok = t < p.S && d0 + cc < p.di;
      rdt[i] = ok ? dtg[t * p.dt_ss + cc] : 0.f;
      rx[i] = ok ? xg[t * p.x_ss + cc] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * NT, t = t0 + e / N, jj = e % N;
      const bool ok = t < p.S;
      rb[i] = ok ? bg[t * p.b_ss + jj] : 0.f;
      rc[i] = ok ? cg[t * p.c_ss + jj] : 0.f;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < LD; ++i) {
      const int e = tid + i * NT;
      sDt[e / CH][e % CH] = rdt[i];
      sX[e / CH][e % CH] = rx[i];
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * NT;
      sB[e / N][e % N] = rb[i];
      sC[e / N][e % N] = rc[i];
    }
  };

  const int64_t hi = bi * p.h_sb + (int64_t)d * N + j;
  const float a = live ? p.a[(int64_t)d * N + j] : 0.f;
  float h = live && p.has_state ? p.h[hi] : 0.f;
  fetch(0);
  for (int t0 = 0; t0 < p.S; t0 += T) {
    __syncthreads();  // the last tile's steps and y are done with sY, sDt..
    stash();
    __syncthreads();
    if (t0 + T < p.S) fetch(t0 + T);  // in flight under this tile's steps
    const int nt = min(T, p.S - t0);
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float dtv = sDt[t][ch];
      const float da = expf(dtv * a);
      const float u = __fmul_rn(__fmul_rn(dtv, sX[t][ch]), sB[t][j]);
      h = __fadd_rn(__fmul_rn(da, h), u);
      float yv = __fmul_rn(h, sC[t][j]);
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, o);
      if (j == 0) sY[t][ch] = yv;
    }
    __syncthreads();
    for (int e = tid; e < nt * CH; e += NT) {
      const int t = e / CH, cc = e % CH;
      if (d0 + cc < p.di) yg[(t0 + t) * p.y_ss + cc] = sY[t][cc];
    }
  }
  if (live) p.h[hi] = h;
}

template <int N>
int launch(const ScanParams& p, int B, cudaStream_t stream) {
  const dim3 grid((p.di + CH - 1) / CH, B);
  mamba_scan_kernel<N><<<grid, ScanShape<N>::NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dt, x and y: (B, S, di) fp32; b, c: (B, S, n) fp32; each given by its
// data pointer and element strides (batch, step) in `strides` (dt, b, c,
// x, y, then the batch stride of h); the last dim of each is contiguous.
// a: (di, n) contiguous. h: (B, di, n), its (di, n) block contiguous;
// has_state = 0 starts from zero without reading it, and the final state
// is written into h either way. n is 8 or 16. One call is one
// launch; returns cudaGetLastError() after it.
extern "C" int mamba_scan_launch(const float* dt, const float* b,
                                 const float* c, const float* x,
                                 const float* a, float* y, float* h,
                                 int has_state, const int64_t* strides,
                                 int B, int S, int di, int n, void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return cudaErrorInvalidValue;
  ScanParams p;
  p.dt = dt; p.b = b; p.c = c; p.x = x; p.a = a; p.y = y; p.h = h;
  p.dt_sb = strides[0]; p.dt_ss = strides[1];
  p.b_sb = strides[2]; p.b_ss = strides[3];
  p.c_sb = strides[4]; p.c_ss = strides[5];
  p.x_sb = strides[6]; p.x_ss = strides[7];
  p.y_sb = strides[8]; p.y_ss = strides[9];
  p.h_sb = strides[10];
  p.S = S; p.di = di; p.has_state = has_state;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return launch<8>(p, B, s);
    case 16: return launch<16>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// the steps a tile stages: the kernel's edges are at multiples of this
extern "C" int mamba_scan_time_tile() { return T; }
