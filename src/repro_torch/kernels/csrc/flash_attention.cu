// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd -> _fa_kernel): causal softmax attention with an
// optional sliding window and native GQA (query head h reads KV head
// h / (H / Hkv)), online softmax with an fp32 running max, denominator and
// accumulator, output clamped by max(l, 1e-30) and written in the input
// dtype.
//
// What bounds it: at the serving prefill shape (B=4, S=512, H=32, Hkv=8,
// hd=128, bf16) one call moves 41.9 MB (Q, K, V read once, O written once),
// 12.5 us at 3.35 TB/s, and does 8.6 GFLOP of causal work, 8.7 us at the
// bf16 tensor-core peak: memory-bound on paper. This first version does
// its arithmetic in fp32 on the CUDA cores (no mma/wgmma), so in practice
// it is bound by fp32 FMA issue and shared-memory loads, not by HBM.
//
// Design: one block of 128 threads per (64-query tile, batch*head). The
// TPU kernel's sequential k-block grid axis becomes a loop inside the
// block over 64-key tiles staged in shared memory. The loop starts at the
// window's lower edge and stops at the causal limit, so fully masked tiles
// cost nothing (the Pallas kernel computed and masked them). Each thread
// owns 4 query rows (rg + 16 i) and, of the 64x64 score tile, 8 keys
// (c + 8 j): 32 scores held in registers, with the row max and sum reduced
// over the row group's 8 neighbouring lanes by shuffles. Probabilities go
// through shared memory to the PV product, where the same thread owns
// head-dim pairs (2c + 16u). Operands are read through their strides, so
// the model hands (B, S, H, hd) projections over without a copy. Rows are
// padded by 16 bytes in shared memory to spread them over the banks.
// The heaviest (last) query tiles are launched first.

#include "common.cuh"

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per tile
constexpr int NT = 128;  // threads per block: 16 row groups x 8 lanes
constexpr int LDP = BN + 8;

struct FaParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;  // element strides (batch, seq, head)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int H, Hkv, Sq, Sk;
  int window;  // <= 0: no window
  float scale;
};

template <typename T, int HD>
struct FaShape {
  static constexpr int LD = HD + Vec<T>::N;  // padded smem row (elements)
  static constexpr size_t SMEM =
      size_t(BM + 2 * BN) * LD * sizeof(T) + size_t(BM) * LDP * sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) fa_kernel(const FaParams p) {
  constexpr int LD = FaShape<T, HD>::LD;
  constexpr int NU = HD / 16;  // head-dim pairs per thread in PV
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BM * LD;
  T* sV = sK + BN * LD;
  float* sP = reinterpret_cast<float*>(sV + BN * LD);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * BM;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // row group: rows rg + 16 i
  const int c = tid & 7;    // lane in the row group

  load_tile<T, HD, LD, BM, NT>(sQ, Q, p.q_ss, q0, p.Sq);

  float m[4], l[4], acc[4][2 * NU];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 2 * NU; ++u) acc[i][u] = 0.f;
  }

  const int q_end = min(q0 + BM, p.Sq);      // exclusive
  const int k_end = min(p.Sk, q_end);        // causal limit, exclusive
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  k_begin = k_begin / BN * BN;

  for (int k0 = k_begin; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD, LD, BN, NT>(sK, K, p.k_ss, k0, p.Sk);
    load_tile<T, HD, LD, BN, NT>(sV, V, p.v_ss, k0, p.Sk);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = load2(sQ + (rg + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = load2(sK + (c + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, s[i][j]));
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg + 16 * i;
      const int qpos = q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + c + 8 * j;
        const bool ok = kpos <= qpos && kpos < p.Sk &&
                        (p.window <= 0 || qpos - kpos < p.window);
        s[i][j] = ok ? s[i][j] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max8(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;  // all masked
      const float alpha = expf(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float pv = expf(s[i][j] - base);
        sP[row * LDP + c + 8 * j] = pv;
        rs += pv;
      }
      l[i] = l[i] * alpha + warp_sum8(rs);
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < 2 * NU; ++u) acc[i][u] *= alpha;
    }
    __syncwarp();  // a row group's P is written and read by its own 8 lanes

#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sP[(rg + 16 * i) * LDP + j];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float2 vv = load2(sV + j * LD + 2 * c + 16 * u);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][2 * u] = fmaf(pr[i], vv.x, acc[i][2 * u]);
          acc[i][2 * u + 1] = fmaf(pr[i], vv.y, acc[i][2 * u + 1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg + 16 * i;
    if (qpos >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = O + qpos * p.o_ss;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      store2(out + 2 * c + 16 * u, acc[i][2 * u] / denom,
             acc[i][2 * u + 1] / denom);
  }
}

template <typename T, int HD>
int launch(const FaParams& p, int B, cudaStream_t stream) {
  const size_t smem = FaShape<T, HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, B * p.H);
  fa_kernel<T, HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_hd(const FaParams& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Sk, Hkv, hd), o: (B, Sq, H, hd), each given
// by its data pointer and its (batch, seq, head) element strides in
// `strides` (q, k, v, o in that order); the head dim is contiguous.
// Returns cudaGetLastError() after the launch, 0 on success.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* strides, int B, int H,
                                      int Hkv, int Sq, int Sk, int hd,
                                      int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  FaParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.window = window;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return dispatch_hd<float>(p, B, hd, s);
  if (dtype == DTYPE_BF16) return dispatch_hd<__nv_bfloat16>(p, B, hd, s);
  return cudaErrorInvalidValue;
}
