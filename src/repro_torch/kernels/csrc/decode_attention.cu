// Flash decode for Hopper, sm_90a: one new token per KV head against the
// KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (flash_decode -> _decode_kernel): the grp query heads that share one KV
// head attend to the first cache_len[b] slots of that head's cache, with an
// fp32 online softmax and the max(l, 1e-30) clamp; output in the input
// dtype.
//
// What bounds it: bytes. A step reads each valid K and V slot once and does
// 4 * grp flops per element read; at the serving decode shape (B=4, Hkv=8,
// grp=4, hd=128, ~544 slots, bf16) that is ~8.9 MB, 2.7 us at 3.35 TB/s.
//
// Design: one block of 128 threads per (batch, KV head) row, which streams
// the cache up to cache_len[b] (not to the cache's capacity) in 128-slot
// tiles staged in shared memory by coalesced 16-byte loads; slots past
// cache_len are never read. Thread j scores slot j for every query of the
// group; the tile's max and sum per query are reduced by warp shuffles and
// across the 4 warps through shared memory; then each thread accumulates a
// head-dim pair of P V for its share of the group's queries. The cache is
// read through its strides, so the model hands over its (B, S, Hkv, hd)
// cache without a transpose. At B * Hkv = 32 blocks the card's 132 SMs are
// far from full: splitting the slots over more blocks with a merge pass
// (flash-decoding) is the known next step.

#include "common.cuh"

namespace {

constexpr int BS = 128;   // cache slots per tile
constexpr int NT = 128;   // threads per block, one per slot of a tile
constexpr int NW = NT / 32;
constexpr int GMAX = 16;  // largest query group

struct FdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lens;
  int64_t q_sb, q_sh, q_sg;  // element strides (batch, kv head, group)
  int64_t k_sb, k_ss, k_sh;  // (batch, slot, kv head)
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sh, o_sg;
  int Hkv, grp, S;
  float scale;
};

template <typename T, int HD>
struct FdShape {
  static constexpr int LD = HD + Vec<T>::N;
  static constexpr size_t SMEM = size_t(2) * BS * LD * sizeof(T) +
                                 size_t(GMAX) * (HD + BS + 2 * NW + 2) *
                                     sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) fd_kernel(const FdParams p) {
  constexpr int LD = FdShape<T, HD>::LD;
  constexpr int VEC = Vec<T>::N;
  constexpr int RS = NT / (HD / 2);   // threads per head-dim pair
  constexpr int GPT = GMAX / RS;      // queries per thread in PV
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BS * LD;
  float* sQ = reinterpret_cast<float*>(sV + BS * LD);  // (GMAX, HD)
  float* sP = sQ + GMAX * HD;                          // (GMAX, BS)
  float* sMax = sP + GMAX * BS;                        // (NW, GMAX)
  float* sSum = sMax + NW * GMAX;                      // (NW, GMAX)
  float* sAlpha = sSum + NW * GMAX;                    // (GMAX,)
  float* sL = sAlpha + GMAX;                           // (GMAX,)

  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int grp = p.grp;
  const int len = min(p.lens[b], p.S);
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + hk * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + hk * p.o_sh;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int idx = tid; idx < grp * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    sQ[g * HD + d] = to_float(Q[g * p.q_sg + d]);
  }

  // m and l are the same in every thread; the PV loop reads the
  // rescale factor and the final l from shared memory, so that no
  // register array is indexed by a run-time query number
  float m[GMAX], l[GMAX], acc[GPT][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) { m[g] = -INFINITY; l[g] = 0.f; }
#pragma unroll
  for (int a = 0; a < GPT; ++a) acc[a][0] = acc[a][1] = 0.f;
  const int dp = tid % (HD / 2);  // head-dim pair owned in PV
  const int g0 = tid / (HD / 2);  // first query owned in PV; then g0 + RS...

  for (int s0 = 0; s0 < len; s0 += BS) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD, LD, BS, NT>(sK, K, p.k_ss, s0, len);
    load_tile<T, HD, LD, BS, NT>(sV, V, p.v_ss, s0, len);
    __syncthreads();

    // scores of slot s0 + tid for every query of the group
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    const T* krow = sK + tid * LD;
    for (int d = 0; d < HD; d += VEC) {
      float kf[VEC];
      load_vec(krow + d, kf);  // 16-byte loads: no bank conflicts
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= grp) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          s[g] = fmaf(sQ[g * HD + d + e], kf[e], s[g]);
      }
    }
    const bool valid = s0 + tid < len;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= grp) break;
      s[g] = valid ? s[g] * p.scale : -INFINITY;
      const float wm = warp_max(s[g]);
      if (lane == 0) sMax[warp * GMAX + g] = wm;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= grp) break;
      float tm = sMax[g];
#pragma unroll
      for (int w = 1; w < NW; ++w) tm = fmaxf(tm, sMax[w * GMAX + g]);
      const float m_new = fmaxf(m[g], tm);  // finite: slot s0 is valid
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
      if (tid == 0) sAlpha[g] = alpha;
      m[g] = m_new;
      const float pv = expf(s[g] - m_new);
      sP[g * BS + tid] = pv;
      const float ws = warp_sum(pv);
      if (lane == 0) sSum[warp * GMAX + g] = ws;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= grp) break;
      float ts = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) ts += sSum[w * GMAX + g];
      l[g] += ts;
    }

    // P V for head-dim pair dp and queries g0, g0 + RS, ...
    const int n = min(BS, len - s0);
#pragma unroll
    for (int a = 0; a < GPT; ++a) {
      const int g = g0 + a * RS;
      if (g >= grp) break;
      acc[a][0] *= sAlpha[g];
      acc[a][1] *= sAlpha[g];
    }
    for (int j = 0; j < n; ++j) {
      const float2 vv = load2(sV + j * LD + 2 * dp);
#pragma unroll
      for (int a = 0; a < GPT; ++a) {
        const int g = g0 + a * RS;
        if (g >= grp) break;
        const float pr = sP[g * BS + j];
        acc[a][0] = fmaf(pr, vv.x, acc[a][0]);
        acc[a][1] = fmaf(pr, vv.y, acc[a][1]);
      }
    }
  }

  if (tid == 0)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) sL[g] = l[g];
  __syncthreads();
#pragma unroll
  for (int a = 0; a < GPT; ++a) {
    const int g = g0 + a * RS;
    if (g >= grp) break;
    const float denom = fmaxf(sL[g], 1e-30f);
    store2(O + g * p.o_sg + 2 * dp, acc[a][0] / denom, acc[a][1] / denom);
  }
}

template <typename T, int HD>
int launch(const FdParams& p, int B, cudaStream_t stream) {
  const size_t smem = FdShape<T, HD>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      fd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fd_kernel<T, HD><<<B * p.Hkv, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_hd(const FdParams& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Hkv, grp, hd) and o: (B, Hkv, grp, hd), k/v caches:
// (B, S, Hkv, hd), each given by its data pointer and element strides in
// `strides` (q: batch, kv head, group; k, v: batch, slot, kv head; o as q);
// the head dim is contiguous. lens: (B,) int32 valid slots per batch row.
// Returns cudaGetLastError() after the launch, 0 on success.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* o,
                                       const int* lens,
                                       const int64_t* strides, int B,
                                       int Hkv, int grp, int S, int hd,
                                       int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || grp <= 0 || grp > GMAX || S <= 0)
    return cudaErrorInvalidValue;
  FdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lens = lens;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sg = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_sg = strides[11];
  p.Hkv = Hkv; p.grp = grp; p.S = S;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return dispatch_hd<float>(p, B, hd, s);
  if (dtype == DTYPE_BF16) return dispatch_hd<__nv_bfloat16>(p, B, hd, s);
  return cudaErrorInvalidValue;
}
