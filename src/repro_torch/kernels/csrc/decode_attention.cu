// Flash decode for Hopper, sm_90a: one new token per KV head against the
// KV cache, split over the cache's slots (flash-decoding).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (flash_decode -> _decode_kernel): the grp query heads that share one KV
// head attend to the first cache_len[b] slots of that head's cache, with an
// fp32 online softmax and the max(l, 1e-30) clamp; output in the input
// dtype. The Pallas kernel walks the slots in a sequential grid on one
// core; here blocks run in parallel and in no order, so the walk is split
// and merged.
//
// What bounds it: bytes. A step reads each valid K and V slot once and does
// 4 * grp flops per element read, far below the card's ridge point; at the
// serving decode shape (B=4, Hkv=8, grp=4, hd=128, ~544 slots, bf16) that
// is ~8.9 MB, 2.7 us at 3.35 TB/s. Reaching the memory rate takes many
// loads in flight on every SM: one block per (batch, KV head) row gives 32
// blocks for 132 SMs at that shape, and 8 at batch 1.
//
// Design: two kernels launched by one entry point on one stream.
//  - fd_split_kernel, grid (B * Hkv, n_split): each block takes one
//    contiguous chunk of `chunk` slots, intersected with [0, cache_len[b]);
//    the wrapper plans n_split and chunk from the cache's capacity and the
//    SM count, never from cache_len (a device tensor). A block stages its
//    64-slot tiles in shared memory by cp.async (double-buffered when the
//    chunk holds more than one tile; slots at or past the chunk's end or
//    cache_len are zero-filled without a read). Each slot is scored by two
//    threads, one per half of the head dim; rows are padded by 16 bytes, so
//    the 8 consecutive slots of a quarter warp fall in distinct banks. One
//    warp per query runs the online softmax over the two halves' sums;
//    then each warp accumulates P V over a quarter of the tile's slots,
//    each lane over column units of every query (a unit is two
//    neighbouring columns from hd 64 up, one below; lane l takes units
//    l, l + 32, ..., so a warp reads a V row in consecutive words, and at
//    hd 80, 96 and 160 the lanes past the last unit sit out the last
//    round), and the warps' sums are added once, at the end. The block writes its partial m and l per
//    query and unnormalised acc per query x hd in fp32 to the workspace. A
//    block whose chunk starts at or past cache_len[b] reads no K or V and
//    writes m = -inf, l = 0.
//  - fd_merge_kernel, grid (B * Hkv, grp), a thread per head-dim element:
//    m* = max m_i, l = sum l_i e^(m_i-m*), o = sum acc_i e^(m_i-m*) /
//    max(l, 1e-30), in q's dtype; one warp turns the m_i and l_i into
//    weights in shared memory, so each thread's loop over the splits is
//    independent loads; an empty split (m_i = -inf) weighs 0 and its acc
//    is never read.
// fp32 and bf16 both take this path; grp up to 16; hd 32, 64, 80, 96, 128
// and 160 (any multiple of 16 up to 256 that an instance names); every
// operand is read through its strides, so a layer's (B, S, Hkv, hd) cache
// slice goes in without a transpose.

#include "common.cuh"

namespace {

constexpr int BS = 64;    // cache slots per tile
constexpr int NT = 128;   // threads per block: two per slot of a tile
constexpr int NW = NT / 32;
constexpr int GMAX = 16;  // largest query group
constexpr int MERGE_NT = 256;  // the merge's threads: one per column, hd <= 256
constexpr int MAX_SPLIT = 8192;  // the merge's weights fit 32 KB of smem

struct FdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lens;
  float* ws_acc;  // (B * Hkv, n_split, grp, hd)
  float* ws_m;    // (B * Hkv, n_split, grp)
  float* ws_l;    // (B * Hkv, n_split, grp)
  int64_t q_sb, q_sh, q_sg;  // element strides (batch, kv head, group)
  int64_t k_sb, k_ss, k_sh;  // (batch, slot, kv head)
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sh, o_sg;
  int Hkv, grp, S, hd, n_split, chunk;
  float scale;
};

template <typename T, int HD>
struct FdShape {
  static_assert(HD % 16 == 0 && HD <= MERGE_NT, "hd: a multiple of 16");
  // 16-byte pad: rows are an odd number of 16-byte chunks apart, so the 8
  // consecutive slots a quarter warp reads fall in distinct banks
  static constexpr int LD = HD + Vec<T>::N;
  // nbuf K/V tile buffers, then per query: q (fp32), the two halves'
  // partial scores (then the probabilities), and m, l, alpha. The tile
  // buffers also hold the warps' (NW, grp, HD) fp32 sums at the end.
  static size_t smem(int nbuf, int grp) {
    return size_t(nbuf) * 2 * BS * LD * sizeof(T) +
           size_t(grp) * (HD + 2 * BS + 3) * sizeof(float);
  }
  static_assert(2 * BS * LD * sizeof(T) >= NW * GMAX * HD * sizeof(float),
                "a tile buffer holds the warps' sums");
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT) fd_split_kernel(const FdParams p) {
  constexpr int LD = FdShape<T, HD>::LD;
  constexpr int VEC = Vec<T>::N;
  constexpr int CPR = HD / VEC;       // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];

  const int row = blockIdx.x, split = blockIdx.y;
  const int b = row / p.Hkv, hk = row % p.Hkv;
  const int grp = p.grp;
  const int len = min(p.lens[b], p.S);
  const int s_begin = split * p.chunk;
  const int s_end = min(s_begin + p.chunk, len);  // exclusive
  const int64_t part = (int64_t(row) * p.n_split + split) * grp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (s_begin >= s_end) {  // nothing valid in this chunk: read no K or V
    if (tid < grp) {
      p.ws_m[part + tid] = -INFINITY;
      p.ws_l[part + tid] = 0.f;
    }
    return;
  }
  const int nbuf = p.chunk > BS ? 2 : 1;
  T* sK = reinterpret_cast<T*>(smem);   // buffer i at sK + 2 i BS LD
  float* sQ = reinterpret_cast<float*>(sK + nbuf * 2 * BS * LD);  // (grp, HD)
  float* sS = sQ + grp * HD;     // (2, grp, BS) partial scores; then [0]
                                 // holds the probabilities
  float* sM = sS + 2 * grp * BS;  // (grp,) running max (exp2 domain)
  float* sL = sM + grp;           // (grp,) running sum
  float* sAlpha = sL + grp;       // (grp,) this tile's rescale factor

  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + hk * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto stage = [&](int buf, int s0) {
    T* dk = sK + buf * 2 * BS * LD;
    load_tile_async<T, HD, LD, BS, NT>(dk, K, p.k_ss, s0, s_end);
    load_tile_async<T, HD, LD, BS, NT>(dk + BS * LD, V, p.v_ss, s0, s_end);
    cp_async_commit();
  };
  stage(0, s_begin);
  for (int idx = tid; idx < grp * HD; idx += NT) {
    const int g = idx / HD, d = idx % HD;
    sQ[g * HD + d] = to_float(Q[g * p.q_sg + d]);
  }
  if (tid < grp) { sM[tid] = -INFINITY; sL[tid] = 0.f; }

  const float sl2 = p.scale * LOG2E;  // scores in the exp2 domain
  // scores: thread (slot, half) sums half of the head dim of one slot
  const int slot = tid % BS, half = tid / BS;
  // P V: warp w takes slots [w SPW, (w + 1) SPW) of a tile; lane the
  // units lane + 32 i (i < UPL) of every query, unit u being the U
  // columns [U u, U u + U); a unit past NU (the last round at hd 80, 96,
  // 160) reads nothing and is never stored
  constexpr int SPW = BS / NW;
  constexpr int U = HD >= 64 ? 2 : 1, NU = HD / U, UPL = (NU + 31) / 32;
  auto unit_ok = [&](int i) { return NU % 32 == 0 || lane + 32 * i < NU; };
  float acc[GMAX][UPL][U];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < UPL; ++i)
#pragma unroll
      for (int e = 0; e < U; ++e) acc[g][i][e] = 0.f;

  int buf = 0;
  for (int s0 = s_begin; s0 < s_end; s0 += BS, buf ^= 1) {
    cp_async_wait<0>();  // this tile has landed (this thread's part)
    // every thread's part is visible, and every warp is done with the
    // previous tile's buffer and scores
    __syncthreads();
    if (s0 + BS < s_end) stage(buf ^ 1, s0 + BS);
    const T* cK = sK + buf * 2 * BS * LD;
    const T* cV = cK + BS * LD;

    // partial scores of slot s0 + slot over this thread's half of hd
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
#pragma unroll
    for (int i = 0; i < CPR / 2; ++i) {
      const int c = half * (CPR / 2) + i;
      float kf[VEC];
      load_vec(cK + slot * LD + c * VEC, kf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= grp) break;
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv =
              *reinterpret_cast<const float4*>(sQ + g * HD + c * VEC + e);
          s[g] = fmaf(qv.x, kf[e], s[g]);
          s[g] = fmaf(qv.y, kf[e + 1], s[g]);
          s[g] = fmaf(qv.z, kf[e + 2], s[g]);
          s[g] = fmaf(qv.w, kf[e + 3], s[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= grp) break;
      sS[(half * grp + g) * BS + slot] = s[g];
    }
    __syncthreads();

    // online softmax: warp w takes queries w, w + NW, ...
    for (int g = warp; g < grp; g += NW) {
      const float* h0 = sS + g * BS;
      const float* h1 = sS + (grp + g) * BS;
      const float x0 = s0 + lane < s_end ? (h0[lane] + h1[lane]) * sl2
                                         : -INFINITY;
      const float x1 = s0 + lane + 32 < s_end
                           ? (h0[lane + 32] + h1[lane + 32]) * sl2
                           : -INFINITY;
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));  // finite:
      const float p0 = fast_exp2(x0 - m_new);  // slot s0 is valid
      const float p1 = fast_exp2(x1 - m_new);
      sS[g * BS + lane] = p0;
      sS[g * BS + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = fast_exp2(m_old - m_new);
        sAlpha[g] = alpha;
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    // P V over this warp's slots; a slot past s_end has p = 0 and V = 0
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= grp) break;
#pragma unroll
      for (int i = 0; i < UPL; ++i)
#pragma unroll
        for (int e = 0; e < U; ++e) acc[g][i][e] *= sAlpha[g];
    }
#pragma unroll 4
    for (int j = warp * SPW; j < (warp + 1) * SPW; ++j) {
      float vv[UPL][U];
#pragma unroll
      for (int i = 0; i < UPL; ++i) {
        const T* vu = cV + j * LD + U * (lane + 32 * i);
        if (!unit_ok(i)) {
#pragma unroll
          for (int e = 0; e < U; ++e) vv[i][e] = 0.f;
        } else if constexpr (U == 1) {
          vv[i][0] = to_float(vu[0]);
        } else {
          const float2 f = load2(vu);
          vv[i][0] = f.x;
          vv[i][1] = f.y;
        }
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= grp) break;
        const float pr = sS[g * BS + j];
#pragma unroll
        for (int i = 0; i < UPL; ++i)
#pragma unroll
          for (int e = 0; e < U; ++e)
            acc[g][i][e] = fmaf(pr, vv[i][e], acc[g][i][e]);
      }
    }
  }

  // sum the warps' accumulators through the (now free) tile buffers
  __syncthreads();
  float* sRed = reinterpret_cast<float*>(smem);  // (NW, grp, HD)
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= grp) break;
#pragma unroll
    for (int i = 0; i < UPL; ++i) {
      if (!unit_ok(i)) continue;
#pragma unroll
      for (int e = 0; e < U; ++e)
        sRed[(warp * grp + g) * HD + U * (lane + 32 * i) + e] = acc[g][i][e];
    }
  }
  __syncthreads();
  if (tid < grp) {
    p.ws_m[part + tid] = sM[tid];
    p.ws_l[part + tid] = sL[tid];
  }
  for (int idx = tid; idx < grp * HD; idx += NT) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) a += sRed[w * grp * HD + idx];
    p.ws_acc[part * HD + idx] = a;
  }
}

template <typename T>
__global__ void __launch_bounds__(MERGE_NT) fd_merge_kernel(
    const FdParams p) {
  extern __shared__ float sW[];  // (n_split,) weight of each split
  const int row = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  const int b = row / p.Hkv, hk = row % p.Hkv;
  const int grp = p.grp, n = p.n_split;
  const int64_t part0 = int64_t(row) * n * grp + g;  // split i: + i * grp
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, p.ws_m[part0 + i * grp]);
    m = warp_max(m);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float mi = p.ws_m[part0 + i * grp];
      // an empty split (m_i = -inf) weighs 0 and its acc is never read
      const float w = mi == -INFINITY ? 0.f : fast_exp2(mi - m);
      sW[i] = w;
      l = fmaf(p.ws_l[part0 + i * grp], w, l);
    }
    l = warp_sum(l);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int i = lane; i < n; i += 32) sW[i] *= inv;
  }
  __syncthreads();
  if (d >= p.hd) return;
  float o = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    // an empty split's acc may hold anything: it is loaded (so that the
    // loads need not wait on the weights) but not used
    const float a = p.ws_acc[(part0 + i * grp) * p.hd + d];
    if (sW[i] != 0.f) o = fmaf(a, sW[i], o);
  }
  T* O = static_cast<T*>(p.o) + b * p.o_sb + hk * p.o_sh + g * p.o_sg;
  from_float(O + d, o);
}

template <typename T, int HD>
int launch(const FdParams& p, int B, cudaStream_t stream) {
  const size_t smem = FdShape<T, HD>::smem(p.chunk > BS ? 2 : 1, p.grp);
  cudaError_t err = cudaFuncSetAttribute(
      fd_split_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fd_split_kernel<T, HD>
      <<<dim3(B * p.Hkv, p.n_split), NT, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fd_merge_kernel<T><<<dim3(B * p.Hkv, p.grp), HD, p.n_split * sizeof(float),
                       stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch_hd(const FdParams& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 80: return launch<T, 80>(p, B, stream);
    case 96: return launch<T, 96>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 160: return launch<T, 160>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Hkv, grp, hd) and o: (B, Hkv, grp, hd), k/v caches:
// (B, S, Hkv, hd), each given by its data pointer and element strides in
// `strides` (q: batch, kv head, group; k, v: batch, slot, kv head; o as q);
// the head dim is contiguous. lens: (B,) int32 valid slots per batch row.
// ws: fp32 workspace of B * Hkv * n_split * grp * (hd + 2) floats; the
// slots are split into n_split chunks of `chunk` slots (a multiple of 64,
// n_split * chunk >= S). Returns cudaGetLastError() after the two
// launches, 0 on success.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* o,
                                       const int* lens,
                                       const int64_t* strides, int B,
                                       int Hkv, int grp, int S, int hd,
                                       int dtype, void* ws, int n_split,
                                       int chunk, void* stream) {
  if (B <= 0 || Hkv <= 0 || grp <= 0 || grp > GMAX || S <= 0 ||
      n_split <= 0 || n_split > MAX_SPLIT || chunk <= 0 || chunk % BS != 0 ||
      int64_t(n_split) * chunk < S || int64_t(n_split - 1) * chunk >= S)
    return cudaErrorInvalidValue;
  FdParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lens = lens;
  const int64_t parts = int64_t(B) * Hkv * n_split * grp;
  p.ws_acc = static_cast<float*>(ws);
  p.ws_m = p.ws_acc + parts * hd;
  p.ws_l = p.ws_m + parts;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sg = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_sg = strides[11];
  p.Hkv = Hkv; p.grp = grp; p.S = S; p.hd = hd;
  p.n_split = n_split; p.chunk = chunk;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return dispatch_hd<float>(p, B, hd, s);
  if (dtype == DTYPE_BF16) return dispatch_hd<__nv_bfloat16>(p, B, hd, s);
  return cudaErrorInvalidValue;
}
