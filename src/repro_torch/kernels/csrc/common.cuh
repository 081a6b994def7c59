// Shared helpers for the kernels: element conversion, paired loads and
// stores, tile copies from device to shared memory (plain and cp.async),
// bf16 pairs for the tensor cores' fragments, and the TF32 mma.sync with
// its hi/lo split, split fragments and their loaders from shared memory
// (WKV6's 3xTF32 products, forward and backward), and WKV6's hd x hd
// matrices held by a block.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
enum : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

constexpr float LOG2E = 1.4426950408889634f;  // softmax in the exp2 domain

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one 16-byte vector (4 fp32 or 8 bf16 elements) as floats
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// two neighbouring elements as float2 (element index must be even)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Elements per 16-byte vector.
template <typename T>
struct Vec { static constexpr int N = 16 / sizeof(T); };

// Copy rows [row0, row0 + ROWS) of a (rows, HD) operand whose rows are
// `row_stride` elements apart into shared memory with row stride LD.
// Rows at or past `limit` are zero-filled, so a ragged tile holds no
// garbage that 0 * x could turn into NaN. Each thread moves 16 bytes at a
// time; the wrapper guarantees 16-byte aligned rows.
template <typename T, int HD, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int limit) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CPR = HD / VEC;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, c = idx % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + (int64_t)(row0 + r) * row_stride + c * VEC);
    *reinterpret_cast<uint4*>(dst + r * LD + c * VEC) = val;
  }
}

// ---- cp.async: 16 bytes from device to shared memory, not through
// registers. With `valid` false nothing is read and the 16 bytes are
// zero-filled (the source operand must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// load_tile by cp.async, issued but not waited for: rows at or past
// `limit` are zero-filled without a read of device memory.
template <typename T, int HD, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int64_t row_stride, int row0,
                                                int limit) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CPR = HD / VEC;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * LD + c * VEC,
               ok ? src + (int64_t)(row0 + r) * row_stride + c * VEC : src,
               ok);
  }
}

// ---- Fragment layouts of the tensor cores' m16n8k16 shape (bf16 in, fp32
// accumulate; the A layout is also wgmma's register A operand, hopper.cuh),
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major) a[0..3]: (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
//     (g+8, 2t+8..);
//   B (16 x 8, k x n)      b[0..1]: (k 2t..2t+1, n g), (k 2t+8.., n g);
//   C (16 x 8, fp32)       c[0..3]: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- TF32 tensor cores (mma.sync, m16n8k8, fp32 accumulate), the same
// fragment layouts with k 8 deep:
//   A (16 x 8, row-major) a[0..3]: (g, t), (g+8, t), (g, t+4), (g+8, t+4);
//   B (8 x 8, k x n)      b[0..1]: (k t, n g), (k t+4, n g);
//   C as for bf16.
// x rounded to TF32 (10 mantissa bits, to nearest, ties away), kept in an
// fp32 word with the low 13 bits 0: two integer operations, where
// cvt.rna.tf32.f32 also tests for NaN and infinity (NaN and infinity pass
// through; a finite x within 2^-11 of the largest float rounds to inf)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to ~22 bits: hi its TF32 rounding, lo = x - hi (exact in
// fp32), handed to the mma as it is: the mma drops lo's bits below TF32,
// an error under 2^-10 of lo, 2^-21 of x
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// c += a * b
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- 3xTF32: an operand split as x = hi + lo, and the product of split
// fragments accumulated as lo*hi + hi*lo + hi*hi in fp32 (~22 bits per
// operand; lo*lo, below 2^-22 relative, dropped). WKV6's forward and
// backward run their fp32 products this way.
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}
// c += a * b in 3xTF32: the small terms first, lo * lo dropped
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// Fragments of fp32 operands in shared memory, `p` at the tile's first
// row and column (g = lane / 4, tq = lane % 4). A 16 x 8 A tile stored
// row-major ([m][k], row stride ld: conflict-free for ld = 4 mod 32) or
// k-major ([k][m]: ld = 8 or 24 mod 32); an 8 x 8 B tile stored k-major
// ([k][n]: ld = 8 or 24 mod 32) or n-major ([n][k]: ld = 4 mod 32).
__device__ __forceinline__ FragA lda_rm(const float* p, int ld, int g,
                                        int tq) {
  return frag_a(p[g * ld + tq], p[(g + 8) * ld + tq], p[g * ld + tq + 4],
                p[(g + 8) * ld + tq + 4]);
}
__device__ __forceinline__ FragA lda_km(const float* p, int ld, int g,
                                        int tq) {
  return frag_a(p[tq * ld + g], p[tq * ld + g + 8], p[(tq + 4) * ld + g],
                p[(tq + 4) * ld + g + 8]);
}
__device__ __forceinline__ FragB ldb_km(const float* p, int ld, int g,
                                        int tq) {
  return frag_b(p[tq * ld + g], p[(tq + 4) * ld + g]);
}
__device__ __forceinline__ FragB ldb_nm(const float* p, int ld, int g,
                                        int tq) {
  return frag_b(p[g * ld + tq], p[g * ld + tq + 4]);
}

// ---- WKV6's hd x hd fp32 matrices (a state, its gradient, a chunk's
// summary), held by a block of hd / 8 warps in the mma accumulator
// layout, and updated by 3xTF32 products over L = 16 tokens (forward
// and backward)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void to4(float* x, float4 f) {
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

// An hd x hd matrix held by a block, warp w value columns [8w, 8w + 8):
// m[e] is the accumulator tile of key rows [16e, +16): m[e][0..3] at (i,
// j) = (16e + g, 8w + 2tq), (.., +1), (16e + g + 8, 8w + 2tq), (.., +1).
template <int HD>
using Mat = float[HD / 16][4];

// from [i][j] with row stride ld (shared or device memory)
template <int HD>
__device__ __forceinline__ void mat_load(Mat<HD>& m, const float* src,
                                         int ld, int w, int g, int tq) {
#pragma unroll
  for (int e = 0; e < HD / 16; ++e) {
    const float2 a = *reinterpret_cast<const float2*>(
        src + (16 * e + g) * ld + 8 * w + 2 * tq);
    const float2 c = *reinterpret_cast<const float2*>(
        src + (16 * e + g + 8) * ld + 8 * w + 2 * tq);
    m[e][0] = a.x; m[e][1] = a.y; m[e][2] = c.x; m[e][3] = c.y;
  }
}
template <int HD>
__device__ __forceinline__ void mat_store(float* dst, int ld,
                                          const Mat<HD>& m, int w, int g,
                                          int tq) {
#pragma unroll
  for (int e = 0; e < HD / 16; ++e) {
    *reinterpret_cast<float2*>(dst + (16 * e + g) * ld + 8 * w + 2 * tq) =
        make_float2(m[e][0], m[e][1]);
    *reinterpret_cast<float2*>(dst + (16 * e + g + 8) * ld + 8 * w +
                               2 * tq) = make_float2(m[e][2], m[e][3]);
  }
}

// m <- diag(decay) m + Aop^T B over L tokens, Aop [t][i] (ld lda, k-major
// A), B given as the warp's two k-step fragments of [t][j]: the product in
// fresh accumulators, added by FFMA (decay null: m + the product)
template <int HD>
__device__ __forceinline__ void mat_update(Mat<HD>& m, const float* aop,
                                           int lda, const FragB (&bf)[2],
                                           const float* decay, int g,
                                           int tq) {
#pragma unroll
  for (int e = 0; e < HD / 16; ++e) {
    float up[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      mma3(up, lda_km(aop + 8 * kk * lda + 16 * e, lda, g, tq), bf[kk]);
    const float d0 = decay ? decay[16 * e + g] : 1.f;
    const float d1 = decay ? decay[16 * e + g + 8] : 1.f;
    m[e][0] = fmaf(d0, m[e][0], up[0]);
    m[e][1] = fmaf(d0, m[e][1], up[1]);
    m[e][2] = fmaf(d1, m[e][2], up[2]);
    m[e][3] = fmaf(d1, m[e][3], up[3]);
  }
}

// the warp's B fragments of a [t][j] operand (ld) over the L tokens
__device__ __forceinline__ void b_frags(FragB (&bf)[2], const float* src,
                                        int ld, int w, int g, int tq) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    bf[kk] = ldb_km(src + 8 * kk * ld + 8 * w, ld, g, tq);
}

// 2^x by the SFU in one instruction (flushes denormal results to 0;
// 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Sums over the N lanes of a group (N | 32, M and N powers of 2; `group`
// the mask of the lanes calling, the group's own at least) of v[0..M),
// reduce-scattered: with N <= M, the group's lane l ends with the sums of
// entries [l M/N, (l+1) M/N) in v[0..M/N), after M - M/N shuffles, where
// a butterfly of each entry would take M log2 N; with N > M, lanes l and
// l + M hold entry l % M in v[0].
template <int M, int N>
__device__ __forceinline__ void reduce_scatter(float* v, int lane,
                                               unsigned group) {
  if constexpr (N > M) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      v[j] += __shfl_xor_sync(group, v[j], N / 2);
    reduce_scatter<M, N / 2>(v, lane, group);
  } else if constexpr (N > 1) {
    constexpr int half = M / 2, o = N / 2;
    const bool upper = lane & o;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? v[j] : v[j + half];
      const float keep = upper ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(group, send, o);
    }
    reduce_scatter<half, o>(v, lane, group);
  }
}

// sum over N neighbouring lanes (N a power of 2; `group` as above)
template <int N>
__device__ __forceinline__ float sum_lanes(float x, unsigned group) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(group, x, o);
  return x;
}

__device__ __forceinline__ float warp_max8(float x) {
  // max over the 8 neighbouring lanes of one row group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}
__device__ __forceinline__ float warp_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
