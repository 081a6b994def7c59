// Shared helpers for the attention kernels: element conversion, paired
// loads and stores, and the tile copy from device to shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
enum : int { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
