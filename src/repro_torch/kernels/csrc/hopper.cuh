// Hopper helpers of the attention kernels (flash_attention.cu's bf16 body,
// flash_attention_bwd.cu's Hopper bodies): mbarriers, TMA tile loads, the
// wgmma shared-memory descriptors of the 128-byte swizzle, the wgmma
// products and fences, the accumulator-to-A-fragment conversion, and on
// the host the TMA map of a (B, S, heads, hd) bf16 operand and the check
// of a kernel's registers at entry that setmaxnreg relies on.
//
// Layout of a tile in shared memory: a tile of R rows of hd bf16 is
// ceil(hd / 64) boxes of 128 bytes a row, each box R rows x 128 bytes
// (box_bytes(R)), in the 128-byte swizzle, so the swizzle's 8-row x
// 128-byte atoms tile it with no padding. A box starts 1024-byte aligned.
// Columns past hd are TMA's zero fill (the map's innermost extent is hd).
#pragma once

#include <cuda.h>

#include "common.cuh"

constexpr int BOX = 64;  // bf16 columns of a 128-byte box
constexpr int BOX_ROW_BYTES = 128;
__host__ __device__ constexpr int box_bytes(int rows) {
  return rows * BOX_ROW_BYTES;
}
constexpr int BOX64 = box_bytes(64);  // a 64-row box: 8 KB

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
// after the block's mbar_init calls, before any other thread uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// an arrival that also expects `bytes` of TMA copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA: a box of a (B, S, H, hd) operand, columns [c, c + 64) of head
// h, rows [s, s + the map's box rows) of batch row b (rows past S and
// columns past hd zero-filled), completing on `bar`
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c, int h, int s,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c),
      "r"(h), "r"(s), "r"(b) : "memory");
}

// ---- wgmma shared-memory descriptors
// 128-byte swizzle: start address, leading and stride byte offsets
// (16-byte units)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows x hd, the product's depth along hd), its k-step kk
// of 16 columns: box kk / 4 (`box` bytes apart), 32 bytes a step inside
// the box's 128-byte rows; 8-row groups 1024 bytes apart. hd / 16 steps:
// where hd is not a multiple of 64 the last ones read the last box's first
// columns, never its zero fill.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk,
                                           int box = BOX64) {
  return gmma_desc(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}
// MN-major operand (the product's depth along the tile's rows, N = hd),
// its k-step kk of 16 rows; 8-row groups 1024 bytes apart, the next 64
// columns one box (`box` bytes) on
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk,
                                            int box = BOX64) {
  return gmma_desc(tile + kk * 16 * BOX_ROW_BYTES, box, 1024);
}

// ---- wgmma fences
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups of the warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep registers that an asynchronous wgmma writes or reads in place until
// its wait: the compiler sees them used here
template <int N>
__device__ __forceinline__ void keep(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K = 4>
__device__ __forceinline__ void keep_frags(uint32_t (*a)[4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// ---- wgmma products, bf16 in, fp32 accumulate. Accumulator layout of
// m64nN: warp w of the warpgroup holds rows 16 w + g and 16 w + g + 8
// (g = lane / 4, t = lane % 4); d[4 j + 2 r + e] is row 16 w + g + 8 r,
// column 8 j + 2 t + e.

// d (64 x 64) += A B, A (64 x 16) and B (16 x 64) K-major in shared
// memory (descriptors da, db); with acc 0, d = A B
__device__ __forceinline__ void wgmma_ss_64(float* d, uint64_t da,
                                             uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128) += A B, A (64 x 16) and B (16 x 128) K-major in shared
// memory; with acc 0, d = A B
__device__ __forceinline__ void wgmma_ss_128(float* d, uint64_t da,
                                              uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 32) += A B, A (64 x 16) and B (16 x 32) K-major in shared
// memory; with acc 0, d = A B (the attention backward's 32-row streamed
// tiles at hd 160)
__device__ __forceinline__ void wgmma_ss_32(float* d, uint64_t da,
                                             uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N) += A B with B K-major, N = 32, 64 or 128; with acc 0, d = A B
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int acc = 1) {
  if constexpr (N == 128) {
    wgmma_ss_128(d, da, db, acc);
  } else if constexpr (N == 64) {
    wgmma_ss_64(d, da, db, acc);
  } else {
    static_assert(N == 32, "wgmma_ss: N = 32, 64 or 128");
    wgmma_ss_32(d, da, db, acc);
  }
}

// d (64 x 64) += A B, A (64 x 16) bf16 in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 64) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A B, A (64 x 16) bf16 in registers (the m16n8k16 A
// fragment of each warp's 16 rows), B (16 x 128) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_128(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += A B and d (64 x 16) += A B, as wgmma_rs_64: the tails of
// hd 160, 96 and 80 in their last box, and hd 32 in its one box
__device__ __forceinline__ void wgmma_rs_32(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_16(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x HD) += A B over a tile's k-step kk, B MN-major (N = hd) in boxes
// `box` bytes apart: one instruction at hd 64 and 128 (the second box LBO
// on); at hd 80, 96 and 160 the whole boxes' 64 or 128 columns, then an
// N = 16 or 32 instruction from the last box's start, whose columns past
// hd (TMA's zero fill) no product reads; at hd 32 one N = 32 instruction.
// d[4 j + 2 r + e] is column 8 j + 2 t + e in every case.
template <int HD, int BOXB = BOX64>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint32_t tile, int kk) {
  if constexpr (HD == 128 || HD == 160) {
    wgmma_rs_128(d, a, mnmajor(tile, kk, BOXB));
    if constexpr (HD == 160)
      wgmma_rs_32(d + 64, a, mnmajor(tile + 2 * BOXB, kk, BOXB));
  } else if constexpr (HD == 32) {
    wgmma_rs_32(d, a, mnmajor(tile, kk, BOXB));
  } else {
    wgmma_rs_64(d, a, mnmajor(tile, kk, BOXB));
    if constexpr (HD == 96)
      wgmma_rs_32(d + 32, a, mnmajor(tile + BOXB, kk, BOXB));
    else if constexpr (HD == 80)
      wgmma_rs_16(d + 32, a, mnmajor(tile + BOXB, kk, BOXB));
    else
      static_assert(HD == 64, "wgmma_rs: hd 32, 64, 80, 96, 128, 160");
  }
}

// the K 16-column steps of a 64 x 16K accumulator (rows of each warp's 16,
// in wgmma's accumulator layout) as bf16 A fragments
template <int K = 4>
__device__ __forceinline__ void to_frags(const float* s, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ---- host side
// cuTensorMapEncodeTiled, a driver call, through the runtime's entry point
// (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// the TMA map of a (B, S, heads, hd) bf16 operand with element strides
// (batch, seq, head): dims (hd, heads, S, B), 64 x 1 x box_rows x 1 boxes,
// 128-byte swizzle, rows past S and columns past hd read as zeros
inline int make_map(CUtensorMap* map, const void* base, int64_t sb,
                    int64_t ss, int64_t sh, int B, int S, int heads, int hd,
                    int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {BOX, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// setmaxnreg moves registers inside a block's allocation: the producer
// warpgroup drops its threads to a few and the consumer warpgroups raise
// theirs, which needs `regs` a thread at entry (the block's threads x regs
// = what the warpgroups hold after setmaxnreg). With fewer the consumers'
// setmaxnreg.inc would wait for ever, so such a build is refused before
// its first launch.
template <typename Kernel>
int check_entry_registers(Kernel kernel, int regs) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  return a.numRegs >= regs ? cudaSuccess : cudaErrorInvalidConfiguration;
}
