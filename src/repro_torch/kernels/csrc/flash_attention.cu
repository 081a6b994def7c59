// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd -> _fa_kernel): causal softmax attention with an
// optional sliding window and native GQA (query head h reads KV head
// h / (H / Hkv)), online softmax with an fp32 running max, denominator and
// accumulator, output clamped by max(l, 1e-30) (a fully masked row gives
// 0) and written in the input dtype.
//
// What bounds it: at the serving prefill shape (B=4, S=512, H=32, Hkv=8,
// hd=128, bf16) one call moves 41.9 MB (Q, K, V read once, O written once),
// 12.5 us at 3.35 TB/s, and does 8.6 GFLOP of causal work, 8.7 us at the
// bf16 tensor-core peak. Both products are matrix products, so the
// arithmetic has to run on the tensor cores to come near either bound.
//
// bf16 body (fa_bf16_kernel), the serving dtype: FlashAttention-2 on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). One block of 4 warps per
// (64-query tile, batch*head), 2 blocks per SM; each warp owns 16 query
// rows, whose Q fragments it loads once by ldmatrix and keeps in
// registers. 64-key tiles of K and V stream through a ring of 3 shared-
// memory buffers filled by cp.async (16-byte copies, rows at or past Sk
// zero-filled without a read), so two tiles are in flight while one is
// computed, with one barrier per tile; Q is first staged in the ring's
// last buffer. Rows are padded by 16 bytes, so the 8 rows an ldmatrix
// reads fall in distinct banks. S = Q K^T takes K by ldmatrix; the online
// softmax runs in the accumulator registers (row max and sum over the 4
// lanes of a row by two shuffles; p = 2^(s * scale * log2 e - m) as one
// FFMA and one ex2.approx; a straddling tile masks by each row's key
// bounds, two compares an element); P is rounded to bf16 in registers and
// fed straight back as the A operand of the P V product, with V read by
// ldmatrix.trans. Nothing but K and V passes through shared memory, and
// the output is staged there only to leave in 16-byte stores. Rounding P
// to bf16 is what JAX's model and SDPA do; the Pallas kernel and the
// plain version keep P in fp32. What still bounds it is latency: each
// warp runs its loads, products and softmax one after another, so taking
// out the tile loads, or either product, each saves a tenth to a fifth of
// the time (PERF.md). wgmma with TMA, fed by a producer warp so that the
// parts overlap, is the next step.
//
// fp32 body (fa_f32_kernel), the precision path for the tests and for
// compare_paths, not a serving dtype: TF32 tensor cores would not hold its
// limits, so it keeps the CUDA cores. Each thread owns 4 query rows and 8
// keys of a 64x64 score tile, row max and sum reduced over 8 lanes by
// shuffles, probabilities through shared memory to the P V product.
//
// Both: the key loop starts at the window's lower edge and stops at the
// causal limit, so fully masked tiles cost nothing (the Pallas kernel
// computed and masked them), and masks apply only on tiles that straddle
// an edge (bf16 body); the heaviest (last) query tiles launch first;
// operands are read through their strides, so the model hands (B, S, H, hd)
// projections over without a copy; hd 32, 64, 80, 96, 128 and 160, any
// multiple of 16 that an instance names: the bf16 body tiles Q K^T in
// hd / 16 k-steps and P V in hd / 8 n-blocks, the fp32 body takes hd / 16
// column pairs a lane. At hd 160 three (K, V) buffers (126 KB) would leave
// one block an SM, so that instance rings two and keeps two blocks.
//
// Training (flash_attention_bwd.cu): given an lse pointer, both bodies also
// write each row's log-sum-exp of the scaled scores, lse = m + log l in
// fp32 ((B, H, Sq), m taken as 0 for a row with every key masked, l
// clamped as the output's denominator is), from which the backward
// recomputes P. Serving passes none and writes nothing more.

#include "common.cuh"

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // keys per tile
constexpr int NT = 128;  // threads per block: fp32 16 row groups x 8 lanes,
                         // bf16 4 warps x 16 rows
constexpr int LDP = BN + 8;

struct FaParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) or null: the training forward's row log-sum-exp
  int64_t q_sb, q_ss, q_sh;  // element strides (batch, seq, head)
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int H, Hkv, Sq, Sk;
  int window;  // <= 0: no window
  float scale;
};

// ------------------------------------------------------------ fp32 body
template <int HD>
struct FaF32Shape {
  static constexpr int LD = HD + 4;  // padded smem row (elements)
  static constexpr size_t SMEM =
      size_t(BM + 2 * BN) * LD * sizeof(float) +
      size_t(BM) * LDP * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(NT) fa_f32_kernel(const FaParams p) {
  using T = float;
  constexpr int LD = FaF32Shape<HD>::LD;
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
    if (p.lse != nullptr && c == 0)
      p.lse[((int64_t)b * p.H + h) * p.Sq + qpos] =
          (m[i] == -INFINITY ? 0.f : m[i]) + logf(denom);
    T* out = O + qpos * p.o_ss;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      store2(out + 2 * c + 16 * u, acc[i][2 * u] / denom,
             acc[i][2 * u + 1] / denom);
  }
}

// ------------------------------------------------------------ bf16 body
constexpr size_t SM_SMEM = 228 * 1024;  // shared memory of one SM
constexpr size_t BLOCK_RESERVED = 1024;  // the runtime's share per block

template <int HD>
struct FaBf16Shape {
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  static constexpr int LD = HD + 8;  // 16-byte pad: conflict-free ldmatrix
  // K/V tiles in the cp.async ring: three, or two where three would not
  // leave room for two blocks an SM (hd 160)
  static constexpr int NSTAGE =
      2 * (3 * 2 * BN * LD * 2 + BLOCK_RESERVED) <= SM_SMEM ? 3 : 2;
  // a ring of NSTAGE (K, V) tile buffers; Q is first loaded into the last
  static constexpr size_t SMEM =
      size_t(NSTAGE) * 2 * BN * LD * sizeof(__nv_bfloat16);
  static_assert(2 * (SMEM + BLOCK_RESERVED) <= SM_SMEM,
                "two blocks must fit one SM");
  static_assert(BM <= 2 * BN, "Q must fit one (K, V) buffer");
};

template <int HD>
__global__ void __launch_bounds__(NT, 2) fa_bf16_kernel(const FaParams p) {
  using T = __nv_bfloat16;
  constexpr int LD = FaBf16Shape<HD>::LD;
  constexpr int NSTAGE = FaBf16Shape<HD>::NSTAGE;
  constexpr int KD = HD / 16;  // k-steps of Q K^T
  constexpr int ND = HD / 8;   // n-blocks of the output
  extern __shared__ __align__(16) unsigned char smem[];
  // buffer i holds K at sKV + 2 i BN LD and V BN rows after it
  T* sKV = reinterpret_cast<T*>(smem);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qt * BM;
  const T* Q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* K = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* V = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* O = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 16 * warp;  // this warp's first query row

  const int q_end = min(q0 + BM, p.Sq);  // exclusive
  const int k_end = min(p.Sk, q_end);      // causal limit, exclusive
  int k_begin = 0;
  if (p.window > 0) k_begin = max(0, q0 - p.window + 1);
  k_begin = k_begin / BN * BN;
  const int n_tiles = (k_end - k_begin + BN - 1) / BN;  // may be <= 0

  // tile n goes to buffer n % NSTAGE, one commit group per tile (empty
  // past the last), so that wait<NSTAGE - 2> means "tile n has landed"
  auto stage_kv = [&](int n) {
    if (n < n_tiles) {
      T* dst = sKV + (n % NSTAGE) * 2 * BN * LD;
      const int k0 = k_begin + n * BN;
      load_tile_async<T, HD, LD, BN, NT>(dst, K, p.k_ss, k0, p.Sk);
      load_tile_async<T, HD, LD, BN, NT>(dst + BN * LD, V, p.v_ss, k0,
                                           p.Sk);
    }
    cp_async_commit();
  };
  T* sQ = sKV + (NSTAGE - 1) * 2 * BN * LD;  // until the Q fragments load
  load_tile_async<T, HD, LD, BM, NT>(sQ, Q, p.q_ss, q0, p.Sq);
  stage_kv(0);  // one group with Q
#pragma unroll
  for (int n = 1; n < NSTAGE - 1; ++n) stage_kv(n);
  cp_async_wait<NSTAGE - 2>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk],
                sQ + (16 * warp + (lane & 15)) * LD + 16 * kk + (lane >> 4) * 8);

  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int d = 0; d < ND; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  const float sl2 = p.scale * LOG2E;  // to the exp2 domain
  // keys a row may see: [lo, hi) (causal limit, Sk, window)
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = wq0 + g + 8 * r;
    hi[r] = min(qpos + 1, p.Sk);
    lo[r] = p.window > 0 ? qpos - p.window + 1 : 0;
  }

  for (int n = 0; n < n_tiles; ++n) {
    cp_async_wait<NSTAGE - 2>();  // tile n has landed (this thread's part)
    // every thread's part of tile n is visible, and every warp is done
    // with tile n - 1's buffer, which the next copy reuses
    __syncthreads();
    stage_kv(n + NSTAGE - 1);
    const int k0 = k_begin + n * BN;
    // skip the tile for this warp if every (row, key) pair of it is
    // masked: keys after the causal limit or below the window
    const bool skip =
        wq0 >= p.Sq || k0 > wq0 + 15 ||
        (p.window > 0 && wq0 - (k0 + BN - 1) >= p.window);
    if (!skip) {
      const T* kb = sKV + (n % NSTAGE) * 2 * BN * LD;
      const T* vb = kb + BN * LD;
      float s[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kb + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * LD +
                              16 * kk + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * j], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * j + 1], qf[kk], kf[2], kf[3]);
        }
      // masks only where the tile straddles the diagonal, Sk or the window
      const bool edge = k0 + BN - 1 > wq0 || k0 + BN > p.Sk ||
                        (p.window > 0 && wq0 + 15 - k0 >= p.window);
      // online softmax of rows g (r = 0: c[0..1]) and g + 8 (r = 1: c[2..3])
      // on the raw scores; p = 2^(s sl2 - m sl2), one FFMA and one ex2
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (edge) {
          // column c = 8 j + e of this lane is key k0 + 2 t + c
          const int c_lo = lo[r] - k0 - 2 * t, c_hi = hi[r] - k0 - 2 * t;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + e;
              if (c < c_lo || c >= c_hi) s[j][2 * r + e] = -INFINITY;
            }
        }
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        // all masked so far: m_new = -inf, and every p and alpha is 0
        const float base = m_new == -INFINITY ? 0.f : m_new * sl2;
        const float alpha = fast_exp2(fmaf(m[r], sl2, -base));
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          s[j][2 * r] = fast_exp2(fmaf(s[j][2 * r], sl2, -base));
          s[j][2 * r + 1] = fast_exp2(fmaf(s[j][2 * r + 1], sl2, -base));
          rs += s[j][2 * r] + s[j][2 * r + 1];
        }
        l[r] = l[r] * alpha + rs;  // this lane's share; summed at the end
#pragma unroll
        for (int d = 0; d < ND; ++d) {
          o[d][2 * r] *= alpha;
          o[d][2 * r + 1] *= alpha;
        }
      }
      // O += P V: P's accumulators are the A fragments of 16-key steps
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint32_t a[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, vb + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      16 * dd + (lane >> 4) * 8);
          mma_bf16(o[2 * dd], a, vf[0], vf[1]);
          mma_bf16(o[2 * dd + 1], a, vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left; wait all the same
  __syncthreads();     // every warp is done with the buffers

  // normalise, stage the warp's 16 rows in buffer 0 and store them 16
  // bytes at a time
  T* sO = sKV + 16 * warp * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int qpos = wq0 + g + 8 * r;
    if (p.lse != nullptr && t == 0 && qpos < p.Sq)
      p.lse[((int64_t)b * p.H + h) * p.Sq + qpos] =
          (m[r] == -INFINITY ? 0.f : m[r] * p.scale) +
          logf(fmaxf(lr, 1e-30f));
    T* row = sO + (g + 8 * r) * LD + 2 * t;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      store2(row + 8 * d, o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
  }
  __syncwarp();
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = idx / CPR, c = idx % CPR;
    if (wq0 + r < p.Sq)
      *reinterpret_cast<uint4*>(O + (int64_t)(wq0 + r) * p.o_ss + 8 * c) =
          *reinterpret_cast<const uint4*>(sO + r * LD + 8 * c);
  }
}

// ------------------------------------------------------------ launch
template <typename Kernel>
int launch(Kernel kernel, size_t smem, const FaParams& p, int B,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, B * p.H);
  kernel<<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
int launch_hd(const FaParams& p, int B, bool bf16, cudaStream_t stream) {
  if (bf16)
    return launch(fa_bf16_kernel<HD>, FaBf16Shape<HD>::SMEM, p, B, stream);
  return launch(fa_f32_kernel<HD>, FaF32Shape<HD>::SMEM, p, B, stream);
}

int dispatch_hd(const FaParams& p, int B, int hd, bool bf16,
                cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<32>(p, B, bf16, stream);
    case 64: return launch_hd<64>(p, B, bf16, stream);
    case 80: return launch_hd<80>(p, B, bf16, stream);
    case 96: return launch_hd<96>(p, B, bf16, stream);
    case 128: return launch_hd<128>(p, B, bf16, stream);
    case 160: return launch_hd<160>(p, B, bf16, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, hd), k/v: (B, Sk, Hkv, hd), o: (B, Sq, H, hd), each given
// by its data pointer and its (batch, seq, head) element strides in
// `strides` (q, k, v, o in that order); the head dim is contiguous. lse:
// null, or (B, H, Sq) fp32 to receive each row's log-sum-exp (training).
// Returns cudaGetLastError() after the launch, 0 on success.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const int64_t* strides, int B, int H,
                                      int Hkv, int Sq, int Sk, int hd,
                                      int window, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  FaParams p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Sk = Sk;
  p.window = window;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != DTYPE_F32 && dtype != DTYPE_BF16) return cudaErrorInvalidValue;
  return dispatch_hd(p, B, hd, dtype == DTYPE_BF16, s);
}
