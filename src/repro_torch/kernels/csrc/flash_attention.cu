// Flash attention forward (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd -> _fa_kernel): causal softmax attention with an
// optional sliding window and native GQA (query head h reads KV head
// h / (H / Hkv)), online softmax with an fp32 running max, denominator and
// accumulator, output clamped by max(l, 1e-30) (a fully masked row gives
// 0) and written in the input dtype.
//
// What bounds it: operations where the sequences are long. At qwen3-8b's
// training shape (B=2, S=4096, 32/8 heads of 128, bf16) the two products
// over the causal pairs are 275 GFLOP, 0.278 ms at the bf16 tensor-core
// peak, against 0.10 GB to move (Q, K, V read once, O written once), 0.03
// ms; at the serving prefill (B=4, S=512, 32/8 heads of 128) bytes, 41.9
// MB (12.5 us) against 8.6 GFLOP (8.7 us). So both products run on the
// tensor cores at their full rate (wgmma), and the loads, the products and
// the softmax have to overlap rather than follow one another.
//
// bf16 body (fa_hopper_kernel), the serving and training dtype, at every
// head dim (32, 64, 80, 96, 128, 160). One persistent block an SM (a grid
// of min(items, SMs)) walks work items, a 128-query tile of one (batch,
// head) each, a head's heaviest tiles first, in rounds of gridDim.x items
// whose order alternates from round to round, so that no block draws the
// heavy tiles every round. A block is three warpgroups. Warpgroup 0 gives
// up its registers (setmaxnreg 24) and one thread loads by TMA: per item
// its Q tile once the last item's Q has been read (an mbarrier pair), then
// its K and V tiles, from the window's lower edge to the causal limit,
// into a ring of NST stages, each
// a full and an empty mbarrier, whose stages run on across items: the next
// item's tiles load under this one's last tiles and its epilogue. A tile
// of R rows is ceil(hd / 64) boxes of R rows x 128 bytes in the 128-byte
// swizzle that the wgmma descriptors name (hopper.cuh); the last box's
// columns past hd are TMA's zero fill, and rows past Sq or Sk are zeros.
// Warpgroups 1 and 2 (setmaxnreg 240) each own 64 of an item's 128 query
// rows and share every K/V tile, so a tile crosses shared memory once for
// 128 queries. Per tile a consumer warpgroup runs S = Q K^T on wgmma
// m64nBNk16 with both operands in shared memory, K-major (hd / 16 k-steps:
// never the zero fill); the online softmax in the accumulator registers
// (row max and sum over the 4 lanes of a row by two shuffles; p = 2^(s *
// scale * log2 e - m) as one FFMA and one ex2.approx); P rounded to bf16
// in registers as the A operand of O += P V, V MN-major (N = hd: 64 or 128
// columns over whole boxes, plus an N = 16 or 32 instruction from the last
// box's start at hd 80, 96 and 160; hd 32 one N = 32 instruction). What
// overlaps: a tile's S is issued together with the previous tile's P V
// and O's rescaling runs under S, so the softmax waits for S alone; the
// two consumer warpgroups take turns to issue (named barriers 1 and 2), so
// one's softmax runs under the other's products; the loads run ahead in
// the ring. Rounding P to bf16 is what JAX's model and SDPA do; the Pallas
// kernel and the plain version keep P in fp32. Each consumer thread
// arrives on a stage's empty barrier once that tile's P V has landed. The
// key tile, BN, is 128 keys up to hd 128 and 64 at hd 160.
//
// Registers a consumer thread (fp32 words): O hd / 2, S BN / 2, P BN / 4
// (bf16 pairs): hd 128 64 + 64 + 32, hd 96 48 + 64 + 32, hd 80 40 + 64 +
// 32, hd 64 32 + 64 + 32, hd 32 16 + 64 + 32, hd 160 80 + 32 + 16, under
// the 240 that setmaxnreg gives it. Launch bounds hold a thread to 168 at
// entry (384 x 168 = 128 x 24 + 256 x 240); a build with fewer is refused
// before its first launch (check_entry_registers: the consumers'
// setmaxnreg.inc would wait for ever). Shared memory: a Q tile of 128 rows
// and NST stages of K and V tiles (16 KB a 128-row box, 8 KB a 64-row
// one), the most stages up to 4 that fit the block's 227 KB: hd 32 and 64
// 16 + 4 x 32 KB (144 KB), hd 80, 96 and 128 32 + 3 x 64 KB (224 KB), hd
// 160 48 + 3 x 48 KB (192 KB). Three stages are the fewest the overlap
// needs (a warpgroup holds one tile for S and the last for P V). Every
// head dim runs one block (12 warps) an SM, set by the registers as much as
// by shared memory. What bounds it now, and what each part costs
// (tools/ablate_kernels.py), is in PERF.md.
//
// fp32 body (fa_f32_kernel), the precision path for the tests and for
// compare_paths, not a serving dtype: TF32 tensor cores would not hold its
// limits, so it keeps the CUDA cores. Each thread owns 4 query rows and 8
// keys of a 64x64 score tile, row max and sum reduced over 8 lanes by
// shuffles, probabilities through shared memory to the P V product.
//
// Both: the key loop starts at the window's lower edge and stops at the
// causal limit, so fully masked tiles cost nothing (the Pallas kernel
// computed and masked them); the bf16 body's warpgroups also skip a tile
// in which every pair of their 64 rows is masked, and mask only where a
// warp's 16 rows straddle the diagonal, Sk or the window's edge; the
// heaviest (last) query tiles of a head go first; operands are read
// through their strides, so the model hands (B, S, H, hd) projections over
// without a copy (the TMA maps take the three strides). Every sum runs in
// a fixed order: two runs give the same bits.
//
// Training (flash_attention_bwd.cu): given an lse pointer, both bodies also
// write each row's log-sum-exp of the scaled scores, lse = m + log l in
// fp32 ((B, H, Sq), m taken as 0 for a row with every key masked, l
// clamped as the output's denominator is), from which the backward
// recomputes P. Serving passes none and writes nothing more. Rows at or
// past Sq are never written.

#include "hopper.cuh"

namespace {

constexpr int BM = 64;   // fp32 body: query rows per block
constexpr int BN = 64;   // fp32 body: keys per tile
constexpr int NT = 128;  // fp32 body: threads, 16 row groups x 8 lanes
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
// wgmma on TMA tiles with a producer warp; the header says why
constexpr int HBM = 128;  // query rows a block: two consumer warpgroups
constexpr int HNT = 384;  // a producer and two consumer warpgroups
// registers a thread at entry: 384 x 168 = 128 x 24 (producer) + 256 x
// 240 (consumers), what setmaxnreg moves them to
constexpr int ENTRY_REGS = 168;
constexpr int MAX_SMEM = 232448;  // a block's shared memory (227 KB)

// named barrier `id` of the two consumer warpgroups (256 threads): wait for
// it, or arrive without waiting. The warpgroups take turns to issue their
// products on barriers 1 and 2, so that one's softmax runs under the
// other's wgmma.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// a block's bytes: a Q tile, nst x (K, V) tiles, the mbarriers, + 1024 to
// align
constexpr int hopper_bytes(int qtile, int ktile, int nst) {
  return qtile + nst * 2 * ktile + (2 * nst + 2) * 8 + 1024;
}

template <int HD>
struct FaHopperShape {
  static constexpr int NB = (HD + BOX - 1) / BOX;  // boxes a tile row
  static constexpr int BN = HD > 128 ? 64 : 128;   // keys a tile
  static constexpr int QBOX = box_bytes(HBM);      // bytes of a Q box
  static constexpr int KBOX = box_bytes(BN);       // of a K or V box
  static constexpr int QTILE = NB * QBOX;
  static constexpr int KTILE = NB * KBOX;
  // TMA ring depth: the most stages up to 4 that fit
  static constexpr int NST =
      hopper_bytes(QTILE, KTILE, 4) <= MAX_SMEM   ? 4
      : hopper_bytes(QTILE, KTILE, 3) <= MAX_SMEM ? 3
                                                  : 2;
  // Q, then NST x (K, V), then the mbarriers
  static constexpr int OFF_STAGE = QTILE;
  static constexpr int OFF_BAR = OFF_STAGE + NST * 2 * KTILE;
  static constexpr int BYTES = hopper_bytes(QTILE, KTILE, NST);
  static_assert(BYTES <= MAX_SMEM, "the ring must fit a block");
};

// A work item: a 128-query tile of one (batch, head), its KV head, its
// key tiles from the window's edge (k_begin) to the causal limit. Item w
// is query tile n_qt - 1 - w % n_qt of head w / n_qt: a head's heaviest
// tiles come first, and the items in flight at one time read a few heads'
// K and V, which stay in L2.
struct FaItem {
  int b, h, hk, q0, k_begin, n_tiles;
};
template <int KN>
__device__ __forceinline__ FaItem fa_item(const FaParams& p, int n_qt,
                                          int w) {
  FaItem f;
  const int bh = w / n_qt;
  f.b = bh / p.H;
  f.h = bh % p.H;
  f.hk = f.h / (p.H / p.Hkv);
  f.q0 = (n_qt - 1 - w % n_qt) * HBM;
  const int q_end = min(f.q0 + HBM, p.Sq);  // exclusive
  const int k_end = min(p.Sk, q_end);       // causal limit, exclusive
  f.k_begin = (p.window > 0 ? max(0, f.q0 - p.window + 1) : 0) / KN * KN;
  f.n_tiles = max(0, (k_end - f.k_begin + KN - 1) / KN);
  return f;
}

// The work item of round i of block c among G: the rounds run over the
// items G at a time, each block taking item c of an even round and item
// G - 1 - c of an odd one, so that a block that drew a head's heavy tiles
// in one round draws light ones in the next (with G a multiple of the
// query tiles, every block would draw the same tile of each head)
__device__ __forceinline__ int fa_round_item(int i) {
  return i * gridDim.x + (i & 1 ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// One persistent block an SM walks its items, fa_round_item(0),
// fa_round_item(1), ... while they are below n_items (a round's items
// past the end all fall to the blocks that stop). Warpgroup 0 is the
// producer: one thread loads each
// item's Q once the last item's has been read, then its key tiles, K and
// V by TMA into the ring, whose stages run on across items, so the next
// item's tiles load under this one's last tiles and its epilogue.
// Warpgroups 1 and 2 each take 64 of an item's query rows: per tile S = Q
// K^T (wgmma, both operands in shared memory), the online softmax in
// registers, and O += T(P) V with P as the register A operand, each
// tile's S in flight with the previous tile's P V.
template <int HD>
__global__ void __launch_bounds__(HNT, 1) fa_hopper_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv, const FaParams p, int n_qt,
    int n_items) {
  using C = FaHopperShape<HD>;
  using T = __nv_bfloat16;
  constexpr int KN = C::BN, NST = C::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* empty = full + NST;
  uint64_t* q_full = empty + NST;
  uint64_t* q_empty = q_full + 1;
  // the warp's index, uniform across its lanes to the compiler as well: a
  // branch on it holds no divergent path around the wgmma instructions
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + s, 1);     // the producer's expect_tx
      mbar_init(empty + s, 256);  // every consumer thread
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x != 0) return;
    int it = 0;  // the ring's tiles so far
    for (int j = 0, w = fa_round_item(0); w < n_items;
         w = fa_round_item(++j)) {
      const FaItem f = fa_item<KN>(p, n_qt, w);
      if (j > 0) mbar_wait(q_empty, (j - 1) & 1);  // the last Q is read
      mbar_expect_tx(q_full, C::QTILE);
      for (int c = 0; c < C::NB; ++c)
        tma_box(smem + c * C::QBOX, &mq, q_full, BOX * c, f.h, f.q0, f.b);
      for (int n = 0; n < f.n_tiles; ++n, ++it) {
        const int st = it % NST;
        if (it >= NST) mbar_wait(empty + st, ((it / NST) & 1) ^ 1);
        unsigned char* dst = smem + C::OFF_STAGE + st * 2 * C::KTILE;
        const int k0 = f.k_begin + n * KN;
        mbar_expect_tx(full + st, 2 * C::KTILE);
        for (int c = 0; c < C::NB; ++c) {
          tma_box(dst + c * C::KBOX, &mk, full + st, BOX * c, f.hk, k0, f.b);
          tma_box(dst + C::KTILE + c * C::KBOX, &mv, full + st, BOX * c,
                  f.hk, k0, f.b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds an item's query rows wq0 + [0, 64),
  // its warp cw rows rq0 + [0, 16)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  constexpr int NA = HD / 2;  // a 64 x HD accumulator's floats a thread
  constexpr int NS = KN / 2;  // a 64 x KN score tile's
  constexpr int KS = KN / 16;  // k-steps of P V
  const int wg = warp / 4 - 1, cw = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  // the warpgroup's 64 rows of each Q box
  const uint32_t sQ = smem_addr(smem) + wg * box_bytes(64);
  const float sl2 = p.scale * LOG2E;  // to the exp2 domain

  float o[NA], m[2], l[2];
  float s[NS];           // a tile's scores, then its p
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.f;
  uint32_t pa[KS][4];    // the previous tile's P, bf16, until its P V
  uint32_t sV = 0;       // the previous tile's V
  int prev = 0;          // its stage
  float alpha[2];        // a tile's rescaling of O
  int it = 0;            // the ring's tiles before this item
  int k_begin = 0, rq0 = 0;
  int lo[2], hi[2];      // keys row g + 8 r may see: [lo, hi)

  // turns: warpgroup wg waits on barrier 1 + wg and passes to 2 - wg once
  // a tile, skipped ones too, so the two keep count; warpgroup 0 goes first
  auto take_turn = [&]() { turn_wait(1 + wg); };
  auto pass_turn = [&]() { turn_pass(2 - wg); };
  // the item's tile n has landed in its stage; returns the stage
  auto wait_tile = [&](int n) {
    const int st = (it + n) % NST;
    mbar_wait(full + st, ((it + n) / NST) & 1);
    return st;
  };
  // a tile outside the warpgroup's range: released once it has landed
  auto skip_tile = [&](int n) {
    const int st = wait_tile(n);
    take_turn();
    pass_turn();
    mbar_arrive(empty + st);
  };
  // S = Q K^T of the tile in stage st, issued and committed
  auto issue_s = [&](int st) {
    const uint32_t sK = smem_addr(smem) + C::OFF_STAGE + st * 2 * C::KTILE;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<KN>(s, kmajor(sQ, kk, C::QBOX), kmajor(sK, kk, C::KBOX),
                   kk > 0);
    wg_commit();
  };
  // O += T(P) V of the previous tile, issued and committed
  auto issue_pv = [&]() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_rs<HD, C::KBOX>(o, pa[kk], sV, kk);
    wg_commit();
  };
  // the previous tile's P V has landed: its stage is released
  auto retire_pv = [&]() {
    keep<NA>(o);
    keep_frags<KS>(pa);
    mbar_arrive(empty + prev);
  };
  // the online softmax of tile n's scores, S landed: s becomes p (fp32),
  // alpha each row's rescaling of O. Masks only where the warp's rows
  // straddle the diagonal, Sk or the window; s[4 j + 2 r + e] is row rq0 +
  // g + 8 r, key k0 + 8 j + 2 t + e. p = 2^(s sl2 - m sl2) on the raw
  // scores.
  auto softmax = [&](int n) {
    keep<NS>(s);
    const int k0 = k_begin + n * KN;
    const bool edge = k0 + KN - 1 > rq0 || k0 + KN > p.Sk ||
                      (p.window > 0 && rq0 + 15 - k0 >= p.window);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (edge) {
        const int c_lo = lo[r] - k0 - 2 * t, c_hi = hi[r] - k0 - 2 * t;
        if (p.window > 0) {
#pragma unroll
          for (int j = 0; j < KN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + e;
              if (c < c_lo || c >= c_hi) s[4 * j + 2 * r + e] = -INFINITY;
            }
        } else {  // no key of a tile lies below the row's lo
#pragma unroll
          for (int j = 0; j < KN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * j + e >= c_hi) s[4 * j + 2 * r + e] = -INFINITY;
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // all masked so far: m_new = -inf, and every p and alpha is 0
      const float base = m_new == -INFINITY ? 0.f : m_new * sl2;
      alpha[r] = fast_exp2(fmaf(m[r], sl2, -base));
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
        float* sj = s + 4 * j + 2 * r;
        sj[0] = fast_exp2(fmaf(sj[0], sl2, -base));
        sj[1] = fast_exp2(fmaf(sj[1], sl2, -base));
        rs += sj[0] + sj[1];
      }
      l[r] = l[r] * alpha[r] + rs;  // this lane's share; summed at the end
    }
  };
  // tile n's p become the next P, its V the next P V's
  auto next_p = [&](int st) {
    to_frags<KS>(s, pa);
    sV = smem_addr(smem) + C::OFF_STAGE + st * 2 * C::KTILE + C::KTILE;
    prev = st;
  };
  // O holds the tiles before the previous one (their P V landed):
  // rescaled to the previous tile's max before its P V adds to it, while
  // the tensor cores run this tile's S
  auto rescale_o = [&]() {
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o[4 * d + 2 * r] *= alpha[r];
        o[4 * d + 2 * r + 1] *= alpha[r];
      }
    wg_fence();
  };

  if (wg == 1) turn_pass(1);
  for (int j = 0, w = fa_round_item(0); w < n_items;
       w = fa_round_item(++j)) {
    const FaItem f = fa_item<KN>(p, n_qt, w);
    k_begin = f.k_begin;
    const int wq0 = f.q0 + 64 * wg;
    rq0 = wq0 + 16 * cw;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = rq0 + g + 8 * r;
      hi[r] = min(qpos + 1, p.Sk);
      lo[r] = p.window > 0 ? qpos - p.window + 1 : 0;
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NA; ++i) o[i] = 0.f;
    // the warpgroup's tiles, [n_lo, n_hi): the others have every (row, key)
    // pair of its 64 rows masked (no row below Sq, every key after the
    // causal limit, or every key below the window). It still waits for
    // each of them and releases it, so that each thread's arrivals on a
    // stage's empty barrier keep to the producer's phases.
    int n_lo = 0, n_hi = 0;
    if (wq0 < p.Sq) {
      n_hi = min(f.n_tiles, (wq0 + 63 - k_begin) / KN + 1);
      const int below = wq0 - p.window - KN + 2 - k_begin;  // k0 must reach
      n_lo = min(n_hi,
                 p.window > 0 && below > 0 ? (below + KN - 1) / KN : 0);
    }
    mbar_wait(q_full, j & 1);
    // Q is released to the next item once the range's last S has landed
    if (n_lo == n_hi) mbar_arrive(q_empty);
    int n = 0;
    for (; n < n_lo; ++n) skip_tile(n);
    if (n < n_hi) {
      // the first tile: S alone
      int st = wait_tile(n);
      take_turn();
      wg_fence();
      issue_s(st);
      pass_turn();
      wg_wait0();
      if (n == n_hi - 1) mbar_arrive(q_empty);
      softmax(n);
      next_p(st);
      // then each tile's S in flight with the previous tile's P V, the
      // softmax of S waiting only for S
      for (++n; n < n_hi; ++n) {
        st = wait_tile(n);
        take_turn();
        wg_fence();
        issue_s(st);
        rescale_o();
        issue_pv();
        pass_turn();
        wg_wait<1>();
        if (n == n_hi - 1) mbar_arrive(q_empty);
        softmax(n);
        wg_wait0();
        retire_pv();
        next_p(st);
      }
      // the last P V
      rescale_o();
      issue_pv();
      wg_wait0();
      retire_pv();
    }
    for (; n < f.n_tiles; ++n) skip_tile(n);
    it += f.n_tiles;

    // normalise and store: o[4 d + 2 r + e] is row rq0 + g + 8 r, column
    // 8 d + 2 t + e
    T* O = static_cast<T*>(p.o) + f.b * p.o_sb + f.h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const float denom = fmaxf(lr, 1e-30f), inv = 1.f / denom;
      const int qpos = rq0 + g + 8 * r;
      if (qpos >= p.Sq) continue;
      if (p.lse != nullptr && t == 0)
        p.lse[((int64_t)f.b * p.H + f.h) * p.Sq + qpos] =
            (m[r] == -INFINITY ? 0.f : m[r] * p.scale) + logf(denom);
      T* row = O + (int64_t)qpos * p.o_ss + 2 * t;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        store2(row + 8 * d, o[4 * d + 2 * r] * inv,
               o[4 * d + 2 * r + 1] * inv);
    }
  }
  if (wg == 0) turn_wait(1);  // warpgroup 1's last pass
}

// ------------------------------------------------------------ launch
template <int HD>
int launch_hopper(const FaParams& p, int B, cudaStream_t stream) {
  using C = FaHopperShape<HD>;
  CUtensorMap mq, mk, mv;
  int err =
      make_map(&mq, p.q, p.q_sb, p.q_ss, p.q_sh, B, p.Sq, p.H, HD, HBM);
  if (!err)
    err = make_map(&mk, p.k, p.k_sb, p.k_ss, p.k_sh, B, p.Sk, p.Hkv, HD,
                   C::BN);
  if (!err)
    err = make_map(&mv, p.v, p.v_sb, p.v_ss, p.v_sh, B, p.Sk, p.Hkv, HD,
                   C::BN);
  if (err) return err;
  static const int attr = [] {
    const int e = check_entry_registers(fa_hopper_kernel<HD>, ENTRY_REGS);
    return e ? e
             : cudaFuncSetAttribute(fa_hopper_kernel<HD>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    C::BYTES);
  }();
  if (attr != cudaSuccess) return attr;
  // one persistent block an SM, or one an item where there are fewer
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                         dev);
  if (err) return err;
  const int n_qt = (p.Sq + HBM - 1) / HBM;
  const int64_t n_items = (int64_t)n_qt * B * p.H;
  if (n_items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = n_items < n_sm ? static_cast<int>(n_items) : n_sm;
  fa_hopper_kernel<HD><<<grid, HNT, C::BYTES, stream>>>(
      mq, mk, mv, p, n_qt, static_cast<int>(n_items));
  return cudaGetLastError();
}

template <int HD>
int launch_hd(const FaParams& p, int B, bool bf16, cudaStream_t stream) {
  if (bf16) return launch_hopper<HD>(p, B, stream);
  const int smem = static_cast<int>(FaF32Shape<HD>::SMEM);
  const cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, B * p.H);
  fa_f32_kernel<HD><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
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

bool is_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 80 || hd == 96 || hd == 128 ||
         hd == 160;
}

}  // namespace

// The body that flash_attention_launch runs for head dim `hd` and `dtype`:
// 0 the fp32 CUDA-core body, 1 the Hopper (wgmma, TMA) body (the codes of
// flash_attention_bwd_body); -1 for a pair it refuses.
extern "C" int flash_attention_body(int hd, int dtype) {
  if (!is_head_dim(hd) || (dtype != DTYPE_F32 && dtype != DTYPE_BF16))
    return -1;
  return dtype == DTYPE_BF16 ? 1 : 0;
}

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
