// Expert-grouped matrix product (the MoE expert FFN's gate, up and down
// projections): for every row i of lhs,
//   out[i] = lhs[i] @ rhs[tile_expert[i / blk_m]],
// lhs (M, K) holding the routed tokens sorted by expert, each expert's
// group padded to a multiple of blk_m rows, so that every M-tile of blk_m
// rows belongs to one expert; rhs (E, K, N) the stacked expert weights;
// out (M, N) in lhs's dtype, every element one float32 sum rounded once.
// A tile whose expert id is negative (past the last group of a buffer
// sized for the worst case) is written as zeros and reads no weights.
//
// Replaces: src/repro/kernels/grouped_matmul.py::grouped_matmul (Pallas,
// TPU; its body is _gmm_kernel).
//
// Bound: bytes at the serving shapes. One launch reads the weights of
// every expert that owns a tile, up to E x K x N values (64 x 2048 x 1408
// bf16 = 369 MB at deepseek-moe-16b, 0.110 ms of HBM), while a 2048-token
// prompt's gate product is 2 x 12 288 x 2048 x 1408 = 70.9 GFLOP, 0.072 ms
// at the dense bf16 rate; a decode step's 96 assignments do almost no
// arithmetic. So the weight stream sets the pace, and at a prompt the
// tensor cores have to keep up with it.
//
// Three bodies, chosen by dtype and blk_m in grouped_matmul_launch (the
// wrapper's kernels/grouped_matmul.py::design names them):
//
// bfloat16 at blk_m 64 and 128 (prompts of more than 341 tokens at top-6
// over 64 experts): wgmma fed by TMA, warp-specialised and persistent. One
// CTA per SM walks the output tiles (128 x 128 at blk_m 128, 64 x 256 at
// blk_m 64) in groups of four M-tiles, N-tile by N-tile, so the tiles in
// flight at once belong to a few experts and each expert's K x N slab
// comes from HBM about once and from L2 after that. 384 threads: a
// producer warpgroup, one lane of which issues the TMA loads of 64-deep
// stages (lhs: BM rows x 64, K-major; rhs[e]: 64 rows x BN, read in place
// as (K, N) row-major through a 3-D tensor map over (E, K, N), so a K
// tail reads zeros and never the next expert's rows) into a ring of five
// (four at blk_m 64) stages with full and empty mbarriers, across tile
// boundaries; and two consumer warpgroups, each owning 64 rows x 128
// columns of the tile, which run wgmma m64n128k16 (bf16 in, float32 sums)
// from the 128-byte-swizzled stages, B read MN-major through the
// descriptor's transpose bit, one product group in flight while the next
// stage is waited for. setmaxnreg moves registers from the producer to the
// consumers. The epilogue rounds each sum once into a tile in shared
// memory, which leaves in coalesced 16-byte stores, while the producer
// already loads the next tile's stages. A tile whose expert is -1 is
// stored as zeros and loads nothing.
//
// bfloat16 at blk_m 16 and 32 (decode and short prompts): one CTA per
// (M-tile, 128 output columns) reads its expert id from the tile table and
// loops over K, as the Pallas kernel's grid runs K innermost with an
// accumulator in VMEM; here the accumulator stays in registers. Four
// warps, each owning BM rows x 32 columns; 32-deep stages of the lhs tile
// and of the expert's weight slab are copied into shared memory with
// cp.async, double-buffered (stage t + 1 loads while stage t computes),
// and the products run on the tensor cores with mma.sync m16n8k16 (bf16
// products exact, float32 sums), their fragments read with ldmatrix (the
// weights' transposed, since rhs is (K, N) row-major). The M-tile is as
// small as blk_m, so a decode group of one or two rows wastes 16 rows of
// arithmetic and not 128.
//
// float32 (any blk_m): the CUDA cores in full float32 (no TF32, which would
// keep 10 mantissa bits): BM x 64 outputs per CTA of 256 threads, 16-deep
// stages in shared memory, fmaf.
//
// K and N are any multiples of 16 (neither need divide the tile: the tail
// of a stage is zero-filled, and columns past N are neither read nor
// stored); M is a multiple of blk_m, which is 16, 32, 64 or 128. PERF.md
// has the times beside the bound.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"   // TMA, mbarriers, wgmma descriptors, tensor maps

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBN = 128;          // output columns per CTA
constexpr int kBK = 32;           // depth of one shared-memory stage
constexpr int kLdA = kBK + 8;     // row strides of the shared tiles, in
constexpr int kLdB = kBN + 8;     // bf16 (+8: ldmatrix without conflicts)

// d += a b for one m16n8k16 tile: bfloat16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 tiles of 16-bit values from shared memory, one row address
// per lane (lanes 8i..8i+7 give tile i's rows); with kTrans each tile is
// handed out transposed: the layout of mma.sync's A and B fragments.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// One 16-byte copy from global to shared memory without passing through
// registers; with `full` false it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Zeros over the CTA's BM x BN block of out (a tile past the last group).
template <typename T, int BM, int BN>
__device__ __forceinline__ void store_zeros(T* __restrict__ out, int64_t m0,
                                            int n0, int N, int threads) {
  constexpr int kVec = 16 / sizeof(T);
  for (int idx = threadIdx.x; idx < BM * BN / kVec; idx += threads) {
    const int r = idx / (BN / kVec), c = (idx % (BN / kVec)) * kVec;
    if (n0 + c < N)
      *reinterpret_cast<uint4*>(out + (m0 + r) * N + n0 + c) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int BM>
__global__ void __launch_bounds__(128)
gmm_bf16_kernel(const uint16_t* __restrict__ lhs,
                const uint16_t* __restrict__ rhs,
                const int* __restrict__ tile_expert,
                __nv_bfloat16* __restrict__ out, int K, int N) {
  static_assert(BM == 16 || BM == 32, "blk_m 64 and 128 take the wgmma body");
  constexpr int kThreads = 128;
  constexpr int kMT = BM / 16;                 // m16 tiles of each warp
  __shared__ __align__(16) uint16_t as[2][BM * kLdA];
  __shared__ __align__(16) uint16_t bs[2][kBK * kLdB];

  const int e = tile_expert[blockIdx.x];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * kBN;
  if (e < 0) {
    store_zeros<__nv_bfloat16, BM, kBN>(out, m0, n0, N, kThreads);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp;                         // the warp's 32 columns
  const int gr = lane >> 2, tg = lane & 3;
  const uint16_t* a_src = lhs + m0 * K;
  const uint16_t* b_src = rhs + static_cast<int64_t>(e) * K * N + n0;

  auto load_stage = [&](int stage, int k0) {
    for (int idx = threadIdx.x; idx < BM * (kBK / 8); idx += kThreads) {
      const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
      const bool ok = k0 + c < K;
      cp_async16(&as[stage][r * kLdA + c],
                 ok ? a_src + static_cast<int64_t>(r) * K + k0 + c : lhs, ok);
    }
    for (int idx = threadIdx.x; idx < kBK * (kBN / 8); idx += kThreads) {
      const int r = idx / (kBN / 8), c = (idx % (kBN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(&bs[stage][r * kLdB + c],
                 ok ? b_src + static_cast<int64_t>(k0 + r) * N + c : rhs, ok);
    }
  };

  float acc[kMT][4][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][nt][x] = 0.f;

  // this lane's row address in ldmatrix's tiles: A (rows +0..15, columns
  // +0/+8) and B, transposed (depth +0..15, columns +0/+8)
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = (lane >> 4) * 8;
  const int brow = lane & 15;
  const int bcol = (lane >> 4) * 8;

  const int n_k = (K + kBK - 1) / kBK;
  load_stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < n_k; ++t) {
    // stage t + 1 goes into the buffer stage t - 1 left (the barrier at the
    // end of the last iteration saw it consumed)
    if (t + 1 < n_k) {
      load_stage((t + 1) & 1, (t + 1) * kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* at = as[t & 1];
    const uint16_t* bt = bs[t & 1];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        ldsm_x4<false>(a[mi], at + (mi * 16 + arow) * kLdA + kk * 16 + acol);
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t b[4];
        ldsm_x4<true>(b, bt + (kk * 16 + brow) * kLdB + wn * 32 + dp * 16
                             + bcol);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_bf16(acc[mi][2 * dp], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * dp + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // stage t is consumed before its buffer is refilled
  }

  // one rounding per element; each lane stores pairs of adjacent columns
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + tg * 2;
      if (col >= N) continue;
      const int64_t row = m0 + mi * 16 + gr;
      *reinterpret_cast<__nv_bfloat162*>(out + row * N + col) =
          __floats2bfloat162_rn(acc[mi][nt][0], acc[mi][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * N + col) =
          __floats2bfloat162_rn(acc[mi][nt][2], acc[mi][nt][3]);
    }
}

// ---------------------------------------------------------------------------
// bfloat16 at blk_m 64 and 128: wgmma fed by TMA, persistent
// ---------------------------------------------------------------------------

// a producer warpgroup (warps 8-11; one lane issues the loads) after two
// consumer warpgroups; a whole warpgroup, so that setmaxnreg can hand its
// registers to the consumers (168 a thread at launch: the producer's 128
// threads give up 128 each, the consumers' 256 take 64)
constexpr int kWgThreads = 384;
constexpr int kProducerWarp = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kWgBK = 64;          // depth of a stage: one 128-byte row
constexpr int kBox = 64 * 128;     // bytes of one 64 x 64 box of rhs

// Named barrier `id` (1 and 2 here, one per consumer warpgroup; 0 is
// __syncthreads) over n threads.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The CTA's output tile and ring for M-tiles of BM rows: 128 x 128 (the
// two consumers one above the other) or 64 x 256 (side by side), each
// consumer 64 x 128; a stage is the lhs box (BM rows of 128 bytes) and
// BN / 64 boxes of rhs (64 depth rows of 128 bytes each), all 1 KB aligned
// for the swizzle. (128 x 256 tiles at blk_m 128 measured no faster.)
template <int BM>
struct WgCfg {
  static constexpr int BN = BM == 128 ? 128 : 256;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int STAGE = A_BYTES + (BN / 64) * kBox;
  static constexpr int NST = BM == 128 ? 5 : 4;
  // after the ring, each consumer's 64 x 128 output tile in bf16, rows
  // kLdo apart (+8: the fragment writes meet no bank conflicts)
  static constexpr int kLdo = 128 + 8;
  static constexpr int OUT_BYTES = 2 * 64 * kLdo * 2;
  static constexpr size_t SMEM =
      static_cast<size_t>(NST) * STAGE + OUT_BYTES + 1024;
  static_assert(BM == 64 || BM == 128, "the wgmma body takes blk_m 64, 128");
  static_assert(SMEM <= 232448 - 1024, "the ring fits in shared memory");
};

// Tile t of the persistent walk: M-tiles in groups of kGroupM, each
// group's tiles N-tile by N-tile, M-tile by M-tile within an N-tile, so
// the tiles in flight read the weights of a few experts (an expert owns
// about two M-tiles of a 2048-token prompt), which stay in L2 while its
// M-tiles use them. (Groups of 2, 8, 16 and 32 measured no faster than 4
// at deepseek-moe-16b's prompt products.)
constexpr int kGroupM = 4;
__device__ __forceinline__ void tile_of(int64_t t, int tiles_m, int tiles_n,
                                        int& m, int& n) {
  const int64_t per_group = static_cast<int64_t>(kGroupM) * tiles_n;
  const int first = static_cast<int>(t / per_group) * kGroupM;
  const int rows = min(kGroupM, tiles_m - first);
  const int r = static_cast<int>(t % per_group);
  m = first + r % rows;
  n = r / rows;
}

template <int BM>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_lhs,
                 const __grid_constant__ CUtensorMap tm_rhs,
                 const int* __restrict__ tile_expert,
                 __nv_bfloat16* __restrict__ out, int tiles_m, int K, int N) {
  using C = WgCfg<BM>;
  constexpr int NST = C::NST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * NST];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // stage st: lhs at base + st STAGE, rhs right after it; barriers: full
  // (TMA landed) then empty (both consumers done), per stage
  auto full = [&](int st) { return smem_u32(bars) + 8u * st; };
  auto empty = [&](int st) { return smem_u32(bars) + 8u * (NST + st); };
  auto a_tile = [&](int st) { return base + st * C::STAGE; };
  auto b_tile = [&](int st) { return base + st * C::STAGE + C::A_BYTES; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_n = (N + C::BN - 1) / C::BN;
  const int64_t n_tiles = static_cast<int64_t>(tiles_m) * tiles_n;
  const int n_k = (K + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2);   // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Both roles walk the same tiles, t = blockIdx.x, + gridDim.x, ...
  // (tile_of); stage use `it` counts on across tiles, so K / 64 need not
  // divide by the ring's depth.
  if (warp >= kProducerWarp) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs) : "memory");
    if (warp == kProducerWarp && lane == 0) {
      int it = 0;
      for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int m, nt;
        tile_of(t, tiles_m, tiles_n, m, nt);
        const int e = tile_expert[m];
        if (e < 0) continue;
        for (int kb = 0; kb < n_k; ++kb, ++it) {
          const int st = it % NST;
          if (it >= NST) mbar_wait(empty(st), ((it / NST) - 1) & 1);
          mbar_expect_tx(full(st), C::STAGE);
          tma_load_2d(a_tile(st), &tm_lhs, full(st), kb * kWgBK, m * BM);
#pragma unroll
          for (int i = 0; i < C::BN / 64; ++i)
            tma_load_3d(b_tile(st) + i * kBox, &tm_rhs, full(st),
                        nt * C::BN + 64 * i, kb * kWgBK, e);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(kConsumerRegs) : "memory");
  const int wg = warp / 4, wq = warp % 4;
  const int gr = lane >> 2, tg = lane & 3;
  // this warpgroup's 64 rows and 128 columns of the tile
  const int row0 = BM == 128 ? wg * 64 : 0;
  const int col0 = BM == 128 ? 0 : wg * 128;
  __nv_bfloat16* tile_out = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + (base - smem_u32(smem_raw)) + NST * C::STAGE)
      + wg * 64 * C::kLdo;
  float acc[64];
  int it = 0;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int m, nt;
    tile_of(t, tiles_m, tiles_n, m, nt);
    const int c0 = nt * C::BN + col0;
    const int e = tile_expert[m];
    const int64_t r0 = static_cast<int64_t>(m) * BM + row0;
    if (e < 0) {
      // 64 rows x 128 columns of zeros, 16 bytes a store
      for (int idx = threadIdx.x % 128; idx < 64 * 16; idx += 128) {
        const int r = idx / 16, c = c0 + (idx % 16) * 8;
        if (c < N)
          *reinterpret_cast<uint4*>(out + (r0 + r) * N + c) =
              make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    // a warpgroup whose columns all lie past N (the last 64 x 256 tile of
    // an N that 256 does not divide) waits and releases, and computes
    // nothing
    const bool live = c0 < N;
    for (int kb = 0; kb < n_k; ++kb, ++it) {
      const int st = it % NST;
      mbar_wait(full(st), (it / NST) & 1);
      if (live) {
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          // lhs: K-major, 16 depth values = 32 bytes along the row;
          // rhs: MN-major, 16 depth rows of 128 bytes, the two 64-column
          // boxes kBox apart
          const uint64_t da = wg_desc(a_tile(st) + row0 * 128 + kk * 32, 16,
                                      8 * 128, kSwizzle128);
          const uint64_t db = wg_desc(
              b_tile(st) + (col0 / 64) * kBox + kk * 16 * 128, kBox, 8 * 128,
              kSwizzle128);
          wgmma_ss_n128<1>(acc, da, db, kb > 0 || kk > 0);
        }
      }
      wgmma_commit();
      // the product before this one is done: its stage goes back
      wgmma_wait<1>();
      if (kb > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(empty((it - 1) % NST));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (threadIdx.x % 128 == 0) mbar_arrive(empty((it - 1) % NST));
    if (!live) continue;
    // one rounding per element, through shared memory: acc[4 i + 2 r + u]
    // is row 16 wq + gr + 8 r, column 8 i + 2 tg + u of the warpgroup's
    // 64 x 128; the tile then leaves in 16-byte stores, a row's 256 bytes
    // at a time (pairs of bf16 stored from the fragments straight to
    // global memory cost ~20% of the call at a 2048-token prompt)
    bar_sync(1 + wg, 128);   // the last tile's copy-out has read the buffer
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<__nv_bfloat162*>(
            tile_out + (wq * 16 + gr + 8 * r) * C::kLdo + 8 * i + 2 * tg) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    bar_sync(1 + wg, 128);
    for (int idx = threadIdx.x % 128; idx < 64 * 16; idx += 128) {
      const int r = idx / 16, c = (idx % 16) * 8;
      if (c0 + c < N)
        *reinterpret_cast<uint4*>(out + (r0 + r) * N + c0 + c) =
            *reinterpret_cast<const uint4*>(tile_out + r * C::kLdo + c);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBNf = 64;   // output columns per CTA
constexpr int kBKf = 16;   // depth of one stage (K is a multiple of 16)

template <int BM>
__global__ void __launch_bounds__(256)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int* __restrict__ tile_expert, float* __restrict__ out,
               int K, int N) {
  constexpr int TM = BM / 16;   // rows per thread: ty, ty + 16, ...
  __shared__ __align__(16) float as[kBKf][BM + 4];   // lhs tile, transposed
  __shared__ __align__(16) float bs[kBKf][kBNf];

  const int e = tile_expert[blockIdx.x];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * kBNf;
  if (e < 0) {
    store_zeros<float, BM, kBNf>(out, m0, n0, N, 256);
    return;
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* a_src = lhs + m0 * K;
  const float* b_src = rhs + static_cast<int64_t>(e) * K * N + n0;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBKf) {
    for (int idx = threadIdx.x; idx < BM * kBKf; idx += 256) {
      const int r = idx / kBKf, c = idx % kBKf;
      as[c][r] = a_src[static_cast<int64_t>(r) * K + k0 + c];
    }
    for (int idx = threadIdx.x; idx < kBKf * kBNf; idx += 256) {
      const int r = idx / kBNf, c = idx % kBNf;
      bs[r][c] = n0 + c < N ? b_src[static_cast<int64_t>(k0 + r) * N + c]
                            : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBKf; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = as[k][ty + 16 * i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
  const int col = n0 + tx * 4;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i)
    *reinterpret_cast<float4*>(out + (m0 + ty + 16 * i) * N + col) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// The tensor maps of the wgmma body: lhs (M, K) in boxes of BM rows x 64
// columns; rhs (E, K, N) in boxes of 64 x 64 of one expert, so depth rows
// past K read as zeros, not as the next expert's. Both 128-byte swizzled.
int make_maps(CUtensorMap* lhs_map, CUtensorMap* rhs_map, const void* lhs,
              const void* rhs, int64_t M, int K, int N, int64_t E, int BM) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -3;
  const cuuint32_t step[3] = {1, 1, 1};
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t a_box[2] = {64, static_cast<cuuint32_t>(BM)};
  CUresult r = fn(lhs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(lhs), a_dims, a_strides, a_box, step,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -3;
  const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(E)};
  const cuuint64_t b_strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                   static_cast<cuuint64_t>(K) * N * 2};
  const cuuint32_t b_box[3] = {64, 64, 1};
  r = fn(rhs_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
         const_cast<void*>(rhs), b_dims, b_strides, b_box, step,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int BM>
int launch_wgmma(const void* lhs, const void* rhs, const int* tile_expert,
                 void* out, int64_t M, int K, int N, int64_t E,
                 cudaStream_t stream) {
  using C = WgCfg<BM>;
  // built per call: the pointers change from call to call
  CUtensorMap tm_lhs, tm_rhs;
  const int rc = make_maps(&tm_lhs, &tm_rhs, lhs, rhs, M, K, N, E, BM);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gmm_wgmma_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles_m = M / BM;
  const int64_t tiles = tiles_m * ((N + C::BN - 1) / C::BN);
  const unsigned int grid = static_cast<unsigned int>(tiles < sms ? tiles
                                                                  : sms);
  gmm_wgmma_kernel<BM><<<grid, kWgThreads, C::SMEM, stream>>>(
      tm_lhs, tm_rhs, tile_expert, static_cast<__nv_bfloat16*>(out),
      static_cast<int>(tiles_m), K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_mma(const void* lhs, const void* rhs, const int* tile_expert,
               void* out, int64_t tiles, int K, int N, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(tiles), (N + kBN - 1) / kBN);
  gmm_bf16_kernel<BM><<<grid, 128, 0, stream>>>(
      static_cast<const uint16_t*>(lhs), static_cast<const uint16_t*>(rhs),
      tile_expert, static_cast<__nv_bfloat16*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_f32(const void* lhs, const void* rhs, const int* tile_expert,
               void* out, int64_t tiles, int K, int N, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>(tiles), (N + kBNf - 1) / kBNf);
  gmm_f32_kernel<BM><<<grid, 256, 0, stream>>>(
      static_cast<const float*>(lhs), static_cast<const float*>(rhs),
      tile_expert, static_cast<float*>(out), K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer aligned to 16 bytes: lhs (M, K), rhs (E, K, N) and out
// (M, N) in one dtype (0 float32, 1 bfloat16), tile_expert (M / blk_m,)
// int32 with ids below E (negative: a tile of zeros); K and N multiples of
// 16, M a multiple of blk_m in {16, 32, 64, 128} (the wrapper checks all of
// these). bfloat16 at blk_m 64 and 128 takes the wgmma/TMA body, at 16 and
// 32 the mma.sync one; float32 the CUDA-core one. Launches on `stream`
// without synchronising and returns cudaGetLastError(), -1 for a bad
// argument or -3 when the driver cannot build a tensor map.
extern "C" int grouped_matmul_launch(const void* lhs, const void* rhs,
                                     const void* tile_expert, void* out,
                                     int64_t M, int K, int N, int E,
                                     int blk_m, int dtype, void* stream) {
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16 || E < 1 || blk_m < 1
      || M % blk_m || M / blk_m > 2147483647LL || (dtype != 0 && dtype != 1))
    return -1;
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = M / blk_m;
  if (dtype == 1 && blk_m == 128)
    return launch_wgmma<128>(lhs, rhs, te, out, M, K, N, E, st);
  if (dtype == 1 && blk_m == 64)
    return launch_wgmma<64>(lhs, rhs, te, out, M, K, N, E, st);
  if (dtype == 1 && blk_m == 32)
    return launch_mma<32>(lhs, rhs, te, out, tiles, K, N, st);
  if (dtype == 1 && blk_m == 16)
    return launch_mma<16>(lhs, rhs, te, out, tiles, K, N, st);
  switch (blk_m) {
    case 16: return launch_f32<16>(lhs, rhs, te, out, tiles, K, N, st);
    case 32: return launch_f32<32>(lhs, rhs, te, out, tiles, K, N, st);
    case 64: return launch_f32<64>(lhs, rhs, te, out, tiles, K, N, st);
    case 128: return launch_f32<128>(lhs, rhs, te, out, tiles, K, N, st);
    default: return -1;
  }
}
