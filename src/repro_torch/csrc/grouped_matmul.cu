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
// arithmetic. So the weight stream sets the pace: one CTA per (M-tile,
// 128 output columns) streams its expert's K x 128 slab once, and the
// M-tile is as small as the caller's blk_m (16 at decode, so a group of
// one or two rows wastes 16 rows of arithmetic and not 128).
//
// Design: one CTA per (M-tile, N-tile) reads its expert id from the tile
// table and loops over K, as the Pallas kernel's grid runs K innermost
// with an accumulator in VMEM; here the accumulator stays in registers.
//   bfloat16: BM = blk_m rows x 128 columns; four warps per 64 rows, each
//   owning BM (or 64) rows x 32 columns; 32-deep stages of the lhs tile
//   and of the expert's weight slab are copied into shared memory with
//   cp.async, double-buffered (stage t + 1 loads while stage t computes),
//   and the products run on the tensor cores with mma.sync m16n8k16
//   (bf16 products exact, float32 sums), their fragments read with
//   ldmatrix (the weights' transposed, since rhs is (K, N) row-major).
//   float32: the CUDA cores in full float32 (no TF32, which would keep 10
//   mantissa bits): BM x 64 outputs per CTA of 256 threads, 16-deep
//   stages in shared memory, fmaf.
// K and N are any multiples of 16 (neither need divide the tile: the tail
// of a stage is zero-filled, and columns past N are neither read nor
// stored); M is a multiple of blk_m, which is 16, 32, 64 or 128. Making it
// fast (wgmma, TMA, warp specialisation, a persistent schedule) is later
// work; PERF.md has its times beside the bound.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
__global__ void __launch_bounds__(BM == 128 ? 256 : 128)
gmm_bf16_kernel(const uint16_t* __restrict__ lhs,
                const uint16_t* __restrict__ rhs,
                const int* __restrict__ tile_expert,
                __nv_bfloat16* __restrict__ out, int K, int N) {
  constexpr int kWarpsM = BM == 128 ? 2 : 1;   // warps down the tile
  constexpr int kThreads = 128 * kWarpsM;
  constexpr int kWM = BM / kWarpsM;            // rows per warp
  constexpr int kMT = kWM / 16;                // its m16 tiles
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
  const int wm = warp / 4, wn = warp % 4;      // the warp's rows and columns
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
        ldsm_x4<false>(a[mi], at + (wm * kWM + mi * 16 + arow) * kLdA
                                  + kk * 16 + acol);
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
      const int64_t row = m0 + wm * kWM + mi * 16 + gr;
      *reinterpret_cast<__nv_bfloat162*>(out + row * N + col) =
          __floats2bfloat162_rn(acc[mi][nt][0], acc[mi][nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (row + 8) * N + col) =
          __floats2bfloat162_rn(acc[mi][nt][2], acc[mi][nt][3]);
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

template <int BM>
int launch(const void* lhs, const void* rhs, const int* tile_expert,
           void* out, int64_t tiles, int K, int N, int dtype,
           cudaStream_t stream) {
  if (dtype == 1) {
    const dim3 grid(static_cast<unsigned int>(tiles), (N + kBN - 1) / kBN);
    gmm_bf16_kernel<BM><<<grid, BM == 128 ? 256 : 128, 0, stream>>>(
        static_cast<const uint16_t*>(lhs), static_cast<const uint16_t*>(rhs),
        tile_expert, static_cast<__nv_bfloat16*>(out), K, N);
  } else if (dtype == 0) {
    const dim3 grid(static_cast<unsigned int>(tiles), (N + kBNf - 1) / kBNf);
    gmm_f32_kernel<BM><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs),
        tile_expert, static_cast<float*>(out), K, N);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer aligned to 16 bytes: lhs (M, K), rhs (E, K, N) and out
// (M, N) in one dtype (0 float32, 1 bfloat16), tile_expert (M / blk_m,)
// int32 with ids below E (negative: a tile of zeros); K and N multiples of
// 16, M a multiple of blk_m in {16, 32, 64, 128} (the wrapper checks all of
// these). Launches on `stream` without synchronising and returns
// cudaGetLastError(), or -1 for a bad argument.
extern "C" int grouped_matmul_launch(const void* lhs, const void* rhs,
                                     const void* tile_expert, void* out,
                                     int64_t M, int K, int N, int blk_m,
                                     int dtype, void* stream) {
  if (M < 1 || K < 16 || N < 16 || K % 16 || N % 16 || blk_m < 1
      || M % blk_m || M / blk_m > 2147483647LL)
    return -1;
  const int* te = static_cast<const int*>(tile_expert);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = M / blk_m;
  switch (blk_m) {
    case 16: return launch<16>(lhs, rhs, te, out, tiles, K, N, dtype, st);
    case 32: return launch<32>(lhs, rhs, te, out, tiles, K, N, dtype, st);
    case 64: return launch<64>(lhs, rhs, te, out, tiles, K, N, dtype, st);
    case 128: return launch<128>(lhs, rhs, te, out, tiles, K, N, dtype, st);
    default: return -1;
  }
}
