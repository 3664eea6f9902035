// Attention forward without a cache (flash attention): for every query
// position i of head h,
//   out[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / G] * scale)
//                  v[b, j, h / G],        scale = 1 / sqrt(D),
// over j < Skv, and j <= i when causal (top-left aligned: query row i sees
// key columns 0..i whatever Skv is). q is (B, Sq, Hq, D), k and v (B, Skv,
// Hkv, D), out (B, Sq, Hq, D), Hq = G * Hkv; bfloat16 or float32 operands;
// scores, softmax statistics and sums in float32.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention (Pallas,
// TPU; its body is _flash_kernel).
//
// Bound: operations. One (query, key) pair costs 4 D operations (q.k and
// p.v) against 2 D values of k and v read once per query tile: at
// hubert-xlarge's shape (B = 8, S = 4096, 16 heads of 80, bf16) one call is
// 0.69 TFLOP over 42 MB, ~16 000 operations per byte, far above the card's
// ~295. PERF.md has the times beside the bound.
//
// Two designs, chosen by dtype and head dim in flash_attention_launch:
//
// bfloat16 at D = 64, 80 and 128 (every configuration's head dim but
// gemma's 256): wgmma with TMA loads, warp-specialised. One CTA per
// (128-row query tile, query head, batch row), 384 threads: two consumer
// warpgroups of 64 query rows each and a producer warpgroup, whose one
// lane issues TMA loads (4-D tensor maps over the (B, S, H, D) tensors
// read in place, rows past the end filled with zeros) of the Q tile once
// and of 128-key K and V tiles into a ring of three stages, each with a
// full barrier for K, one for V and an empty barrier both warpgroups
// arrive on when they are done with it; setmaxnreg moves registers from
// the producer to the consumers. A consumer computes S = Q K^T with
// wgmma m64n128k16 from swizzled shared memory (both K-major; Q loaded
// once), the online softmax in registers, and O += P V with wgmma
// m64nNk16, P from registers (the exponentials rounded to bfloat16) and V
// read MN-major (transposed) through its descriptor. Three things keep
// the tensor cores fed: the softmax of tile t runs while the P V of tile
// t - 1 is in flight (one S accumulator, one P); the two warpgroups take
// turns to issue their products (two named barriers), so one's softmax
// runs under the other's products; and the row maxima and sums reduce
// over eight and four partial values, since two warps a scheduler hide
// little latency. A tile row of D values is D / 64 blocks of 64 columns
// with the 128-byte swizzle, and at D = 80 one more block of 16 columns
// with the 32-byte swizzle (a row of 80 is wider than one 128-byte swizzle
// row; no tensor work is spent on padding), which P V takes as a second
// product of width 16.
//
// Every other case keeps the first design: one CTA per (64-row query tile,
// query head, batch row); the query tile stays in shared memory while
// 64-key tiles of K and V stream through it, and the head dim is padded
// inside to DP (16, 32, 64, 80, 128 or 256) with zero columns, so any D up
// to 256 is taken; the tail rows of the last query and key tiles are zero
// and never stored.
//   bfloat16 (D <= 32, other widths up to 256): four warps, 16 query rows
//   each; Q K^T and P V on the tensor cores with mma.sync m16n8k16 (their
//   fragments read from shared memory with ldmatrix, V's transposed), K and
//   V double-buffered by cp.async.
//   float32 (any D): no tensor cores (TF32 would keep 10 mantissa bits):
//   256 threads on a 16 x 16 grid, each owning 4 x 4 scores and 4 x DP/16
//   outputs, fmaf on the CUDA cores; P is not rounded.
//
// Common to both: q, k and v are read in place in the (B, S, H, D) layout
// the model hands over, a row of D values every H * D (the Pallas wrapper
// copies them into (B*H, S, D) first). Query head h reads KV head h / G,
// the Pallas kernel's index map, so K and V are never repeated per head.
// The online softmax (running max m, sum l, accumulator) stays in
// registers in float32, as the Pallas kernel keeps it in VMEM scratch.
// Causal: the KV tiles wholly above the diagonal are not visited; masked
// scores (above the diagonal, past the last key) take the Pallas kernel's
// NEG_INF (-2^30), and only the tiles that cross the diagonal or the keys'
// end are masked element by element. Tile 0 always holds key 0, which
// every query row sees, so the running max is a real score before any
// masked entry meets it and the masked weights are exactly 0. Query tiles
// are issued from the last to the first, so the longest causal rows start
// first. In bfloat16 the exponentials are exp2 of the scores scaled by
// scale * log2(e) (one fmaf with the running max subtracted, since the
// unit is built with --fmad=false), the weights P are rounded to bfloat16
// before P V, and the row sums l add those rounded weights, so the
// normaliser matches the numerator; the plain version rounds its weights
// to bfloat16 as well. The final division is by max(l, 1e-30), as the
// Pallas kernel's.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"   // TMA, mbarriers, wgmma descriptors, tensor maps

namespace {

using namespace hopper;

constexpr int kBM = 64;  // query rows per CTA
constexpr int kBN = 64;  // keys per tile
// the reference's NEG_INF (-2^30)
constexpr float kNegInf = -1073741824.0f;
constexpr int kMaxSmem = 232448;

struct Shape {
  int64_t Sq, Skv;
  int Hq, Hkv, G, D, causal;
};

// Key tiles the query tile starting at q0 visits: all of them, or, when
// causal, those that start at or before its last row.
__device__ __forceinline__ int kv_tiles(const Shape& s, int64_t q0) {
  int64_t n = (s.Skv + kBN - 1) / kBN;
  const int64_t last = (q0 + kBM - 1) / kBN + 1;
  if (s.causal && last < n) n = last;
  return static_cast<int>(n);
}

__device__ __forceinline__ bool masked(const Shape& s, int64_t i, int64_t j) {
  return j >= s.Skv || (s.causal && j > i);
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

// d += a b for one m16n8k16 tile: bfloat16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8 x 8 tiles of 16-bit values from shared memory, one row address
// per lane (lanes 8i..8i+7 give tile i's rows); with kTrans each tile is
// handed out transposed. Lane t gets, of each tile, row t / 4 and columns
// 2 (t % 4) and 2 (t % 4) + 1 (transposed: those rows of column t / 4), the
// layout of mma.sync's A and B fragments.
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

// Two floats rounded to bfloat16 (round to nearest even, as torch's cast)
// and packed, the first in the low half; `rlo`, `rhi` get the rounded values.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& rlo,
                                              float& rhi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const uint32_t u = *reinterpret_cast<uint32_t*>(&v);
  // a bf16 is the top half of the float it rounds: widen with bit moves
  // on the integer pipe, not with conversions
  rlo = __uint_as_float(u << 16);
  rhi = __uint_as_float(u & 0xffff0000u);
  return u;
}

// Rows [0, rows) of a tile whose row r starts at src + r * stride (D
// values) into dst (kRows x DP, row stride DP + 8); the other rows and the
// columns D..DP-1 are zero. 16-byte loads when D is a multiple of 8.
template <int DP, int kRows>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst,
                                               const uint16_t* __restrict__ src,
                                               int64_t stride, int64_t rows,
                                               int D) {
  constexpr int kVecs = DP / 8;
  const bool vec = D % 8 == 0;
  for (int e = threadIdx.x; e < kRows * kVecs; e += blockDim.x) {
    const int r = e / kVecs, c = (e % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const uint16_t* row = src + r * stride;
      if (vec) {
        if (c < D) val = *reinterpret_cast<const uint4*>(row + c);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t lo = c + 2 * u < D ? row[c + 2 * u] : 0u;
          const uint32_t hi = c + 2 * u + 1 < D ? row[c + 2 * u + 1] : 0u;
          w[u] = lo | (hi << 16);
        }
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c) = val;
  }
}

// One 16-byte copy from global to shared memory without passing through
// registers (cp.async); with `full` false it writes 16 zero bytes and
// reads nothing.
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

// A tile as load_tile_bf16 stores it, but with asynchronous copies (D a
// multiple of 8); they land once the thread's group is waited for.
template <int DP, int kRows>
__device__ __forceinline__ void load_tile_async(
    uint16_t* dst, const uint16_t* __restrict__ src, int64_t stride,
    int64_t rows, int D) {
  constexpr int kVecs = DP / 8;
  for (int e = threadIdx.x; e < kRows * kVecs; e += blockDim.x) {
    const int r = e / kVecs, c = (e % kVecs) * 8;
    const bool full = r < rows && c < D;
    cp_async16(dst + r * (DP + 8) + c, full ? src + r * stride + c : src,
               full);
  }
}

template <int DP>
__global__ void __launch_bounds__(128)
flash_bf16_kernel(const uint16_t* __restrict__ q,
                  const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, __nv_bfloat16* __restrict__ o,
                  Shape s) {
  constexpr int kLd = DP + 8;    // row stride of a shared tile, in bf16
  constexpr int kDn = DP / 8;    // n8 tiles of the output row
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* qs = smem16;             // [kBM][kLd]
  uint16_t* ks = qs + kBM * kLd;     // [2][kBN][kLd], double-buffered
  uint16_t* vs = ks + 2 * kBN * kLd; // [2][kBN][kLd]
  constexpr int kK = DP / 16;    // k16 steps over the head dim

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tg = lane & 3;
  const int rb = warp * 16;  // this warp's rows of the tile
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hk = h / s.G;
  const int64_t qstride = static_cast<int64_t>(s.Hq) * s.D;
  const int64_t kstride = static_cast<int64_t>(s.Hkv) * s.D;
  const int64_t koff = (b * s.Skv * s.Hkv + hk) * s.D;
  // scores in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
  const float scale2 = 1.0f / sqrtf(static_cast<float>(s.D))
                       * 1.4426950408889634f;
  // this lane's row address in ldmatrix's tiles: Q (A operand: rows
  // rb..rb+15, columns +0/+8), K (B: keys +0..15 of a pair of n8 tiles,
  // columns +0/+8) and V (B, transposed: keys +0..15, dims +0/+8)
  const int qrow = rb + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int qcol = (lane >> 4) * 8;
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 8;
  const int vrow = lane & 15;
  const int vcol = (lane >> 4) * 8;

  // Q, then key tiles t + 1 copied while tile t computes (asynchronously
  // when D is a multiple of 8; else with plain loads)
  const bool vec = s.D % 8 == 0;
  const uint16_t* qsrc = q + (b * s.Sq * s.Hq + h) * s.D + q0 * qstride;
  if (vec)
    load_tile_async<DP, kBM>(qs, qsrc, qstride, s.Sq - q0, s.D);
  else
    load_tile_bf16<DP, kBM>(qs, qsrc, qstride, s.Sq - q0, s.D);
  auto load_kv = [&](int t) {
    const int64_t k0 = static_cast<int64_t>(t) * kBN;
    uint16_t* kd = ks + (t & 1) * kBN * kLd;
    uint16_t* vd = vs + (t & 1) * kBN * kLd;
    if (vec) {
      load_tile_async<DP, kBN>(kd, k + koff + k0 * kstride, kstride,
                               s.Skv - k0, s.D);
      load_tile_async<DP, kBN>(vd, v + koff + k0 * kstride, kstride,
                               s.Skv - k0, s.D);
    } else {
      load_tile_bf16<DP, kBN>(kd, k + koff + k0 * kstride, kstride,
                              s.Skv - k0, s.D);
      load_tile_bf16<DP, kBN>(vd, v + koff + k0 * kstride, kstride,
                              s.Skv - k0, s.D);
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDn][4];
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int n_tiles = kv_tiles(s, q0);
  load_kv(0);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t k0 = static_cast<int64_t>(t) * kBN;
    // tile t + 1 goes into the buffer that tile t - 1 left (the barrier at
    // the end of the last iteration saw it consumed)
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* kt_s = ks + (t & 1) * kBN * kLd;
    const uint16_t* vt_s = vs + (t & 1) * kBN * kLd;

    // scores: this warp's 16 rows x the tile's 64 keys, eight n8 tiles
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int ki = 0; ki < kK; ++ki) {
      uint32_t a[4];
      ldsm_x4<false>(a, qs + qrow * kLd + ki * 16 + qcol);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4<false>(bk, kt_s + (np * 16 + krow) * kLd + ki * 16 + kcol);
        mma_bf16(sc[2 * np], a[0], a[1], a[2], a[3], bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
      }
    }
    // scale, and mask where the tile crosses the diagonal or the keys'
    // end; the row maxima over the quad that shares a row
    const bool edge = k0 + kBN > s.Skv || (s.causal && k0 + kBN - 1 > q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t i = q0 + rb + gr + (e >> 1) * 8;
        const int64_t j = k0 + nt * 8 + tg * 2 + (e & 1);
        const float x = edge && masked(s, i, j) ? kNegInf
                                                : sc[nt][e] * scale2;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // the weights, rounded to bf16 and packed as P V's A fragments
    uint32_t pk[8][2];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float r0, r1, r2, r3;
      pk[nt][0] = pack_bf16(exp2f(sc[nt][0] - m[0]), exp2f(sc[nt][1] - m[0]),
                            r0, r1);
      pk[nt][1] = pack_bf16(exp2f(sc[nt][2] - m[1]), exp2f(sc[nt][3] - m[1]),
                            r2, r3);
      rs[0] += r0 + r1;
      rs[1] += r2 + r3;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = alpha[r] * l[r] + rs[r];
    }
#pragma unroll
    for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];
    // acc += P V: k16 steps over the tile's keys, pairs of n8 dim tiles
#pragma unroll
    for (int kt = 0; kt < kBN / 16; ++kt) {
#pragma unroll
      for (int dp = 0; dp < kDn / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4<true>(bv, vt_s + (kt * 16 + vrow) * kLd + dp * 16 + vcol);
        mma_bf16(acc[2 * dp], pk[2 * kt][0], pk[2 * kt][1],
                 pk[2 * kt + 1][0], pk[2 * kt + 1][1], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pk[2 * kt][0], pk[2 * kt][1],
                 pk[2 * kt + 1][0], pk[2 * kt + 1][1], bv[2], bv[3]);
      }
    }
    __syncthreads();  // tile t is consumed before its buffer is refilled
  }

  __nv_bfloat16* ob = o + (b * s.Sq * s.Hq + h) * s.D;
#pragma unroll
  for (int dn = 0; dn < kDn; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t i = q0 + rb + gr + (e >> 1) * 8;
      const int c = dn * 8 + tg * 2 + (e & 1);
      if (i < s.Sq && c < s.D)
        ob[i * qstride + c] =
            __float2bfloat16(acc[dn][e] / fmaxf(l[e >> 1], 1e-30f));
    }
}

// ---------------------------------------------------------------------------
// bfloat16 at D = 64, 80 and 128: wgmma with TMA loads
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;     // query rows per CTA: two warpgroups of 64
constexpr int kWgKeys = 128;     // keys per tile
// two consumer warpgroups, then the producer warpgroup (warps 8-11), whose
// one lane issues the loads: a whole warpgroup, so that setmaxnreg can
// hand its registers to the consumers (168 a thread at launch; the
// producer's 128 threads give up 144 each, the consumers' 256 take 72)
constexpr int kWgThreads = 384;
constexpr int kProducerWarp = 8;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// The shared-memory layout of one 128-row tile of Q, K or V at head dim D:
// D / 64 blocks of 64 columns, each one TMA box as TMA writes it with the
// 128-byte swizzle, then at D = 80 a block of the last 16 columns with the
// 32-byte swizzle (a row of 80 is wider than one 128-byte swizzle row; the
// narrow block keeps it unpadded). The blocks lie one after another.
template <int D>
struct WgTile {
  static constexpr int NW = D / 64;            // 64-column blocks
  static constexpr int TAIL = D % 64;          // columns of the narrow block
  static constexpr int WIDE = kWgRows * 128;   // bytes of a 64-column block
  static constexpr int NARROW = kWgRows * 32;  // bytes of the 16-column one
  static constexpr int BYTES = NW * WIDE + (TAIL ? NARROW : 0);
  static constexpr int NST = 3;   // K/V ring stages (deeper rings measured
                                  // no faster)
  static constexpr size_t SMEM = (1 + 2 * NST) * static_cast<size_t>(BYTES)
                                 + 1024;   // + alignment of the base
  static_assert(NW >= 1 && (TAIL == 0 || TAIL == 16),
                "the wgmma body takes D = 64, 80 or 128");
  static_assert(BYTES % 1024 == 0, "tiles stay 1 KB aligned");
};
// Named barrier `id` (1 and 2 here; 0 is __syncthreads) over n threads:
// wait for it, or arrive on it without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// 2^x on the special-function unit (one instruction; relative error about
// 2^-22, far below the bf16 rounding the weights then take)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A B for one m64n16k16 step, A (four bf16 pairs a thread, the
// m16n8k16 A fragment of this warp's 16 rows) in registers and B in shared
// memory, MN-major (transposed); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (+)= A B for one m64n64k16 step, A (four bf16 pairs a thread, the
// m16n8k16 A fragment of this warp's 16 rows) in registers and B in shared
// memory, MN-major (transposed); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (+)= A B for one m64n128k16 step, A (four bf16 pairs a thread, the
// m16n8k16 A fragment of this warp's 16 rows) in registers and B in shared
// memory, MN-major (transposed); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// K-major descriptor of k-step kk (16 head dims) of a tile at `tile`,
// starting `row0` rows in (Q: a warpgroup's 64 rows; K: all 128 keys).
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int row0,
                                                int kk) {
  using T = WgTile<D>;
  const int col = kk * 16;
  if (col < 64 * T::NW)
    return wg_desc(tile + (col / 64) * T::WIDE + row0 * 128 + (col % 64) * 2,
                   16, 8 * 128, kSwizzle128);
  return wg_desc(tile + T::NW * T::WIDE + row0 * 32, 16, 8 * 32, kSwizzle32);
}

// acc += P V over V's keys 16 kk .. 16 kk + 15: V is read MN-major
// (transposed); the 64-column blocks go in one product (WIDE bytes apart,
// groups of 8 keys 1 KB apart), the narrow block of D = 80 in a second.
template <int D>
__device__ __forceinline__ void pv_step(float (&acc)[D / 2],
                                        const uint32_t (&p)[4], uint32_t tile,
                                        int kk) {
  using T = WgTile<D>;
  const uint64_t wide = wg_desc(tile + kk * 16 * 128, T::WIDE, 8 * 128,
                                kSwizzle128);
  float (&main)[32 * T::NW] = *reinterpret_cast<float (*)[32 * T::NW]>(acc);
  if constexpr (T::NW == 1) wgmma_rs_n64(main, p, wide, 1);
  else wgmma_rs_n128(main, p, wide, 1);
  if constexpr (T::TAIL != 0) {
    float (&tail)[8] = *reinterpret_cast<float (*)[8]>(acc + 32 * T::NW);
    wgmma_rs_n16(tail, p,
                 wg_desc(tile + T::NW * T::WIDE + kk * 16 * 32, T::NARROW,
                         8 * 32, kSwizzle32),
                 1);
  }
}

// The tensor maps of one operand: `wide` boxes of 64 columns, `narrow`
// boxes of the last 16 (D = 80 only).
struct WgMaps {
  CUtensorMap wide, narrow;
};

template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const WgMaps& m,
                                          uint32_t bar, int h, int row,
                                          int b) {
  using T = WgTile<D>;
#pragma unroll
  for (int i = 0; i < T::NW; ++i)
    tma_load_4d(dst + i * T::WIDE, &m.wide, bar, 64 * i, h, row, b);
  if constexpr (T::TAIL != 0)
    tma_load_4d(dst + T::NW * T::WIDE, &m.narrow, bar, 64 * T::NW, h, row,
                b);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ WgMaps tm_q,
                   const __grid_constant__ WgMaps tm_k,
                   const __grid_constant__ WgMaps tm_v,
                   __nv_bfloat16* __restrict__ o, Shape s) {
  using T = WgTile<D>;
  constexpr int NST = T::NST;
  constexpr int KSTEPS = kWgKeys / 16;   // k-steps of P V
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * NST];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  // stage st: K at base + (1 + 2 st) tiles, V right after it
  // barriers: Q's, then per stage K full, V full and empty
  const uint32_t q_full = smem_u32(bars);
  auto k_full = [&](int st) { return q_full + 8u * (1 + st); };
  auto v_full = [&](int st) { return q_full + 8u * (1 + NST + st); };
  auto empty = [&](int st) { return q_full + 8u * (1 + 2 * NST + st); };
  auto k_tile = [&](int st) { return base + (1 + 2 * st) * T::BYTES; };
  auto v_tile = [&](int st) { return base + (2 + 2 * st) * T::BYTES; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x)
                     * kWgRows;   // the longest causal rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / s.G;
  int n_tiles = static_cast<int>((s.Skv + kWgKeys - 1) / kWgKeys);
  if (s.causal && q0 / kWgKeys + 1 < n_tiles)
    n_tiles = static_cast<int>(q0 / kWgKeys + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 2);   // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    // the producer: one lane issues every TMA load; K/V tile t goes into
    // stage t % NST once both warpgroups have released the tile there
    // before it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs) : "memory");
    if (warp == kProducerWarp && lane == 0) {
      mbar_expect_tx(q_full, T::BYTES);
      load_tile<D>(q_tile, tm_q, q_full, h, static_cast<int>(q0), b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % NST;
        if (t >= NST) mbar_wait(empty(st), ((t / NST) - 1) & 1);
        mbar_expect_tx(k_full(st), T::BYTES);
        load_tile<D>(k_tile(st), tm_k, k_full(st), hk, t * kWgKeys, b);
        mbar_expect_tx(v_full(st), T::BYTES);
        load_tile<D>(v_tile(st), tm_v, v_full(st), hk, t * kWgKeys, b);
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows, 16 a warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs) : "memory");
    const int wg = warp / 4, wq = warp % 4;
    const int gr = lane >> 2, tg = lane & 3;
    const int row0 = wg * 64;                  // the warpgroup's rows
    const int64_t i0 = q0 + row0 + wq * 16 + gr;   // this thread's rows:
                                                   // i0 and i0 + 8
    // scores in log2 units: exp(x * scale) = exp2(x * scale * log2(e))
    const float scale2 = 1.0f / sqrtf(static_cast<float>(s.D))
                         * 1.4426950408889634f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[64];               // S of the tile in hand, then its weights
    uint32_t pk[KSTEPS][4];     // the last tile's weights: P V's A operand

    // S = Q K^T of tile t (asynchronous): this warpgroup's 64 rows x the
    // tile's 128 keys
    auto issue_s = [&](int t) {
      const int st = t % NST;
      mbar_wait(k_full(st), (t / NST) & 1);
      // the updates of acc and pk happen before the fence, not after it
      fence_regs(acc);
      fence_regs(pk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128<0>(sc, kmajor_desc<D>(q_tile, row0, kk),
                      kmajor_desc<D>(k_tile(st), 0, kk), kk > 0);
      wgmma_commit();
    };
    // acc += P V of tile t (asynchronous), P from pk
    auto issue_pv = [&](int t) {
      const int st = t % NST;
      mbar_wait(v_full(st), (t / NST) & 1);
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        pv_step<D>(acc, pk[kk], v_tile(st), kk);
      wgmma_commit();
    };
    // the online softmax of tile t on sc, in place: masks where the tile
    // crosses the keys' end or, for these rows, the diagonal; updates m and
    // puts the old state's factor into alpha; leaves exp2 of the scaled
    // scores minus the new max in sc. sc[4 i + e] is row i0 + 8 (e >> 1),
    // key k0 + 8 i + 2 tg + (e & 1).
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int64_t k0 = static_cast<int64_t>(t) * kWgKeys;
      const bool edge = k0 + kWgKeys > s.Skv
                        || (s.causal && k0 + kWgKeys - 1 > q0 + row0);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int64_t row = i0 + ((i >> 1) & 1) * 8;
          const int64_t j = k0 + (i >> 2) * 8 + tg * 2 + (i & 1);
          if (masked(s, row, j)) sc[i] = kNegInf;
        }
      }
      // row maxima: eight partial maxima a row (short dependency chains:
      // two warps a scheduler leave little latency hidden), then the quad
      float part[2][8];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        part[(i >> 1) & 1][(i >> 2) * 2 + (i & 1)] = sc[i];
#pragma unroll
      for (int i = 16; i < 64; ++i) {
        float& p = part[(i >> 1) & 1][((i >> 2) & 3) * 2 + (i & 1)];
        p = fmaxf(p, sc[i]);
      }
      float mx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(fmaxf(fmaxf(part[r][0], part[r][1]),
                            fmaxf(part[r][2], part[r][3])),
                      fmaxf(fmaxf(part[r][4], part[r][5]),
                            fmaxf(part[r][6], part[r][7])));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale2);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i)
        sc[i] = ex2(fmaf(sc[i], scale2, -m[(i >> 1) & 1]));
    };
    // the weights rounded to bf16 into pk (k-step kk of P V takes score
    // blocks 2 kk and 2 kk + 1), l updated with the rounded weights, and
    // acc brought to the new max
    auto hand_on = [&](const float (&alpha)[2]) {
      float part[2][4] = {};    // four partial sums a row, as the maxima
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float lo, hi;
        pk[i / 4][i % 4] = pack_bf16(sc[2 * i], sc[2 * i + 1], lo, hi);
        // pairs alternate rows i0 and i0 + 8
        part[i & 1][(i >> 1) & 3] += lo + hi;
      }
      float rs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] = (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = fmaf(alpha[r], l[r], rs[r]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    };

    // Tile t's softmax runs while tile t - 1's P V is on the tensor cores,
    // and the two warpgroups take turns to issue their products (named
    // barrier 1 + wg is this warpgroup's turn; warpgroup 0 goes first), so
    // one's softmax runs while the other's products do.
    auto my_turn = [&]() { bar_sync(1 + wg, 256); };
    auto your_turn = [&]() { bar_arrive(2 - wg, 256); };
    // K and V of tile t are done with once its P V is: hand the stage back
    // (releasing K earlier, once S is done, measured slower)
    auto release = [&](int t) {
      if (threadIdx.x % 128 == 0) mbar_arrive(empty(t % NST));
    };
    mbar_wait(q_full, 0);
    float alpha[2];
    if (wg == 1) your_turn();
    my_turn();
    issue_s(0);
    your_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, alpha);
    hand_on(alpha);                // acc is zero: the factor changes nothing
    for (int t = 1; t < n_tiles; ++t) {
      my_turn();
      issue_s(t);
      issue_pv(t - 1);
      your_turn();
      wgmma_wait<1>();             // S of tile t is done
      fence_regs(sc);
      softmax(t, alpha);
      wgmma_wait<0>();             // P V of tile t - 1 is done
      fence_regs(acc);
      fence_regs(pk);
      release(t - 1);
      hand_on(alpha);
    }
    fence_regs(acc);
    fence_regs(pk);
    wgmma_fence();
    my_turn();
    issue_pv(n_tiles - 1);
    your_turn();
    wgmma_wait<0>();
    fence_regs(acc);

    __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * s.Sq * s.Hq + h) * s.D;
    const int64_t qstride = static_cast<int64_t>(s.Hq) * s.D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t i = i0 + r * 8;
      if (i >= s.Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            acc[4 * n + 2 * r] / denom, acc[4 * n + 2 * r + 1] / denom);
        *reinterpret_cast<__nv_bfloat162*>(ob + i * qstride + n * 8
                                           + tg * 2) = v2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kTP = kBM + 4;  // row stride of a transposed tile: 16-byte
                              // aligned rows, fewer bank conflicts

// K consecutive floats of shared memory at p (aligned to their width).
template <int K>
__device__ __forceinline__ void lds(const float* p, float (&out)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = x.x; out[4 * i + 1] = x.y;
      out[4 * i + 2] = x.z; out[4 * i + 3] = x.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(p)[i];
      out[2 * i] = x.x; out[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = p[i];
  }
}

// Rows [0, rows) of a 64-row tile (row r at src + r * stride, D values),
// zero elsewhere, into dst: transposed (dst[c * kTP + r]) or as rows of DP.
template <int DP, bool kTransposed>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int64_t stride, int64_t rows,
                                              int D) {
  static_assert(kBM == kBN, "query and key tiles share the loader");
  for (int e = threadIdx.x; e < kBN * DP; e += blockDim.x) {
    const int r = e / DP, c = e % DP;
    const float x = r < rows && c < D ? src[r * stride + c] : 0.f;
    dst[kTransposed ? c * kTP + r : r * DP + c] = x;
  }
}

template <int DP>
__global__ void __launch_bounds__(256)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Shape s) {
  constexpr int PT = DP / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // Q transposed [DP][kTP]
  float* kt = qt + DP * kTP;   // K transposed [DP][kTP]
  float* vs = kt + DP * kTP;   // V            [kBN][DP]
  float* pt = vs + kBN * DP;   // P transposed [kBN][kTP]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hk = h / s.G;
  const int64_t qstride = static_cast<int64_t>(s.Hq) * s.D;
  const int64_t kstride = static_cast<int64_t>(s.Hkv) * s.D;
  const int64_t koff = (b * s.Skv * s.Hkv + hk) * s.D;
  const float scale = 1.0f / sqrtf(static_cast<float>(s.D));

  load_tile_f32<DP, true>(qt, q + (b * s.Sq * s.Hq + h) * s.D + q0 * qstride,
                          qstride, s.Sq - q0, s.D);

  float m[4], l[4], acc[4][PT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < PT; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = kv_tiles(s, q0);
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t k0 = static_cast<int64_t>(t) * kBN;
    __syncthreads();
    load_tile_f32<DP, true>(kt, k + koff + k0 * kstride, kstride, s.Skv - k0,
                            s.D);
    load_tile_f32<DP, false>(vs, v + koff + k0 * kstride, kstride, s.Skv - k0,
                             s.D);
    __syncthreads();

    // scores: rows ty * 4 + r, keys tx * 4 + c
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
      lds<4>(qt + d * kTP + ty * 4, qv);
      lds<4>(kt + d * kTP + tx * 4, kv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }
    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t i = q0 + ty * 4 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = masked(s, i, k0 + tx * 4 + c) ? kNegInf
                                                      : sc[r][c] * scale;
        sc[r][c] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of a row group are 16 lanes of one warp
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[r][c] = expf(sc[r][c] - m_new);
        rs += sc[r][c];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = alpha[r] * l[r] + rs;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (tx * 4 + c) * kTP + ty * 4) =
          make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < PT; ++c) acc[r][c] *= alpha[r];
#pragma unroll 4
    for (int j = 0; j < kBN; ++j) {
      float pv[4], vv[PT];
      lds<4>(pt + j * kTP + ty * 4, pv);
      lds<PT>(vs + j * DP + tx * PT, vv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < PT; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

  float* ob = o + (b * s.Sq * s.Hq + h) * s.D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t i = q0 + ty * 4 + r;
    if (i >= s.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < PT; ++c) {
      const int col = tx * PT + c;
      if (col < s.D) ob[i * qstride + col] = acc[r][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel, typename T, typename O>
int launch(Kernel kernel, int threads, size_t smem, const void* q,
           const void* k, const void* v, void* out, int64_t B,
           const Shape& s, cudaStream_t stream) {
  if (smem > static_cast<size_t>(kMaxSmem)) return -2;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((s.Sq + kBM - 1) / kBM),
                  static_cast<unsigned int>(s.Hq),
                  static_cast<unsigned int>(B));
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<O*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

// A 4-D tensor map over a (B, S, H, D) bfloat16 tensor read in place (row
// stride H * D): one box is `bw` columns (64 or 16) of one head x 128 rows
// of one batch row, swizzled as WgTile lays it out (128 or 32 bytes);
// rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S, int H,
             int D, int bw) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -3;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bw), 1, kWgRows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      bw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// Both maps of one operand (the narrow one only at D = 80).
int make_maps(WgMaps* m, const void* ptr, int64_t B, int64_t S, int H,
              int D) {
  int rc = make_map(&m->wide, ptr, B, S, H, D, 64);
  if (rc == 0) rc = D % 64 ? make_map(&m->narrow, ptr, B, S, H, D, 16) : 0;
  if (D % 64 == 0) m->narrow = m->wide;
  return rc;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int64_t B, const Shape& s, cudaStream_t stream) {
  using T = WgTile<D>;
  // built per call: the pointers change from call to call
  WgMaps tq, tk, tv;
  int rc = make_maps(&tq, q, B, s.Sq, s.Hq, D);
  if (rc == 0) rc = make_maps(&tk, k, B, s.Skv, s.Hkv, D);
  if (rc == 0) rc = make_maps(&tv, v, B, s.Skv, s.Hkv, D);
  if (rc != 0) return rc;
  auto kernel = flash_wgmma_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((s.Sq + kWgRows - 1) / kWgRows),
                  static_cast<unsigned int>(s.Hq),
                  static_cast<unsigned int>(B));
  kernel<<<grid, kWgThreads, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dtype(const void* q, const void* k, const void* v, void* out,
                 int64_t B, const Shape& s, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    return launch<decltype(&flash_f32_kernel<DP>), float, float>(
        flash_f32_kernel<DP>, 256,
        sizeof(float) * (2 * DP * kTP + kBN * DP + kBN * kTP), q, k, v, out,
        B, s, stream);
  if (dtype == 1)
    return launch<decltype(&flash_bf16_kernel<DP>), uint16_t, __nv_bfloat16>(
        flash_bf16_kernel<DP>, 128,
        sizeof(uint16_t) * (kBM + 4 * kBN) * (DP + 8),
        q, k, v, out, B, s, stream);
  return -1;
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer aligned to 16 bytes; dtype is 0 for float32 and 1 for
// bfloat16; 1 <= D <= 256; Hq = G * Hkv; B <= 65535 and Hq <= 65535 (the
// grid's y and z); causal is 0 or 1 (the wrapper checks all of these).
// bfloat16 at D = 64, 80 and 128 takes the wgmma/TMA kernel, every other
// case the mma.sync (bfloat16) or CUDA-core (float32) one. Launches on
// `stream` without synchronising and returns cudaGetLastError(), -1 for a
// bad argument, -2 when the tiles do not fit in shared memory or -3 when
// the driver cannot build a tensor map.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int64_t B,
                                      int64_t Sq, int64_t Skv, int Hq,
                                      int Hkv, int D, int causal, int dtype,
                                      void* stream) {
  if (B < 1 || B > 65535 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq < Hkv
      || Hq % Hkv || Hq > 65535 || D < 1 || (causal != 0 && causal != 1))
    return -1;
  const Shape s{Sq, Skv, Hq, Hkv, Hq / Hkv, D, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 64) return launch_wgmma<64>(q, k, v, out, B, s, st);
  if (dtype == 1 && D == 80) return launch_wgmma<80>(q, k, v, out, B, s, st);
  if (dtype == 1 && D == 128)
    return launch_wgmma<128>(q, k, v, out, B, s, st);
  if (D <= 16) return launch_dtype<16>(q, k, v, out, B, s, dtype, st);
  if (D <= 32) return launch_dtype<32>(q, k, v, out, B, s, dtype, st);
  if (D <= 64) return launch_dtype<64>(q, k, v, out, B, s, dtype, st);
  if (D <= 80) return launch_dtype<80>(q, k, v, out, B, s, dtype, st);
  if (D <= 128) return launch_dtype<128>(q, k, v, out, B, s, dtype, st);
  if (D <= 256) return launch_dtype<256>(q, k, v, out, B, s, dtype, st);
  return -1;
}
