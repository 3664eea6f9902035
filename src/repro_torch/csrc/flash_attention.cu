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
// ~295. The kernel does not reach the tensor cores' rate: it uses mma.sync
// (not wgmma), four warps share each K/V tile, and every tile costs two
// barriers. PERF.md has its times beside the bound.
//
// Design: one CTA per (64-row query tile, query head, batch row); the
// query tile stays in shared memory while 64-key tiles of K and V stream
// through it (in bfloat16 double-buffered: tile t + 1 is copied with
// cp.async while tile t computes), and the online softmax (running max m,
// sum l, accumulator) stays in registers in float32, as the Pallas kernel
// keeps it in VMEM scratch. q, k and v are read in place in the (B, S, H,
// D) layout the model hands over, a row of D values every H * D (the
// Pallas wrapper copies them into (B*H, S, D) first). Query head h reads
// KV head h / G, the Pallas kernel's index map, so K and V are never
// repeated per head.
// Causal: the KV tiles wholly above the diagonal are not visited; masked
// scores (above the diagonal, past the last key) take the Pallas kernel's
// NEG_INF (-2^30). Tile 0 always holds key 0, which every query row sees,
// so the running max is a real score before any masked entry meets it and
// exp(NEG_INF - m) is exactly 0. The
// head dim is padded inside to DP (16, 32, 64, 80, 128 or 256) with zero
// columns, so any D up to 256 is taken; the tail rows of the last query and
// key tiles are zero and never stored. Query tiles are issued from the last
// to the first, so the longest causal rows start first.
//   bfloat16: four warps, 16 query rows each; Q K^T and P V on the tensor
//   cores with mma.sync m16n8k16 (bfloat16 products are exact, sums
//   float32), their fragments read from shared memory with ldmatrix (V's
//   transposed). The exponentials are exp2 of the scores scaled by
//   scale * log2(e) (the same softmax, one instruction each), and only
//   the tiles that cross the diagonal or the keys' end are masked element
//   by element. The softmax weights P are rounded to bfloat16 before P V
//   (the A operand of the second product), and the row sums l add those
//   rounded weights, so the normaliser matches the numerator; the plain
//   version rounds its weights to bfloat16 as well.
//   float32: no tensor cores (TF32 would keep 10 mantissa bits): 256
//   threads on a 16 x 16 grid, each owning 4 x 4 scores and 4 x DP/16
//   outputs, fmaf on the CUDA cores; P is not rounded.
// The final division is by max(l, 1e-30), as the Pallas kernel's.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
  rlo = __low2float(v);
  rhi = __high2float(v);
  return *reinterpret_cast<uint32_t*>(&v);
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
// Launches on `stream` without synchronising and returns
// cudaGetLastError(), -1 for a bad argument or -2 when the tiles do not fit
// in shared memory.
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
  if (D <= 16) return launch_dtype<16>(q, k, v, out, B, s, dtype, st);
  if (D <= 32) return launch_dtype<32>(q, k, v, out, B, s, dtype, st);
  if (D <= 64) return launch_dtype<64>(q, k, v, out, B, s, dtype, st);
  if (D <= 80) return launch_dtype<80>(q, k, v, out, B, s, dtype, st);
  if (D <= 128) return launch_dtype<128>(q, k, v, out, B, s, dtype, st);
  if (D <= 256) return launch_dtype<256>(q, k, v, out, B, s, dtype, st);
  return -1;
}
