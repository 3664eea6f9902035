// One-token (decode) grouped-query attention over a KV cache:
//   out[b, h*G + g] = softmax_t(q[b, h*G + g] . k[b, t, h] / sqrt(D)) v[b, t, h]
// over t < lengths[b] only. q is (B, 1, Hq, D), k and v (B, S_max, Hkv, D),
// lengths (B,) int32, out (B, 1, Hq, D); Hq = G * Hkv. bfloat16 or float32
// operands; scores, softmax statistics and sums in float32.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas,
// TPU; its body is _decode_kernel).
//
// Bound: memory. Each valid position is read once, k and v, for 4*D*G
// operations per position and KV head: at bf16, G = 7 and D = 128 that is
// about 7 operations per byte, far below the card's ratio. The bytes that
// must move are the valid prefix of each row's cache, so the work stops at
// lengths[b] and never touches S_max - lengths[b] slots.
//
// Design (split over positions, "flash-decoding"). The Pallas kernel walks
// a row's blocks in order and carries m, l and acc in scratch; here that
// walk runs in parallel and a second pass merges it:
//   pass 1: one CTA per (chunk of `chunk` positions, KV head, row). The
//     wrapper picks the chunk from the shapes alone (B, S_max, Hkv, the SM
//     count): as large as keeps the card full, since each CTA and the
//     merge cost a fixed time; it never reads lengths, which stay on the
//     device. A chunk that starts at or past lengths[b] writes the empty
//     state m = NEG_INF (-2^30, the reference's), l = 0 and exits.
//     Otherwise the CTA writes its partial state: m (in log2 units of the
//     scaled scores), l and the unnormalised accumulator, float32, into a
//     buffer the wrapper allocates.
//   pass 2: one CTA per (row, query head) rescales each non-empty chunk's
//     partial by exp2(m_i - m) and adds them in chunk order, then divides
//     by max(l, 1e-30). Fixed orders everywhere, so the result is the same
//     bit for bit from run to run; a row of length 0 gives zeros (l = 0),
//     as the Pallas kernel gives.
// bfloat16 (pass 1): four warps each take every fourth 16-position tile of
//   the chunk and stream it through a private ring of NST stages in shared
//   memory with 16-byte cp.async copies (neighbouring lanes on neighbouring
//   addresses of one cache row; rows past the length are zero-filled and
//   not read), so each warp keeps NST - 1 tiles of K and V in flight and
//   syncs with __syncwarp only. Both products run on the tensor cores
//   (mma.sync m16n8k16, fragments from ldmatrix): S = Q K^T with the group's
//   G query heads as the 16 rows (rows >= G are zero), then O += P V with V
//   read transposed. The online softmax is in float32 as exp2 of
//   fmaf(s, scale*log2(e), -m); P is rounded to bfloat16 for the product and
//   l sums the rounded weights. At the end the four warps' states merge
//   through shared memory in warp order.
// float32 (pass 1): the CUDA cores, eight warps over 32-position tiles of
//   the chunk: lane j owns a position for the scores (its G dot products in
//   its own registers) and D/32 dims for the values; the warps merge in
//   warp order.
// Every multiply-add is an explicit fmaf: the unit is built with
// --fmad=false. G is at most 16; D is a template value (64, 128, 256); a
// narrower head reaches the kernel zero-padded to the next of them, with
// its own 1/sqrt(D) passed as d_scale.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// the reference's NEG_INF (-2^30): a finite floor for the running max, so
// exp(m_prev - m_new) is 0 and not NaN before the first position
constexpr float kNegInf = -1073741824.0f;
constexpr float kLog2e = 1.4426950408889634f;
// chunks are a multiple of this: four warps of 16-position tiles (bf16),
// and eight warps of 32 (float32) divide it too
constexpr int kChunkQuantum = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// The partial state of query head hq (flattened over rows and heads) and
// chunk i: o_part[(hq * n_split + i) * D + d], and m, l at
// ml_part[(hq * n_split + i) * 2 + {0, 1}].
__device__ __forceinline__ void write_empty(float* ml_part, int64_t hq,
                                            int n_split, int split) {
  float* ml = ml_part + (hq * n_split + split) * 2;
  ml[0] = kNegInf;
  ml[1] = 0.f;
}

// ---------------------------------------------------------------------------
// bfloat16 pass 1: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps16 = 4;   // warps of the bf16 pass
constexpr int kTile16 = 16;   // positions per warp tile

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

// Two floats rounded to bfloat16 (round to nearest even) and packed, the
// first in the low half; `rlo`, `rhi` get the rounded values.
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

template <int D>
__host__ __device__ constexpr int bf16_stages() { return D <= 128 ? 3 : 2; }

// Shared memory of the bf16 pass: Q (16 rows) and each warp's ring of
// NST stages of K and V tiles, rows padded by 16 bytes (ldmatrix without
// bank conflicts). The warps' merge reuses the ring.
template <int D>
__host__ __device__ constexpr size_t bf16_smem_bytes() {
  return sizeof(uint16_t) * (kTile16 * (D + 8)
                             + kWarps16 * bf16_stages<D>() * 2 * kTile16
                                   * (D + 8));
}

template <int D>
__global__ void __launch_bounds__(kWarps16 * 32)
decode_split_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const int32_t* __restrict__ lengths,
                         float* __restrict__ o_part,
                         float* __restrict__ ml_part, int64_t S, int Hkv,
                         int G, int chunk, int n_split, float scale2) {
  constexpr int NST = bf16_stages<D>();
  constexpr int kLd = D + 8;                   // shared row stride, bf16
  constexpr int kStage = 2 * kTile16 * kLd;    // K then V of one tile
  constexpr int kVec = D / 8;                  // 16-byte pieces of a row
  static_assert(kWarps16 * kTile16 * D * sizeof(float)
                    <= kWarps16 * NST * kStage * sizeof(uint16_t),
                "the warps' merge must fit in the ring");
  extern __shared__ __align__(16) uint16_t smem16[];
  __shared__ float m_s[kWarps16][kTile16], l_s[kWarps16][kTile16];
  uint16_t* qs = smem16;                 // [16][kLd], rows >= G zero
  uint16_t* ring = qs + kTile16 * kLd;   // [warp][NST][K | V][16][kLd]

  const int split = blockIdx.x, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tg = lane & 3;
  const int64_t head0 = (b * Hkv + h) * G;   // first query head, flattened
  int64_t len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int64_t c0 = static_cast<int64_t>(split) * chunk;
  const int64_t c1 = c0 + chunk < len ? c0 + chunk : len;
  if (c0 >= c1) {
    if (threadIdx.x < G) write_empty(ml_part, head0 + threadIdx.x, n_split,
                                     split);
    return;
  }

  const uint16_t* qb = q + head0 * D;
  for (int e = threadIdx.x; e < kTile16 * kVec; e += blockDim.x) {
    const int r = e / kVec, c = (e % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < G) val = *reinterpret_cast<const uint4*>(qb + r * D + c);
    *reinterpret_cast<uint4*>(qs + r * kLd + c) = val;
  }
  __syncthreads();

  // this warp's tiles: every fourth 16-position tile of [c0, c1)
  const int n_tiles = static_cast<int>((c1 - c0 + kTile16 - 1) / kTile16);
  const int n_mine = n_tiles > warp ? (n_tiles - warp + kWarps16 - 1)
                                          / kWarps16 : 0;
  uint16_t* wring = ring + warp * NST * kStage;
  const int64_t row = static_cast<int64_t>(Hkv) * D;  // between positions
  const uint16_t* kb = k + (b * S * Hkv + h) * D;
  const uint16_t* vb = v + (b * S * Hkv + h) * D;
  auto tile_start = [&](int i) {
    return c0 + static_cast<int64_t>(warp + kWarps16 * i) * kTile16;
  };
  auto load = [&](int i) {
    const int64_t p0 = tile_start(i);
    uint16_t* ks = wring + (i % NST) * kStage;
    uint16_t* vs = ks + kTile16 * kLd;
#pragma unroll
    for (int e = lane; e < kTile16 * kVec; e += 32) {
      const int r = e / kVec, c = (e % kVec) * 8;
      const bool ok = p0 + r < c1;
      const int64_t off = ok ? (p0 + r) * row + c : 0;
      cp_async16(ks + r * kLd + c, kb + off, ok);
      cp_async16(vs + r * kLd + c, vb + off, ok);
    }
  };

  // ldmatrix row addresses: Q (A: heads 0..15, dims +0/+8), K (B: two n8
  // tiles of positions, dims +0/+8), V (B, transposed: positions, dims)
  const int qrow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int qcol = (lane >> 4) * 8;
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 8;
  const int vrow = lane & 15;
  const int vcol = (lane >> 4) * 8;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) {
    if (i < n_mine) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < n_mine; ++i) {
    // tile i + NST - 1 goes into the stage tile i - 1 left
    if (i + NST - 1 < n_mine) load(i + NST - 1);
    cp_async_commit();
    cp_async_wait<NST - 1>();
    __syncwarp();
    const uint16_t* ks = wring + (i % NST) * kStage;
    const uint16_t* vs = ks + kTile16 * kLd;
    const int64_t p0 = tile_start(i);

    // S: the group's heads (rows) x the tile's 16 positions
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4<false>(a, qs + qrow * kLd + kk * 16 + qcol);
      ldsm_x4<false>(bk, ks + krow * kLd + kk * 16 + kcol);
      mma_bf16(sc[0], a[0], a[1], a[2], a[3], bk[0], bk[1]);
      mma_bf16(sc[1], a[0], a[1], a[2], a[3], bk[2], bk[3]);
    }
    // mask past the length (only the chunk's last tile crosses it); row
    // maxima over the quad that shares a row
    const bool edge = p0 + kTile16 > c1;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t t = p0 + nt * 8 + tg * 2 + (e & 1);
        if (edge && t >= c1) sc[nt][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale2);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // the weights, rounded to bf16 and packed as P V's A fragment
    uint32_t pk[2][2];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float r0, r1, r2, r3;
      pk[nt][0] = pack_bf16(exp2f(fmaf(sc[nt][0], scale2, -m[0])),
                            exp2f(fmaf(sc[nt][1], scale2, -m[0])), r0, r1);
      pk[nt][1] = pack_bf16(exp2f(fmaf(sc[nt][2], scale2, -m[1])),
                            exp2f(fmaf(sc[nt][3], scale2, -m[1])), r2, r3);
      rs[0] += r0 + r1;
      rs[1] += r2 + r3;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = fmaf(alpha[r], l[r], rs[r]);
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] *= alpha[e >> 1];
    // O += P V over the tile's 16 positions, pairs of n8 dim tiles
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      ldsm_x4<true>(bv, vs + vrow * kLd + dp * 16 + vcol);
      mma_bf16(acc[2 * dp], pk[0][0], pk[0][1], pk[1][0], pk[1][1], bv[0],
               bv[1]);
      mma_bf16(acc[2 * dp + 1], pk[0][0], pk[0][1], pk[1][0], pk[1][1],
               bv[2], bv[3]);
    }
    __syncwarp();   // the stage is consumed before it is refilled
  }

  // merge the warps' states in warp order, through the ring's space
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);   // [warp][16][D]
  if (tg == 0) {
    m_s[warp][gr] = m[0];
    m_s[warp][gr + 8] = m[1];
    l_s[warp][gr] = l[0];
    l_s[warp][gr + 8] = l[1];
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * kTile16 + gr + (e >> 1) * 8) * D + dn * 8 + tg * 2
          + (e & 1)] = acc[dn][e];
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    const int g = e / D, d = e % D;
    float mx = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps16; ++w) mx = fmaxf(mx, m_s[w][g]);
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps16; ++w) {
      const float f = exp2f(m_s[w][g] - mx);
      sum = fmaf(l_s[w][g], f, sum);
      o = fmaf(red[(w * kTile16 + g) * D + d], f, o);
    }
    const int64_t idx = (head0 + g) * n_split + split;
    o_part[idx * D + d] = o;
    if (d == 0) {
      ml_part[idx * 2] = mx;
      ml_part[idx * 2 + 1] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// float32 pass 1: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps32 = 8;
constexpr int kThreads32 = kWarps32 * 32;
constexpr int kTile32 = 32;  // positions per warp tile: one per lane

// N consecutive values at p (aligned to N * sizeof(T) bytes) as floats,
// in as few vector loads as the width allows.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  using Raw = std::conditional_t<
      kBytes % 16 == 0, uint4,
      std::conditional_t<kBytes % 8 == 0, uint2, uint32_t>>;
  constexpr int kRaw = kBytes / static_cast<int>(sizeof(Raw));
  Raw raw[kRaw];
#pragma unroll
  for (int i = 0; i < kRaw; ++i) raw[i] = reinterpret_cast<const Raw*>(p)[i];
  const T* vals = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(vals[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The eight warps take the chunk's 32-position tiles in turn; lane j owns
// position t0 + j for the scores and D/32 consecutive dims for the values.
// G is a runtime value below a compile-time bucket GMAX (1, 2, 4, 8, 16).
template <int D, int GMAX>
__global__ void __launch_bounds__(kThreads32)
decode_split_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        float* __restrict__ o_part,
                        float* __restrict__ ml_part, int64_t S, int Hkv,
                        int G, int chunk, int n_split, float scale) {
  constexpr int EPL = D / 32;  // V dims per lane
  constexpr int VEC = 4;       // K values a 16-byte load
  // q (the loop's operand), then the merge's accumulator
  __shared__ __align__(16) float qa_s[GMAX][D];
  __shared__ float p_s[kWarps32][GMAX][kTile32];
  __shared__ float m_s[kWarps32][GMAX];
  __shared__ float l_s[kWarps32][GMAX];

  const int split = blockIdx.x, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t head0 = (b * Hkv + h) * G;
  int64_t len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int64_t c0 = static_cast<int64_t>(split) * chunk;
  const int64_t c1 = c0 + chunk < len ? c0 + chunk : len;
  if (c0 >= c1) {
    if (threadIdx.x < G) write_empty(ml_part, head0 + threadIdx.x, n_split,
                                     split);
    return;
  }

  const float* qb = q + head0 * D;
  for (int i = threadIdx.x; i < GMAX * D; i += kThreads32)
    qa_s[i / D][i % D] = i < G * D ? qb[i] : 0.f;
  __syncthreads();

  const int64_t row = static_cast<int64_t>(Hkv) * D;  // between positions
  const float* kb = k + (b * S * Hkv + h) * D;
  const float* vb = v + (b * S * Hkv + h) * D + lane * EPL;

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  for (int64_t t0 = c0 + static_cast<int64_t>(warp) * kTile32; t0 < c1;
       t0 += static_cast<int64_t>(kWarps32) * kTile32) {
    // scores: lane j takes position t0 + j
    const int64_t t = t0 + lane;
    const bool valid = t < c1;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (valid) {
      const float* kr = kb + t * row;
#pragma unroll 4
      for (int c = 0; c < D; c += VEC) {
        float kf[VEC];
        load_row<float, VEC>(kr + c, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              s[g] = fmaf(qa_s[g][c + e], kf[e], s[g]);
          }
        }
      }
    }
    // the tile's softmax update, one max and one sum over the warp a head
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float sg = valid ? s[g] * scale : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = expf(m[g] - m_new);
        const float p = valid ? expf(sg - m_new) : 0.f;
        l[g] = fmaf(l[g], alpha, warp_sum(p));
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
        p_s[warp][g][lane] = p;
      }
    }
    __syncwarp();
    // values: lane j takes dims [j * EPL, (j + 1) * EPL)
    const int n = static_cast<int>(c1 - t0 < kTile32 ? c1 - t0 : kTile32);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float vf[EPL];
      load_row<float, EPL>(vb + (t0 + j) * row, vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float p = p_s[warp][g][j];
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
    __syncwarp();
  }

  // merge the warps' softmax states: rescale each to the common max and
  // add them up in warp order, in the space q took
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < GMAX * D; i += kThreads32)
    qa_s[i / D][i % D] = 0.f;
  float factor[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float mx = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps32; ++w) mx = fmaxf(mx, m_s[w][g]);
    factor[g] = expf(m[g] - mx);
  }
  __syncthreads();
  for (int w = 0; w < kWarps32; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
#pragma unroll
          for (int i = 0; i < EPL; ++i)
            qa_s[g][lane * EPL + i] = fmaf(acc[g][i], factor[g],
                                           qa_s[g][lane * EPL + i]);
        }
      }
    }
    __syncthreads();
  }

  // the chunk's partial: m in log2 units, as pass 2 and the bf16 pass keep it
  for (int i = threadIdx.x; i < G * D; i += kThreads32) {
    const int g = i / D, d = i % D;
    float mx = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps32; ++w) mx = fmaxf(mx, m_s[w][g]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps32; ++w)
      sum = fmaf(l_s[w][g], expf(m_s[w][g] - mx), sum);
    const int64_t idx = (head0 + g) * n_split + split;
    o_part[idx * D + d] = qa_s[g][d];
    if (d == 0) {
      ml_part[idx * 2] = mx * kLog2e;
      ml_part[idx * 2 + 1] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: merge the chunks in order
// ---------------------------------------------------------------------------

constexpr int kMergeThreads = 128;
// the most chunks pass 2 takes: their factors and sums fill its shared
// memory (48 KB without opting in)
constexpr int kMaxSplits = 6144;

// One CTA per (row, query head): the chunks' common max, each chunk's
// factor exp2(m_i - m) (0 for an empty chunk) and sum in shared memory,
// then each thread adds its dims' partials over the chunks in chunk order,
// several loads in flight (a loop that waited on each load in turn made
// pass 2 the larger part of a call with hundreds of chunks).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ ml_part, T* __restrict__ out,
                    int n_split, int D) {
  extern __shared__ float f_s[];   // [n_split] factors, then [n_split] l
  float* l_s = f_s + n_split;
  __shared__ float max_s[kMergeThreads / 32];
  const int64_t hq = blockIdx.x;   // (row, query head), flattened
  const float* ml = ml_part + hq * n_split * 2;
  const float* op = o_part + hq * n_split * D;
  float mx = kNegInf;
  for (int i = threadIdx.x; i < n_split; i += blockDim.x)
    if (ml[2 * i + 1] > 0.f) mx = fmaxf(mx, ml[2 * i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (threadIdx.x % 32 == 0) max_s[threadIdx.x / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, max_s[w]);
  for (int i = threadIdx.x; i < n_split; i += blockDim.x) {
    const float li = ml[2 * i + 1];   // an empty chunk wrote no accumulator
    f_s[i] = li > 0.f ? exp2f(ml[2 * i] - mx) : 0.f;
    l_s[i] = li;
  }
  __syncthreads();
  float sum = 0.f;
  for (int i = 0; i < n_split; ++i) sum = fmaf(l_s[i], f_s[i], sum);
  const float denom = fmaxf(sum, 1e-30f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_split; ++i) {
      const float x = op[static_cast<int64_t>(i) * D + d];
      const float f = f_s[i];
      o = f > 0.f ? fmaf(x, f, o) : o;
    }
    out[hq * D + d] = from_float<T>(o / denom);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *lengths;
  void* out;
  float *o_part, *ml_part;
  int64_t B, S;
  int Hkv, G, chunk, n_split;
  int d_scale;  // the head dim whose 1/sqrt scales the scores
  cudaStream_t stream;
};

template <typename T>
int launch_merge(const Args& a, int D) {
  decode_merge_kernel<T><<<static_cast<unsigned int>(a.B * a.Hkv * a.G),
                           kMergeThreads, 2 * sizeof(float) * a.n_split,
                           a.stream>>>(a.o_part, a.ml_part,
                                       static_cast<T*>(a.out), a.n_split, D);
  return static_cast<int>(cudaGetLastError());
}

dim3 split_grid(const Args& a) {
  return dim3(static_cast<unsigned int>(a.n_split),
              static_cast<unsigned int>(a.Hkv),
              static_cast<unsigned int>(a.B));
}

template <int D>
int launch_bf16(const Args& a) {
  constexpr size_t smem = bf16_smem_bytes<D>();
  auto kernel = decode_split_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale2 = 1.0f / sqrtf(static_cast<float>(a.d_scale)) * kLog2e;
  kernel<<<split_grid(a), kWarps16 * 32, smem, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v),
      static_cast<const int32_t*>(a.lengths), a.o_part, a.ml_part, a.S,
      a.Hkv, a.G, a.chunk, a.n_split, scale2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge<__nv_bfloat16>(a, D);
}

template <int D, int GMAX>
int launch_f32(const Args& a) {
  const float scale = 1.0f / sqrtf(static_cast<float>(a.d_scale));
  decode_split_f32_kernel<D, GMAX><<<split_grid(a), kThreads32, 0,
                                     a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int32_t*>(a.lengths),
      a.o_part, a.ml_part, a.S, a.Hkv, a.G, a.chunk, a.n_split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge<float>(a, D);
}

template <int D>
int launch_f32_g(const Args& a) {
  if (a.G <= 1) return launch_f32<D, 1>(a);
  if (a.G <= 2) return launch_f32<D, 2>(a);
  if (a.G <= 4) return launch_f32<D, 4>(a);
  if (a.G <= 8) return launch_f32<D, 8>(a);
  return launch_f32<D, 16>(a);
}

template <int D>
int launch_d(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32_g<D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return -1;
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer aligned to 16 bytes; `part` holds B * Hq * n_split *
// (D + 2) floats of scratch (the chunks' partial states); dtype is 0 for
// float32 and 1 for bfloat16; 1 <= G <= 16; D is 64, 128 or 256; the
// scores are scaled by 1/sqrt(d_scale), 1 <= d_scale <= D: D itself, or the
// true head dim of operands the wrapper zero-padded to D; chunk is a
// positive multiple of 64 and n_split = ceil(S / chunk) (the wrapper checks
// all of these). Launches both passes on `stream` without
// synchronising and returns cudaGetLastError(), or -1 for a bad argument.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* part, int64_t B,
                                       int64_t S, int Hkv, int G, int D,
                                       int d_scale, int dtype, int chunk,
                                       int n_split, void* stream) {
  if (G < 1 || G > 16 || B < 1 || B > 65535 || S < 1 || Hkv < 1
      || d_scale < 1 || d_scale > D
      || Hkv > 65535 || chunk < kChunkQuantum || chunk % kChunkQuantum
      || n_split < 1 || n_split > kMaxSplits
      || static_cast<int64_t>(n_split) * chunk < S
      || static_cast<int64_t>(n_split - 1) * chunk >= S)
    return -1;
  const int64_t slots = B * Hkv * G * static_cast<int64_t>(n_split);
  float* o_part = static_cast<float*>(part);
  const Args a{q, k, v, lengths, out, o_part, o_part + slots * D, B, S, Hkv,
               G, chunk, n_split, d_scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 64: return launch_d<64>(a, dtype);
    case 128: return launch_d<128>(a, dtype);
    case 256: return launch_d<256>(a, dtype);
    default: return -1;
  }
}
