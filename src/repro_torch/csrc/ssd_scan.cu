// Mamba2's chunked SSD scan (state-space duality) from a zero state. Per
// (batch b, head h), chunk by chunk over the sequence:
//   cum_i   = sum_{t <= i} dt_t * a            a = -exp(a_log[h]), in chunk
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j   (intra)
//           + exp(cum_i) C_i . S                                     (readout)
//   S      <- exp(cum_last) S + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// x is (B, S, H, P), dt (B, S, H) float32, a_log (H,) float32, b and c
// (B, S, G, N) with head h reading group h / (H / G); y is (B, S, H, P) in
// x's dtype and the final state S (B, H, P, N) float32. x, b and c are
// bfloat16 or float32; every sum is float32.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (Pallas, TPU; its body
// is _ssd_kernel).
//
// Bound: at mamba2-1.3b's prefill shape (S = 2048, H = 64, P = 64, N = 128,
// G = 1, chunk Q = 256) one call is ~8.7 GFLOP over ~37 MB, ~235 FLOP per
// byte: operations, not bytes, bound it. PERF.md has the times beside the
// bound.
//
// Design: the four-step chunked form of the SSD paper (Dao and Gu,
// arXiv:2405.21060), in three passes that each spread over the whole card
// (the Pallas kernel walks a (b, h) row's chunks in order, one grid row
// each; here only the cheap recurrence between chunks stays in order):
//   1. chunk states, one CTA per (b, chunk, h): the chunk's cumulative
//      log-decay, summed by one thread in position order, as torch.cumsum
//      sums it on the CPU, so the exponents here and in the plain version
//      (kernels/ref.py::ssd_scan_ref) are the same floats; it goes to the
//      `cum` scratch (B, H, S). Then the chunk's own state
//      sum_j (dt_j x_j) (x) (B_j exp(cum_last - cum_j)), in tiles of 64
//      positions, into the `states` scratch (B, H, chunks, ., .).
//   2. state passing, one thread per (b, h, state element), chunk by chunk:
//      S_c = exp(cum_last of c - 1) S_{c-1} + local_{c-1}, written over
//      local_c (the state that enters chunk c) and, after the last chunk,
//      into the final state. A fixed order and no atomics: repeated calls
//      give the same bits.
//   3. chunk outputs, one CTA per (b, chunk, h, tile I of 64 rows), the
//      longest rows first: the readout exp(cum_i) C_i . S_c, then for each
//      tile J <= I the 64 x 64 scores C_I B_J^T, masked and decayed, times
//      dt x of J. A one-chunk prompt of 256 tokens still gives 4 CTAs a
//      head.
// The decay exp(cum_i - cum_j) is formed only where i >= j: above the
// diagonal it overflows and inf * 0 is NaN. Tiles of B and x are loaded 16
// bytes a thread into registers while the tile before them computes. B and
// C are read from their group's rows; nothing is expanded per head. The
// unit is built with --fmad=false, which keeps the cumulative sum and the
// state passing's multiply and add plain. The chunk length is a runtime
// value (any Q that divides S: rows past Q in a tile are zero and never
// stored). Two bodies run these passes, chosen in ssd_scan_launch (the
// wrapper's kernels/ssd_scan.py::design names them):
//
// bfloat16 at P = 64 and N = 32, 64 or 128 (mamba2's and zamba2's shapes):
// every product on the tensor cores, mma.sync m16n8k16. Products of
// bfloat16 values are exact in float32, so the scores C B^T run as they
// are; a float32 operand (x scaled by dt and the decay, the decayed and
// dt-scaled scores, the carried state) is split into three bfloat16 parts
// whose sum is the value to 2^-24 (split3), and the three products are
// summed in float32: float32 accuracy, with no single rounding of such an
// operand to bfloat16 or TF32. The decayed scores go from the score
// accumulators to the A fragments of the next product in registers; the
// two warps of a row block split each product's depth and add their
// partial sums once, at the end.
//
// every other shape, and float32: the products with a float32 operand on
// the CUDA cores in float32 (fmaf), from register tiles of 4 x P/16 (P/16
// x N/16 for the states) fed by 16-byte shared-memory loads; the scores on
// mma.sync in bfloat16 and on the CUDA cores in float32. P and N are
// template values (P in 16, 32, 64; N in 16, 32, 64, 128).
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid, or 8 warps of mma tiles
constexpr int kT = 64;         // rows of a tile (i and j tiles alike)
constexpr int kTP = kT + 4;    // row stride of a transposed tile: 16-byte
                               // aligned rows, fewer bank conflicts
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// K consecutive floats of shared memory at p (aligned to their width).
template <int K>
__device__ __forceinline__ void lds(const float* p, float (&out)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      out[4 * i] = v.x; out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(p)[i];
      out[2 * i] = v.x; out[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = p[i];
  }
}

// A tile of kT rows of W values of T in registers, 16 bytes a load: vector
// v of the tile is row v / (W / kVec), columns (v % (W / kVec)) * kVec on.
template <typename T, int W>
struct Tile {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPerRow = W / kVec;
  static constexpr int kVectors = kT * kPerRow;
  static constexpr int kPerThread = (kVectors + kThreads - 1) / kThreads;
  uint4 v[kPerThread];

  // Rows [0, valid) of the tile whose row r starts at src + r * stride;
  // the other rows are zero.
  __device__ __forceinline__ void fetch(const T* __restrict__ src,
                                        int64_t stride, int valid) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int r = e / kPerRow, c = (e % kPerRow) * kVec;
      v[k] = (e < kVectors && r < valid)
                 ? *reinterpret_cast<const uint4*>(src + r * stride + c)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Calls f(row, column, values) for each vector this thread holds.
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < kVectors) {
        const T* vals = reinterpret_cast<const T*>(&v[k]);
        f(e / kPerRow, (e % kPerRow) * kVec, vals, v[k]);
      }
    }
  }

  // As float32, transposed: dst[w * kTP + r].
  __device__ __forceinline__ void store_transposed(float* dst) const {
    each([&](int r, int c, const T* vals, uint4) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[(c + u) * kTP + r] = to_float(vals[u]);
    });
  }

  // As float32, each row scaled: dst[r * W + w] = value * scale[r]; rows
  // >= valid (zero, and with no scale) are zero. 16-byte stores.
  __device__ __forceinline__ void store_scaled(float* dst, const float* scale,
                                               int valid) const {
    each([&](int r, int c, const T* vals, uint4) {
      const float s = r < valid ? scale[r] : 0.f;
#pragma unroll
      for (int u = 0; u < kVec; u += 4)
        *reinterpret_cast<float4*>(dst + r * W + c + u) = make_float4(
            to_float(vals[u]) * s, to_float(vals[u + 1]) * s,
            to_float(vals[u + 2]) * s, to_float(vals[u + 3]) * s);
    });
  }

  // As they are (bfloat16), rows `ld` elements apart: dst[r * ld + w].
  __device__ __forceinline__ void store_raw(T* dst, int ld) const {
    each([&](int r, int c, const T*, uint4 raw) {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = raw;
    });
  }
};

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

// Q rounded up to whole tiles: pass 3's dt and cum arrays, so that a read
// at a position past Q (in a branch whose value is discarded) stays inside
// shared memory.
__host__ __device__ constexpr size_t padded(int Q) {
  return static_cast<size_t>((Q + kT - 1) / kT) * kT;
}

// The chunk's cumulative log-decay cum[t] = sum_{u <= t} dt[u] a, added by
// the calling thread in position order, as torch.cumsum adds on the CPU.
__device__ __forceinline__ void chunk_cum(const float* dtv, float* cum,
                                          float a, int Q) {
  float run = 0.f;
  for (int t0 = 0; t0 < Q; t0 += 8) {
    float da[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) da[u] = t0 + u < Q ? dtv[t0 + u] * a : 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (t0 + u < Q) {
        run = run + da[u];
        cum[t0 + u] = run;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// every other shape, and float32: the float32 products on the CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int P, int N>
struct Smem {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kLd = N + 8;  // row stride of the bf16 C and B tiles
  // pass 1: dt, cum and exp(cum_last - cum) of the chunk [3 Q], then
  // dt * x [kT][P] and B * exp(cum_last - cum) [kT][N]
  static constexpr int kStateFloats = kT * P + kT * N;
  // pass 3: a C and a B tile (bf16 rows, or float32 transposed), the state
  // entering the chunk, transposed [N][P], dt * x of tile J [kT][P] and the
  // decayed scores, transposed [kT][kTP]; then the chunk's dt and cum
  // [2 padded(Q)]
  static constexpr int kTile = kMma ? kT * kLd / 2 : N * kTP;
  static constexpr int kOutFloats = 2 * kTile + N * P + kT * P + kT * kTP;
};

// Pass 1: the chunk's cumulative log-decay into cum, and its own state
// sum_j (dt_j x_j) (x) (B_j exp(cum_last - cum_j)) into states[b, h, c].
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a_log, const T* __restrict__ bmat,
                 float* __restrict__ cum_out, float* __restrict__ states,
                 int64_t S, int H, int G, int Q) {
  constexpr int PT = P / 16;  // rows of p per thread
  constexpr int NT = N / 16;  // columns of n per thread
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // dt * x of a tile              [kT][P]
  float* bs = xs + kT * P;        // B * exp(cum_last - cum)       [kT][N]
  float* dtv = bs + kT * N;       // the chunk's dt                [Q]
  float* cum = dtv + Q;           // its cumulative log-decay      [Q]
  float* dte = cum + Q;           // exp(cum_last - cum_j)         [Q]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t ci = blockIdx.x, n_chunks = gridDim.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);
  const int64_t xrow = static_cast<int64_t>(H) * P;   // x: one position
  const int64_t brow = static_cast<int64_t>(G) * N;   // b: one position
  const int64_t c0 = ci * Q;
  const T* xh = x + ((b * S + c0) * H + h) * P;
  const T* bg = bmat + ((b * S + c0) * G + g) * N;
  const float* dth = dt + (b * S + c0) * H + h;

  for (int t = tid; t < Q; t += kThreads) dtv[t] = dth[t * H];
  __syncthreads();
  if (tid == 0) chunk_cum(dtv, cum, a, Q);
  __syncthreads();
  const float last = cum[Q - 1];
  float* cum_h = cum_out + (b * H + h) * S + c0;
  for (int t = tid; t < Q; t += kThreads) {
    dte[t] = expf(last - cum[t]);
    cum_h[t] = cum[t];
  }

  const int n_tiles = (Q + kT - 1) / kT;
  Tile<T, N> bnext;
  Tile<T, P> xnext;
  bnext.fetch(bg, brow, min(kT, Q));
  xnext.fetch(xh, xrow, min(kT, Q));
  float sacc[PT][NT];
#pragma unroll
  for (int p = 0; p < PT; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n) sacc[p][n] = 0.f;
  __syncthreads();   // dte is complete
  for (int J = 0; J < n_tiles; ++J) {
    const int j0 = J * kT, jvalid = min(kT, Q - j0);
    bnext.store_scaled(bs, dte + j0, jvalid);
    xnext.store_scaled(xs, dtv + j0, jvalid);
    __syncthreads();
    if (J + 1 < n_tiles) {
      const int j1 = j0 + kT;
      bnext.fetch(bg + j1 * brow, brow, min(kT, Q - j1));
      xnext.fetch(xh + j1 * xrow, xrow, min(kT, Q - j1));
    }
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float xv[PT], bv[NT];
      lds<PT>(xs + j * P + ty * PT, xv);
      lds<NT>(bs + j * N + tx * NT, bv);
#pragma unroll
      for (int p = 0; p < PT; ++p)
#pragma unroll
        for (int n = 0; n < NT; ++n) sacc[p][n] = fmaf(xv[p], bv[n], sacc[p][n]);
    }
    __syncthreads();
  }
  // transposed, [n][p]: pass 3 reads it so without a transpose
  float* out = states + ((b * H + h) * n_chunks + ci) * P * N;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int p = 0; p < PT; ++p) out[(tx * NT + n) * P + ty * PT + p] = sacc[p][n];
}

// Pass 2: the states passed from chunk to chunk, in chunk order, one
// thread per (b, h, element of the state as pass 1 stores it: [n][p] when
// `transposed`, else [p][n]); the loads of up to eight chunks are issued
// before their additions.
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(const float* __restrict__ cum, float* __restrict__ states,
                float* __restrict__ final_state, int64_t S, int H, int Q,
                int P, int N, int transposed) {
  const int PN = P * N;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  if (e >= PN) return;
  const int64_t n_chunks = S / Q;
  const float* cum_h = cum + (b * H + h) * S;
  float* st = states + (b * H + h) * n_chunks * PN + e;
  float s = 0.f;
  for (int64_t c0 = 0; c0 < n_chunks; c0 += 8) {
    float local[8], decay[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < n_chunks) {
        local[u] = st[(c0 + u) * PN];
        decay[u] = cum_h[(c0 + u) * Q + Q - 1];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (c0 + u < n_chunks) {
        st[(c0 + u) * PN] = s;                  // the state entering c0 + u
        s = expf(decay[u]) * s + local[u];      // the one leaving it
      }
    }
  }
  final_state[(b * H + h) * PN + (transposed ? (e % P) * N + e / P : e)] = s;
}

// Pass 3: rows I * 64 .. I * 64 + 63 of chunk c's output for head h.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const T* __restrict__ bmat, const T* __restrict__ cmat,
                  const float* __restrict__ cum_in,
                  const float* __restrict__ states, T* __restrict__ y,
                  int64_t S, int H, int G, int Q) {
  using L = Smem<T, P, N>;
  constexpr int PT = P / 16;  // columns of p per thread
  extern __shared__ __align__(16) float smem[];
  float* r1 = smem;               // the C tile of I (see Smem)
  float* r2 = r1 + L::kTile;      // the B tile of J
  float* st = r2 + L::kTile;      // the state entering, transposed [N][P]
  float* xs = st + N * P;         // dt * x of tile J               [kT][P]
  float* mt = xs + kT * P;        // decayed scores, transposed     [kT][kTP]
  float* dtv = mt + kT * kTP;     // the chunk's dt        [padded(Q)]
  float* cum = dtv + padded(Q);   // its cumulative log-decay
  T* cs_raw = reinterpret_cast<T*>(r1);   // bf16 C tile [kT][kLd]
  T* bs_raw = reinterpret_cast<T*>(r2);   // bf16 B tile [kT][kLd]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_rt = (Q + kT - 1) / kT;
  const int64_t ci = blockIdx.x / n_rt;
  const int I = n_rt - 1 - static_cast<int>(blockIdx.x % n_rt);  // longest
                                                                  // first
  const int64_t n_chunks = S / Q;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int g = h / (H / G);
  const int64_t xrow = static_cast<int64_t>(H) * P;   // x, y: one position
  const int64_t brow = static_cast<int64_t>(G) * N;   // b, c: one position
  const int64_t c0 = ci * Q;
  const int i0 = I * kT, rows = min(Q, i0 + kT);     // positions it reads
  const T* xh = x + ((b * S + c0) * H + h) * P;
  const T* bg = bmat + ((b * S + c0) * G + g) * N;
  const T* cg = cmat + ((b * S + c0) * G + g) * N;
  T* yh = y + ((b * S + c0) * H + h) * P;

  const float* cum_h = cum_in + (b * H + h) * S + c0;
  const float* dth = dt + (b * S + c0) * H + h;
  for (int t = tid; t < rows; t += kThreads) {
    cum[t] = cum_h[t];
    dtv[t] = dth[t * H];
  }
  {
    Tile<T, N> ctile;
    ctile.fetch(cg + i0 * brow, brow, min(kT, Q - i0));
    if constexpr (L::kMma) ctile.store_raw(cs_raw, L::kLd);
    else ctile.store_transposed(r1);
  }
  if (ci > 0) {
    const float4* sc = reinterpret_cast<const float4*>(
        states + ((b * H + h) * n_chunks + ci) * P * N);
    for (int e = tid; e < P * N / 4; e += kThreads)
      reinterpret_cast<float4*>(st)[e] = sc[e];
  }
  Tile<T, N> bnext;
  Tile<T, P> xnext;
  bnext.fetch(bg, brow, min(kT, Q));
  xnext.fetch(xh, xrow, min(kT, Q));
  __syncthreads();

  // readout of the state carried in: exp(cum_i) C_i . S (zero in chunk 0)
  float acc[4][PT];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < PT; ++k) acc[r][k] = 0.f;
  if (ci > 0) {
    if constexpr (L::kMma) {
      // C from the bf16 rows, two columns of n a load
#pragma unroll 2
      for (int n = 0; n < N; n += 2) {
        float c_lo[4], c_hi[4], s_lo[PT], s_hi[PT];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              cs_raw + (ty * 4 + r) * L::kLd + n);
          c_lo[r] = __low2float(v);
          c_hi[r] = __high2float(v);
        }
        lds<PT>(st + n * P + tx * PT, s_lo);
        lds<PT>(st + (n + 1) * P + tx * PT, s_hi);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < PT; ++k)
            acc[r][k] = fmaf(c_hi[r], s_hi[k], fmaf(c_lo[r], s_lo[k],
                                                    acc[r][k]));
      }
    } else {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PT];
        lds<4>(r1 + n * kTP + ty * 4, cv);
        lds<PT>(st + n * P + tx * PT, sv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < PT; ++k) acc[r][k] = fmaf(cv[r], sv[k], acc[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      const float e = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
      for (int k = 0; k < PT; ++k) acc[r][k] *= e;
    }
  }

  // the intra-chunk dual form over the tiles J <= I
  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kT, jvalid = min(kT, Q - j0);
    if constexpr (L::kMma) bnext.store_raw(bs_raw, L::kLd);
    else bnext.store_transposed(r2);
    xnext.store_scaled(xs, dtv + j0, jvalid);
    __syncthreads();
    if (J < I) {   // the next pair is on its way while this one computes
      const int j1 = j0 + kT;
      bnext.fetch(bg + j1 * brow, brow, min(kT, Q - j1));
      xnext.fetch(xh + j1 * xrow, xrow, min(kT, Q - j1));
    }
    if constexpr (L::kMma) {
      // scores on the tensor cores: warp w takes rows (w / 2) * 16 and
      // columns (w % 2) * 32 of the 64 x 64 tile, four m16n8 tiles
      const int warp = tid / 32, lane = tid % 32;
      const int gr = lane >> 2, tg = lane & 3;
      const int rb = (warp >> 1) * 16, cb0 = (warp & 1) * 32;
      constexpr int kLdw = L::kLd / 2;   // a row, in 32-bit words
      const uint32_t* c32 = reinterpret_cast<const uint32_t*>(cs_raw);
      const uint32_t* b32 = reinterpret_cast<const uint32_t*>(bs_raw);
      float d[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        const int kw = k0 / 2 + tg;
        const uint32_t a0 = c32[(rb + gr) * kLdw + kw];
        const uint32_t a1 = c32[(rb + gr + 8) * kLdw + kw];
        const uint32_t a2 = c32[(rb + gr) * kLdw + kw + 4];
        const uint32_t a3 = c32[(rb + gr + 8) * kLdw + kw + 4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = cb0 + nt * 8 + gr;
          mma_bf16(d[nt], a0, a1, a2, a3, b32[n * kLdw + kw],
                   b32[n * kLdw + kw + 4]);
        }
      }
      // decay and causal mask; exp only where j <= i
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rb + gr + (e >> 1) * 8;
          const int col = cb0 + nt * 8 + tg * 2 + (e & 1);
          const int i = i0 + row, j = j0 + col;
          mt[col * kTP + row] =
              (i < Q && j <= i) ? d[nt][e] * expf(cum[i] - cum[j]) : 0.f;
        }
    } else {
      // scores on the CUDA cores: rows ty * 4, columns tx * 4
      float m[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) m[r][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
        lds<4>(r1 + n * kTP + ty * 4, cv);
        lds<4>(r2 + n * kTP + tx * 4, bv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) m[r][k] = fmaf(cv[r], bv[k], m[r][k]);
      }
      // decay and causal mask; exp only where j <= i
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + tx * 4 + k;
        float mv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
          mv[r] = (i < Q && j <= i) ? m[r][k] * expf(cum[i] - cum[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(mt + (tx * 4 + k) * kTP + ty * 4) =
            make_float4(mv[0], mv[1], mv[2], mv[3]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float mv[4], xv[PT];
      lds<4>(mt + j * kTP + ty * 4, mv);
      lds<PT>(xs + j * P + tx * PT, xv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PT; ++k) acc[r][k] = fmaf(mv[r], xv[k], acc[r][k]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i < Q) {
#pragma unroll
      for (int k = 0; k < PT; ++k)
        yh[i * xrow + tx * PT + k] = from_float<T>(acc[r][k]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at P = 64: every product on the tensor cores
// ---------------------------------------------------------------------------

// Four 8 x 8 tiles of 16-bit values from shared memory, one row address
// per lane (lanes 8i..8i+7 give tile i's rows), each handed out transposed:
// lane t gets rows 2 (t % 4) and 2 (t % 4) + 1 of column t / 4.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

// The same four tiles handed out as stored: lane t gets row t / 4, columns
// 2 (t % 4) and 2 (t % 4) + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two float32 values as three packed bfloat16 pairs whose sum is each value
// to within 2^-24 of it: hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi
// - mid) (each difference exact). Products of bfloat16 values are exact in
// float32, so a product of a bfloat16 operand with the three parts, summed
// in float32, keeps float32 accuracy; no single rounding to bfloat16.
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  v0 = v0 - __low2float(h);
  v1 = v1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(v0, v1);
  v0 = v0 - __low2float(m);
  v1 = v1 - __high2float(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(v0, v1));
}

constexpr int kTcP = 64;           // the head dim of the tensor-core body
constexpr int kLx = kTcP + 8;      // row stride of a bf16 x tile

template <int N>
struct TcSmem {
  static constexpr int kLw = N + 8;   // row stride of bf16 tiles of width N
  // pass 1: the three parts of x * dt * decay [3][kT][kLx] and the B tile
  // [kT][kLw] (bf16), then dt, cum and the decay [3 Q]
  static constexpr int kStateBytes = 2 * (3 * kT * kLx + kT * kLw);
  // pass 3: the C and B tiles [kT][kLw], the three parts of the state
  // entering [3][P][kLw] and the x tile [kT][kLx] (bf16), then dt and cum
  // [2 padded(Q)]; at the end the first 16 KB hold the partial sums the
  // warp pairs add, and the x tile's place (past 16 KB at every N) the y
  // tile
  static constexpr int kOutBytes = 2 * (2 * kT * kLw + 3 * kTcP * kLw
                                        + kT * kLx);
  static_assert(N == 32 || N == 64 || N == 128,
                "the tensor-core body takes N = 32, 64 or 128");
  static_assert(2 * (2 * kT * kLw + 3 * kTcP * kLw) >= 4 * 32 * 32 * 4,
                "the partial sums end before the x tile");
};

// Pass 1, tensor cores: the chunk's cum as ssd_state_kernel, and its own
// state L[p][n] = sum_j (x_j[p] dt_j exp(cum_last - cum_j)) B_j[n]: the
// three bf16 parts of the scaled x, transposed, times B (bf16) on
// mma.sync. Warp w owns rows p of 16 (w % 4) and half the columns n
// (w / 4). The state is stored as [p][n].
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_state_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt,
                    const float* __restrict__ a_log,
                    const __nv_bfloat16* __restrict__ bmat,
                    float* __restrict__ cum_out, float* __restrict__ states,
                    int64_t S, int H, int G, int Q) {
  using L = TcSmem<N>;
  constexpr int P = kTcP, kLw = L::kLw;
  constexpr int NTW = N / 16;        // n-tiles of 8 per warp
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [3][kT][kLx]
  __nv_bfloat16* bs = xs + 3 * kT * kLx;                       // [kT][kLw]
  float* dtv = reinterpret_cast<float*>(bs + kT * kLw);        // [Q]
  float* cum = dtv + Q;                                        // [Q]
  float* dte = cum + Q;                                        // [Q]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, tg = lane & 3;
  const int64_t ci = blockIdx.x, n_chunks = gridDim.x;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);
  const int64_t xrow = static_cast<int64_t>(H) * P;
  const int64_t brow = static_cast<int64_t>(G) * N;
  const int64_t c0 = ci * Q;
  const __nv_bfloat16* xh = x + ((b * S + c0) * H + h) * P;
  const __nv_bfloat16* bg = bmat + ((b * S + c0) * G + g) * N;
  const float* dth = dt + (b * S + c0) * H + h;

  // the first tiles are on their way during the serial sum
  Tile<__nv_bfloat16, N> bnext;
  Tile<__nv_bfloat16, P> xnext;
  bnext.fetch(bg, brow, min(kT, Q));
  xnext.fetch(xh, xrow, min(kT, Q));
  for (int t = tid; t < Q; t += kThreads) dtv[t] = dth[t * H];
  __syncthreads();
  if (tid == 0) chunk_cum(dtv, cum, a, Q);
  __syncthreads();
  const float last = cum[Q - 1];
  float* cum_h = cum_out + (b * H + h) * S + c0;
  for (int t = tid; t < Q; t += kThreads) {
    dte[t] = dtv[t] * expf(last - cum[t]);   // dt_j exp(cum_last - cum_j)
    cum_h[t] = cum[t];
  }

  const int mt = warp % 4, nh = warp / 4;
  float acc[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int n_tiles = (Q + kT - 1) / kT;
  __syncthreads();   // dte is complete
  for (int J = 0; J < n_tiles; ++J) {
    const int j0 = J * kT, jvalid = min(kT, Q - j0);
    bnext.store_raw(bs, kLw);
    xnext.each([&](int r, int c, const __nv_bfloat16* vals, uint4) {
      const float sc = r < jvalid ? dte[j0 + r] : 0.f;
      uint32_t part[3][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        split3(__bfloat162float(vals[2 * u]) * sc,
               __bfloat162float(vals[2 * u + 1]) * sc, part[0][u],
               part[1][u], part[2][u]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint4*>(xs + (k * kT + r) * kLx + c) =
            make_uint4(part[k][0], part[k][1], part[k][2], part[k][3]);
    });
    __syncthreads();
    if (J + 1 < n_tiles) {
      const int j1 = j0 + kT;
      bnext.fetch(bg + j1 * brow, brow, min(kT, Q - j1));
      xnext.fetch(xh + j1 * xrow, xrow, min(kT, Q - j1));
    }
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      // A = the scaled x, transposed: rows p, depth j, from [j][p] tiles
      uint32_t af[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        ldsm_x4_t(af[k], xs + (k * kT + kk * 16 + (lane & 7)
                               + ((lane >> 4) & 1) * 8) * kLx
                             + mt * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bs + (kk * 16 + (lane & 15)) * kLw + nh * (N / 2)
                          + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          mma_bf16(acc[2 * np], af[k][0], af[k][1], af[k][2], af[k][3],
                   bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], af[k][0], af[k][1], af[k][2], af[k][3],
                   bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }
  float* out = states + ((b * H + h) * n_chunks + ci) * P * N;
#pragma unroll
  for (int i = 0; i < NTW; ++i) {
    const int p = mt * 16 + gr, n = nh * (N / 2) + i * 8 + 2 * tg;
    *reinterpret_cast<float2*>(out + p * N + n) = make_float2(acc[i][0],
                                                              acc[i][1]);
    *reinterpret_cast<float2*>(out + (p + 8) * N + n) =
        make_float2(acc[i][2], acc[i][3]);
  }
}

// Pass 3, tensor cores: rows I * 64 .. I * 64 + 63 of chunk c's output for
// head h. The warps pair up on 16 rows each (w / 2) and split the depth of
// every product (w % 2): half the state's columns n in the readout (C, bf16,
// times the three bf16 parts of the state entering), half the columns j of
// each tile J <= I in the intra-chunk form (their 16 x 32 scores C B^T on
// mma.sync, decayed and masked in registers, column j scaled by dt_j, and
// their three bf16 parts, as A fragments straight from the score
// accumulators, times x of J). Each warp of a pair holds all 64 columns p
// of its rows; the second adds its partial sums to the first's through
// shared memory at the end.
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_output_tc_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ dt,
                     const __nv_bfloat16* __restrict__ bmat,
                     const __nv_bfloat16* __restrict__ cmat,
                     const float* __restrict__ cum_in,
                     const float* __restrict__ states,
                     __nv_bfloat16* __restrict__ y, int64_t S, int H, int G,
                     int Q) {
  using L = TcSmem<N>;
  constexpr int P = kTcP, kLw = L::kLw;
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kT][kLw]
  __nv_bfloat16* bs = cs + kT * kLw;                           // [kT][kLw]
  __nv_bfloat16* ss = bs + kT * kLw;                        // [3][P][kLw]
  __nv_bfloat16* xs = ss + 3 * P * kLw;                        // [kT][kLx]
  float* dtv = reinterpret_cast<float*>(xs + kT * kLx);   // [padded(Q)]
  float* cum = dtv + padded(Q);
  float* red = smem;               // at the end: [4][32][32] partial sums
  __nv_bfloat16* ys = xs;          // ... and the y tile [kT][kLx] (bf16)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, tg = lane & 3;
  const int n_rt = (Q + kT - 1) / kT;
  const int64_t ci = blockIdx.x / n_rt;
  const int I = n_rt - 1 - static_cast<int>(blockIdx.x % n_rt);  // longest
                                                                  // first
  const int64_t n_chunks = S / Q;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int g = h / (H / G);
  const int64_t xrow = static_cast<int64_t>(H) * P;
  const int64_t brow = static_cast<int64_t>(G) * N;
  const int64_t c0 = ci * Q;
  const int i0 = I * kT, rows = min(Q, i0 + kT);
  const __nv_bfloat16* xh = x + ((b * S + c0) * H + h) * P;
  const __nv_bfloat16* bg = bmat + ((b * S + c0) * G + g) * N;
  const __nv_bfloat16* cg = cmat + ((b * S + c0) * G + g) * N;
  __nv_bfloat16* yh = y + ((b * S + c0) * H + h) * P;

  // every load of the CTA's start is issued before any of them is used:
  // the C tile, the first B and x tiles, the state entering and the
  // chunk's cum and dt
  const float* cum_h = cum_in + (b * H + h) * S + c0;
  const float* dth = dt + (b * S + c0) * H + h;
  Tile<__nv_bfloat16, N> ctile, bnext;
  Tile<__nv_bfloat16, P> xnext;
  ctile.fetch(cg + i0 * brow, brow, min(kT, Q - i0));
  bnext.fetch(bg, brow, min(kT, Q));
  xnext.fetch(xh, xrow, min(kT, Q));
  constexpr int kSV = P * N / 4 / kThreads;   // float4s of the state each
  float4 sv[kSV];
  if (ci > 0) {
    const float4* sc = reinterpret_cast<const float4*>(
        states + ((b * H + h) * n_chunks + ci) * P * N);
#pragma unroll
    for (int k = 0; k < kSV; ++k) sv[k] = sc[tid + k * kThreads];
  }
  for (int t = tid; t < rows; t += kThreads) {
    cum[t] = cum_h[t];
    dtv[t] = dth[t * H];
  }
  ctile.store_raw(cs, kLw);
  if (ci > 0) {   // the state entering, [p][n], as three bf16 parts
#pragma unroll
    for (int k = 0; k < kSV; ++k) {
      const int e = 4 * (tid + k * kThreads), p = e / N, n = e % N;
      uint32_t part[3][2];
      split3(sv[k].x, sv[k].y, part[0][0], part[1][0], part[2][0]);
      split3(sv[k].z, sv[k].w, part[0][1], part[1][1], part[2][1]);
#pragma unroll
      for (int u = 0; u < 3; ++u)
        *reinterpret_cast<uint2*>(ss + (u * P + p) * kLw + n) =
            make_uint2(part[u][0], part[u][1]);
    }
  }
  __syncthreads();

  const int rb = (warp >> 1) * 16, half = warp & 1;
  // this thread's rows of the tile: r_lo and r_lo + 8
  const int r_lo = i0 + rb + gr;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  // the A fragment of C's rows rb.. at depth k0
  auto c_frag = [&](int k0, uint32_t (&af)[4]) {
    ldsm_x4(af, cs + (rb + (lane & 7) + ((lane >> 3) & 1) * 8) * kLw + k0
                    + (lane >> 4) * 8);
  };
  // the B fragments of two n-tiles (rows r0 .. r0 + 15 of a [row][k] tile
  // at depth k0): f[0], f[1] of the first, f[2], f[3] of the second
  auto b_frags = [&](const __nv_bfloat16* t, int r0, int k0,
                     uint32_t (&f)[4]) {
    ldsm_x4(f, t + (r0 + (lane & 7) + (lane >> 4) * 8) * kLw + k0
                   + ((lane >> 3) & 1) * 8);
  };
  if (ci > 0) {
    // readout over this warp's half of n: C times the state's three parts
    // (B[k = n][col = p], read as the [p][n] rows), then exp(cum_i)
#pragma unroll
    for (int k0 = half * (N / 2); k0 < (half + 1) * (N / 2); k0 += 16) {
      uint32_t af[4];
      c_frag(k0, af);
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bf[4];
          b_frags(ss + k * P * kLw, np * 16, k0, bf);
          mma_bf16(acc[2 * np], af[0], af[1], af[2], af[3], bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], af[0], af[1], af[2], af[3], bf[2],
                   bf[3]);
        }
    }
    const float e_lo = r_lo < Q ? expf(cum[r_lo]) : 0.f;
    const float e_hi = r_lo + 8 < Q ? expf(cum[r_lo + 8]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      acc[nt][0] *= e_lo;
      acc[nt][1] *= e_lo;
      acc[nt][2] *= e_hi;
      acc[nt][3] *= e_hi;
    }
  }

  for (int J = 0; J <= I; ++J) {
    const int j0 = J * kT;
    bnext.store_raw(bs, kLw);
    xnext.store_raw(xs, kLx);
    __syncthreads();
    if (J < I) {   // the next pair is on its way while this one computes
      const int j1 = j0 + kT;
      bnext.fetch(bg + j1 * brow, brow, min(kT, Q - j1));
      xnext.fetch(xh + j1 * xrow, xrow, min(kT, Q - j1));
    }
    // the warp's 16 x 32 scores: columns half * 32 .. of the tile
    float d[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t af[4];
      c_frag(k0, af);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        b_frags(bs, half * 32 + np * 16, k0, bf);
        mma_bf16(d[2 * np], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        mma_bf16(d[2 * np + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
      }
    }
    // decay, mask (exp only where j <= i), dt_j; then 16 columns j at a
    // time as the three parts of an A fragment times x of J
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      float v[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r_lo + (e >> 1) * 8;
          const int j = j0 + half * 32 + (2 * ks + t) * 8 + 2 * tg + (e & 1);
          v[t][e] = (i < Q && j <= i)
                        ? d[2 * ks + t][e] * expf(cum[i] - cum[j]) * dtv[j]
                        : 0.f;
        }
      uint32_t ap[3][4];
      split3(v[0][0], v[0][1], ap[0][0], ap[1][0], ap[2][0]);
      split3(v[0][2], v[0][3], ap[0][1], ap[1][1], ap[2][1]);
      split3(v[1][0], v[1][1], ap[0][2], ap[1][2], ap[2][2]);
      split3(v[1][2], v[1][3], ap[0][3], ap[1][3], ap[2][3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        // B = x of J: depth j, columns p, from the [j][p] tile transposed
        uint32_t bf[4];
        ldsm_x4_t(bf, xs + (half * 32 + ks * 16 + (lane & 15)) * kLx
                          + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          mma_bf16(acc[2 * np], ap[k][0], ap[k][1], ap[k][2], ap[k][3],
                   bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], ap[k][0], ap[k][1], ap[k][2], ap[k][3],
                   bf[2], bf[3]);
        }
      }
    }
    __syncthreads();
  }
  // the pairs' partial sums, lane-minor (no bank conflicts); the first of
  // each pair rounds the sums into the y tile in shared memory, which
  // leaves a row of 128 bytes at a time
  float* mine = red + (warp >> 1) * 32 * 32 + lane;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) mine[i * 32] = acc[i / 4][i % 4];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = nt * 8 + 2 * tg;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += mine[(4 * nt + e) * 32];
      *reinterpret_cast<__nv_bfloat162*>(ys + (rb + gr) * kLx + p) =
          __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<__nv_bfloat162*>(ys + (rb + gr + 8) * kLx + p) =
          __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kT * P / 8; idx += kThreads) {
    const int r = idx / (P / 8), c = (idx % (P / 8)) * 8;
    if (i0 + r < Q)
      *reinterpret_cast<uint4*>(yh + (i0 + r) * xrow + c) =
          *reinterpret_cast<const uint4*>(ys + r * kLx + c);
  }
}

// The three passes on one stream; -2 when a pass's arrays do not fit in
// shared memory.
template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, void* final_state, void* cum,
           void* states, int64_t B, int64_t S, int H, int G, int Q,
           cudaStream_t stream) {
  using L = Smem<T, P, N>;
  const size_t smem1 = sizeof(float) * (L::kStateFloats + 3 * static_cast<size_t>(Q));
  const size_t smem3 = sizeof(float) * (L::kOutFloats + 2 * padded(Q));
  if (smem1 > static_cast<size_t>(kMaxSmem)
      || smem3 > static_cast<size_t>(kMaxSmem))
    return -2;
  auto k1 = ssd_state_kernel<T, P, N>;
  auto k3 = ssd_output_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_chunks = S / Q;
  const unsigned int hh = static_cast<unsigned int>(H);
  const unsigned int bb = static_cast<unsigned int>(B);
  float* cumf = static_cast<float*>(cum);
  float* stf = static_cast<float*>(states);
  k1<<<dim3(static_cast<unsigned int>(n_chunks), hh, bb), kThreads, smem1,
       stream>>>(static_cast<const T*>(x), static_cast<const float*>(dt),
                 static_cast<const float*>(a_log), static_cast<const T*>(b),
                 cumf, stf, S, H, G, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<<<dim3((P * N + kThreads - 1) / kThreads, hh, bb),
                    kThreads, 0, stream>>>(
      cumf, stf, static_cast<float*>(final_state), S, H, Q, P, N, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_rt = (Q + kT - 1) / kT;
  k3<<<dim3(static_cast<unsigned int>(n_chunks * n_rt), hh, bb), kThreads,
       smem3, stream>>>(static_cast<const T*>(x),
                        static_cast<const float*>(dt),
                        static_cast<const T*>(b), static_cast<const T*>(c),
                        cumf, stf, static_cast<T*>(y), S, H, G, Q);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core body's three passes (bfloat16, P = 64).
template <int N>
int launch_tc(const void* x, const void* dt, const void* a_log,
              const void* b, const void* c, void* y, void* final_state,
              void* cum, void* states, int64_t B, int64_t S, int H, int G,
              int Q, cudaStream_t stream) {
  using L = TcSmem<N>;
  using bf16 = __nv_bfloat16;
  const size_t smem1 = L::kStateBytes + sizeof(float) * 3 * static_cast<size_t>(Q);
  const size_t smem3 = L::kOutBytes + sizeof(float) * 2 * padded(Q);
  if (smem1 > static_cast<size_t>(kMaxSmem)
      || smem3 > static_cast<size_t>(kMaxSmem))
    return -2;
  auto k1 = ssd_state_tc_kernel<N>;
  auto k3 = ssd_output_tc_kernel<N>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_chunks = S / Q;
  const unsigned int hh = static_cast<unsigned int>(H);
  const unsigned int bb = static_cast<unsigned int>(B);
  float* cumf = static_cast<float*>(cum);
  float* stf = static_cast<float*>(states);
  k1<<<dim3(static_cast<unsigned int>(n_chunks), hh, bb), kThreads, smem1,
       stream>>>(static_cast<const bf16*>(x), static_cast<const float*>(dt),
                 static_cast<const float*>(a_log), static_cast<const bf16*>(b),
                 cumf, stf, S, H, G, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<<<dim3((kTcP * N + kThreads - 1) / kThreads, hh, bb),
                    kThreads, 0, stream>>>(
      cumf, stf, static_cast<float*>(final_state), S, H, Q, kTcP, N, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_rt = (Q + kT - 1) / kT;
  k3<<<dim3(static_cast<unsigned int>(n_chunks * n_rt), hh, bb), kThreads,
       smem3, stream>>>(static_cast<const bf16*>(x),
                        static_cast<const float*>(dt),
                        static_cast<const bf16*>(b),
                        static_cast<const bf16*>(c), cumf, stf,
                        static_cast<bf16*>(y), S, H, G, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const void* x, const void* dt, const void* a_log, const void* b,
             const void* c, void* y, void* f, void* cum, void* st, int64_t B,
             int64_t S, int H, int G, int N, int Q, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, a_log, b, c, y, f, cum, st, B, S, H, G, Q, s);
    case 32: return launch<T, P, 32>(x, dt, a_log, b, c, y, f, cum, st, B, S, H, G, Q, s);
    case 64: return launch<T, P, 64>(x, dt, a_log, b, c, y, f, cum, st, B, S, H, G, Q, s);
    case 128: return launch<T, P, 128>(x, dt, a_log, b, c, y, f, cum, st, B, S, H, G, Q, s);
    default: return -1;
  }
}

template <typename T>
int launch_p(const void* x, const void* dt, const void* a_log, const void* b,
             const void* c, void* y, void* f, void* cum, void* st, int64_t B,
             int64_t S, int H, int G, int P, int N, int Q, cudaStream_t s) {
  switch (P) {
    case 16: return launch_n<T, 16>(x, dt, a_log, b, c, y, f, cum, st, B, S, H, G, N, Q, s);
    case 32: return launch_n<T, 32>(x, dt, a_log, b, c, y, f, cum, st, B, S, H, G, N, Q, s);
    case 64: return launch_n<T, 64>(x, dt, a_log, b, c, y, f, cum, st, B, S, H, G, N, Q, s);
    default: return -1;
  }
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer aligned to 16 bytes; dtype is 0 for float32 and 1 for
// bfloat16 (x, b, c, y); dt, a_log, the final state and the two scratch
// buffers are float32: cum (B, H, S) and states (B, H, S / Q, P N), which
// the call overwrites; Q >= 1 divides S, G divides H, B, H and the chunk
// count are at most 65535, P is 16, 32 or 64 and N 16, 32, 64 or 128 (the
// wrapper checks all of these). Launches the three passes on `stream`
// without synchronising and returns cudaGetLastError(), -1 for a bad
// argument or -2 when a pass's arrays do not fit in shared memory.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_log, const void* b, const void* c,
                               void* y, void* final_state, void* cum,
                               void* states, int64_t B, int64_t S, int H,
                               int G, int P, int N, int Q, int dtype,
                               void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || G < 1 || H % G
      || Q < 1 || S % Q || S / Q > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // bfloat16 at P = 64 and N = 32, 64 or 128: the tensor-core body
  if (dtype == 1 && P == 64 && N == 128)
    return launch_tc<128>(x, dt, a_log, b, c, y, final_state, cum, states, B,
                          S, H, G, Q, s);
  if (dtype == 1 && P == 64 && N == 64)
    return launch_tc<64>(x, dt, a_log, b, c, y, final_state, cum, states, B,
                         S, H, G, Q, s);
  if (dtype == 1 && P == 64 && N == 32)
    return launch_tc<32>(x, dt, a_log, b, c, y, final_state, cum, states, B,
                         S, H, G, Q, s);
  // every other shape: the CUDA-core body
  if (dtype == 0)
    return launch_p<float>(x, dt, a_log, b, c, y, final_state, cum, states, B,
                           S, H, G, P, N, Q, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, a_log, b, c, y, final_state, cum,
                                   states, B, S, H, G, P, N, Q, s);
  return -1;
}
