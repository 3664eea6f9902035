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
// byte: operations, not bytes, bound it. Only the C.B scores run on the
// tensor cores (bfloat16 operands); the rest runs on the CUDA cores in
// float32 and the group's scores are recomputed in every head, so the
// kernel runs far from the card's rate; PERF.md has its times beside the
// bound.
//
// Design: one CTA per (b, h) walks the chunks in order and keeps the
// carried state S (P x N float32) in shared memory, as the Pallas kernel
// keeps it in VMEM scratch; nothing of the recurrence goes through device
// memory. A chunk's Q x Q decayed score matrix does not fit in shared
// memory at Q = 256, so the chunk is cut into tiles of 64 rows: for each
// row tile I, the C rows of I stay in shared memory while the tiles J <= I
// of B and dt*x stream through (tiles above the diagonal are skipped).
// Each (I, J) computes the 64 x 64 score tile C_I B_J^T, masks and decays
// it, and adds its product with dt*x to I's rows of y; after the row tiles
// the same B and dt*x tiles update the state. The scores run on the tensor
// cores in bfloat16 (mma.sync m16n8k16: the products of bfloat16 values
// are exact, the sums float32), and on the CUDA cores from 4 x 4 register
// tiles in float32 inputs; the products with dt*x, the state readout and
// the state update use 4 x P/16 (P/16 x N/16) register tiles of fmaf on
// float32 operands. While a tile pair computes, the next pair's B and x
// rows are already on their way into registers (16-byte loads), so global
// latency is exposed only at the C tile of each row tile. The decay
// exp(cum_i - cum_j) is computed only where i >= j: above the diagonal it
// overflows and inf * 0 is NaN. The cumulative log-decay is summed by one
// thread in position order, as torch.cumsum sums it, so the exponents here
// and in the plain version (kernels/ref.py::ssd_scan_ref) are the same
// floats. B and C are read once per head from their group's rows; nothing
// is expanded per head. The unit is built with --fmad=false, which keeps
// the cumulative sum's additions plain; the products use fmaf. The chunk
// length is a runtime value (any Q that divides S); P and N are template
// values (P in 16, 32, 64; N in 16, 32, 64, 128). B * H CTAs leave SMs idle
// at batch 1, which later work can fix by splitting the chunks.
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
  // >= valid (zero, and with no scale) are zero.
  __device__ __forceinline__ void store_scaled(float* dst, const float* scale,
                                               int valid) const {
    each([&](int r, int c, const T* vals, uint4) {
      const float s = r < valid ? scale[r] : 0.f;
#pragma unroll
      for (int u = 0; u < kVec; ++u) dst[r * W + c + u] = to_float(vals[u]) * s;
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

template <typename T, int P, int N>
struct Smem {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kLd = N + 8;  // row stride of the bf16 C and B tiles
  // region 2: B transposed (float32 inputs) or the bf16 C and B tiles; in
  // the state update, B * decay [kT][N]
  static constexpr int kRegion2 =
      kMma ? (2 * kT * kLd * 2 + 15) / 16 * 4 : N * kTP;
  static constexpr int kFloats =
      N * kTP + kRegion2 + kT * P + kT * kTP + N * P;
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bmat,
                const T* __restrict__ cmat, T* __restrict__ y,
                float* __restrict__ final_state, int64_t S, int H, int G,
                int Q) {
  using L = Smem<T, P, N>;
  constexpr int PT = P / 16;  // columns of p per thread (readout, y)
  constexpr int NT = N / 16;  // columns of n per thread (state update)
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;               // C of row tile I, transposed  [N][kTP]
  float* r2 = ct + N * kTP;       // region 2 (see Smem)
  float* xs = r2 + L::kRegion2;   // dt * x of tile J             [kT][P]
  float* mt = xs + kT * P;        // decayed scores, transposed   [kT][kTP]
  float* st = mt + kT * kTP;      // carried state, transposed    [N][P]
  float* dtv = st + N * P;        // the chunk's dt               [Q]
  float* cum = dtv + Q;           // its cumulative log-decay     [Q]
  float* dte = cum + Q;           // exp(cum_last - cum_j)        [Q]
  T* cs_raw = reinterpret_cast<T*>(r2);      // bf16 C tile [kT][kLd]
  T* bs_raw = cs_raw + kT * L::kLd;          // bf16 B tile [kT][kLd]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);
  const int64_t xrow = static_cast<int64_t>(H) * P;   // x, y: one position
  const int64_t brow = static_cast<int64_t>(G) * N;   // b, c: one position
  const T* xh = x + (b * S * H + h) * P;
  const T* bg = bmat + (b * S * G + g) * N;
  const T* cg = cmat + (b * S * G + g) * N;
  const float* dth = dt + b * S * H + h;
  T* yh = y + (b * S * H + h) * P;

  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;

  const int64_t n_chunks = S / Q;
  const int n_tiles = (Q + kT - 1) / kT;
  // the B and x rows of the next tile pair, in flight while one computes
  Tile<T, N> bnext;
  Tile<T, P> xnext;
  auto fetch_pair = [&](int64_t chunk, int J) {
    const int64_t p0 = chunk * Q + J * kT;
    const int valid = min(kT, Q - J * kT);
    bnext.fetch(bg + p0 * brow, brow, valid);
    xnext.fetch(xh + p0 * xrow, xrow, valid);
  };
  fetch_pair(0, 0);

  for (int64_t ci = 0; ci < n_chunks; ++ci) {
    const int64_t c0 = ci * Q;
    for (int t = tid; t < Q; t += kThreads) dtv[t] = dth[(c0 + t) * H];
    __syncthreads();
    if (tid == 0) {  // in position order, as torch.cumsum adds
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
    __syncthreads();
    const float last = cum[Q - 1];
    for (int t = tid; t < Q; t += kThreads) dte[t] = expf(last - cum[t]);

    for (int I = 0; I < n_tiles; ++I) {
      const int i0 = I * kT;
      {
        Tile<T, N> ctile;
        ctile.fetch(cg + (c0 + i0) * brow, brow, min(kT, Q - i0));
        ctile.store_transposed(ct);
        if constexpr (L::kMma) ctile.store_raw(cs_raw, L::kLd);
      }
      __syncthreads();
      // readout of the state carried in: exp(cum_i) C_i . S
      float acc[4][PT];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < PT; ++k) acc[r][k] = 0.f;
      if (ci > 0) {
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], sv[PT];
          lds<4>(ct + n * kTP + ty * 4, cv);
          lds<PT>(st + n * P + tx * PT, sv);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int k = 0; k < PT; ++k) acc[r][k] = fmaf(cv[r], sv[k], acc[r][k]);
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
        // the next pair: J + 1, or the first of the next row tile or of
        // the state update
        fetch_pair(ci, J < I ? J + 1 : 0);
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
            lds<4>(ct + n * kTP + ty * 4, cv);
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
            yh[(c0 + i) * xrow + tx * PT + k] = from_float<T>(acc[r][k]);
        }
      }
    }

    // the state update: S <- exp(cum_last) S + sum_j (dt_j x_j) (x) (B_j dte_j)
    float sacc[PT][NT];
#pragma unroll
    for (int p = 0; p < PT; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n) sacc[p][n] = 0.f;
    for (int J = 0; J < n_tiles; ++J) {
      const int j0 = J * kT, jvalid = min(kT, Q - j0);
      bnext.store_scaled(r2, dte + j0, jvalid);
      xnext.store_scaled(xs, dtv + j0, jvalid);
      __syncthreads();
      if (J + 1 < n_tiles) fetch_pair(ci, J + 1);
      else if (ci + 1 < n_chunks) fetch_pair(ci + 1, 0);
#pragma unroll 4
      for (int j = 0; j < kT; ++j) {
        float xv[PT], bv[NT];
        lds<PT>(xs + j * P + ty * PT, xv);
        lds<NT>(r2 + j * N + tx * NT, bv);
#pragma unroll
        for (int p = 0; p < PT; ++p)
#pragma unroll
          for (int n = 0; n < NT; ++n) sacc[p][n] = fmaf(xv[p], bv[n], sacc[p][n]);
      }
      __syncthreads();
    }
    const float decay = expf(last);
#pragma unroll
    for (int p = 0; p < PT; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* s = st + (tx * NT + n) * P + ty * PT + p;
        *s = fmaf(decay, *s, sacc[p][n]);
      }
    __syncthreads();
  }

  float* fh = final_state + static_cast<int64_t>(blockIdx.x) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e % N;
    fh[e] = st[n * P + p];
  }
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, void* y, void* final_state, int64_t B, int64_t S,
           int H, int G, int Q, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (Smem<T, P, N>::kFloats + 3 * Q);
  if (smem > static_cast<size_t>(kMaxSmem)) return -2;
  auto kernel = ssd_scan_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>(B * H);
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(final_state), S, H, G, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_n(const void* x, const void* dt, const void* a_log, const void* b,
             const void* c, void* y, void* f, int64_t B, int64_t S, int H,
             int G, int N, int Q, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, a_log, b, c, y, f, B, S, H, G, Q, s);
    case 32: return launch<T, P, 32>(x, dt, a_log, b, c, y, f, B, S, H, G, Q, s);
    case 64: return launch<T, P, 64>(x, dt, a_log, b, c, y, f, B, S, H, G, Q, s);
    case 128: return launch<T, P, 128>(x, dt, a_log, b, c, y, f, B, S, H, G, Q, s);
    default: return -1;
  }
}

template <typename T>
int launch_p(const void* x, const void* dt, const void* a_log, const void* b,
             const void* c, void* y, void* f, int64_t B, int64_t S, int H,
             int G, int P, int N, int Q, cudaStream_t s) {
  switch (P) {
    case 16: return launch_n<T, 16>(x, dt, a_log, b, c, y, f, B, S, H, G, N, Q, s);
    case 32: return launch_n<T, 32>(x, dt, a_log, b, c, y, f, B, S, H, G, N, Q, s);
    case 64: return launch_n<T, 64>(x, dt, a_log, b, c, y, f, B, S, H, G, N, Q, s);
    default: return -1;
  }
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer aligned to 16 bytes; dtype is 0 for float32 and 1 for
// bfloat16 (x, b, c, y); dt, a_log and the final state are float32;
// Q >= 1 divides S, G divides H, P is 16, 32 or 64 and N 16, 32, 64 or 128
// (the wrapper checks all of these). Launches on `stream` without
// synchronising and returns cudaGetLastError(), -1 for a bad argument or -2
// when the chunk's arrays do not fit in shared memory.
extern "C" int ssd_scan_launch(const void* x, const void* dt,
                               const void* a_log, const void* b, const void* c,
                               void* y, void* final_state, int64_t B,
                               int64_t S, int H, int G, int P, int N, int Q,
                               int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || Q < 1 || S % Q) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_p<float>(x, dt, a_log, b, c, y, final_state, B, S, H, G, P,
                           N, Q, s);
  if (dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, a_log, b, c, y, final_state, B, S,
                                   H, G, P, N, Q, s);
  return -1;
}
