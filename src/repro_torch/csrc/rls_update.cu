// The forecast bank's ARIMA family on the card, in two kernels:
//
// * rls_rank1_update: one batched rank-1 recursive-least-squares step, one
//   row per stream, the direct counterpart of the Pallas kernel:
//     Pphi = P phi,  denom = lam + phi' Pphi,  gain = Pphi / denom,
//     P'   = (P - gain Pphi') / lam.
//   P is (B, k, k) row-major, phi (B, k), lam (B,); outputs gain (B, k)
//   and P' (B, k, k). float64 (the bank's type) and float32.
// * arima_chunk: a whole flush of the bank, T queued ticks of every stream
//   in one launch: each tick the masked online ARIMA step of
//   core/forecast_bank.py (differencing cascade, masked regressor, the
//   rank-1 RLS step above, residual and weights, re-symmetrised P, trace
//   cap over the active dimensions, padded dimensions pinned at ridge*I,
//   divergence reset, do_rls gating, lag shift, tails, last and count).
//   float64 only. On the TPU the Pallas step runs inside one compiled
//   lax.scan over the chunk, so the host never sees a single tick.
//
// Replaces: src/repro/kernels/rls_update.py::rls_rank1_update (Pallas, TPU;
// its body is _rls_kernel), and with arima_chunk the scan around it,
// src/repro/core/forecast_bank.py (_arima_chunk).
//
// Bound: memory and launch latency. rls_rank1_update reads k*k + k + 1
// values a row and writes k*k + k, i.e. 8*(2k^2 + 2k + 1) bytes in float64,
// for about 5k^2 + 3k operations: about 0.6 operations per byte, far below
// the card's float64 ratio of ~10. arima_chunk reads and writes the state
// once (w, P, lags, tails, count, last) plus 8 bytes in and 9 out a stream
// and tick. At the bank's widths (a few to a few hundred streams, k = 5, 9
// or 17) a launch costs more than its bytes, so arima_chunk's gain is the
// launches it replaces: one a flush instead of ~31 a tick.
//
// Design of rls_rank1_update: one thread per row, every row independent;
// the Pallas kernel's row blocks and their padding are not carried over,
// the ragged tail is masked with `if (i < B)`. k is a runtime argument; the
// bank's orders (k = p_max + 1 with p_max a power of two >= 4: 5, 9, 17)
// get unrolled specializations that keep phi and Pphi in registers, any
// other k up to kMaxK runs the same arithmetic with loops. A thread reads
// its row of P twice (for Pphi and for P'); the second read hits L1/L2.
// At k = 17 it spills (a whole row of P per thread).
//
// Design of arima_chunk: one warp per stream (a block each). Lane r owns
// row r of P (and rows r + 32 for k > 32) in registers for the whole
// chunk, with w[r] and lags[r]; no row is ever held by one thread alone,
// so k = 17 does not spill. phi, Pphi and the products that feed the
// cross-row sums go through shared memory, and every lane sums them
// serially in index order, so every lane holds the same sums (phi' Pphi,
// w . phi, the trace) without a broadcast. The symmetrisation reads P'
// transposed through a shared tile with an odd row stride (no bank
// conflicts). The finiteness test is a warp vote. The next tick's value
// is loaded before this tick's arithmetic.
//
// Rounding: sums run in index order; the unit is built with --fmad=false,
// so every product and sum rounds on its own, as in the plain PyTorch
// version (whose sums may run in another order: the bar is 1e-12 of
// each output's scale).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 64;

template <typename T, int K>
__device__ __forceinline__ void rls_row(const T* __restrict__ P,
                                        const T* __restrict__ phi, T lam,
                                        int k, T* __restrict__ gain,
                                        T* __restrict__ P_out) {
  // K > 0: compile-time order, loops fully unrolled and the arrays in
  // registers; K == 0: runtime k, loops kept (nvcc unrolls `#pragma unroll`
  // loops only when the trip count is a compile-time constant).
  constexpr int kBuf = K > 0 ? K : kMaxK;
  const int n = K > 0 ? K : k;
  T ph[kBuf], pphi[kBuf];
#pragma unroll
  for (int c = 0; c < n; ++c) ph[c] = phi[c];
#pragma unroll
  for (int r = 0; r < n; ++r) {
    T s = P[r * n] * ph[0];
#pragma unroll
    for (int c = 1; c < n; ++c) s = s + P[r * n + c] * ph[c];
    pphi[r] = s;
  }
  T quad = ph[0] * pphi[0];
#pragma unroll
  for (int r = 1; r < n; ++r) quad = quad + ph[r] * pphi[r];
  const T denom = lam + quad;
#pragma unroll
  for (int r = 0; r < n; ++r) {
    const T g = pphi[r] / denom;
    gain[r] = g;
#pragma unroll
    for (int c = 0; c < n; ++c) P_out[r * n + c] = (P[r * n + c] - g * pphi[c]) / lam;
  }
}

template <typename T, int K>
__global__ void rls_rank1_kernel(const T* __restrict__ P,
                                 const T* __restrict__ phi,
                                 const T* __restrict__ lam, int64_t B, int k,
                                 T* __restrict__ gain, T* __restrict__ P_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < B) {
    const int64_t kk = static_cast<int64_t>(k) * k;
    rls_row<T, K>(P + i * kk, phi + i * k, lam[i], k, gain + i * k,
                  P_out + i * kk);
  }
}

template <typename T>
int launch(const void* P, const void* phi, const void* lam, int64_t B, int k,
           void* gain, void* P_out, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const unsigned int blocks =
      static_cast<unsigned int>((B + kThreads - 1) / kThreads);
  const T* p = static_cast<const T*>(P);
  const T* f = static_cast<const T*>(phi);
  const T* l = static_cast<const T*>(lam);
  T* g = static_cast<T*>(gain);
  T* po = static_cast<T*>(P_out);
  switch (k) {
    case 5:
      rls_rank1_kernel<T, 5><<<blocks, kThreads, 0, stream>>>(p, f, l, B, k, g, po);
      break;
    case 9:
      rls_rank1_kernel<T, 9><<<blocks, kThreads, 0, stream>>>(p, f, l, B, k, g, po);
      break;
    case 17:
      rls_rank1_kernel<T, 17><<<blocks, kThreads, 0, stream>>>(p, f, l, B, k, g, po);
      break;
    default:
      rls_rank1_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(p, f, l, B, k, g, po);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- arima_chunk -----------------------------------------------------------

constexpr int kMaxD = 32;  // differencing orders a stream may carry (d_max)

// One entry of the step's new covariance: the symmetrised P' scaled by the
// trace cap where row and column are both active dims, else ridge * I.
__device__ __forceinline__ double p_entry(const double* __restrict__ pt,
                                          int ld, int r, int c, bool keep,
                                          double scale, double ridge) {
  return keep ? 0.5 * (pt[r * ld + c] + pt[c * ld + r]) * scale
              : ridge * (r == c ? 1.0 : 0.0);
}

// KC is the order k for the bank's orders (5, 9, 17), or a bound on a
// runtime k (32 for k <= 32, 64 for k <= 64: two rows a lane).
template <int KC>
__global__ void __launch_bounds__(32) arima_chunk_kernel(
    double* __restrict__ w, double* __restrict__ P,
    double* __restrict__ lags, double* __restrict__ tails,
    int64_t* __restrict__ count, double* __restrict__ last,
    const int64_t* __restrict__ p_arr, const int64_t* __restrict__ d_arr,
    const double* __restrict__ lam_arr, const double* __restrict__ ridge_arr,
    const double* __restrict__ cap_arr, const double* __restrict__ vals,
    int64_t T, int64_t B, int k, int d_max, double* __restrict__ resid_out,
    uint8_t* __restrict__ do_out) {
  constexpr bool kRuntimeK = KC == 32 || KC == 64;
  constexpr int R = (KC + 31) / 32;  // rows a lane owns: r = lane + 32 j
  // row stride of the transpose tile: odd, so that 16 lanes reading a
  // column or writing a row of doubles hit 16 different bank pairs
  constexpr int LD = KC % 2 ? KC : KC + 1;
  __shared__ double s_phi[KC], s_pphi[KC], s_quad[KC], s_wphi[KC], s_tr[KC],
      s_lag[KC], s_pt[KC * LD], s_tails[kMaxD];

  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = kRuntimeK ? k : KC;
  const int pm = n - 1;  // p_max: lag dims; dim pm is the bias
  const int64_t p = p_arr[b], d = d_arr[b];
  const double lam = lam_arr[b], ridge = ridge_arr[b], cap = cap_arr[b];

  double Prow[R][KC], wv[R], lagv[R];
  bool act[R];  // active dims: the first p lags and the bias
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = lane + 32 * j;
    const bool own = r < n;
    act[j] = own && (r < p || r == pm);
    wv[j] = own ? w[b * n + r] : 0.0;
    lagv[j] = r < pm ? lags[b * pm + r] : 0.0;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      Prow[j][c] = (own && c < n) ? P[(b * n + r) * n + c] : 0.0;
  }
  if (lane < d_max) s_tails[lane] = tails[b * d_max + lane];
  int64_t cnt = count[b];
  double lst = last[b];
  __syncwarp();

  double v_next = vals[b];
  for (int64_t t = 0; t < T; ++t) {
    const double v_raw = v_next;
    if (t + 1 < T) v_next = vals[(t + 1) * B + b];
    const bool valid = isfinite(v_raw);
    const double v = valid ? v_raw : 0.0;
    // differencing cascade: diffs[0] = v, diffs[j + 1] = diffs[j] - tails[j];
    // the target is diffs[d], lane j keeps diffs[j] for its tail
    double acc = v, target = v, mydiff = 0.0;
    for (int j = 0; j < d_max; ++j) {
      if (j == lane) mydiff = acc;
      acc = acc - s_tails[j];
      if (j + 1 == d) target = acc;
    }
    // the masked regressor [active lags, bias]
    double ph[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      ph[j] = r < pm ? (r < p ? lagv[j] : 0.0) : (r == pm ? 1.0 : 0.0);
      if (r < n) s_phi[r] = ph[j];
    }
    __syncwarp();
    // Pphi for the lane's rows, and the terms of phi' Pphi and w . phi
    double pp[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      double s = Prow[j][0] * s_phi[0];
#pragma unroll
      for (int c = 1; c < KC; ++c)
        if (c < n) s = s + Prow[j][c] * s_phi[c];
      pp[j] = s;
      if (r < n) {
        s_pphi[r] = s;
        s_quad[r] = ph[j] * s;
        s_wphi[r] = wv[j] * ph[j];
      }
    }
    __syncwarp();
    double quad = s_quad[0], wphi = s_wphi[0];
    for (int c = 1; c < n; ++c) {
      quad = quad + s_quad[c];
      wphi = wphi + s_wphi[c];
    }
    const double denom = lam + quad;
    const double resid = target - wphi;
    // gain, weights, and P' = (P - gain Pphi') / lam into the transpose tile
    double wn[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      const double g = pp[j] / denom;
      wn[j] = wv[j] + g * resid;
      if (r < n) {
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c < n) s_pt[r * LD + c] = (Prow[j][c] - g * s_pphi[c]) / lam;
      }
    }
    __syncwarp();
    // the trace of the symmetrised P' over the active dims, and its cap
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      if (r < n) {
        const double prr = s_pt[r * LD + r];
        s_tr[r] = act[j] ? 0.5 * (prr + prr) : 0.0;
      }
    }
    __syncwarp();
    double tr = s_tr[0];
    for (int c = 1; c < n; ++c) tr = tr + s_tr[c];
    const double scale = tr > cap ? cap / tr : 1.0;
    // divergence: a non-finite weight or covariance entry resets the stream
    bool fin = true;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      if (r < n) {
        fin = fin && isfinite(wn[j]);
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c < n)
            fin = fin && isfinite(p_entry(s_pt, LD, r, c,
                                          act[j] && (c < p || c == pm), scale,
                                          ridge));
      }
    }
    const bool ok = __all_sync(0xffffffffu, fin);
    // RLS fires once p + d + 1 samples exist (count is pre-increment)
    const bool do_rls = valid && cnt >= p + d;
    if (do_rls) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = lane + 32 * j;
        if (r < n) {
          wv[j] = ok ? wn[j] : 0.0;
#pragma unroll
          for (int c = 0; c < KC; ++c)
            if (c < n)
              Prow[j][c] = ok ? p_entry(s_pt, LD, r, c,
                                        act[j] && (c < p || c == pm), scale,
                                        ridge)
                              : ridge * (r == c ? 1.0 : 0.0);
        }
      }
    }
    // the differencing tails, then the lag shift once count >= d
    if (lane < d_max && valid && cnt >= lane && lane < d)
      s_tails[lane] = mydiff;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = lane + 32 * j;
      if (r < pm) s_lag[r] = lagv[j];
    }
    __syncwarp();
    if (valid && cnt >= d) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = lane + 32 * j;
        if (r < pm) lagv[j] = r == 0 ? target : s_lag[r - 1];
      }
    }
    if (valid) {
      lst = v;
      cnt += 1;
    }
    if (lane == 0) {
      resid_out[t * B + b] = resid;
      do_out[t * B + b] = do_rls ? 1 : 0;
    }
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = lane + 32 * j;
    if (r < n) {
      w[b * n + r] = wv[j];
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < n) P[(b * n + r) * n + c] = Prow[j][c];
    }
    if (r < pm) lags[b * pm + r] = lagv[j];
  }
  if (lane < d_max) tails[b * d_max + lane] = s_tails[lane];
  if (lane == 0) {
    count[b] = cnt;
    last[b] = lst;
  }
}


}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer; dtype is 0 for float64 and 1 for float32; 1 <= k <= 64
// (the wrapper checks types, shapes and k). Launches on `stream` without
// synchronising and returns cudaGetLastError(), or -1 for a bad dtype or k.
extern "C" int rls_update_launch(const void* P, const void* phi,
                                 const void* lam, int64_t B, int k, int dtype,
                                 void* gain, void* P_out, void* stream) {
  if (k < 1 || k > kMaxK) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<double>(P, phi, lam, B, k, gain, P_out, s);
  if (dtype == 1) return launch<float>(P, phi, lam, B, k, gain, P_out, s);
  return -1;
}

// The ARIMA chunk for ctypes: state w (B, k), P (B, k, k), lags
// (B, k - 1), tails (B, d_max), count (B,) int64 and last (B,) updated in
// place; params p, d (B,) int64 and lam, ridge, cap (B,); vals (T, B);
// outputs resid (T, B) float64 and do_rls (T, B) bool. All float64 but
// the int64 and bool ones, contiguous device buffers. Launches on `stream`
// without synchronising and returns cudaGetLastError(), or -1 for an
// order, depth or shape out of range.
extern "C" int arima_chunk_launch(void* w, void* P, void* lags, void* tails,
                                  void* count, void* last, const void* p,
                                  const void* d, const void* lam,
                                  const void* ridge, const void* cap,
                                  const void* vals, int64_t T, int64_t B,
                                  int k, int d_max, void* resid, void* do_rls,
                                  void* stream) {
  if (k < 1 || k > kMaxK || d_max < 0 || d_max > kMaxD || T < 1 || B < 1)
    return -1;
  const auto grid = static_cast<unsigned int>(B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARIMA_ARGS                                                           \
  static_cast<double*>(w), static_cast<double*>(P),                          \
      static_cast<double*>(lags), static_cast<double*>(tails),               \
      static_cast<int64_t*>(count), static_cast<double*>(last),              \
      static_cast<const int64_t*>(p), static_cast<const int64_t*>(d),        \
      static_cast<const double*>(lam), static_cast<const double*>(ridge),    \
      static_cast<const double*>(cap), static_cast<const double*>(vals), T,  \
      B, k, d_max, static_cast<double*>(resid), static_cast<uint8_t*>(do_rls)
  switch (k) {
    case 5: arima_chunk_kernel<5><<<grid, 32, 0, s>>>(ARIMA_ARGS); break;
    case 9: arima_chunk_kernel<9><<<grid, 32, 0, s>>>(ARIMA_ARGS); break;
    case 17: arima_chunk_kernel<17><<<grid, 32, 0, s>>>(ARIMA_ARGS); break;
    default:
      if (k <= 32)
        arima_chunk_kernel<32><<<grid, 32, 0, s>>>(ARIMA_ARGS);
      else
        arima_chunk_kernel<64><<<grid, 32, 0, s>>>(ARIMA_ARGS);
  }
#undef ARIMA_ARGS
  return static_cast<int>(cudaGetLastError());
}
