// Batched rank-1 recursive-least-squares step, one row per stream of the
// forecast bank's ARIMA family:
//   Pphi = P phi,  denom = lam + phi' Pphi,  gain = Pphi / denom,
//   P'   = (P - gain Pphi') / lam.
// P is (B, k, k) row-major, phi (B, k), lam (B,); outputs gain (B, k) and
// P' (B, k, k). float64 (the bank's type) and float32.
//
// Replaces: src/repro/kernels/rls_update.py::rls_rank1_update (Pallas, TPU;
// its body is _rls_kernel).
//
// Bound: memory. A row reads k*k + k + 1 values and writes k*k + k, i.e.
// 8*(2k^2 + 2k + 1) bytes in float64, for about 5k^2 + 3k operations: about
// 0.6 operations per byte, far below the card's float64 ratio of ~10. At the
// bank's widths (a few to a few thousand streams, k = 5, 9 or 17) a launch
// costs more than its bytes.
//
// Design: one thread per row, every row independent; the Pallas kernel's
// row blocks and their padding are not carried over, the ragged tail is
// masked with `if (i < B)`. k is a runtime argument; the bank's orders
// (k = p_max + 1 with p_max a power of two >= 4: 5, 9, 17) get unrolled
// specializations that keep phi and Pphi in registers, any other k up to
// kMaxK runs the same arithmetic with loops. Sums run in index order; the
// unit is built with --fmad=false, so every product and sum rounds on its
// own, as in the plain PyTorch version. A thread reads its row of P twice
// (for Pphi and for P'); the second read hits L1/L2. Rows are k*k apart, so
// a warp's loads are not coalesced: making this fast (a warp per row, or
// rows staged through shared memory) is later work.
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
