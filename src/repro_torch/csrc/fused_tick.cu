// One tick of the fused sweep engine for every scenario row: consumer-lag
// update, AR(1)+bias anomaly-detector observe on log1p(lag), and the
// rank-1 RLS update of the detector's weights w and covariance P.
//
// Replaces: src/repro/kernels/fused_tick.py::fused_tick (Pallas, TPU).
//
// Bound: memory and launch latency. Each row moves 154 bytes (89 read:
// lag, lag_add, rates, cap, y_prev, w[2], P[2][2] as float64 plus the
// 1-byte down flag; 65 written: new_lag, err, w'[2], P'[2][2] and the
// 1-byte flag) for a few dozen float64 operations, far below the card's
// ratio of operations to bytes. At the sweep's widths (hundreds to tens of
// thousands of rows) the launch itself costs more than the bytes.
//
// Design: one thread per row, all in float64, every row independent. The
// Pallas kernel's row blocks and their padding are not carried over: the
// grid covers the rows and the ragged tail is masked with `if (i < B)`.
// The rank-1 RLS step is a __device__ template over the order k, so the
// forecast bank's batched RLS kernel can reuse it.
//
// Rounding: this unit is compiled with --fmad=false, and the lag update
// spells its products and sums with __dmul_rn / __dadd_rn besides, in the
// reference's order (lag0 = lag + lag_add; demand = rates*dt + lag0;
// processed = min(cap*dt, demand); then the down_pre select). The engine
// takes its lag carry from this kernel and its metrics from
// step_batch_arrays, so new_lag must equal the plain version bit for bit.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Rank-1 RLS step for one row of order K:
//   Pphi = P phi, denom = lam + phi' Pphi, gain = Pphi / denom,
//   P' = (P - gain Pphi') / lam.
// Sums run in index order, as the plain version's.
template <int K>
__device__ __forceinline__ void rls_rank1_step(const double (&P)[K][K],
                                               const double (&phi)[K],
                                               double lam, double (&gain)[K],
                                               double (&Pnew)[K][K]) {
  double Pphi[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    double s = P[r][0] * phi[0];
#pragma unroll
    for (int c = 1; c < K; ++c) s = s + P[r][c] * phi[c];
    Pphi[r] = s;
  }
  double quad = phi[0] * Pphi[0];
#pragma unroll
  for (int r = 1; r < K; ++r) quad = quad + phi[r] * Pphi[r];
  const double denom = lam + quad;
#pragma unroll
  for (int r = 0; r < K; ++r) gain[r] = Pphi[r] / denom;
#pragma unroll
  for (int r = 0; r < K; ++r) {
#pragma unroll
    for (int c = 0; c < K; ++c) Pnew[r][c] = (P[r][c] - gain[r] * Pphi[c]) / lam;
  }
}

constexpr int kOrder = 2;  // bias + previous log-lag sample

__global__ void fused_tick_kernel(
    const double* __restrict__ lag, const double* __restrict__ lag_add,
    const double* __restrict__ rates, const double* __restrict__ cap,
    const uint8_t* __restrict__ down_pre, const double* __restrict__ w,
    const double* __restrict__ P, const double* __restrict__ y_prev,
    double lam, double thresh, double dt, int64_t B,
    double* __restrict__ new_lag, double* __restrict__ w_out,
    double* __restrict__ P_out, double* __restrict__ err_out,
    uint8_t* __restrict__ flag_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < B) {
    // -- consumer-lag update (step_batch_arrays' expressions, in order) ----
    const double rate = rates[i];
    const double lag0 = __dadd_rn(lag[i], lag_add[i]);
    const double demand = __dadd_rn(__dmul_rn(rate, dt), lag0);
    const double achievable = __dmul_rn(cap[i], dt);
    const double processed = fmin(achievable, demand);
    const double nl = down_pre[i] ? __dadd_rn(lag0, __dmul_rn(rate, dt))
                                  : __dsub_rn(demand, processed);
    new_lag[i] = nl;

    // -- detector observe: AR(1)+bias prediction error on log1p(lag) ------
    const double phi[kOrder] = {1.0, y_prev[i]};
    double wr[kOrder], Pr[kOrder][kOrder];
#pragma unroll
    for (int r = 0; r < kOrder; ++r) {
      wr[r] = w[i * kOrder + r];
#pragma unroll
      for (int c = 0; c < kOrder; ++c) Pr[r][c] = P[(i * kOrder + r) * kOrder + c];
    }
    double pred = wr[0] * phi[0];
#pragma unroll
    for (int r = 1; r < kOrder; ++r) pred = pred + wr[r] * phi[r];
    const double e = log1p(nl) - pred;
    err_out[i] = e;
    flag_out[i] = fabs(e) > thresh ? 1 : 0;

    // -- rank-1 RLS update, weights riding along --------------------------
    double gain[kOrder], Pn[kOrder][kOrder];
    rls_rank1_step<kOrder>(Pr, phi, lam, gain, Pn);
#pragma unroll
    for (int r = 0; r < kOrder; ++r) {
      w_out[i * kOrder + r] = wr[r] + gain[r] * e;
#pragma unroll
      for (int c = 0; c < kOrder; ++c) P_out[(i * kOrder + r) * kOrder + c] = Pn[r][c];
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer of B rows; the wrapper checks types and shapes. Launches
// on `stream` without synchronising and returns cudaGetLastError().
extern "C" int fused_tick_launch(const void* lag, const void* lag_add,
                                 const void* rates, const void* cap,
                                 const void* down_pre, const void* w,
                                 const void* P, const void* y_prev, double lam,
                                 double thresh, double dt, int64_t B,
                                 void* new_lag, void* w_out, void* P_out,
                                 void* err_out, void* flag_out, void* stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  fused_tick_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(lag), static_cast<const double*>(lag_add),
      static_cast<const double*>(rates), static_cast<const double*>(cap),
      static_cast<const uint8_t*>(down_pre), static_cast<const double*>(w),
      static_cast<const double*>(P), static_cast<const double*>(y_prev), lam,
      thresh, dt, B, static_cast<double*>(new_lag),
      static_cast<double*>(w_out), static_cast<double*>(P_out),
      static_cast<double*>(err_out), static_cast<uint8_t*>(flag_out));
  return static_cast<int>(cudaGetLastError());
}
