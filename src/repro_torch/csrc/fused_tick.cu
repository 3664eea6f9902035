// The fused sweep engine's tick for every scenario row: consumer-lag
// update, AR(1)+bias anomaly-detector observe on log1p(lag), and the
// rank-1 RLS update of the detector's weights w and covariance P. Two
// kernels share one copy of that arithmetic (`lag_step`, `detector_step`):
//
// * fused_tick: one tick, the direct counterpart of the Pallas kernel.
// * fused_interval: a whole decision interval of K ticks in one launch,
//   each tick computing every metric of step_batch_arrays as well. This is
//   the engine's path: on the TPU the Pallas tick runs inside one compiled
//   lax.scan over the interval, so the host never sees a single tick.
//
// Replaces: src/repro/kernels/fused_tick.py::fused_tick (Pallas, TPU), and
// with fused_interval the scan around it, src/repro/dsp/fused.py
// (fused_interval_scan).
//
// Bound: memory and launch latency. fused_tick moves 154 bytes a row (89
// read: lag, lag_add, rates, cap, y_prev, w[2], P[2][2] as float64 plus
// the 1-byte down flag; 65 written: new_lag, err, w'[2], P'[2][2] and the
// 1-byte flag). fused_interval moves 184 bytes of state and config a row
// (112 read, 72 written) plus 106 a row and tick (34 of planes in, nine
// float64 metrics out) for about 90 float64 operations a row and tick: far
// below the card's ratio of operations to bytes. At the sweep's widths
// (8 to a few hundred rows) a launch costs more than its bytes, so the
// interval kernel's gain is the launches (and the host dispatch around
// them) it replaces: one instead of ~46 a tick.
//
// Design: one thread per row, all in float64, every row independent; the
// grid covers the rows and the ragged tail is masked. The Pallas kernel's
// row blocks and padding are not carried over. In fused_interval the carry
// (lag, w, P, y, the trigger count) and the row's config operands stay in
// registers for the whole interval; the [K, S] planes are read row-major
// and the metrics written [9, K, S], so a warp's loads and stores for one
// tick coalesce; tick k+1's plane loads are issued before tick k's
// arithmetic, since the chain is serial per row and the loads are what can
// overlap. There is nothing for the tensor cores here.
//
// Rounding: this unit is compiled with --fmad=false, and every expression
// of step_batch_arrays is spelled with __dadd_rn / __dmul_rn / __ddiv_rn in
// the plain PyTorch version's order, so that lag and all nine metrics equal
// the plain version on the card bit for bit. Where the plain version
// divides by a Python scalar (`processed / dt`, `state_mb / 1000.0`),
// PyTorch's CUDA division multiplies by the scalar's reciprocal, and so
// does this kernel; `1024.0 / x` is `x.reciprocal() * 1024.0` in PyTorch
// on every device. clamp and minimum propagate NaN as PyTorch's do.
// log1p only feeds the detector, which is held to 1e-12.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// PyTorch's clamp(min=), clamp(max=) and minimum: NaN propagates.
__device__ __forceinline__ double clamp_min(double x, double lo) {
  return isnan(x) ? x : fmax(x, lo);
}
__device__ __forceinline__ double clamp_max(double x, double hi) {
  return isnan(x) ? x : fmin(x, hi);
}
__device__ __forceinline__ double minimum(double a, double b) {
  return isnan(a) ? a : (isnan(b) ? b : fmin(a, b));
}

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

// The consumer-lag update, step_batch_arrays' expressions in order:
// lag0 = lag + lag_add; achievable = cap*dt; demand = rates*dt + lag0;
// processed = minimum(achievable, demand); then the down_pre select.
struct LagStep {
  double new_lag, processed;
};

__device__ __forceinline__ LagStep lag_step(double lag, double lag_add,
                                            double rate, double cap,
                                            bool down_pre, double dt) {
  const double lag0 = __dadd_rn(lag, lag_add);
  const double achievable = __dmul_rn(cap, dt);
  const double demand = __dadd_rn(__dmul_rn(rate, dt), lag0);
  const double processed = minimum(achievable, demand);
  const double nl = down_pre ? __dadd_rn(lag0, __dmul_rn(rate, dt))
                             : __dsub_rn(demand, processed);
  return {nl, processed};
}

// Detector observe on y = log1p(new_lag) with the AR(1)+bias regressor
// (1, y_prev), then the rank-1 RLS update of (w, P), weights riding along.
// Returns the prediction error; *y is set to log1p(new_lag).
__device__ __forceinline__ double detector_step(double new_lag, double y_prev,
                                                double lam,
                                                double (&w)[kOrder],
                                                double (&P)[kOrder][kOrder],
                                                double* y) {
  const double phi[kOrder] = {1.0, y_prev};
  double pred = w[0] * phi[0];
#pragma unroll
  for (int r = 1; r < kOrder; ++r) pred = pred + w[r] * phi[r];
  *y = log1p(new_lag);
  const double e = *y - pred;
  double gain[kOrder], Pn[kOrder][kOrder];
  rls_rank1_step<kOrder>(P, phi, lam, gain, Pn);
#pragma unroll
  for (int r = 0; r < kOrder; ++r) {
    w[r] = w[r] + gain[r] * e;
#pragma unroll
    for (int c = 0; c < kOrder; ++c) P[r][c] = Pn[r][c];
  }
  return e;
}

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
  if (i >= B) return;
  const LagStep ls =
      lag_step(lag[i], lag_add[i], rates[i], cap[i], down_pre[i] != 0, dt);
  new_lag[i] = ls.new_lag;
  double wr[kOrder], Pr[kOrder][kOrder], y;
#pragma unroll
  for (int r = 0; r < kOrder; ++r) {
    wr[r] = w[i * kOrder + r];
#pragma unroll
    for (int c = 0; c < kOrder; ++c) Pr[r][c] = P[(i * kOrder + r) * kOrder + c];
  }
  const double e = detector_step(ls.new_lag, y_prev[i], lam, wr, Pr, &y);
  err_out[i] = e;
  flag_out[i] = fabs(e) > thresh ? 1 : 0;
#pragma unroll
  for (int r = 0; r < kOrder; ++r) {
    w_out[i * kOrder + r] = wr[r];
#pragma unroll
    for (int c = 0; c < kOrder; ++c) P_out[(i * kOrder + r) * kOrder + c] = Pr[r][c];
  }
}

// The ClusterModel constants step_batch_arrays reads.
struct Model {
  double noise, base_latency_s, queue_gamma, latency_cap_s, cpu_idle_frac,
      state_per_krate_mb;
};

// One tick's host-precomputed control state of one row.
struct Plane {
  double rate, lag_add, z1, z2;
  bool down_pre, down_post;
};

__device__ __forceinline__ Plane load_plane(
    const double* __restrict__ rates, const double* __restrict__ lag_add,
    const uint8_t* __restrict__ down_pre,
    const uint8_t* __restrict__ down_post, const double* __restrict__ z1,
    const double* __restrict__ z2, int64_t at) {
  return {rates[at], lag_add[at], z1[at], z2[at], down_pre[at] != 0,
          down_post[at] != 0};
}

constexpr int kMetrics = 9;  // METRIC_KEYS

__global__ void fused_interval_kernel(
    double* __restrict__ lag, double* __restrict__ det_w,
    double* __restrict__ det_p, double* __restrict__ det_y,
    int64_t* __restrict__ det_trig, const double* __restrict__ rates,
    const double* __restrict__ lag_add, const uint8_t* __restrict__ down_pre,
    const uint8_t* __restrict__ down_post, const double* __restrict__ z1,
    const double* __restrict__ z2, const double* __restrict__ workers,
    const double* __restrict__ cpu_cores,
    const double* __restrict__ memory_mb,
    const double* __restrict__ task_slots,
    const double* __restrict__ cap_base, Model m, double lam, double thresh,
    double dt, int64_t K, int64_t S, double* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= S) return;
  // -- the carry, in registers for the whole interval ----------------------
  double lg = lag[i], y = det_y[i];
  int64_t trig = det_trig[i];
  double w[kOrder], P[kOrder][kOrder];
#pragma unroll
  for (int r = 0; r < kOrder; ++r) {
    w[r] = det_w[i * kOrder + r];
#pragma unroll
    for (int c = 0; c < kOrder; ++c) P[r][c] = det_p[(i * kOrder + r) * kOrder + c];
  }
  // -- the row's config operands and what depends on them alone ------------
  const double wk = workers[i], mem = memory_mb[i], cb = cap_base[i];
  const double cores_total = __dmul_rn(wk, cpu_cores[i]);
  const double mem_total = __dmul_rn(wk, mem);
  const double workers_c = clamp_min(wk, 1.0);
  const double mem_c = clamp_min(mem, 1.0);
  const double mem_per_slot = __ddiv_rn(mem, clamp_min(task_slots[i], 1.0));
  const double slot_ratio = __dmul_rn(__drcp_rn(mem_per_slot), 1024.0);
  const double gc_scale = __dmul_rn(0.25, __dmul_rn(slot_ratio, slot_ratio));
  const double idle = m.cpu_idle_frac, busy = __dsub_rn(1.0, idle);
  const double inv_dt = __drcp_rn(dt), inv_1000 = __drcp_rn(1000.0);

  Plane cur = load_plane(rates, lag_add, down_pre, down_post, z1, z2, i);
  for (int64_t k = 0; k < K; ++k) {
    Plane nxt = cur;
    if (k + 1 < K)
      nxt = load_plane(rates, lag_add, down_pre, down_post, z1, z2,
                       (k + 1) * S + i);
    const double rate = cur.rate;
    // capacity under noise
    const double noise = __dadd_rn(1.0, __dmul_rn(m.noise, cur.z1));
    const double cap = __dmul_rn(cb, clamp_min(noise, 0.5));
    const LagStep ls = lag_step(lg, cur.lag_add, rate, cap, cur.down_pre, dt);
    const double nl = ls.new_lag;
    const double throughput =
        cur.down_pre ? 0.0 : __dmul_rn(ls.processed, inv_dt);
    // utilisation and latency
    const double cap_c = clamp_min(cap, 1e-9);
    const double util = clamp_max(__ddiv_rn(rate, cap_c), 1.5);
    const double rho = clamp_max(__ddiv_rn(rate, cap_c), 0.999);
    const double base = __dmul_rn(
        m.base_latency_s,
        __dadd_rn(1.0, __ddiv_rn(__dmul_rn(m.queue_gamma, rho),
                                 __dsub_rn(1.0, rho))));
    const double backlog_delay = __ddiv_rn(nl, cap_c);
    const double gc_penalty = __dmul_rn(gc_scale, rho);
    const double noisy =
        __dmul_rn(__dadd_rn(__dadd_rn(base, backlog_delay), gc_penalty),
                  __dadd_rn(1.0, __dmul_rn(0.05, cur.z2)));
    const double latency = cur.down_post ? m.latency_cap_s
                                         : clamp_max(noisy, m.latency_cap_s);
    // resource usage
    const double usage_cpu = __dmul_rn(
        cores_total, __dadd_rn(idle, __dmul_rn(busy, clamp_max(util, 1.0))));
    const double state_mb =
        __dmul_rn(__dmul_rn(m.state_per_krate_mb, rate), inv_1000);
    const double mem_needed = __dadd_rn(__ddiv_rn(state_mb, workers_c), 300.0);
    const double mem_frac = clamp_max(
        __dadd_rn(0.25, __ddiv_rn(__dmul_rn(0.75, mem_needed), mem_c)), 1.0);
    const double usage_mem = __dmul_rn(mem_total, mem_frac);

    const double metrics[kMetrics] = {
        rate, throughput, cap, nl, latency, util, usage_cpu, usage_mem,
        cur.down_post ? 1.0 : 0.0};
#pragma unroll
    for (int q = 0; q < kMetrics; ++q) out[(q * K + k) * S + i] = metrics[q];

    // the detector on the tick's new lag, then the carry
    const double e = detector_step(nl, y, lam, w, P, &y);
    trig += fabs(e) > thresh ? 1 : 0;
    lg = nl;
    cur = nxt;
  }
  lag[i] = lg;
  det_y[i] = y;
  det_trig[i] = trig;
#pragma unroll
  for (int r = 0; r < kOrder; ++r) {
    det_w[i * kOrder + r] = w[r];
#pragma unroll
    for (int c = 0; c < kOrder; ++c) det_p[(i * kOrder + r) * kOrder + c] = P[r][c];
  }
}

constexpr int kThreads = 128;

unsigned int blocks_for(int64_t rows) {
  return static_cast<unsigned int>((rows + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points for ctypes. Every pointer is a device pointer to a
// contiguous buffer; the wrappers check types and shapes. Each launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int fused_tick_launch(const void* lag, const void* lag_add,
                                 const void* rates, const void* cap,
                                 const void* down_pre, const void* w,
                                 const void* P, const void* y_prev, double lam,
                                 double thresh, double dt, int64_t B,
                                 void* new_lag, void* w_out, void* P_out,
                                 void* err_out, void* flag_out, void* stream) {
  fused_tick_kernel<<<blocks_for(B), kThreads, 0,
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

// State (lag, det_w, det_p, det_y, det_trig) is updated in place; the
// [K, S] planes are rates, lag_add, down_pre, down_post (bool), z1, z2;
// the [S] config operands workers, cpu_cores, memory_mb, task_slots,
// cap_base; `out` is [9, K, S] in METRIC_KEYS order. K >= 1, S >= 1.
extern "C" int fused_interval_launch(
    void* lag, void* det_w, void* det_p, void* det_y, void* det_trig,
    const void* rates, const void* lag_add, const void* down_pre,
    const void* down_post, const void* z1, const void* z2,
    const void* workers, const void* cpu_cores, const void* memory_mb,
    const void* task_slots, const void* cap_base, double noise,
    double base_latency_s, double queue_gamma, double latency_cap_s,
    double cpu_idle_frac, double state_per_krate_mb, double lam,
    double thresh, double dt, int64_t K, int64_t S, void* out, void* stream) {
  const Model m{noise, base_latency_s, queue_gamma, latency_cap_s,
                cpu_idle_frac, state_per_krate_mb};
  fused_interval_kernel<<<blocks_for(S), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(lag), static_cast<double*>(det_w),
      static_cast<double*>(det_p), static_cast<double*>(det_y),
      static_cast<int64_t*>(det_trig), static_cast<const double*>(rates),
      static_cast<const double*>(lag_add),
      static_cast<const uint8_t*>(down_pre),
      static_cast<const uint8_t*>(down_post),
      static_cast<const double*>(z1), static_cast<const double*>(z2),
      static_cast<const double*>(workers),
      static_cast<const double*>(cpu_cores),
      static_cast<const double*>(memory_mb),
      static_cast<const double*>(task_slots),
      static_cast<const double*>(cap_base), m, lam, thresh, dt, K, S,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
