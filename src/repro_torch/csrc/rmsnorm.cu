// Fused residual add and RMSNorm: for every row of d values,
//   s = x + res                          (float32),
//   y = s * rsqrt(mean(s^2) + eps) * (1 + scale),
// with y and s each rounded once to x's dtype (float32 or bfloat16). x, res,
// y and s are (rows, d), scale (d,).
//
// Replaces: src/repro/kernels/rmsnorm.py::fused_rmsnorm (Pallas, TPU; its
// body is _rmsnorm_kernel).
//
// Bound: bytes. Each element costs a handful of operations against 4 values
// moved (x and res read, y and s written), so the kernel can do no better
// than one pass over them: 16 x 4096 rows of 2048 bf16 move 1.07 GB, 0.320
// ms of HBM. Fusing the add saves the round trip of the sum, which is what
// the Pallas kernel is for.
//
// Design: one warp per row, eight rows per CTA of 256 threads, any d and
// any row count with no padding copies. A first pass reads x and res with
// 16-byte loads (8 bf16 or 4 float32 a lane; scalar loads where d is not a
// multiple of that), writes s and sums s^2 in float32; a shuffle reduction
// gives the row's mean; a second pass writes y. The Pallas kernel keeps
// the row in VMEM across both steps. Here a row of up to 2048 values
// (kHeld per lane) stays in registers, so x and res are read once; a
// longer row (pixtral's 5120) is read again in the second pass (from L1
// and L2, which hold it). The statistic's sum runs in another order than
// the plain version's, and 1 / sqrtf is IEEE-rounded (not the
// approximate rsqrtf).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerCta = 8;
// float32 values of a row a lane holds in registers: rows of up to
// 32 * kHeld values are read once
constexpr int kHeld = 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float& o) { o = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16& o) {
  o = __float2bfloat16(v);   // round to nearest even, as torch's cast
}

// V consecutive values of T; V * sizeof(T) is 16 bytes, or V is 1.
template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T v[V];
};

// A row of d <= 32 * kHeld in registers: s = x + res read once (V values
// a lane per step, kHeld / V steps, unrolled so the array stays in
// registers), then y from the held sums.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kRowsPerCta)
rmsnorm_held_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const T* __restrict__ scale, T* __restrict__ y,
                    T* __restrict__ s, int64_t rows, int d, float eps) {
  using P = Pack<T, V>;
  constexpr int kSteps = kHeld / V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerCta + warp;
  if (row >= rows) return;
  const int64_t off = row * d;
  float held[kSteps][V];
  float ss = 0.f;
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int c = (it * 32 + lane) * V;
    if (c < d) {
      const P xv = *reinterpret_cast<const P*>(x + off + c);
      const P rv = *reinterpret_cast<const P*>(res + off + c);
      P sv;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v = to_f(xv.v[i]) + to_f(rv.v[i]);
        held[it][i] = v;
        ss += v * v;
        from_f(v, sv.v[i]);
      }
      *reinterpret_cast<P*>(s + off + c) = sv;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
  for (int it = 0; it < kSteps; ++it) {
    const int c = (it * 32 + lane) * V;
    if (c < d) {
      const P sc = *reinterpret_cast<const P*>(scale + c);
      P yv;
#pragma unroll
      for (int i = 0; i < V; ++i)
        from_f(held[it][i] * r * (1.0f + to_f(sc.v[i])), yv.v[i]);
      *reinterpret_cast<P*>(y + off + c) = yv;
    }
  }
}

// Any row: s written in a first pass, the row read again for y.
template <typename T, int V>
__global__ void __launch_bounds__(32 * kRowsPerCta)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const T* __restrict__ scale, T* __restrict__ y,
               T* __restrict__ s, int64_t rows, int d, float eps) {
  using P = Pack<T, V>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerCta + warp;
  if (row >= rows) return;
  const int64_t off = row * d;
  float ss = 0.f;
  for (int c = lane * V; c < d; c += 32 * V) {
    const P xv = *reinterpret_cast<const P*>(x + off + c);
    const P rv = *reinterpret_cast<const P*>(res + off + c);
    P sv;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = to_f(xv.v[i]) + to_f(rv.v[i]);
      ss += v * v;
      from_f(v, sv.v[i]);
    }
    *reinterpret_cast<P*>(s + off + c) = sv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
  for (int c = lane * V; c < d; c += 32 * V) {
    const P xv = *reinterpret_cast<const P*>(x + off + c);
    const P rv = *reinterpret_cast<const P*>(res + off + c);
    const P sc = *reinterpret_cast<const P*>(scale + c);
    P yv;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float v = to_f(xv.v[i]) + to_f(rv.v[i]);
      from_f(v * r * (1.0f + to_f(sc.v[i])), yv.v[i]);
    }
    *reinterpret_cast<P*>(y + off + c) = yv;
  }
}

template <typename T>
int launch(const void* x, const void* res, const void* scale, void* y,
           void* s, int64_t rows, int d, float eps, bool vec,
           cudaStream_t stream) {
  const unsigned int grid =
      static_cast<unsigned int>((rows + kRowsPerCta - 1) / kRowsPerCta);
  constexpr int kV = 16 / sizeof(T);
  auto args = [&](auto kernel) {
    kernel<<<grid, 32 * kRowsPerCta, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<const T*>(scale), static_cast<T*>(y), static_cast<T*>(s),
        rows, d, eps);
  };
  if (vec && d % kV == 0 && d <= 32 * kHeld)
    args(rmsnorm_held_kernel<T, kV>);
  else if (vec && d % kV == 0)
    args(rmsnorm_kernel<T, kV>);
  else
    args(rmsnorm_kernel<T, 1>);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer in one dtype (0 float32, 1 bfloat16): x, res, y and s
// (rows, d), scale (d,); `vec` 1 when all five are 16-byte aligned (the
// wrapper checks). Launches on `stream` without synchronising and returns
// cudaGetLastError(), or -1 for a bad argument.
extern "C" int fused_rmsnorm_launch(const void* x, const void* res,
                                    const void* scale, void* y, void* s,
                                    int64_t rows, int d, double eps,
                                    int dtype, int vec, void* stream) {
  if (rows < 1 || d < 1 || (rows + kRowsPerCta - 1) / kRowsPerCta
      > 2147483647LL)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float e = static_cast<float>(eps);
  if (dtype == 0)
    return launch<float>(x, res, scale, y, s, rows, d, e, vec != 0, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, res, scale, y, s, rows, d, e, vec != 0,
                                 st);
  return -1;
}
