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
// about 7 operations per byte, far below the card's float32 ratio of ~20.
// The bytes that must move are the valid prefix of each row's cache, so
// the loop stops at lengths[b] and never touches S_max - lengths[b] slots.
// As written the kernel does not reach that bound: with one CTA per
// (b, KV head) and a few loads in flight per warp it waits on memory
// latency (PERF.md has its times beside the bound).
//
// Design: one CTA per (b, KV head) handles all G query heads of that head
// together, so k and v are read once for the group. The cache is read in
// place in its (B, S_max, Hkv, D) layout: position t of one head is one
// contiguous row of D values, Hkv*D apart from the next (the Pallas wrapper
// instead transposes the whole cache to (B*Hkv, S_max, D) on every call).
// The eight warps take tiles of 32 positions in turn (tile i goes to warp
// i % 8), and a tile is done in two halves with lanes cut two ways:
//   scores: lane j owns position t0 + j and computes its G dot products
//     over the whole row in its own registers (16-byte loads; the other
//     lanes' rows of the tile stay in L1 until they are used), so there is
//     no cross-lane sum per position;
//   values: lane j owns D/32 consecutive dims; the tile's softmax weights
//     go through shared memory, and each of the tile's V rows is one
//     coalesced warp load.
// Between the two, one max and one sum over the warp per head per tile
// update the warp's online softmax (max m, sum l, accumulator acc) in
// float32, as the Pallas kernel does per block. At the end the warps'
// states merge through shared memory in warp order, so the result is
// deterministic. Products use fmaf (one rounding each) even though the
// unit is built with --fmad=false. G is a runtime value below a
// compile-time bucket GMAX (1, 2, 4, 8, 16); D is a template value (64,
// 128, 256). A row of length 0 gives zeros (l = 0, acc = 0), as the Pallas
// kernel gives. No tensor cores, TMA or split over positions: with
// B * Hkv CTAs a small batch leaves SMs idle, which later work can fix by
// splitting long rows.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;  // positions per warp tile: one per lane
// the reference's NEG_INF (-2^30): a finite floor for the running max, so
// exp(m_prev - m_new) is 0 and not NaN before the first position
constexpr float kNegInf = -1073741824.0f;

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

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, int64_t S, int Hkv, int G,
                        float scale) {
  constexpr int EPL = D / 32;                          // V dims per lane
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // K values a load
  // q (the loop's operand), then the merge's accumulator
  __shared__ __align__(16) float qa_s[GMAX][D];
  __shared__ float p_s[kWarps][GMAX][kTile];
  __shared__ float m_s[kWarps][GMAX];
  __shared__ float l_s[kWarps][GMAX];

  const int64_t b = blockIdx.x / Hkv;
  const int h = blockIdx.x % Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t head0 = b * Hkv * G + static_cast<int64_t>(h) * G;

  const T* qb = q + head0 * D;
  for (int i = threadIdx.x; i < GMAX * D; i += kThreads)
    qa_s[i / D][i % D] = i < G * D ? to_float(qb[i]) : 0.f;
  __syncthreads();

  int64_t len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int64_t row = static_cast<int64_t>(Hkv) * D;  // between positions
  const T* kb = k + (b * S * Hkv + h) * D;
  const T* vb = v + (b * S * Hkv + h) * D + lane * EPL;

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  for (int64_t t0 = static_cast<int64_t>(warp) * kTile; t0 < len;
       t0 += static_cast<int64_t>(kWarps) * kTile) {
    // scores: lane j takes position t0 + j
    const int64_t t = t0 + lane;
    const bool valid = t < len;
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
    if (valid) {
      const T* kr = kb + t * row;
#pragma unroll 4
      for (int c = 0; c < D; c += VEC) {
        float kf[VEC];
        load_row<T, VEC>(kr + c, kf);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) s[g] = fmaf(qa_s[g][c + e], kf[e], s[g]);
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
    const int n = static_cast<int>(len - t0 < kTile ? len - t0 : kTile);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      float vf[EPL];
      load_row<T, EPL>(vb + (t0 + j) * row, vf);
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
  for (int i = threadIdx.x; i < GMAX * D; i += kThreads)
    qa_s[i / D][i % D] = 0.f;
  float factor[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float mx = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    factor[g] = expf(m[g] - mx);
  }
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
#pragma unroll
          for (int i = 0; i < EPL; ++i)
            qa_s[g][lane * EPL + i] += acc[g][i] * factor[g];
        }
      }
    }
    __syncthreads();
  }

  T* ob = out + head0 * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = m_s[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += l_s[w][g] * expf(m_s[w][g] - mx);
    ob[i] = from_float<T>(qa_s[g][i % D] / fmaxf(sum, 1e-30f));
  }
}

template <typename T, int D, int GMAX>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int64_t B, int64_t S, int Hkv, int G,
           cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  const unsigned int blocks = static_cast<unsigned int>(B * Hkv);
  decode_attention_kernel<T, D, GMAX><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), S, Hkv, G, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_g(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int64_t B, int64_t S, int Hkv, int G,
             cudaStream_t stream) {
  if (G <= 1) return launch<T, D, 1>(q, k, v, lengths, out, B, S, Hkv, G, stream);
  if (G <= 2) return launch<T, D, 2>(q, k, v, lengths, out, B, S, Hkv, G, stream);
  if (G <= 4) return launch<T, D, 4>(q, k, v, lengths, out, B, S, Hkv, G, stream);
  if (G <= 8) return launch<T, D, 8>(q, k, v, lengths, out, B, S, Hkv, G, stream);
  return launch<T, D, 16>(q, k, v, lengths, out, B, S, Hkv, G, stream);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* lengths,
             void* out, int64_t B, int64_t S, int Hkv, int G, int D,
             cudaStream_t stream) {
  switch (D) {
    case 64: return launch_g<T, 64>(q, k, v, lengths, out, B, S, Hkv, G, stream);
    case 128: return launch_g<T, 128>(q, k, v, lengths, out, B, S, Hkv, G, stream);
    case 256: return launch_g<T, 256>(q, k, v, lengths, out, B, S, Hkv, G, stream);
    default: return -1;
  }
}

}  // namespace

// Plain C entry point for ctypes. Every pointer is a device pointer to a
// contiguous buffer aligned to 16 bytes; dtype is 0 for float32 and 1 for
// bfloat16; 1 <= G <= 16; D is 64, 128 or 256 (the wrapper checks all of
// these). Launches on `stream` without synchronising and returns
// cudaGetLastError(), or -1 for a bad dtype, D or G.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int64_t B, int64_t S,
                                       int Hkv, int G, int D, int dtype,
                                       void* stream) {
  if (G < 1 || G > 16 || B < 1 || S < 1 || Hkv < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, lengths, out, B, S, Hkv, G, D, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, lengths, out, B, S, Hkv, G, D, s);
  return -1;
}
