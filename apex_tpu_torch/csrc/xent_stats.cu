// Cross-entropy row statistics, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/xentropy.py::xent_stats (:73-101; kernel
// body _stats_kernel :41-70). Same contract: for each row of (N, V)
// logits (bf16, fp16 or fp32) and an int32/int64 label per row, four fp32
// statistics -- the row max m, sum(exp(x - m)), the raw target logit
// x[label] (0 when the label lies outside [0, V)), and the raw row sum
// (what label smoothing needs).
//
// Bound on this card at the train step's shape (N = 20480 tokens,
// V = 32768, bf16): bytes. The logits are read once, 1.34 GB, 0.40 ms at
// 3.35 TB/s; the work is ~3 fp32 operations and one exp per logit.
//
// Design: one 256-thread CTA per row streams it with 16-byte vector loads,
// neighbouring threads on neighbouring addresses. Each thread keeps an
// online (max, sum-exp) pair, rescaled once per 16-byte vector, and a
// plain fp32 row sum; warps and then the CTA merge the pairs (the
// Pallas grid's sequential vocab axis becomes this in-block merge). The
// target logit is one direct read. Nothing but the four stats is written.
#include <cstdint>

#include "apex_cuda.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;  // one 16-byte load
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// fp16 (amp's strict-fp16 step): the same loads, converted in pairs; an
// inf logit makes the row's statistics inf or nan, as in the plain version
template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ static void load(const __half* p, float (&v)[8]) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
    xent_stats_kernel(const T* __restrict__ x, const L* __restrict__ labels,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      float* __restrict__ t_out, float* __restrict__ s_out,
                      int V) {
  constexpr int kVec = Vec<T>::N;
  __shared__ float red_m[kWarps], red_l[kWarps], red_s[kWarps];
  const int row = blockIdx.x;
  const T* xr = x + static_cast<size_t>(row) * V;

  float m = kNegInf, l = 0.f, sum = 0.f;
  for (int i = threadIdx.x * kVec; i < V; i += kThreads * kVec) {
    float v[kVec];
    Vec<T>::load(xr + i, v);
    float mv = v[0];
#pragma unroll
    for (int k = 1; k < kVec; ++k) mv = fmaxf(mv, v[k]);
    const float m_new = fmaxf(m, mv);
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      e += expf(v[k] - m_new);
      sum += v[k];
    }
    l = l * expf(m - m_new) + e;
    m = m_new;
  }

  // merge across the warp, then across warps
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float mw = apex::warp_max(m);
  l = apex::warp_sum(l * expf(m - mw));
  sum = apex::warp_sum(sum);
  if (lane == 0) {
    red_m[warp] = mw;
    red_l[warp] = l;
    red_s[warp] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float mt = red_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, red_m[w]);
    float lt = 0.f, st = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lt += red_l[w] * expf(red_m[w] - mt);
      st += red_s[w];
    }
    const long long lab = static_cast<long long>(labels[row]);
    m_out[row] = mt;
    l_out[row] = lt;
    t_out[row] = (lab >= 0 && lab < V) ? apex::to_float(xr[lab]) : 0.f;
    s_out[row] = st;
  }
}

template <typename T, typename L>
cudaError_t launch(const void* x, const void* labels, void* m, void* l,
                   void* t, void* s, int n, int V, cudaStream_t stream) {
  xent_stats_kernel<T, L><<<n, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const L*>(labels),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(t),
      static_cast<float*>(s), V);
  return cudaGetLastError();
}

}  // namespace

extern "C" int apex_xent_stats(const void* x, const void* labels, void* m,
                               void* l, void* t, void* s, int dtype,
                               int labels_int64, int n, int V, void* stream) {
  const int vec = dtype == apex::kFloat32 ? 4 : 8;
  if (n < 1 || V < 1 || V % vec ||
      (dtype != apex::kFloat32 && dtype != apex::kBFloat16 &&
       dtype != apex::kFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == apex::kFloat16) {
    err = labels_int64
              ? launch<__half, long long>(x, labels, m, l, t, s, n, V, st)
              : launch<__half, int>(x, labels, m, l, t, s, n, V, st);
  } else if (dtype == apex::kBFloat16) {
    err = labels_int64
              ? launch<__nv_bfloat16, long long>(x, labels, m, l, t, s, n, V,
                                                 st)
              : launch<__nv_bfloat16, int>(x, labels, m, l, t, s, n, V, st);
  } else {
    err = labels_int64
              ? launch<float, long long>(x, labels, m, l, t, s, n, V, st)
              : launch<float, int>(x, labels, m, l, t, s, n, V, st);
  }
  return static_cast<int>(err);
}
