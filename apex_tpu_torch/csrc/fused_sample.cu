// Fused sampling tail: one logits row -> temperature -> top-k -> top-p ->
// Gumbel-argmax -> one int32 token, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/sampling.py::fused_sample_fwd (:150; kernel
// body _sample_kernel :140). Written from the reference's helpers
// (_bisect :61-85, apply_top_k, apply_top_p :96-113, gumbel_argmax
// :116-125), not carried over block by block:
// * one CTA (1024 threads) per row. The row, scaled by 1/T in fp32, stays
//   in shared memory for the whole tail (V = 32768 is 128 KB, hence the
//   dynamic shared-memory attribute).
// * top-k and top-p thresholds are the reference's 48-step bisection:
//   mid = 0.5f*(lo+hi); top-k counts entries >= mid exactly; top-p sums
//   expf(s - m) over entries >= mid (recomputed each step rather than
//   stored, so the row is the only O(V) state) and starts lo at the
//   minimum over live entries (:110). Entries below the threshold become
//   -1e30.
// * the draw is argmax(s + (-logf(-logf(u)))), ties to the lowest index.
//   logf/expf are the accurate ones: the library is built without
//   --use_fast_math.
// The block-wide sums run in another order than the reference's, so a
// top-p threshold can differ where a cumulative mass lies within float
// rounding of p*z; the tests and chip_smoke.py compare tokens under a
// stated near-tie rule.
//
// Bound on this card: operations. A row of V logits costs about
// 200*V simple fp32 operations (96 bisection passes of compare+add, the
// exp of the top-p passes counted once per pass) against 6*V bytes
// (bf16 logits + fp32 noise): at the slice's (8, 32768) ~0.8 us of
// 67 TFLOP/s fp32 versus ~0.5 us of HBM. The design keeps every pass in
// shared memory; what it does not do yet is spread a row over several
// CTAs — 8 rows fill 8 of 132 SMs, and the 96 dependent block-wide
// reductions (two barriers each) set the time.
#include <cmath>
#include <cstdint>

#include "apex_cuda.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 48;
constexpr float kFiltered = -1e30f;

// Block-wide reductions: every warp reduces the per-warp partials itself,
// so each thread returns the same bit-identical total (one fixed tree).
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = apex::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = apex::warp_sum(red[lane]);
  __syncthreads();
  return v;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = apex::warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = apex::warp_max(red[lane]);
  __syncthreads();
  return v;
}

__device__ float block_min(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = apex::warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = apex::warp_min(red[lane]);
  __syncthreads();
  return v;
}

// The largest threshold t with mass(s >= t) >= target, by 48 halvings of
// [lo, hi]: mass counts entries (top-k) or sums expf(s - m) (top-p).
__device__ float bisect(const float* s, int V, float lo, float hi,
                        float target, bool weighted, float m, float* red) {
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float mass = 0.f;
    for (int i = threadIdx.x; i < V; i += kThreads) {
      const float x = s[i];
      if (x >= mid) mass += weighted ? expf(x - m) : 1.f;
    }
    mass = block_sum(mass, red);
    const bool ok = mass >= target;
    lo = ok ? mid : lo;
    hi = ok ? hi : mid;
  }
  return lo;
}

__device__ void filter_below(float* s, int V, float t) {
  for (int i = threadIdx.x; i < V; i += kThreads)
    if (!(s[i] >= t)) s[i] = kFiltered;
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_sample_kernel(const T* __restrict__ logits,
                        const float* __restrict__ u, int* __restrict__ out,
                        int V, float inv_temp, int top_k, int use_top_p,
                        float top_p) {
  extern __shared__ float s[];
  __shared__ float red[kWarps];
  __shared__ int red_i[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * V;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = apex::to_float(logits[base + i]) * inv_temp;
    s[i] = x;
    lo = fminf(lo, x);
    hi = fmaxf(hi, x);
  }
  lo = block_min(lo, red);  // its barriers also publish s
  hi = block_max(hi, red);

  if (top_k > 0) {
    filter_below(s, V, bisect(s, V, lo, hi, static_cast<float>(top_k),
                              false, 0.f, red));
  }
  if (use_top_p) {
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < V; i += kThreads) mx = fmaxf(mx, s[i]);
    const float m = block_max(mx, red);
    float z = 0.f, live_lo = INFINITY;
    for (int i = threadIdx.x; i < V; i += kThreads) {
      const float x = s[i];
      z += expf(x - m);
      live_lo = fminf(live_lo, x > kFiltered * 0.5f ? x : m);
    }
    z = block_sum(z, red);
    live_lo = block_min(live_lo, red);
    filter_below(s, V, bisect(s, V, live_lo, m, top_p * z, true, m, red));
  }

  // Gumbel-argmax; a strict > keeps each thread's lowest index on ties
  float best = -INFINITY;
  int best_i = V;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = s[i] + (-logf(-logf(u[base + i])));
    if (x > best) {
      best = x;
      best_i = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    if (ob > best || (ob == best && oi < best_i)) {
      best = ob;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red[warp] = best;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best = red[lane];
    best_i = red_i[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
    if (lane == 0) out[blockIdx.x] = best_i;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const void* u, void* out, int b,
                   int V, float inv_temp, int top_k, int use_top_p,
                   float top_p, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(V) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sample_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_sample_kernel<T><<<b, kThreads, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const float*>(u),
      static_cast<int*>(out), V, inv_temp, top_k, use_top_p, top_p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int apex_fused_sample(const void* logits, const void* u,
                                 void* out, int dtype, int b, int V,
                                 float inv_temp, int top_k, int use_top_p,
                                 float top_p, void* stream) {
  if (b < 1 || V < 1 ||
      (dtype != apex::kFloat32 && dtype != apex::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? launch<__nv_bfloat16>(logits, u, out, b, V, inv_temp, top_k,
                                  use_top_p, top_p, s)
          : launch<float>(logits, u, out, b, V, inv_temp, top_k, use_top_p,
                          top_p, s);
  return static_cast<int>(err);
}
