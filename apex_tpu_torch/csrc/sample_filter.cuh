// The sampling filter shared by the fused sampler (fused_sample.cu) and the
// speculative verify kernels (fused_verify.cu), as the reference shares
// apex_tpu/ops/pallas/sampling.py's helpers with ops/pallas/verify.py (:52):
// the 1/T scale, the top-k and top-p thresholds by 48-step bisection
// (_bisect :61-85, apply_top_k, apply_top_p :96-113), and the
// Gumbel-argmax draw (gumbel_argmax :116-125). Every function here runs on
// one CTA of kThreads threads that holds a whole row of V fp32 scores in
// shared memory.
//
// * top-k counts entries >= mid exactly; top-p sums expf(s - m) over
//   entries >= mid (recomputed each step rather than stored, so the row is
//   the only O(V) state) and starts lo at the minimum over live entries
//   (:110). Entries below a threshold become -1e30.
// * logf/expf are the accurate ones: the library is built without
//   --use_fast_math.
// * argmaxes keep each thread's lowest index on ties (a strict >) and
//   reduce with "larger value, else lower index", so a row's result is
//   the lowest index among its maxima: jnp.argmax's convention, which the
//   greedy verify's token-identity contract rests on.
// The block-wide sums run in another order than the reference's, so a
// top-p threshold can differ where a cumulative mass lies within float
// rounding of p*z; the tests compare tokens under a stated near-tie rule.
#pragma once

#include <cmath>

#include "apex_cuda.cuh"

namespace apex {
namespace filter {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBisectIters = 48;
constexpr float kFiltered = -1e30f;

// Block-wide reductions: every warp reduces the per-warp partials itself,
// so each thread returns the same bit-identical total (one fixed tree).
__device__ inline float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = warp_sum(red[lane]);
  __syncthreads();
  return v;
}

__device__ inline float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = warp_max(red[lane]);
  __syncthreads();
  return v;
}

__device__ inline float block_min(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = warp_min(red[lane]);
  __syncthreads();
  return v;
}

// (best, best_i) of every thread -> the index of the block's largest value,
// ties to the lowest index, returned to every thread
__device__ inline int block_argmax(float best, int best_i, float* red,
                                   int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  __syncthreads();  // red and red_i are free again
  return best_i;
}

// The largest threshold t with mass(s >= t) >= target, by 48 halvings of
// [lo, hi]: mass counts entries (top-k) or sums expf(s - m) (top-p).
__device__ inline float bisect(const float* s, int V, float lo, float hi,
                               float target, bool weighted, float m,
                               float* red) {
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

__device__ inline void filter_below(float* s, int V, float t) {
  for (int i = threadIdx.x; i < V; i += kThreads)
    if (!(s[i] >= t)) s[i] = kFiltered;
  __syncthreads();
}

// s = row * inv_temp in fp32, then top-k (top_k > 0) and top-p
// (use_top_p): filtered_scaled of the reference. s is published to the
// whole block on return.
template <typename T>
__device__ inline void load_filtered(float* s, const T* __restrict__ row,
                                     int V, float inv_temp, int top_k,
                                     int use_top_p, float top_p, float* red) {
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = to_float(row[i]) * inv_temp;
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
}

// argmax(s + (-logf(-logf(u)))): one categorical draw over softmax(s)
__device__ inline int gumbel_argmax(const float* s,
                                    const float* __restrict__ u, int V,
                                    float* red, int* red_i) {
  float best = -INFINITY;
  int best_i = V;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float x = s[i] + (-logf(-logf(u[i])));
    if (x > best) {
      best = x;
      best_i = i;
    }
  }
  return block_argmax(best, best_i, red, red_i);
}

}  // namespace filter
}  // namespace apex
