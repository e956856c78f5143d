// Fused sampling tail: one logits row -> temperature -> top-k -> top-p ->
// Gumbel-argmax -> one int32 token, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/sampling.py::fused_sample_fwd (:150; kernel
// body _sample_kernel :140). Written from the reference's helpers, whose
// device counterparts live in sample_filter.cuh (shared with the verify
// kernels), not carried over block by block:
// * one CTA (1024 threads) per row. The row, scaled by 1/T in fp32, stays
//   in shared memory for the whole tail (V = 32768 is 128 KB, hence the
//   dynamic shared-memory attribute).
// * top-k and top-p thresholds are the reference's 48-step bisection;
//   entries below the threshold become -1e30.
// * the draw is argmax(s + (-logf(-logf(u)))), ties to the lowest index.
//
// Bound on this card: operations. A row of V logits costs about
// 200*V simple fp32 operations (96 bisection passes of compare+add, the
// exp of the top-p passes counted once per pass) against 6*V bytes
// (bf16 logits + fp32 noise): at the slice's (8, 32768) ~0.8 us of
// 67 TFLOP/s fp32 versus ~0.5 us of HBM. The design keeps every pass in
// shared memory; what it does not do yet is spread a row over several
// CTAs — 8 rows fill 8 of 132 SMs, and the 96 dependent block-wide
// reductions (two barriers each) set the time.
#include <cstdint>

#include "sample_filter.cuh"

namespace {

using apex::filter::kThreads;
using apex::filter::kWarps;

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
  apex::filter::load_filtered(s, logits + base, V, inv_temp, top_k,
                              use_top_p, top_p, red);
  const int tok = apex::filter::gumbel_argmax(s, u + base, V, red, red_i);
  if (threadIdx.x == 0) out[blockIdx.x] = tok;
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
