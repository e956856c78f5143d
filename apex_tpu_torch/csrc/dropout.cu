// Counter-hash elementwise dropout for Hopper: GPT's residual dropout and,
// on the softmax and naive attention routes, its probability dropout,
// forward and backward alike (the backward is the same function of the
// cotangent with the same seed).
//
// Replaces no Pallas kernel: the reference computes it in XLA
// (apex_tpu/models/gpt.py::_dropout, :883-900). It was added because the
// port's train step with dropout needs it on the card and plain PyTorch
// would take several passes over the tensor (the mask's integer hash, the
// division, the select).
//
// y = keep ? dtype(float(x) / div) : 0, with div = float(dtype(1 - rate))
// (JAX's weak typing rounds 1 - rate to x's dtype: 3 / bf16(0.9) =
// 3.34375), the division correctly rounded (__fdiv_rn, as PyTorch's
// division of two tensors) and one rounding to the dtype: bit-identical to
// apex_tpu_torch/ops/dropout.py::dropout_plain. keep from dropout_hash.cuh
// with t = 0, the row = all leading dims flattened, the column = the last
// dim.
//
// Bound on this card: bytes. At GPT's residual (20480 x 1024 bf16) 84 MB
// read and written, 25 us at 3.35 TB/s; the hash is one fmix32 a row and
// one an element (about 12 integer operations), under the bytes' time.
//
// Design: one thread a 16-byte chunk (8 bf16 or 4 fp32 elements of one
// row, the row's key computed once) in a grid-stride loop over 8 CTAs of
// 256 threads an SM: 32 KB of loads in flight an SM. A tensor whose rows
// are not whole chunks, or not 16-byte aligned, takes a scalar loop.
#include <cstdint>
#include <cstring>

#include "apex_cuda.cuh"
#include "dropout_hash.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

template <typename T, bool kFault>
__device__ __forceinline__ T drop_one(T x, bool keep, float div,
                                      float inv) {
  // the planted fault: a multiply by float32(1 / (1 - rate)) in place of
  // the division by (1 - rate) in x's dtype
  const float v = kFault ? apex::to_float(x) * inv
                         : __fdiv_rn(apex::to_float(x), div);
  return apex::from_float<T>(keep ? v : 0.f);
}

template <typename T, bool kFault>
__global__ void __launch_bounds__(kThreads)
    dropout_vec(const T* __restrict__ x, T* __restrict__ y,
                unsigned chunks, unsigned cpr, uint32_t key,
                uint32_t thresh, float div, float inv) {
  constexpr int kVec = 16 / sizeof(T);
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned c = blockIdx.x * kThreads + threadIdx.x; c < chunks;
       c += stride) {
    const unsigned row = c / cpr;
    const unsigned col0 = (c - row * cpr) * kVec;
    const uint32_t rk = apex::drop_row_key(key, row);
    const uint4 u = reinterpret_cast<const uint4*>(x)[c];
    T e[kVec];
    memcpy(e, &u, 16);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      e[i] = drop_one<T, kFault>(e[i], apex::drop_keep(rk, col0 + i, thresh),
                                 div, inv);
    uint4 w;
    memcpy(&w, e, 16);
    reinterpret_cast<uint4*>(y)[c] = w;
  }
}

template <typename T, bool kFault>
__global__ void __launch_bounds__(kThreads)
    dropout_scalar(const T* __restrict__ x, T* __restrict__ y,
                   long long numel, long long n, uint32_t key,
                   uint32_t thresh, float div, float inv) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       e < numel; e += stride) {
    const long long row = e / n;
    const uint32_t rk =
        apex::drop_row_key(key, static_cast<uint32_t>(row));
    y[e] = drop_one<T, kFault>(
        x[e], apex::drop_keep(rk, static_cast<uint32_t>(e - row * n), thresh),
        div, inv);
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

template <typename T, bool kFault>
cudaError_t launch(const void* x, void* y, long long numel, long long n,
                   uint32_t key, uint32_t thresh, float div, float inv,
                   cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const long long cap = 8LL * sm_count();
  const bool vec = n % kVec == 0 && numel / kVec < 0x7fffffffLL &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if (vec) {
    const long long chunks = numel / kVec;
    const long long need = (chunks + kThreads - 1) / kThreads;
    const long long grid = need < cap ? need : cap;
    dropout_vec<T, kFault><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y),
        static_cast<unsigned>(chunks), static_cast<unsigned>(n / kVec), key,
        thresh, div, inv);
  } else {
    const long long need = (numel + kThreads - 1) / kThreads;
    const long long grid = need < cap ? need : cap;
    dropout_scalar<T, kFault>
        <<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
            static_cast<const T*>(x), static_cast<T*>(y), numel, n, key,
            thresh, div, inv);
  }
  return cudaGetLastError();
}

}  // namespace

// x and y: numel elements (dtype 0 = float32, 1 = bfloat16), contiguous,
// rows of n; seed: the int32 seed's bits; thresh: the 24-bit threshold
// (<= 2^24); div: 1 - rate rounded to the dtype; inv: float32(1 / (1 -
// rate)), read only by the planted fault (fault 1).
extern "C" int apex_dropout(const void* x, void* y, int dtype,
                            long long numel, long long n, unsigned seed,
                            int thresh, float div, float inv, int fault,
                            void* stream) {
  if (numel < 1 || n < 1 || numel % n || numel / n >= 0x80000000LL ||
      n >= 0x80000000LL || thresh < 0 || thresh > (1 << 24) ||
      (dtype != apex::kFloat32 && dtype != apex::kBFloat16) ||
      (fault != 0 && fault != 1) || !(div > 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t key = apex::drop_key(seed, 0u);
  const uint32_t th = static_cast<uint32_t>(thresh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == apex::kBFloat16)
    err = fault ? launch<bf16, true>(x, y, numel, n, key, th, div, inv, st)
                : launch<bf16, false>(x, y, numel, n, key, th, div, inv, st);
  else
    err = fault ? launch<float, true>(x, y, numel, n, key, th, div, inv, st)
                : launch<float, false>(x, y, numel, n, key, th, div, inv, st);
  return static_cast<int>(err);
}
