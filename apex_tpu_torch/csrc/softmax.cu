// The scaled masked softmax, forward and backward, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/softmax.py::softmax_fwd (:83; body
// _softmax_fwd_kernel :43) and ::softmax_bwd (:108; body
// _softmax_bwd_kernel :96). Same contract, per row of (rows, sk) scores in
// fp32 arithmetic: the forward computes y = softmax(scale * x) with
// MASK_FILL = -10000 put in place of every masked entry AFTER the scale
// (so a fully masked row comes out uniform), y in x's dtype; the backward
// computes dx = scale * y * (dy - sum(dy * y)) from the saved y alone.
//
// Masks: none; causal (key k kept where k <= q, q = row mod sq, built in
// the kernel); or a bool mask read through its four strides (b, h, q, k)
// in bytes, 0 on every broadcast dimension. The reference materialises
// broadcast_to(mask, x.shape) as int8 before its kernel (ops/softmax.py:
// 90-91): at BERT-large that is 32*16*512*512 B = 134 MB a call against
// the 16 KB (b, 1, 1, s) key mask this kernel reads.
//
// Entries: apex_softmax_fwd and apex_softmax_bwd.
//
// Bound on this card at GPT's causal call (163840 rows x 1024, bf16):
// bytes, counting only the entries the function must read (a masked
// entry's y and dx are 0). The forward reads x on and below the
// diagonal and writes y whole (503 MB, 0.150 ms at 3.35 TB/s), the
// backward reads dy and y there and writes dx (671 MB, 0.200 ms). This
// kernel reads whole rows (671 MB and 1.0 GB).
//
// Design: one warp per row while the row fits in registers (sk <= 2048:
// E = 8, 16, 32 or 64 elements a lane, as 16-byte chunks through
// row_io.cuh; a row length that is no multiple of the chunk moves element
// by element; a key-contiguous mask row in 8- or 4-byte accesses): max,
// exp and sum by warp shuffles, one multiply by the sum's reciprocal, one
// read and one write of the row. A longer row takes a CTA of 256 threads
// and three passes over it (max, sum, write), the same arithmetic.
#include <cmath>
#include <cstdint>

#include "apex_cuda.cuh"
#include "row_io.cuh"

namespace {

constexpr float kMaskFill = -10000.f;
constexpr int kThreads = 128;  // 4 warps, one row each
constexpr int kWarps = kThreads / 32;
constexpr int kLongThreads = 256;

enum Mode : int { kNoMask = 0, kCausal = 1, kMask = 2 };

// the mask viewed (b, h, q, k) over x's rows: row r is (b, h, q) with
// q = r % q_rows and h = (r / q_rows) % heads; strides in bytes
struct MaskView {
  const uint8_t* p;
  long long sb, sh, sq, sk;
  int heads, q_rows;

  __device__ const uint8_t* row(int r) const {
    const int qi = r % q_rows;
    const int t = r / q_rows;
    return p + (t / heads) * sb + (t % heads) * sh + qi * sq;
  }
};

// the mask bytes of elements i .. i + V - 1 of a mask row (0 past n): one
// access when the key stride is 1 and the bytes are aligned
template <int V>
__device__ __forceinline__ void load_mask(const uint8_t* mr, long long sk,
                                          int i, int n, uint8_t* mk) {
  const uint8_t* p = mr + i * sk;
  if (sk == 1 && i + V <= n && reinterpret_cast<uintptr_t>(p) % V == 0) {
    if constexpr (V == 8) {
      const uint2 r = *reinterpret_cast<const uint2*>(p);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&r);
#pragma unroll
      for (int k = 0; k < V; ++k) mk[k] = b[k];
    } else {
      const uint32_t r = *reinterpret_cast<const uint32_t*>(p);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&r);
#pragma unroll
      for (int k = 0; k < V; ++k) mk[k] = b[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) mk[k] = i + k < n ? p[k * sk] : 0;
  }
}

// the scaled, masked score of element i of a row
template <int kMode>
__device__ __forceinline__ float score(float x, int i, int q,
                                       const uint8_t* mr,
                                       const MaskView& m, float scale) {
  float s = x * scale;
  if constexpr (kMode == kCausal) s = i <= q ? s : kMaskFill;
  if constexpr (kMode == kMask) s = mr[i * m.sk] ? kMaskFill : s;
  return s;
}

template <typename T, int E, int kMode>
__global__ void __launch_bounds__(kThreads)
    softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       MaskView m, int rows, int n, int sq, float scale,
                       bool vec) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = E / V;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(row) * n;
  const int q = kMode == kCausal ? row % sq : 0;
  const uint8_t* mr = kMode == kMask ? m.row(row) : nullptr;
  float v[E];
#pragma unroll
  for (int c = 0; c < C; ++c)
    apex::load_chunk(x + off, (lane + 32 * c) * V, n, vec, 0.f, v + c * V);
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i0 = (lane + 32 * c) * V;
    uint8_t mk[V];
    if constexpr (kMode == kMask) load_mask<V>(mr, m.sk, i0, n, mk);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = i0 + k;
      if (i < n) {
        float s = v[c * V + k] * scale;
        if constexpr (kMode == kCausal) s = i <= q ? s : kMaskFill;
        if constexpr (kMode == kMask) s = mk[k] ? kMaskFill : s;
        v[c * V + k] = s;
        mx = fmaxf(mx, s);
      }
    }
  }
  mx = apex::warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int e = c * V + k;
      v[e] = (lane + 32 * c) * V + k < n ? expf(v[e] - mx) : 0.f;
      sum += v[e];
    }
  const float inv = 1.f / apex::warp_sum(sum);
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] *= inv;
#pragma unroll
  for (int c = 0; c < C; ++c)
    apex::store_chunk(y + off, (lane + 32 * c) * V, n, vec, v + c * V);
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                       T* __restrict__ dx, int rows, int n, float scale,
                       bool vec) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = E / V;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(row) * n;
  float g[E], p[E];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    apex::load_chunk(dy + off, (lane + 32 * c) * V, n, vec, 0.f, g + c * V);
    apex::load_chunk(y + off, (lane + 32 * c) * V, n, vec, 0.f, p + c * V);
  }
  float dot = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) dot += g[e] * p[e];
  dot = apex::warp_sum(dot);
#pragma unroll
  for (int e = 0; e < E; ++e) g[e] = scale * p[e] * (g[e] - dot);
#pragma unroll
  for (int c = 0; c < C; ++c)
    apex::store_chunk(dx + off, (lane + 32 * c) * V, n, vec, g + c * V);
}

// a CTA-wide sum (is_max false) or max over kLongThreads threads
__device__ float block_reduce(float v, bool is_max, float* red) {
  v = is_max ? apex::warp_max(v) : apex::warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kLongThreads / 32; ++w)
    t = is_max ? fmaxf(t, red[w]) : t + red[w];
  return t;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kLongThreads)
    softmax_fwd_long_kernel(const T* __restrict__ x, T* __restrict__ y,
                            MaskView m, int n, int sq, float scale) {
  __shared__ float red[kLongThreads / 32];
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * n;
  const int q = kMode == kCausal ? row % sq : 0;
  const uint8_t* mr = kMode == kMask ? m.row(row) : nullptr;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kLongThreads)
    mx = fmaxf(mx, score<kMode>(apex::to_float(x[off + i]), i, q, mr, m,
                                scale));
  mx = block_reduce(mx, true, red);
  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += kLongThreads)
    sum += expf(score<kMode>(apex::to_float(x[off + i]), i, q, mr, m,
                             scale) - mx);
  const float inv = 1.f / block_reduce(sum, false, red);
  for (int i = threadIdx.x; i < n; i += kLongThreads)
    y[off + i] = apex::from_float<T>(
        expf(score<kMode>(apex::to_float(x[off + i]), i, q, mr, m, scale) -
             mx) * inv);
}

template <typename T>
__global__ void __launch_bounds__(kLongThreads)
    softmax_bwd_long_kernel(const T* __restrict__ dy,
                            const T* __restrict__ y, T* __restrict__ dx,
                            int n, float scale) {
  __shared__ float red[kLongThreads / 32];
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  float dot = 0.f;
  for (int i = threadIdx.x; i < n; i += kLongThreads)
    dot += apex::to_float(dy[off + i]) * apex::to_float(y[off + i]);
  dot = block_reduce(dot, false, red);
  for (int i = threadIdx.x; i < n; i += kLongThreads) {
    const float p = apex::to_float(y[off + i]);
    dx[off + i] = apex::from_float<T>(
        scale * p * (apex::to_float(dy[off + i]) - dot));
  }
}

// elements a lane holds for a row of n: 8, 16, 32, 64 (0: a CTA per row)
template <typename T>
int lane_elems(int n) {
  constexpr int V = apex::Chunk<T>::kVec;
  const int need = ((n + V - 1) / V + 31) / 32 * V;
  return need <= 8 ? 8 : need <= 16 ? 16 : need <= 32 ? 32
                                                       : need <= 64 ? 64 : 0;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int kMode>
cudaError_t fwd_mode(const void* x, void* y, const MaskView& m, int rows,
                     int n, int sq, float scale, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const bool vec = n % apex::Chunk<T>::kVec == 0 && aligned(x) && aligned(y);
  const int blocks = (rows + kWarps - 1) / kWarps;
  switch (lane_elems<T>(n)) {
    case 8:
      softmax_fwd_kernel<T, 8, kMode><<<blocks, kThreads, 0, st>>>(
          xp, yp, m, rows, n, sq, scale, vec);
      break;
    case 16:
      softmax_fwd_kernel<T, 16, kMode><<<blocks, kThreads, 0, st>>>(
          xp, yp, m, rows, n, sq, scale, vec);
      break;
    case 32:
      softmax_fwd_kernel<T, 32, kMode><<<blocks, kThreads, 0, st>>>(
          xp, yp, m, rows, n, sq, scale, vec);
      break;
    case 64:
      softmax_fwd_kernel<T, 64, kMode><<<blocks, kThreads, 0, st>>>(
          xp, yp, m, rows, n, sq, scale, vec);
      break;
    default:
      softmax_fwd_long_kernel<T, kMode><<<rows, kLongThreads, 0, st>>>(
          xp, yp, m, n, sq, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_t(const void* x, void* y, const MaskView& m, int mode,
                  int rows, int n, int sq, float scale, cudaStream_t st) {
  if (mode == kCausal) return fwd_mode<T, kCausal>(x, y, m, rows, n, sq,
                                                   scale, st);
  if (mode == kMask) return fwd_mode<T, kMask>(x, y, m, rows, n, sq, scale,
                                               st);
  return fwd_mode<T, kNoMask>(x, y, m, rows, n, sq, scale, st);
}

template <typename T>
cudaError_t bwd_t(const void* dy, const void* y, void* dx, int rows, int n,
                  float scale, cudaStream_t st) {
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  T* dxp = static_cast<T*>(dx);
  const bool vec = n % apex::Chunk<T>::kVec == 0 && aligned(dy) &&
                   aligned(y) && aligned(dx);
  const int blocks = (rows + kWarps - 1) / kWarps;
  switch (lane_elems<T>(n)) {
    case 8:
      softmax_bwd_kernel<T, 8><<<blocks, kThreads, 0, st>>>(
          dyp, yp, dxp, rows, n, scale, vec);
      break;
    case 16:
      softmax_bwd_kernel<T, 16><<<blocks, kThreads, 0, st>>>(
          dyp, yp, dxp, rows, n, scale, vec);
      break;
    case 32:
      softmax_bwd_kernel<T, 32><<<blocks, kThreads, 0, st>>>(
          dyp, yp, dxp, rows, n, scale, vec);
      break;
    case 64:
      softmax_bwd_kernel<T, 64><<<blocks, kThreads, 0, st>>>(
          dyp, yp, dxp, rows, n, scale, vec);
      break;
    default:
      softmax_bwd_long_kernel<T><<<rows, kLongThreads, 0, st>>>(
          dyp, yp, dxp, n, scale);
  }
  return cudaGetLastError();
}

bool dtype_ok(int dtype) {
  return dtype == apex::kFloat32 || dtype == apex::kBFloat16;
}

}  // namespace

// x, y (rows, n) of dtype. mode 0: no mask; 1: causal, q = row % sq;
// 2: mask (bool bytes) at strides mstrides = (b, h, q, k) in bytes over
// x's rows seen as (b, heads, q_rows).
extern "C" int apex_softmax_fwd(const void* x, void* y, const void* mask,
                                const long long* mstrides, int heads,
                                int q_rows, int dtype, int mode, int rows,
                                int n, int sq, float scale, void* stream) {
  if (!dtype_ok(dtype) || rows < 1 || n < 1 || mode < kNoMask ||
      mode > kMask || (mode == kCausal && sq < 1) ||
      (mode == kMask && (mask == nullptr || mstrides == nullptr ||
                         heads < 1 || q_rows < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  MaskView m{static_cast<const uint8_t*>(mask), 0, 0, 0, 0, 1, 1};
  if (mode == kMask) {
    for (int i = 0; i < 4; ++i)
      if (mstrides[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    m.sb = mstrides[0];
    m.sh = mstrides[1];
    m.sq = mstrides[2];
    m.sk = mstrides[3];
    m.heads = heads;
    m.q_rows = q_rows;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? fwd_t<__nv_bfloat16>(x, y, m, mode, rows, n, sq, scale, st)
          : fwd_t<float>(x, y, m, mode, rows, n, sq, scale, st);
  return static_cast<int>(err);
}

// dy, y, dx (rows, n) of dtype
extern "C" int apex_softmax_bwd(const void* dy, const void* y, void* dx,
                                int dtype, int rows, int n, float scale,
                                void* stream) {
  if (!dtype_ok(dtype) || rows < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? bwd_t<__nv_bfloat16>(dy, y, dx, rows, n, scale, st)
          : bwd_t<float>(dy, y, dx, rows, n, scale, st);
  return static_cast<int>(err);
}
