// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/layer_norm.py::ln_fwd (:102; body
// _ln_fwd_kernel :42) and ::ln_bwd (:186; body _ln_bwd_kernel :123). Same
// contract: rows of (rows, hidden) x in fp32 arithmetic; the forward writes
// y in x's dtype and the per-row fp32 mean and rstd, the backward reads
// them back instead of reducing again. Statistics are two-pass from
// registers: the mean, then the mean of (x - mean)^2 (never E[x^2] -
// mean^2). RMSNorm writes mean 0 and skips the centring. The affine
// (gamma, or gamma and beta) is a compile-time option; the parameters may
// be fp32 or bf16 whatever x is.
//
// Entries: apex_ln_fwd and apex_ln_bwd (the backward is two launches: the
// row kernel, then the parameter reduction).
//
// Bound on this card at the GPT train step (20480 rows x 1024, bf16):
// bytes. The forward reads x once and writes y (84 MB, 0.025 ms at 3.35
// TB/s); the backward reads dy and x and writes dx (126 MB, 0.038 ms).
// About ten fp32 operations per element are far below the card's rate.
//
// Design:
// * one warp per row; lane l holds the 16-byte chunks l, l + 32, ... of
//   the row in fp32 registers (row_io.cuh), E elements a lane, E one of 8,
//   32, 128 by the hidden size (at most 32 * 128 = 4096); a hidden that is
//   no multiple of 8 (bf16) or 4 (fp32) elements moves element by element.
// * the forward's warps walk rows in a grid-stride loop, holding gamma and
//   beta in registers across rows.
// * dgamma/dbeta without atomics, bit-reproducible: CTA c owns the fixed
//   row block [c * rows_per_cta, (c + 1) * rows_per_cta); its 4 warps keep
//   fp32 partials in registers, sum them in warp order through shared
//   memory and write one (2, hidden) row of the partial buffer; a second
//   launch sums the buffer's rows in a fixed order per column and casts to
//   the parameters' dtype. The TPU kernel's revisited output block (a sum
//   carried along a sequential grid) does not carry over to a card whose
//   CTAs run in no order.
#include <cstdint>

#include "apex_cuda.cuh"
#include "row_io.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, one row each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFwdBlocks = 1056;  // 8 a streaming multiprocessor
constexpr int kMaxHidden = 32 * 128;

enum Affine : int { kNone = 0, kWeight = 1, kWeightBias = 2 };

// element i of a float32 (w_bf16 false) or bfloat16 (true) vector, 0 past n
__device__ __forceinline__ float load_param(const void* p, bool w_bf16,
                                            int i, int n) {
  if (i >= n) return 0.f;
  return w_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_param(void* p, bool w_bf16, int i,
                                            float v) {
  if (w_bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <typename T, int E, int kAff>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w,
                  const void* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int rows, int n, float eps, bool rms, bool vec,
                  bool w_bf16) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = E / V;  // chunks a lane
  const int lane = threadIdx.x & 31;
  float g[kAff >= kWeight ? E : 1];
  float be[kAff == kWeightBias ? E : 1];
  if constexpr (kAff >= kWeight) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = (lane + 32 * c) * V + k;
        g[c * V + k] = load_param(w, w_bf16, i, n);
        if constexpr (kAff == kWeightBias)
          be[c * V + k] = load_param(b, w_bf16, i, n);
      }
  }
  const float nf = static_cast<float>(n);
  for (int row = blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kWarps) {
    float v[E];
#pragma unroll
    for (int c = 0; c < C; ++c)
      apex::load_chunk(x + static_cast<size_t>(row) * n, (lane + 32 * c) * V,
                       n, vec, 0.f, v + c * V);
    float mu = 0.f;
    if (!rms) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[e];
      mu = apex::warp_sum(s) / nf;
    }
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int e = c * V + k;
        v[e] = (lane + 32 * c) * V + k < n ? v[e] - mu : 0.f;
        ss += v[e] * v[e];
      }
    const float rstd = rsqrtf(apex::warp_sum(ss) / nf + eps);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float o = v[e] * rstd;
      if constexpr (kAff >= kWeight) o *= g[e];
      if constexpr (kAff == kWeightBias) o += be[e];
      v[e] = o;
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
      apex::store_chunk(y + static_cast<size_t>(row) * n, (lane + 32 * c) * V,
                        n, vec, v + c * V);
    if (lane == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
}

// dx per row; with kW also the CTA's (2, n) partial row of (dgamma, dbeta)
template <typename T, int E, bool kW>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const void* __restrict__ w,
                  T* __restrict__ dx, float* __restrict__ part, int rows,
                  int n, int rows_per_cta, bool rms, bool vec, bool w_bf16) {
  extern __shared__ float red[];  // (2, n) with kW
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = E / V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float g[kW ? E : 1], dg[kW ? E : 1], db[kW ? E : 1];
  if constexpr (kW) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        g[c * V + k] = load_param(w, w_bf16, (lane + 32 * c) * V + k, n);
        dg[c * V + k] = 0.f;
        db[c * V + k] = 0.f;
      }
  }
  const float nf = static_cast<float>(n);
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(r0 + rows_per_cta, rows);
  for (int row = r0 + warp; row < r1; row += kWarps) {
    const size_t off = static_cast<size_t>(row) * n;
    float xv[E], gv[E];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      apex::load_chunk(x + off, (lane + 32 * c) * V, n, vec, 0.f,
                       xv + c * V);
      apex::load_chunk(dy + off, (lane + 32 * c) * V, n, vec, 0.f,
                       gv + c * V);
    }
    const float mu = rms ? 0.f : mean[row];
    const float rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int e = c * V + k;
        const float xh =
            (lane + 32 * c) * V + k < n ? (xv[e] - mu) * rs : 0.f;
        float d = gv[e];
        if constexpr (kW) {
          dg[e] += d * xh;
          db[e] += d;
          d *= g[e];
        }
        xv[e] = xh;
        gv[e] = d;
        s1 += d;
        s2 += d * xh;
      }
    const float c2 = apex::warp_sum(s2) / nf;
    const float c1 = rms ? 0.f : apex::warp_sum(s1) / nf;
#pragma unroll
    for (int e = 0; e < E; ++e) xv[e] = (gv[e] - c1 - xv[e] * c2) * rs;
#pragma unroll
    for (int c = 0; c < C; ++c)
      apex::store_chunk(dx + off, (lane + 32 * c) * V, n, vec, xv + c * V);
  }
  if constexpr (kW) {
    // lane l of every warp owns the same columns: add the warps' partials
    // in warp order, then write the CTA's row of the partial buffer
    for (int wi = 0; wi < kWarps; ++wi) {
      if (warp == wi) {
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int i = (lane + 32 * c) * V + k;
            if (i < n) {
              red[i] = (wi ? red[i] : 0.f) + dg[c * V + k];
              red[n + i] = (wi ? red[n + i] : 0.f) + db[c * V + k];
            }
          }
      }
      __syncthreads();
    }
    float* pr = part + static_cast<size_t>(blockIdx.x) * 2 * n;
    for (int i = threadIdx.x; i < 2 * n; i += kThreads) pr[i] = red[i];
  }
}

// (dgamma, dbeta)[col] = the partial rows' sum, in row order 0, 1, ...
// per thread row group, then the 8 groups in order
__global__ void __launch_bounds__(256)
    ln_bwd_reduce_kernel(const float* __restrict__ part, void* dw, void* db,
                         int parts, int n, bool w_bf16) {
  __shared__ float s[2][8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  float a = 0.f, bsum = 0.f;
  if (col < n) {
    for (int p = ty; p < parts; p += 8) {
      const float* pr = part + static_cast<size_t>(p) * 2 * n;
      a += pr[col];
      bsum += pr[n + col];
    }
  }
  s[0][ty][tx] = a;
  s[1][ty][tx] = bsum;
  __syncthreads();
  if (ty == 0 && col < n) {
    float ta = 0.f, tb = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      ta += s[0][t][tx];
      tb += s[1][t][tx];
    }
    store_param(dw, w_bf16, col, ta);
    if (db != nullptr) store_param(db, w_bf16, col, tb);
  }
}

// elements a lane holds for a row of n: 8, 32 or 128 (0: too long)
template <typename T>
int lane_elems(int n) {
  constexpr int V = apex::Chunk<T>::kVec;
  const int need = ((n + V - 1) / V + 31) / 32 * V;
  return need <= 8 ? 8 : need <= 32 ? 32 : need <= 128 ? 128 : 0;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int E>
cudaError_t fwd_e(const void* x, const void* w, const void* b, void* y,
                  void* mean, void* rstd, int affine, bool rms, int rows,
                  int n, float eps, bool vec, bool w_bf16, cudaStream_t st) {
  const int blocks = min((rows + kWarps - 1) / kWarps, kMaxFwdBlocks);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  if (affine == kWeightBias)
    ln_fwd_kernel<T, E, kWeightBias><<<blocks, kThreads, 0, st>>>(
        xp, w, b, yp, mp, rp, rows, n, eps, rms, vec, w_bf16);
  else if (affine == kWeight)
    ln_fwd_kernel<T, E, kWeight><<<blocks, kThreads, 0, st>>>(
        xp, w, b, yp, mp, rp, rows, n, eps, rms, vec, w_bf16);
  else
    ln_fwd_kernel<T, E, kNone><<<blocks, kThreads, 0, st>>>(
        xp, w, b, yp, mp, rp, rows, n, eps, rms, vec, w_bf16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_t(const void* x, const void* w, const void* b, void* y,
                  void* mean, void* rstd, int affine, bool rms, int rows,
                  int n, float eps, bool w_bf16, cudaStream_t st) {
  const bool vec = n % apex::Chunk<T>::kVec == 0 && aligned(x) && aligned(y);
  switch (lane_elems<T>(n)) {
    case 8:
      return fwd_e<T, 8>(x, w, b, y, mean, rstd, affine, rms, rows, n, eps,
                         vec, w_bf16, st);
    case 32:
      return fwd_e<T, 32>(x, w, b, y, mean, rstd, affine, rms, rows, n, eps,
                          vec, w_bf16, st);
    case 128:
      return fwd_e<T, 128>(x, w, b, y, mean, rstd, affine, rms, rows, n,
                           eps, vec, w_bf16, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int E>
cudaError_t bwd_e(const void* dy, const void* x, const void* mean,
                  const void* rstd, const void* w, void* dx, void* part,
                  void* dw, void* db, bool rms, int rows, int n,
                  int rows_per_cta, bool vec, bool w_bf16, cudaStream_t st) {
  const int blocks = (rows + rows_per_cta - 1) / rows_per_cta;
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  if (w == nullptr) {
    ln_bwd_kernel<T, E, false><<<blocks, kThreads, 0, st>>>(
        dyp, xp, mp, rp, w, dxp, pp, rows, n, rows_per_cta, rms, vec,
        w_bf16);
    return cudaGetLastError();
  }
  const size_t smem = static_cast<size_t>(2) * n * sizeof(float);
  ln_bwd_kernel<T, E, true><<<blocks, kThreads, smem, st>>>(
      dyp, xp, mp, rp, w, dxp, pp, rows, n, rows_per_cta, rms, vec, w_bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_reduce_kernel<<<(n + 31) / 32, 256, 0, st>>>(pp, dw, db, blocks, n,
                                                      w_bf16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_t(const void* dy, const void* x, const void* mean,
                  const void* rstd, const void* w, void* dx, void* part,
                  void* dw, void* db, bool rms, int rows, int n,
                  int rows_per_cta, bool w_bf16, cudaStream_t st) {
  const bool vec = n % apex::Chunk<T>::kVec == 0 && aligned(dy) &&
                   aligned(x) && aligned(dx);
  switch (lane_elems<T>(n)) {
    case 8:
      return bwd_e<T, 8>(dy, x, mean, rstd, w, dx, part, dw, db, rms, rows,
                         n, rows_per_cta, vec, w_bf16, st);
    case 32:
      return bwd_e<T, 32>(dy, x, mean, rstd, w, dx, part, dw, db, rms, rows,
                          n, rows_per_cta, vec, w_bf16, st);
    case 128:
      return bwd_e<T, 128>(dy, x, mean, rstd, w, dx, part, dw, db, rms,
                           rows, n, rows_per_cta, vec, w_bf16, st);
    default:
      return cudaErrorInvalidValue;
  }
}

bool dtype_ok(int dtype) {
  return dtype == apex::kFloat32 || dtype == apex::kBFloat16;
}

}  // namespace

// x, y (rows, n) of dtype; w, b (n,) fp32 or bf16 (w_bf16) or null by
// `affine` (0 none, 1 weight, 2 weight and bias); mean, rstd (rows,) fp32
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, void* mean, void* rstd, int dtype,
                           int w_bf16, int affine, int rms, int rows, int n,
                           float eps, void* stream) {
  if (!dtype_ok(dtype) || rows < 1 || n < 1 || n > kMaxHidden ||
      affine < kNone || affine > kWeightBias ||
      (affine >= kWeight && w == nullptr) ||
      (affine == kWeightBias && b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? fwd_t<__nv_bfloat16>(x, w, b, y, mean, rstd, affine, rms != 0,
                                 rows, n, eps, w_bf16 != 0, st)
          : fwd_t<float>(x, w, b, y, mean, rstd, affine, rms != 0, rows, n,
                         eps, w_bf16 != 0, st);
  return static_cast<int>(err);
}

// dy, x, dx (rows, n) of dtype; mean, rstd (rows,) fp32; w (n,) or null.
// With w: part (ceil(rows / rows_per_cta), 2, n) fp32 scratch, dw (n,) and
// db (n,) or null in w's dtype.
extern "C" int apex_ln_bwd(const void* dy, const void* x, const void* mean,
                           const void* rstd, const void* w, void* dx,
                           void* part, void* dw, void* db, int dtype,
                           int w_bf16, int rms, int rows, int n,
                           int rows_per_cta, void* stream) {
  if (!dtype_ok(dtype) || rows < 1 || n < 1 || n > kMaxHidden ||
      rows_per_cta < 1 ||
      (w != nullptr && (part == nullptr || dw == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? bwd_t<__nv_bfloat16>(dy, x, mean, rstd, w, dx, part, dw, db,
                                 rms != 0, rows, n, rows_per_cta,
                                 w_bf16 != 0, st)
          : bwd_t<float>(dy, x, mean, rstd, w, dx, part, dw, db, rms != 0,
                         rows, n, rows_per_cta, w_bf16 != 0, st);
  return static_cast<int>(err);
}
