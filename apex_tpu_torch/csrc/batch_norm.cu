// Batch norm over channel-last activations for Hopper: ResNet-50's 53
// batch norms a step, forward and backward, with the optional residual add
// and ReLU of the bottleneck's epilogue.
//
// Replaces no Pallas kernel: the reference computes batch norm in XLA
// (apex_tpu/parallel/sync_batchnorm.py::sync_batch_norm, :52-133), whose
// fusion stands in for upstream apex's Welford SyncBN kernels and for
// groupbn's fused add + ReLU. Eager PyTorch has no such fusion: the
// reference's composition costs about 10 fp32 passes forward and 15
// backward, and saves fp32 copies of every activation, which does not fit
// ResNet-50's step at batch 256 on the card. This file computes the same
// function at one process.
//
// x is viewed as (M, C) row-major (NHWC, M = N·H·W), x in fp32, bf16 or
// fp16, y in x's dtype (or bf16/fp16 for fp32 x), the residual in y's
// dtype, scale and bias in fp32 or x's dtype.
//   forward (training): per-channel fp32 mean and biased variance over the
//     M rows, rstd = 1 / sqrt(var + eps), then
//     y = ((x - mean) * rstd) * scale + bias (+ residual) (ReLU);
//   forward (eval): the same apply on the running mean and variance;
//   backward: dy' = dy · [y > 0] with the ReLU, else dy; per channel
//     Σdy' and Σdy'·x̂ (x̂ = (x - mean) * rstd), then
//     dx = scale·rstd·(dy' − Σdy'/M − x̂·Σdy'x̂/M) (eval: scale·rstd·dy'),
//     dscale = Σdy'·x̂, dbias = Σdy', dresidual = dy'.
//
// Bound on this card: bytes. ResNet-50's batch norms at batch 256 touch
// about 2.7 G elements a step; at 3.35 TB/s the forward (x and the residual
// read, y written) and the backward (dy, x, y read, dx and dresidual
// written) are some 5-10 ms together in bf16. The operations (a few fp32
// flops an element) are far under that.
//
// Design. The per-channel sums are column reductions over up to 3.2 M rows.
// The rows are cut into fixed chunks (the host's plan, a function of M, C
// and the dtype alone); a CTA of tx × ty threads takes one chunk and tx
// 16-byte column vectors, each thread a column vector over every ty-th row
// of the chunk: Welford in fp32 forward (no E[x²] − E[x]² cancellation),
// plain fp32 sums backward. The ty threads of a column combine in order in
// shared memory (Chan's formula forward) into one (chunks, C) fp32 partial;
// a second launch combines the chunks in a fixed order in fp64. Mean, rstd
// and the weight gradients are therefore bit-identical from run to run. The apply
// and dx passes keep each thread on one column vector, its per-channel
// values in registers, over a grid-stride of rows.
#include <cstdint>

#include "apex_cuda.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr int kMaxThreads = 256;

// the planted faults: the last row chunk left out of the statistics
// (forward), dx without its −x̂·Σdy'x̂/M term (backward)
constexpr int kDropLastChunk = 1;
constexpr int kDropXhatTerm = 1;

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = apex::to_float(pk.v[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int i = 0; i < V; ++i) pk.v[i] = apex::from_float<T>(in[i]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

__device__ __forceinline__ float load_w(const void* p, int dtype, int c) {
  if (dtype == apex::kBFloat16)
    return __bfloat162float(static_cast<const bf16*>(p)[c]);
  if (dtype == apex::kFloat16)
    return __half2float(static_cast<const f16*>(p)[c]);
  return static_cast<const float*>(p)[c];
}

__device__ __forceinline__ void store_w(void* p, int dtype, int c, float v) {
  if (dtype == apex::kBFloat16)
    static_cast<bf16*>(p)[c] = __float2bfloat16_rn(v);
  else if (dtype == apex::kFloat16)
    static_cast<f16*>(p)[c] = __float2half_rn(v);
  else
    static_cast<float*>(p)[c] = v;
}

// rows of the chunk [r0, r1) that thread row k of ty visits
__device__ __forceinline__ int rows_of(int r0, int r1, int k, int ty) {
  return r0 + k < r1 ? (r1 - r0 - k + ty - 1) / ty : 0;
}

// pass 1 (training): each chunk's per-channel mean and centred second
// moment, the CTA's ty threads of a column combined in order
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_stats_partial(const T* __restrict__ x, float* __restrict__ part_mean,
                     float* __restrict__ part_m2, int M, int C,
                     int rows_per_chunk) {
  __shared__ float s_mean[kMaxThreads * V];
  __shared__ float s_m2[kMaxThreads * V];
  const int tx = blockDim.x, ty = blockDim.y;
  const int w = tx * V;
  const int chunk = blockIdx.x;
  const int col = (blockIdx.y * tx + threadIdx.x) * V;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  float mean[V], m2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) mean[v] = m2[v] = 0.f;
  if (col < C) {
    int n = 0;
#pragma unroll 4
    for (int r = r0 + threadIdx.y; r < r1; r += ty) {
      float xv[V];
      load<T, V>(x + static_cast<long long>(r) * C + col, xv);
      ++n;
      const float inv = 1.f / static_cast<float>(n);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = xv[v] - mean[v];
        mean[v] += d * inv;
        m2[v] += d * (xv[v] - mean[v]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s_mean[threadIdx.y * w + threadIdx.x * V + v] = mean[v];
    s_m2[threadIdx.y * w + threadIdx.x * V + v] = m2[v];
  }
  __syncthreads();
  const int t = threadIdx.y * tx + threadIdx.x;
  const int c = blockIdx.y * w + t;
  if (t < w && c < C) {
    float cn = 0.f, cm = 0.f, cm2 = 0.f;
    for (int k = 0; k < ty; ++k) {
      const int nb = rows_of(r0, r1, k, ty);
      if (nb == 0) break;  // the counts fall with k
      const float fb = static_cast<float>(nb), nn = cn + fb;
      const float d = s_mean[k * w + t] - cm;
      cm += d * (fb / nn);
      cm2 += s_m2[k * w + t] + d * d * (cn * fb / nn);
      cn = nn;
    }
    part_mean[static_cast<long long>(chunk) * C + c] = cm;
    part_m2[static_cast<long long>(chunk) * C + c] = cm2;
  }
}

// the statistics: the chunks combined in a fixed order (training) or the
// running ones (eval); stats = (mean, var, rstd, scale, bias), C floats
// each. A CTA takes kFinalCols channels; its kFinalGroups thread rows each
// sum every kFinalGroups-th chunk in fp64, and the groups' sums are added
// in order: first the mean, Σ nb·mean_k / n, then the variance,
// Σ (M2_k + nb·(mean_k − mean)²) / n (exact, with no cancellation).
constexpr int kFinalCols = 32;
constexpr int kFinalGroups = 8;

__device__ __forceinline__ int chunk_rows(int k, int M, int rows_per_chunk) {
  return min(rows_per_chunk, M - k * rows_per_chunk);
}

__global__ void __launch_bounds__(kFinalCols * kFinalGroups)
    bn_stats_final(const float* __restrict__ part_mean,
                   const float* __restrict__ part_m2,
                   const float* __restrict__ rmean,
                   const float* __restrict__ rvar, const void* scale,
                   const void* bias, int w_dtype, float* __restrict__ stats,
                   int M, int C, int chunks, int rows_per_chunk, float eps,
                   int train, int fault) {
  __shared__ double sh[kFinalGroups][kFinalCols];
  __shared__ double sh_mean[kFinalCols];
  const int lane = threadIdx.x, grp = threadIdx.y;
  const int c = blockIdx.x * kFinalCols + lane;
  const bool live = c < C;
  float mean = 0.f, var = 0.f;
  if (train) {
    const int used = fault == kDropLastChunk ? chunks - 1 : chunks;
    const double n = fault == kDropLastChunk
                         ? static_cast<double>(used) * rows_per_chunk
                         : static_cast<double>(M);
    double s = 0.0;
    if (live)
      for (int k = grp; k < used; k += kFinalGroups)
        s += static_cast<double>(chunk_rows(k, M, rows_per_chunk)) *
             part_mean[static_cast<long long>(k) * C + c];
    sh[grp][lane] = s;
    __syncthreads();
    if (grp == 0) {
      double t = 0.0;
      for (int g = 0; g < kFinalGroups; ++g) t += sh[g][lane];
      sh_mean[lane] = t / n;  // NaN when no row is left
    }
    __syncthreads();
    const double mu = sh_mean[lane];
    double q = 0.0;
    if (live)
      for (int k = grp; k < used; k += kFinalGroups) {
        const long long i = static_cast<long long>(k) * C + c;
        const double d = part_mean[i] - mu;
        q += part_m2[i] +
             static_cast<double>(chunk_rows(k, M, rows_per_chunk)) * d * d;
      }
    __syncthreads();  // every read of sh's sums is done
    sh[grp][lane] = q;
    __syncthreads();
    if (grp != 0 || !live) return;
    double t = 0.0;
    for (int g = 0; g < kFinalGroups; ++g) t += sh[g][lane];
    mean = static_cast<float>(mu);
    var = static_cast<float>(t / n);
  } else {
    if (grp != 0 || !live) return;
    mean = rmean[c];
    var = rvar[c];
  }
  stats[c] = mean;
  stats[C + c] = var;
  stats[2 * C + c] = 1.f / sqrtf(var + eps);
  stats[3 * C + c] = scale ? load_w(scale, w_dtype, c) : 1.f;
  stats[4 * C + c] = bias ? load_w(bias, w_dtype, c) : 0.f;
}

template <int V>
__device__ __forceinline__ void channel_values(const float* stats, int C,
                                               int row, int col,
                                               float (&out)[V]) {
  load<float, V>(stats + static_cast<long long>(row) * C + col, out);
}

// pass 2: y = ((x - mean) * rstd) * scale + bias (+ residual) (ReLU)
template <typename T, typename O, int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_apply(const T* __restrict__ x, const O* __restrict__ res,
             O* __restrict__ y, const float* __restrict__ stats, int M, int C,
             int relu) {
  const int ty = blockDim.y;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (col >= C) return;
  float mean[V], rstd[V], sc[V], bi[V];
  channel_values<V>(stats, C, 0, col, mean);
  channel_values<V>(stats, C, 2, col, rstd);
  channel_values<V>(stats, C, 3, col, sc);
  channel_values<V>(stats, C, 4, col, bi);
  const long long step = static_cast<long long>(gridDim.x) * ty;
#pragma unroll 2
  for (long long r = static_cast<long long>(blockIdx.x) * ty + threadIdx.y;
       r < M; r += step) {
    const long long off = r * C + col;
    float xv[V], rv[V], out[V];
    load<T, V>(x + off, xv);
    if (res) load<O, V>(res + off, rv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float t = (xv[v] - mean[v]) * rstd[v];
      t = t * sc[v];
      t = t + bi[v];
      if (res) t = t + rv[v];
      // NaN passes the ReLU, as torch.relu and jnp.maximum pass it
      if (relu && t < 0.f) t = 0.f;
      out[v] = t;
    }
    store<O, V>(y + off, out);
  }
}

// backward pass 1: each chunk's per-channel Σdy' and Σdy'·x̂
template <typename T, typename O, int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_bwd_partial(const O* __restrict__ dy, const T* __restrict__ x,
                   const O* __restrict__ y, const float* __restrict__ stats,
                   float* __restrict__ part_dy, float* __restrict__ part_dyx,
                   int M, int C, int rows_per_chunk, int relu) {
  __shared__ float s_dy[kMaxThreads * V];
  __shared__ float s_dyx[kMaxThreads * V];
  const int tx = blockDim.x, ty = blockDim.y;
  const int w = tx * V;
  const int chunk = blockIdx.x;
  const int col = (blockIdx.y * tx + threadIdx.x) * V;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  float sdy[V], sdyx[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sdy[v] = sdyx[v] = 0.f;
  if (col < C) {
    float mean[V], rstd[V];
    channel_values<V>(stats, C, 0, col, mean);
    channel_values<V>(stats, C, 2, col, rstd);
#pragma unroll 4
    for (int r = r0 + threadIdx.y; r < r1; r += ty) {
      const long long off = static_cast<long long>(r) * C + col;
      float g[V], xv[V], yv[V];
      load<O, V>(dy + off, g);
      load<T, V>(x + off, xv);
      if (relu) load<O, V>(y + off, yv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float gv = relu && !(yv[v] > 0.f) ? 0.f : g[v];
        sdy[v] += gv;
        sdyx[v] += gv * ((xv[v] - mean[v]) * rstd[v]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s_dy[threadIdx.y * w + threadIdx.x * V + v] = sdy[v];
    s_dyx[threadIdx.y * w + threadIdx.x * V + v] = sdyx[v];
  }
  __syncthreads();
  const int t = threadIdx.y * tx + threadIdx.x;
  const int c = blockIdx.y * w + t;
  if (t < w && c < C) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < ty; ++k) {
      a += s_dy[k * w + t];
      b += s_dyx[k * w + t];
    }
    part_dy[static_cast<long long>(chunk) * C + c] = a;
    part_dyx[static_cast<long long>(chunk) * C + c] = b;
  }
}

// backward: the chunks summed in a fixed order (as bn_stats_final's, in
// fp64); sums = (Σdy', Σdy'·x̂), C floats each; dscale and dbias in the
// parameters' dtype where asked for
__global__ void __launch_bounds__(kFinalCols * kFinalGroups)
    bn_bwd_final(const float* __restrict__ part_dy,
                 const float* __restrict__ part_dyx, float* __restrict__ sums,
                 void* dscale, void* dbias, int w_dtype, int C, int chunks) {
  __shared__ double sh_a[kFinalGroups][kFinalCols];
  __shared__ double sh_b[kFinalGroups][kFinalCols];
  const int lane = threadIdx.x, grp = threadIdx.y;
  const int c = blockIdx.x * kFinalCols + lane;
  double a = 0.0, b = 0.0;
  if (c < C)
    for (int k = grp; k < chunks; k += kFinalGroups) {
      a += part_dy[static_cast<long long>(k) * C + c];
      b += part_dyx[static_cast<long long>(k) * C + c];
    }
  sh_a[grp][lane] = a;
  sh_b[grp][lane] = b;
  __syncthreads();
  if (grp != 0 || c >= C) return;
  a = b = 0.0;
  for (int g = 0; g < kFinalGroups; ++g) {
    a += sh_a[g][lane];
    b += sh_b[g][lane];
  }
  sums[c] = static_cast<float>(a);
  sums[C + c] = static_cast<float>(b);
  if (dscale) store_w(dscale, w_dtype, c, static_cast<float>(b));
  if (dbias) store_w(dbias, w_dtype, c, static_cast<float>(a));
}

// backward pass 2: dx (and dresidual = dy')
template <typename T, typename O, int V>
__global__ void __launch_bounds__(kMaxThreads)
    bn_bwd_dx(const O* __restrict__ dy, const T* __restrict__ x,
              const O* __restrict__ y, const float* __restrict__ stats,
              const float* __restrict__ sums, T* __restrict__ dx,
              O* __restrict__ dres, int M, int C, int relu, int train,
              int fault) {
  const int ty = blockDim.y;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (col >= C) return;
  float mean[V], rstd[V], k[V], mdy[V], mdyx[V];
  channel_values<V>(stats, C, 0, col, mean);
  channel_values<V>(stats, C, 2, col, rstd);
  channel_values<V>(stats, C, 3, col, k);
  channel_values<V>(sums, C, 0, col, mdy);
  channel_values<V>(sums, C, 1, col, mdyx);
  const float inv_m = 1.f / static_cast<float>(M);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    k[v] = k[v] * rstd[v];
    mdy[v] = train ? mdy[v] * inv_m : 0.f;
    mdyx[v] = train && fault != kDropXhatTerm ? mdyx[v] * inv_m : 0.f;
  }
  const long long step = static_cast<long long>(gridDim.x) * ty;
#pragma unroll 2
  for (long long r = static_cast<long long>(blockIdx.x) * ty + threadIdx.y;
       r < M; r += step) {
    const long long off = r * C + col;
    float g[V], xv[V], yv[V], out[V];
    load<O, V>(dy + off, g);
    load<T, V>(x + off, xv);
    if (relu) load<O, V>(y + off, yv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (relu && !(yv[v] > 0.f)) g[v] = 0.f;
      const float xhat = (xv[v] - mean[v]) * rstd[v];
      out[v] = k[v] * (g[v] - mdy[v] - xhat * mdyx[v]);
    }
    store<T, V>(dx + off, out);
    if (dres) store<O, V>(dres + off, g);
  }
}

struct Plan {
  int vec, tx, ty, chunks, rows_per_chunk, apply_ctas;
};

bool plan_ok(const Plan& p, int M, int C, int natural) {
  return M >= 1 && C >= 1 && (p.vec == 1 || p.vec == natural) &&
         C % p.vec == 0 && p.tx >= 1 && p.tx <= 32 && p.ty >= 1 &&
         p.tx * p.ty <= kMaxThreads && p.tx * p.vec <= p.tx * p.ty &&
         p.chunks >= 1 && p.rows_per_chunk >= 1 &&
         static_cast<long long>(p.chunks) * p.rows_per_chunk >= M &&
         static_cast<long long>(p.chunks - 1) * p.rows_per_chunk < M &&
         p.apply_ctas >= 1 && p.apply_ctas <= 65535;
}

int col_blocks(const Plan& p, int C) {
  const int cv = C / p.vec;
  return (cv + p.tx - 1) / p.tx;
}

template <typename T, typename O, int V>
cudaError_t fwd_impl(const void* x, const void* res, void* y,
                     const void* scale, const void* bias, const float* rmean,
                     const float* rvar, float* stats, float* part,
                     int w_dtype, int M, int C, int train, int relu,
                     float eps, const Plan& p, int fault, cudaStream_t st) {
  const dim3 block(p.tx, p.ty);
  const int cb = col_blocks(p, C);
  float* part_mean = part;
  float* part_m2 =
      part ? part + static_cast<long long>(p.chunks) * C : nullptr;
  if (train) {
    bn_stats_partial<T, V><<<dim3(p.chunks, cb), block, 0, st>>>(
        static_cast<const T*>(x), part_mean, part_m2, M, C,
        p.rows_per_chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  bn_stats_final<<<(C + kFinalCols - 1) / kFinalCols,
                   dim3(kFinalCols, kFinalGroups), 0, st>>>(part_mean, part_m2, rmean, rvar, scale, bias,
                         w_dtype, stats, M, C, p.chunks, p.rows_per_chunk,
                         eps, train, fault);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_apply<T, O, V><<<dim3(p.apply_ctas, cb), block, 0, st>>>(
      static_cast<const T*>(x), static_cast<const O*>(res),
      static_cast<O*>(y), stats, M, C, relu);
  return cudaGetLastError();
}

template <typename T, typename O, int V>
cudaError_t bwd_impl(const void* dy, const void* x, const void* y,
                     const float* stats, void* dx, void* dres, void* dscale,
                     void* dbias, float* part, int w_dtype, int M, int C,
                     int train, int relu, const Plan& p, int fault,
                     cudaStream_t st) {
  const dim3 block(p.tx, p.ty);
  const int cb = col_blocks(p, C);
  float* part_dy = part;
  float* part_dyx = part + static_cast<long long>(p.chunks) * C;
  float* sums = part + 2LL * p.chunks * C;
  bn_bwd_partial<T, O, V><<<dim3(p.chunks, cb), block, 0, st>>>(
      static_cast<const O*>(dy), static_cast<const T*>(x),
      static_cast<const O*>(y), stats, part_dy, part_dyx, M, C,
      p.rows_per_chunk, relu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_final<<<(C + kFinalCols - 1) / kFinalCols,
                 dim3(kFinalCols, kFinalGroups), 0, st>>>(part_dy, part_dyx, sums, dscale, dbias, w_dtype, C,
                       p.chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_dx<T, O, V><<<dim3(p.apply_ctas, cb), block, 0, st>>>(
      static_cast<const O*>(dy), static_cast<const T*>(x),
      static_cast<const O*>(y), stats, sums, static_cast<T*>(dx),
      static_cast<O*>(dres), M, C, relu, train, fault);
  return cudaGetLastError();
}

// the (x dtype, y dtype) pairs the kernels take: y in x's dtype, or a half
// y for fp32 x
template <template <typename, typename> class Fn, typename... Args>
cudaError_t dispatch(int dtype, int out_dtype, Args... args) {
  using apex::kBFloat16;
  using apex::kFloat16;
  using apex::kFloat32;
  if (dtype == kFloat32 && out_dtype == kFloat32)
    return Fn<float, float>::run(args...);
  if (dtype == kBFloat16 && out_dtype == kBFloat16)
    return Fn<bf16, bf16>::run(args...);
  if (dtype == kFloat16 && out_dtype == kFloat16)
    return Fn<f16, f16>::run(args...);
  if (dtype == kFloat32 && out_dtype == kBFloat16)
    return Fn<float, bf16>::run(args...);
  if (dtype == kFloat32 && out_dtype == kFloat16)
    return Fn<float, f16>::run(args...);
  return cudaErrorInvalidValue;
}

template <typename T, typename O>
struct Fwd {
  static cudaError_t run(const void* x, const void* res, void* y,
                         const void* scale, const void* bias,
                         const float* rmean, const float* rvar, float* stats,
                         float* part, int w_dtype, int M, int C, int train,
                         int relu, float eps, Plan p, int fault,
                         cudaStream_t st) {
    constexpr int kVec = 16 / sizeof(T);
    if (!plan_ok(p, M, C, kVec)) return cudaErrorInvalidValue;
    if (p.vec == kVec)
      return fwd_impl<T, O, kVec>(x, res, y, scale, bias, rmean, rvar, stats,
                                  part, w_dtype, M, C, train, relu, eps, p,
                                  fault, st);
    return fwd_impl<T, O, 1>(x, res, y, scale, bias, rmean, rvar, stats,
                             part, w_dtype, M, C, train, relu, eps, p, fault,
                             st);
  }
};

template <typename T, typename O>
struct Bwd {
  static cudaError_t run(const void* dy, const void* x, const void* y,
                         const float* stats, void* dx, void* dres,
                         void* dscale, void* dbias, float* part, int w_dtype,
                         int M, int C, int train, int relu, Plan p, int fault,
                         cudaStream_t st) {
    constexpr int kVec = 16 / sizeof(T);
    if (!plan_ok(p, M, C, kVec)) return cudaErrorInvalidValue;
    if (p.vec == kVec)
      return bwd_impl<T, O, kVec>(dy, x, y, stats, dx, dres, dscale, dbias,
                                  part, w_dtype, M, C, train, relu, p, fault,
                                  st);
    return bwd_impl<T, O, 1>(dy, x, y, stats, dx, dres, dscale, dbias, part,
                             w_dtype, M, C, train, relu, p, fault, st);
  }
};

bool w_dtype_ok(int w_dtype) {
  return w_dtype == -1 || w_dtype == apex::kFloat32 ||
         w_dtype == apex::kBFloat16 || w_dtype == apex::kFloat16;
}

}  // namespace

// The forward. x (M, C) contiguous in `dtype`; res (or null) and y in
// `out_dtype`; scale and bias (each may be null) in `w_dtype` (-1: both
// null); rmean and rvar (eval: fp32, C each; training: null); stats: fp32
// (5, C) out (mean, var, rstd, scale, bias); part: fp32 (2, chunks, C)
// scratch (training). The plan: vec (1 or 16 bytes of x), tx column
// vectors by ty rows a CTA, chunks of rows_per_chunk rows, apply_ctas row
// CTAs for the apply pass. fault 1: the last chunk left out.
extern "C" int apex_bn_fwd(const void* x, const void* res, void* y,
                           const void* scale, const void* bias,
                           const void* rmean, const void* rvar, void* stats,
                           void* part, int dtype, int out_dtype, int w_dtype,
                           int M, int C, int train, int relu, float eps,
                           int vec, int tx, int ty, int chunks,
                           int rows_per_chunk, int apply_ctas, int fault,
                           void* stream) {
  if (!x || !y || !stats || (train && !part) ||
      (!train && (!rmean || !rvar)) || !w_dtype_ok(w_dtype) ||
      (w_dtype == -1 && (scale || bias)) || (fault != 0 && fault != 1) ||
      (train != 0 && train != 1) || !(eps >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{vec, tx, ty, chunks, rows_per_chunk, apply_ctas};
  return static_cast<int>(dispatch<Fwd>(
      dtype, out_dtype, x, res, y, scale, bias,
      static_cast<const float*>(rmean), static_cast<const float*>(rvar),
      static_cast<float*>(stats), static_cast<float*>(part), w_dtype, M, C,
      train, relu, eps, p, fault, static_cast<cudaStream_t>(stream)));
}

// The backward. dy, y (with the ReLU; else null) and dres (with a
// residual; else null) in `out_dtype`; x and dx in `dtype`; stats: the
// forward's; dscale and dbias (each may be null) in `w_dtype`; part: fp32
// (2 · chunks + 2, C) scratch (the chunks' sums, then Σdy' and Σdy'·x̂).
// The forward's plan. fault 1: dx without its x̂ term.
extern "C" int apex_bn_bwd(const void* dy, const void* x, const void* y,
                           const void* stats, void* dx, void* dres,
                           void* dscale, void* dbias, void* part, int dtype,
                           int out_dtype, int w_dtype, int M, int C,
                           int train, int relu, int vec, int tx, int ty,
                           int chunks, int rows_per_chunk, int apply_ctas,
                           int fault, void* stream) {
  if (!dy || !x || !stats || !dx || !part || (relu && !y) ||
      !w_dtype_ok(w_dtype) || (w_dtype == -1 && (dscale || dbias)) ||
      (fault != 0 && fault != 1) || (train != 0 && train != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p{vec, tx, ty, chunks, rows_per_chunk, apply_ctas};
  return static_cast<int>(dispatch<Bwd>(
      dtype, out_dtype, dy, x, y, static_cast<const float*>(stats), dx, dres,
      dscale, dbias, static_cast<float*>(part), w_dtype, M, C, train, relu,
      p, fault, static_cast<cudaStream_t>(stream)));
}
