// Paged decode attention: one query token per slot against the serving
// engine's paged KV pool, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/decode_attention.py::decode_attn_paged_fwd
// (:211; kernel body _decode_kernel :56-146). Same contract: q
// (b*h_kv, group, d) holds each kv head's group of query heads; the pool
// (num_blocks, h_kv, bs, d) is shared by every slot; block_tables (b, nb)
// names slot i's j-th logical block; lengths (b,) counts live rows per
// slot. Output (b*h_kv, group, d) in q's dtype.
//
// Bound on this card: HBM bytes. Every live K/V row is read once and each
// row costs 4*group*d operations against 2*2*d bytes (bf16), far below the
// ~295 operations per byte where an H100's tensor cores become the limit.
// At the serving slice's shapes (8 slots x 512 live rows x 8 kv heads x d
// 128, bf16) one layer reads 2*8*512*8*128*2 B = 16.8 MB: ~5 us at
// 3.35 TB/s.
//
// Design, simple and right first:
// * one CTA (128 threads) per (slot, kv head). The CTA reads its own table
//   row and loops over ceil(len / bs) blocks only: the Pallas grid's
//   `j*bk < kvlen` skip (:99) becomes the loop bound, and within the last
//   block only the live rows are loaded, scored and summed — columns
//   >= len take no part, which is exactly the reference's -1e30 mask
//   (:124): exp(-1e30 - m) is 0 in fp32.
// * a block's pool row is table[slot, j] * h_kv + kv_head; its live K and
//   V rows are staged in shared memory (128 x 128 bf16 = 32 KB each) by
//   cp.async 16-byte copies, all in flight at once: V's copy overlaps the
//   scores, and the next block's K copy overlaps this block's softmax and
//   PV product.
// * thread r scores row r of the block (bs <= 128) for the G query heads
//   of the kv group, reading K and q from shared memory in a rotated order
//   that keeps a warp's 32 reads in 32 banks. G is a template parameter
//   (1, 2, 4, 8, 16): loops over a runtime group count, guarded for up to
//   16 heads, took most of the first version's time.
// * the online softmax runs in fp32 with m starting at -1e30 and an fp32
//   accumulator; the block's max and sum are block-wide reductions, and
//   every thread keeps the running m and l. p is rounded to V's dtype
//   before the PV product (:137), l sums the unrounded p, and the output
//   divides by max(l, 1e-30), so a length-0 slot comes out as zeros (:145).
// Known weakness, left for a later change: b*h_kv CTAs (64 at the slice's
// shapes) on 132 SMs, each walking its blocks in turn. Split-K over the
// blocks (flash-decoding) is the fix.
#include <cstdint>

#include "apex_cuda.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

// 16-byte global -> shared copy that bypasses registers and L1
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// stage the first `live` rows of pool row `prow` (bs x D elements) into dst
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* pool,
                                           size_t prow, int bs, int live) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  const T* src = pool + prow * bs * D;
  const int nvec = live * D / kVec;
  for (int i = threadIdx.x; i < nvec; i += kThreads)
    cp_async_16(dst + i * kVec, src + i * kVec);
  cp_async_commit();
}

// q.k for one K row held in shared memory, G query heads at once; row r
// starts its walk at word r so a warp's reads fall in 32 distinct banks
template <int D, int G>
__device__ __forceinline__ void row_scores(const __nv_bfloat16* krow,
                                           const float* q_s, int r,
                                           float (&s)[G]) {
  const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(krow);
#pragma unroll 8
  for (int i = 0; i < D / 2; ++i) {
    const int w = (i + r) & (D / 2 - 1);
    const float2 k = __bfloat1622float2(k2[w]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float2 qv = *reinterpret_cast<const float2*>(q_s + g * D + 2 * w);
      s[g] += qv.x * k.x + qv.y * k.y;
    }
  }
}

template <int D, int G>
__device__ __forceinline__ void row_scores(const float* krow,
                                           const float* q_s, int r,
                                           float (&s)[G]) {
#pragma unroll 8
  for (int i = 0; i < D; ++i) {
    const int w = (i + r) & (D - 1);
    const float k = krow[w];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] += q_s[g * D + w] * k;
  }
}

size_t smem_bytes(size_t elem, int d, int bs, int group) {
  const int split = kThreads / d;
  return 2 * static_cast<size_t>(bs) * d * elem  // K and V tiles
         + sizeof(float) *
               (static_cast<size_t>(group) * d     // q
                + static_cast<size_t>(group) * bs  // p
                + 2 * kWarps * group               // per-warp max and sum
                + static_cast<size_t>(split - 1) * group * d);  // PV parts
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int h_kv, int bs, int nb, float scale) {
  constexpr int kSplit = kThreads / D;  // row subsets of the PV product

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + static_cast<size_t>(bs) * D;
  float* q_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(bs) * D);
  float* p_s = q_s + G * D;
  float* red_max = p_s + G * bs;
  float* red_sum = red_max + kWarps * G;
  float* part_s = red_sum + kWarps * G;

  const int row = blockIdx.x;  // slot * h_kv + kv head
  const int slot = row / h_kv;
  const int kvh = row - slot * h_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = tid % D;
  const int part = tid / D;
  const int len = lengths[slot];

  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = apex::to_float(q[static_cast<size_t>(row) * G * D + i]);
  // the running softmax state, identical in every thread
  float m_run[G], l_run[G], acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
    acc[g] = 0.f;
  }

  const int nblk = (len + bs - 1) / bs;
  const int* trow = tables + static_cast<size_t>(slot) * nb;
  auto pool_row = [&](int j) {
    return static_cast<size_t>(trow[j]) * h_kv + kvh;
  };
  if (nblk > 0) stage_rows<T, D>(k_s, k_pool, pool_row(0), bs, min(bs, len));
  for (int j = 0; j < nblk; ++j) {
    const int live = min(bs, len - j * bs);
    stage_rows<T, D>(v_s, v_pool, pool_row(j), bs, live);
    cp_async_wait<1>();  // this block's K has landed; V may be in flight
    __syncthreads();     // ... for every thread's copies (and q_s)

    // scores in fp32: thread tid scores row tid of the block
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    const bool mine = tid < live;
    if (mine) row_scores<D, G>(k_s + tid * D, q_s, tid, s);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] = mine ? s[g] * scale : kNegInf;
      const float mx = apex::warp_max(s[g]);
      if (lane == 0) red_max[warp * G + g] = mx;
    }
    __syncthreads();  // per-warp maxima published; the K tile is free
    const bool more = j + 1 < nblk;
    if (more)
      stage_rows<T, D>(k_s, k_pool, pool_row(j + 1), bs,
                       min(bs, len - (j + 1) * bs));

    // online softmax: the block's max, p = exp(s - m_new) (p rounded to
    // V's dtype for the PV product), the block's sum of the unrounded p
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = red_max[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_max[w * G + g]);
      const float m_new = fmaxf(m_run[g], mx);
      alpha[g] = expf(m_run[g] - m_new);
      m_run[g] = m_new;
      const float p = mine ? expf(s[g] - m_new) : 0.f;
      const float ps = apex::warp_sum(p);
      if (lane == 0) red_sum[warp * G + g] = ps;
      if (mine) p_s[g * bs + tid] = apex::to_float(apex::from_float<T>(p));
    }
    if (more)
      cp_async_wait<1>();  // V has landed; the next K may be in flight
    else
      cp_async_wait<0>();
    __syncthreads();

    // PV: thread (part, col) owns output column col for rows
    // part, part + kSplit, ... of the block
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float ps = red_sum[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) ps += red_sum[w * G + g];
      l_run[g] = l_run[g] * alpha[g] + ps;
      acc[g] *= alpha[g];
    }
#pragma unroll 4
    for (int r = part; r < live; r += kSplit) {
      const float v = apex::to_float(v_s[r * D + col]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += p_s[g * bs + r] * v;
    }
    __syncthreads();  // the next block overwrites v_s, p_s and red_*
  }

  if (kSplit > 1) {
    if (part > 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        part_s[((part - 1) * G + g) * D + col] = acc[g];
    }
    __syncthreads();
    if (part == 0) {
      for (int p = 1; p < kSplit; ++p) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[g] += part_s[((p - 1) * G + g) * D + col];
      }
    }
  }
  if (part == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      out[(static_cast<size_t>(row) * G + g) * D + col] =
          apex::from_float<T>(acc[g] / fmaxf(l_run[g], 1e-30f));
    }
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* tables, const void* lengths, void* out, int b,
                   int h_kv, int bs, int nb, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), D, bs, G);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, D, G><<<b * h_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), h_kv, bs, nb,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_group(int group, const void* q, const void* k_pool,
                         const void* v_pool, const void* tables,
                         const void* lengths, void* out, int b, int h_kv,
                         int bs, int nb, float scale, cudaStream_t stream) {
#define APEX_GROUP_CASE(G)                                                \
  case G:                                                                 \
    return launch<T, D, G>(q, k_pool, v_pool, tables, lengths, out, b,    \
                           h_kv, bs, nb, scale, stream);
  switch (group) {
    APEX_GROUP_CASE(1)
    APEX_GROUP_CASE(2)
    APEX_GROUP_CASE(4)
    APEX_GROUP_CASE(8)
    APEX_GROUP_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef APEX_GROUP_CASE
}

}  // namespace

extern "C" int apex_paged_decode_attn(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out,
                                      int dtype, int b, int h_kv, int group,
                                      int d, int bs, int nb, float scale,
                                      void* stream) {
  if (b < 1 || h_kv < 1 || bs < 1 || bs > kThreads || nb < 1 ||
      (d != 64 && d != 128) ||
      (dtype != apex::kFloat32 && dtype != apex::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == apex::kBFloat16) {
    err = d == 128 ? launch_group<__nv_bfloat16, 128>(
                         group, q, k_pool, v_pool, tables, lengths, out, b,
                         h_kv, bs, nb, scale, s)
                   : launch_group<__nv_bfloat16, 64>(
                         group, q, k_pool, v_pool, tables, lengths, out, b,
                         h_kv, bs, nb, scale, s);
  } else {
    err = d == 128 ? launch_group<float, 128>(group, q, k_pool, v_pool,
                                              tables, lengths, out, b, h_kv,
                                              bs, nb, scale, s)
                   : launch_group<float, 64>(group, q, k_pool, v_pool,
                                             tables, lengths, out, b, h_kv,
                                             bs, nb, scale, s);
  }
  return static_cast<int>(err);
}
