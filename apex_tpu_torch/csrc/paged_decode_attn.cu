// Decode attention: one query token per (batch, kv head) row against a KV
// cache, for Hopper (sm_90a), in two addressings of one kernel body:
//
// * paged (apex_paged_decode_attn): replaces
//   apex_tpu/ops/pallas/decode_attention.py::decode_attn_paged_fwd (:211).
//   q (b*h_kv, group, d) holds each kv head's group of query heads; the
//   pool (num_blocks, h_kv, bs, d) is shared by every slot; block_tables
//   (b, nb) names slot i's j-th logical block; lengths (b,) counts live
//   rows per slot.
// * contiguous (apex_decode_attn): replaces ::decode_attn_fwd (:156-200),
//   the decode engine's cache. k and v are (rows, max_s, d) with rows =
//   b*h_kv, a free view of the (b, h_kv, max_s, d) cache; lengths (rows,)
//   is the per-batch length repeated over kv heads (as at
//   apex_tpu/ops/decode_attention.py:193). Block j of row r is rows
//   [j*128, j*128 + 128) of that row: the table lookup becomes r*nb + j.
// Both share the kernel body _decode_kernel (:56-146). Output
// (rows, group, d) in q's dtype.
//
// Bound on this card: HBM bytes. Every live K/V row is read once and each
// row costs 4*group*d operations against 2*2*d bytes (bf16), far below the
// ~295 operations per byte where an H100's tensor cores become the limit.
// At the serving slice's shapes (8 slots x 512 live rows x 8 kv heads x d
// 128, bf16) one layer reads 2*8*512*8*128*2 B = 16.8 MB: ~5 us at
// 3.35 TB/s; at the decode engine's (16 x 8 rows, ~640 live) 42 MB, ~12 us.
//
// Design, simple and right first:
// * one CTA (128 threads) per row. The CTA loops over ceil(len / bs)
//   blocks only: the Pallas grid's `j*bk < kvlen` skip (:99) becomes the
//   loop bound, and within the last block only the live rows are loaded,
//   scored and summed — columns >= len take no part, which is exactly the
//   reference's -1e30 mask (:124): exp(-1e30 - m) is 0 in fp32.
// * a block's live K and V rows are staged in shared memory (128 x 128
//   bf16 = 32 KB each) by cp.async 16-byte copies, all in flight at once:
//   V's copy overlaps the scores, and the next block's K copy overlaps this
//   block's softmax and PV product.
// * thread r scores row r of the block (bs <= 128) for the G query heads
//   of the kv group, reading K and q from shared memory in a rotated order
//   that keeps a warp's 32 reads in 32 banks. G is a template parameter
//   (1, 2, 4, 8, 16): loops over a runtime group count, guarded for up to
//   16 heads, took most of the first version's time.
// * the online softmax runs in fp32 with m starting at -1e30 and an fp32
//   accumulator; the block's max and sum are block-wide reductions, and
//   every thread keeps the running m and l. p is rounded to V's dtype
//   before the PV product (:137), l sums the unrounded p, and the output
//   divides by max(l, 1e-30), so a length-0 row comes out as zeros (:145).
// Known weakness, left for a later change: one CTA per row (64 paged rows
// at the serving slice's shapes, 128 contiguous rows at the decode
// engine's) on 132 SMs, each walking its blocks in turn. Split-K over the
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

// kPaged: block j of row `row` is pool row table[slot, j] * h_kv + kv head;
// otherwise (h_kv == 1, tables unused) it is block j of the row's own
// contiguous max_s strip, row * nb + j
template <typename T, int D, int G, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
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
  // a length past the row's nb blocks means every row of them is live
  const int len = min(lengths[slot], nb * bs);

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
  const int* trow = kPaged ? tables + static_cast<size_t>(slot) * nb : tables;
  auto pool_row = [&](int j) {
    return kPaged ? static_cast<size_t>(trow[j]) * h_kv + kvh
                  : static_cast<size_t>(row) * nb + j;
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

template <typename T, int D, int G, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tables, const void* lengths, void* out,
                   int rows, int h_kv, int bs, int nb, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T), D, bs, G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D, G, kPaged>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_kernel<T, D, G, kPaged><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), h_kv, bs, nb,
      scale);
  return cudaGetLastError();
}

template <typename T, int D, bool kPaged>
cudaError_t launch_group(int group, const void* q, const void* k,
                         const void* v, const void* tables,
                         const void* lengths, void* out, int rows, int h_kv,
                         int bs, int nb, float scale, cudaStream_t stream) {
#define APEX_GROUP_CASE(G)                                                  \
  case G:                                                                   \
    return launch<T, D, G, kPaged>(q, k, v, tables, lengths, out, rows,     \
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

template <bool kPaged>
int dispatch(int dtype, int d, int group, const void* q, const void* k,
             const void* v, const void* tables, const void* lengths,
             void* out, int rows, int h_kv, int bs, int nb, float scale,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == apex::kBFloat16) {
    err = d == 128 ? launch_group<__nv_bfloat16, 128, kPaged>(
                         group, q, k, v, tables, lengths, out, rows, h_kv,
                         bs, nb, scale, s)
                   : launch_group<__nv_bfloat16, 64, kPaged>(
                         group, q, k, v, tables, lengths, out, rows, h_kv,
                         bs, nb, scale, s);
  } else {
    err = d == 128 ? launch_group<float, 128, kPaged>(
                         group, q, k, v, tables, lengths, out, rows, h_kv,
                         bs, nb, scale, s)
                   : launch_group<float, 64, kPaged>(
                         group, q, k, v, tables, lengths, out, rows, h_kv,
                         bs, nb, scale, s);
  }
  return static_cast<int>(err);
}

bool bad_common(int dtype, int d) {
  return (d != 64 && d != 128) ||
         (dtype != apex::kFloat32 && dtype != apex::kBFloat16);
}

}  // namespace

extern "C" int apex_paged_decode_attn(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out,
                                      int dtype, int b, int h_kv, int group,
                                      int d, int bs, int nb, float scale,
                                      void* stream) {
  if (b < 1 || h_kv < 1 || bs < 1 || bs > kThreads || nb < 1 ||
      bad_common(dtype, d))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<true>(dtype, d, group, q, k_pool, v_pool, tables, lengths,
                        out, b * h_kv, h_kv, bs, nb, scale, stream);
}

// k, v (rows, max_s, d) with max_s a multiple of 128; lengths (rows,)
extern "C" int apex_decode_attn(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int dtype,
                                int rows, int group, int d, int max_s,
                                float scale, void* stream) {
  if (rows < 1 || max_s < kThreads || max_s % kThreads ||
      bad_common(dtype, d))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(dtype, d, group, q, k, v, nullptr, lengths, out,
                         rows, 1, kThreads, max_s / kThreads, scale, stream);
}
