// Launch parameters of the port's flash-attention kernels, the bucketed
// relative-bias lookup and the array bias they share.
//
// Addressing: a tensor of the bh-flat family is a (b, heads, s, d) view
// with element strides (b, h, r) and a unit feature stride, so the
// (b, h, s, d) views of a (b, s, h*d) projection output, a contiguous
// (b*h, s, d) tensor (heads = 1) and the packed q|k|v buffer are all one
// case. Row r = bi * heads + hi of q indexes lse and the bias (row r % hb
// of the table lookup or of the array bias); kv head = hi / (h / h_kv)
// within batch bi. kv_lens is read at bi * lens_b + hi * lens_h: per row
// (lens_b = heads, lens_h = 1) on the bh-flat layout, per batch (lens_b =
// 1, lens_h = 0) on the seq-major one, so the forward, the backward and
// the dbias kernel agree on a row's length under either.
//
// The array bias (apex_tpu/ops/attention.py:709-724): fp32 (hb, sq, sk),
// contiguous, added to the SCALED scores before the causal and kv_lens
// masks; row r reads bias row r % hb. Its gradient is the unscaled dS
// summed over the rows that share a bias row (flash_attn_dbias.cu).
//
// Dropout (drop.thresh > 0, the wgmma kernels only): the mask of q-head
// row r = bi * heads + hi (the row that indexes lse), query row, key
// column (dropout_hash.cuh).
//
// The bucketed T5 bias (apex_tpu/ops/pallas/attention.py:119-175,
// _rel_bias_block) depends only on the offset n = (k_off + col) -
// (q_off + row) clamped to [-maxd, maxd]: from max_distance on, every
// offset falls into its side's last bucket. So the kernels read a
// per-head lookup of 2*maxd + 1 fp32 values (lut), built once per call
// from the table by the host's integer-exact bucket function, and
// rel_off = k_off - q_off; the bias is the exact table value, as the
// reference's select-sum gives it. The bucket-table gradient sums the
// unscaled dS into the same offset bins, then into buckets through
// `bucket` (the clamped offset's bucket index).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

#include "dropout_hash.cuh"

namespace apex {

struct View {
  long long b, h, r;  // element strides of batch, head and row
};

// T: the 16-bit element type of q, k, v, o, do and the outputs -- bf16
// (FlashParams, every entry), or fp16 (the packed path's fp16 instances)
template <typename T>
struct FlashParamsT {
  const T *q, *k, *v;              // forward and backward inputs
  const T *o, *dout;               // backward inputs
  const float* lse;                // backward input (forward output)
  T* out;                          // forward output, or dq
  float* lse_out;                  // forward output
  T *dk, *dv;                      // dK/dV outputs
  float* dtab;                     // (hb, nb) fp32, zeroed before launch
  const int* kv_lens;              // see lens_b / lens_h, or null
  const float* bias;               // (hb, sq, sk) fp32 or null
  float* dbias;                    // (hb, sq, sk) fp32 dbias output
  float* delta;                    // (b*h, sq) fp32 rowsum(do * o): the
                                   // wgmma dQ kernel writes, dK/dV reads
  const float* lut;                // (hb, 2 * maxd + 1) or null
  const int* bucket;               // (2 * maxd + 1,) or null
  View q_v, kv_v, o_v, do_v, out_v, dkv_v;
  int sq, sk, h, h_kv, causal;
  float scale;
  int maxd, rel_off, hb, nb;  // hb: rows of the lookup or of the bias
  int lens_b, lens_h;         // kv_lens strides of batch and head
  int tiles;                  // the wgmma forward's (b*h, query tile)s
  int lut_rows;               // its lookup rows in shared memory: hb or 1
  DropParams drop;            // the probabilities' dropout (thresh 0: off);
                              // at fp16, drop.fault names the planted
                              // Fp16Fault whose instance the launch
                              // picks (flash_sm90.cuh)
};
using FlashParams = FlashParamsT<__nv_bfloat16>;

// rowsum(do * o) in fp32 over D elements of T (bf16 or fp16),
// THREADS_PER_ROW threads per row (neighbouring lanes), each reading
// D / THREADS_PER_ROW elements in 16-byte loads
template <int D, int THREADS_PER_ROW, typename T = __nv_bfloat16>
__device__ __forceinline__ float row_delta(const T* dorow, const T* orow,
                                           int part) {
  constexpr int kPer = D / THREADS_PER_ROW;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; i += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(dorow + part * kPer + i);
    const uint4 b = *reinterpret_cast<const uint4*>(orow + part * kPer + i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float2 x, y;
      if constexpr (std::is_same<T, __half>::value) {
        x = __half22float2(reinterpret_cast<const __half2*>(&a)[k]);
        y = __half22float2(reinterpret_cast<const __half2*>(&b)[k]);
      } else {
        x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&a)[k]);
        y = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&b)[k]);
      }
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int o = 1; o < THREADS_PER_ROW; o <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// a row's kv length, clamped to [0, sk]
__device__ __forceinline__ int kv_len(const int* __restrict__ lens, int bi,
                                      int hi, int lens_b, int lens_h,
                                      int sk) {
  return min(sk, max(lens[bi * lens_b + hi * lens_h], 0));
}

// the array bias at score (row, col) of q-head row r; 0 outside the
// (sq, sk) block (ragged tiles read nothing past the end)
__device__ __forceinline__ float bias_at(const float* __restrict__ bias,
                                         int r, int hb, int sq, int sk,
                                         int row, int col) {
  if (row >= sq || col >= sk) return 0.f;
  return __ldg(bias + (static_cast<size_t>(r % hb) * sq + row) * sk + col);
}

// the lookup index of score (row, col): the clamped offset, shifted >= 0
__device__ __forceinline__ int rel_index(int col, int row, int rel_off,
                                         int maxd) {
  const int n = col - row + rel_off;
  return min(max(n, -maxd), maxd) + maxd;
}

}  // namespace apex
