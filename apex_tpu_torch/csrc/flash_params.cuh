// Launch parameters of the port's flash-attention kernels, and the
// bucketed relative-bias lookup they share.
//
// Addressing: a tensor of the bh-flat family is a (b, heads, s, d) view
// with element strides (b, h, r) and a unit feature stride, so the
// (b, h, s, d) views of a (b, s, h*d) projection output, a contiguous
// (b*h, s, d) tensor (heads = 1) and the packed q|k|v buffer are all one
// case. Row r = bi * heads + hi of q indexes lse, kv_lens and the bias
// table (r % hb); kv head = hi / (h / h_kv) within batch bi.
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

namespace apex {

struct View {
  long long b, h, r;  // element strides of batch, head and row
};

struct FlashParams {
  const __nv_bfloat16 *q, *k, *v;  // forward and backward inputs
  const __nv_bfloat16 *o, *dout;   // backward inputs
  const float* lse;                // backward input (forward output)
  __nv_bfloat16* out;              // forward output, or dq
  float* lse_out;                  // forward output
  __nv_bfloat16 *dk, *dv;          // dK/dV outputs
  float* dtab;                     // (hb, nb) fp32, zeroed before launch
  const int* kv_lens;              // (b * h,) or null
  const float* lut;                // (hb, 2 * maxd + 1) or null
  const int* bucket;               // (2 * maxd + 1,) or null
  View q_v, kv_v, o_v, do_v, out_v, dkv_v;
  int sq, sk, h, h_kv, causal;
  float scale;
  int maxd, rel_off, hb, nb;
};

// the lookup index of score (row, col): the clamped offset, shifted >= 0
__device__ __forceinline__ int rel_index(int col, int row, int rel_off,
                                         int maxd) {
  const int n = col - row + rel_off;
  return min(max(n, -maxd), maxd) + maxd;
}

}  // namespace apex
