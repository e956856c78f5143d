// The counter-hash dropout mask shared by the flash kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu) and the elementwise dropout
// (dropout.cu): apex_tpu/ops/pallas/attention.py::dropout_keep (:56-86),
// bit for bit. keep(t, row, col) is a pure function of (seed, q-head row
// t, query row, key column): key = fmix(seed ^ t * 0x9E3779B9), row_key =
// fmix(key ^ row), keep iff (fmix(row_key ^ col) >> 8) >= thresh, with
// thresh = min(2^24, round(rate * 2^24)) computed on the host. It never
// depends on a tile, so the kernels' tiles need not match the TPU's, the
// backward rebuilds the forward's mask and a recompute under remat
// rebuilds it too; no mask is stored.
#pragma once

#include <cstdint>

namespace apex {

// murmur3's fmix32 (pallas/attention.py:56-63)
__host__ __device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// the key of q-head row t
__host__ __device__ __forceinline__ uint32_t drop_key(uint32_t seed,
                                                      uint32_t t) {
  return fmix32(seed ^ (t * 0x9E3779B9u));
}

// the key material of (q-head row, query row)
__host__ __device__ __forceinline__ uint32_t drop_row_key(uint32_t key,
                                                          uint32_t row) {
  return fmix32(key ^ row);
}

// keep (col) of the row whose key is row_key
__host__ __device__ __forceinline__ bool drop_keep(uint32_t row_key,
                                                   uint32_t col,
                                                   uint32_t thresh) {
  return (fmix32(row_key ^ col) >> 8) >= thresh;
}

// the flash kernels' dropout arguments: a 24-bit threshold > 0 turns it
// on; kept probabilities are scaled by `scale` = float32(1 / (1 - rate));
// `fault` plants one of the chip checks' faults (kDrop*)
struct DropParams {
  uint32_t seed;
  uint32_t thresh;
  float scale;
  int fault;
};

enum DropFault : int {
  kDropSound = 0,
  kDropKeyKvHead = 1,   // the key of the kv head's row, not the q head's
  kDropSwapRowCol = 2,  // the row and the column swapped in the hash
  kDropNoDkvDsMask = 3, // dK/dV: dS without the mask (dV keeps it)
  kDropLFromDropped = 4 // forward: l summed from the dropped p
};

// keep of (row, col): from the row's key row_key, or (kSwap, the planted
// fault) with the row and the column swapped
template <bool kSwap>
__device__ __forceinline__ bool drop_keep_at(uint32_t key, uint32_t row_key,
                                             uint32_t row, uint32_t col,
                                             uint32_t thresh) {
  return kSwap ? drop_keep(drop_row_key(key, col), row, thresh)
               : drop_keep(row_key, col, thresh);
}

}  // namespace apex
