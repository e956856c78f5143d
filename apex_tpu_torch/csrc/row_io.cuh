// Row loads and stores shared by the row-wise kernels (layer norm,
// softmax): one warp owns one row, and lane l holds the 16-byte chunks
// l, l + 32, l + 64, ... of it, converted to fp32 in registers.
//
// A chunk is kVec = 16 / sizeof(T) elements. With `vec` set (the row
// length a multiple of kVec and the base pointer 16-byte aligned, so every
// row starts aligned) a chunk is one 16-byte access; otherwise the same
// elements move one by one. Elements at or past the row length n load as
// `fill` and are never stored.
#pragma once

#include <cstdint>

#include "apex_cuda.cuh"

namespace apex {

template <typename T>
struct Chunk {
  static constexpr int kVec = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int i,
                                           int n, bool vec, float fill,
                                           float* v) {
  constexpr int V = Chunk<T>::kVec;
  if (vec && i + V <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_float(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = i + k < n ? to_float(row[i + k]) : fill;
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int i, int n,
                                            bool vec, const float* v) {
  constexpr int V = Chunk<T>::kVec;
  if (vec && i + V <= n) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) e[k] = from_float<T>(v[k]);
    *reinterpret_cast<uint4*>(row + i) = raw;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (i + k < n) row[i + k] = from_float<T>(v[k]);
  }
}

}  // namespace apex
