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
#include <type_traits>

#include "apex_cuda.cuh"

namespace apex {

template <typename T>
struct Chunk {
  static constexpr int kVec = 16 / sizeof(T);
};

// the V elements of a chunk held as 16 raw bytes, in fp32 (bf16 pairs by
// shifts, fp16 pairs by the conversion instruction)
template <typename T>
__device__ __forceinline__ void unpack_chunk(const uint4& raw, float* v) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2* u = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __half22float2(u[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else if constexpr (sizeof(T) == 2) {
    const uint32_t* u = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(u[k] << 16);
      v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  } else {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
}

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
