// Tensor-core and async-copy building blocks of the port's attention and
// GEMM kernels (sm_80+ instructions, built for sm_90a): bf16 mma.sync with
// fp32 accumulation, ldmatrix, cp.async with zero-fill, and the tile
// loader that reads one head's d-wide window out of a (rows, features)
// buffer.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..2t+1],
//                           a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, "col"):      b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32):       c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// so two neighbouring C tiles of a 16 x 16 score block, rounded to bf16,
// are exactly the A fragment of the next product (no shuffle needed).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace apex {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&v);
}

// two fp32 values as a pair of T (bf16 or fp16), rounded to nearest: an
// fp16 past its range becomes inf, never a saturated 65504
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b on the tensor cores: bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8 x 8 b16 matrices from shared memory; lane L supplies
// the address of row (L % 8) of matrix (L / 8)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// four 8 x 8 b16 matrices from shared memory, not transposed; lane L
// supplies the address of row (L % 8) of matrix (L / 8)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// 16-byte global -> shared copy of the first `bytes` (0..16) source bytes;
// the rest of the destination is zero-filled
__device__ __forceinline__ void cp_async_16_bytes(void* smem, const void* gmem,
                                                  int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes)
               : "memory");
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async_16_zfill(void* smem, const void* gmem,
                                                  bool valid) {
  cp_async_16_bytes(smem, gmem, valid ? 16 : 0);
}

// 4- or 8-byte global -> shared copy (both addresses aligned to it)
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem,
                                               int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// Stage ROWS rows, starting at row0, of a D-wide bf16 window into a
// [ROWS][D + 8] shared tile (the 8-element pad puts the 8 rows an ldmatrix
// or fragment load touches in 8 distinct bank groups). `src` points at
// the window's first element of row 0; `stride` is the row stride in
// elements. Rows at or past `s` are zero-filled: no garbage (or NaN) ever
// meets a masked probability of 0.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0, int s) {
  constexpr int kLd = D + 8;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int row = row0 + r;
    const bool ok = row < s;
    cp_async_16_zfill(dst + r * kLd + c * 8,
                      src + static_cast<size_t>(ok ? row : 0) * stride + c * 8,
                      ok);
  }
}

}  // namespace apex
