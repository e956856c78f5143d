// The pieces the port's wgmma/TMA flash-attention kernels share: the
// forward (flash_attn_fwd.cu), the backward pair (flash_attn_bwd.cu) and
// the array bias's gradient (flash_attn_dbias.cu).
//
// Operands are (batch, head, row)-strided bf16 (or, in the fp16 instances
// of the packed path, fp16) views with a unit feature
// stride (flash_params.cuh), each read through one 4-D TMA map (d, row,
// head, batch) in 64-row x 64-feature boxes with the 128-byte swizzle (d
// 128 is two boxes across). A tile of `rows` rows lies in shared memory as
// D / 64 column blocks of `rows` rows of 128 bytes; wgmma reads it through
// a K-major descriptor (the tile is the product's K-contiguous operand) or
// an MN-major one (its rows are the product's K index). A map's row extent
// is sq or sk, so TMA reads zeros past the end of a head and never the
// next head's rows.
//
// The array bias (fp32 (hb, sq, sk)) is staged as a (query rows x key
// columns) block in 64-row x 32-column boxes with the same swizzle: by TMA
// through a 3-D (sk, sq, hb) map where one describes it (sk a multiple of
// 4, a 16-byte aligned base), else by cp.async of the producer warpgroup.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "apex_mma.cuh"
#include "apex_sm90.cuh"
#include "flash_params.cuh"

namespace apex {
namespace flash_sm90 {

using namespace apex::sm90;

constexpr int kBox = 64 * 64 * 2;      // a 64-row x 64-feature bf16 box
constexpr int kBiasBox = 64 * 32 * 4;  // a 64-row x 32-column fp32 box
constexpr float kLog2e = 1.4426950408889634f;

enum BiasKind : int { kNone = 0, kRel = 1, kArr = 2 };

// element (row, col) of a staged fp32 bias block: 64 x 32 boxes, COLS / 32
// of them across, each 64 rows of 128 bytes with 16-byte chunk c of row r
// at c ^ (r % 8) (TMA's 128-byte swizzle)
template <int COLS>
__device__ __forceinline__ int bias_offset(int row, int col) {
  const int box = (row >> 6) * (COLS / 32) + (col >> 5);
  const int r = row & 63, c = col & 31;
  return box * (kBiasBox / 4) + r * 32 +
         ((((c >> 2) ^ (r & 7)) << 2) | (c & 3));
}

// the TMA boxes of a ROWS x COLS bias block (query rows from q0, key
// columns from c0 of bias row `brow`) into the staged layout, counted on
// `bar`; one thread
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_bias_tma(uint32_t dst,
                                               const CUtensorMap* tm,
                                               int brow, int q0, int c0,
                                               uint32_t bar) {
  for (int i = 0; i < ROWS / 64; ++i)
    for (int j = 0; j < COLS / 32; ++j)
      tma_load_3d(dst + (i * (COLS / 32) + j) * kBiasBox, tm, c0 + 32 * j,
                  q0 + 64 * i, brow, bar);
}

// the same block for a bias no tensor map describes, by cp.async of the
// producer warpgroup's 128 threads: 8 bytes (two columns) where the
// rows' starts allow it, else 4; complete when this returns. Only the
// entries inside (sq, sk) are copied: the consumers mask the others out
// by a select, whatever the staged value
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_bias_copy(uint32_t dst,
                                                const float* bias, int brow,
                                                int q0, int c0, int sq,
                                                int sk, int tid) {
  const float* base = bias + static_cast<size_t>(brow) * sq * sk;
  const int rows = min(ROWS, sq - q0), cols = min(COLS, sk - c0);
  const bool pairs =
      (sk & 1) == 0 && (reinterpret_cast<uintptr_t>(bias) & 7) == 0;
  const int per_row = pairs ? (cols + 1) / 2 : cols;
  for (int e = tid; e < rows * per_row; e += 128) {
    const int r = e / per_row;
    const int c = pairs ? 2 * (e - r * per_row) : e - r * per_row;
    const float* src = base + static_cast<size_t>(q0 + r) * sk + c0 + c;
    const uint32_t at = dst + 4 * bias_offset<COLS>(r, c);
    if (pairs && c + 1 < cols)
      cp_async_8(at, src);
    else
      cp_async_4(at, src);
  }
  cp_async_wait_all();
}

// rows x D bf16 at (row0, head, batch) of a (d, row, head, batch) map, in
// 64 x 64 boxes: D / 64 column blocks of `rows` rows (128 bytes a row)
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* tm,
                                          int rows, int row0, int head,
                                          int bi, uint32_t bar) {
  for (int c = 0; c < D / 64; ++c)
    for (int i = 0; i < rows / 64; ++i)
      tma_load_4d(dst + c * rows * 128 + i * kBox, tm, c * 64, row0 + 64 * i,
                  head, bi, bar);
}

// K-major operand of `rows` rows in 64-feature column blocks: the
// descriptor of its k-th 16-deep slice, `row0` rows in (a multiple of 8)
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int k,
                                           int row0) {
  return wgmma_desc(tile + (k >> 2) * rows * 128 + row0 * 128 + (k & 3) * 32,
                    16, 1024);
}

// MN-major operand (its K rows contiguous, 128 bytes each; the N features
// in 64-wide column blocks `lbo` bytes apart): the descriptor of its k-th
// 16-deep slice
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int k,
                                            uint32_t lbo) {
  return wgmma_desc(tile + k * 2048, lbo, 1024);
}

// how a stage reads the bucketed bias's lookup: per score through the
// clamped offset; one value (every offset clamps to one end); or, where no
// offset clamps, at a fixed distance from a per-thread row of it
template <int M>
using LutMode = std::integral_constant<int, M>;
constexpr int kLutClamp = 0, kLutOne = 1, kLutRow = 2;

// 2^x (the MUFU's approximation, relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// d (64 x N) = A B (scale_d 0) or += (1), both T from shared memory,
// K-major
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 128)
    wgmma_m64n128k16_ss<0, 0, T>(d, da, db, scale_d);
  else
    wgmma_m64n64k16_ss<0, 0, T>(d, da, db, scale_d);
}

// d (64 x N) += A (64 x 16 from registers) B (16 x N, MN-major), both T
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 128)
    wgmma_m64n128k16_rs<1, T>(d, a, db);
  else
    wgmma_m64n64k16_rs<1, T>(d, a, db);
}

// The fp16 instances' planted faults, by the code the entries take in
// FlashParams::drop.fault and the launch turns into an instance of its own
// (a runtime branch in the inner loop cost the sound instance 5-10%): P
// and dS rounded through bf16 before the fp16 operand, or every output
// clamped to +-65504
enum Fp16Fault : int { kF16Sound = 0, kF16Bf16P = 16, kF16Satfinite = 17 };

// the T operand fragment of an accumulator slice (wgmma_a_frag); the fp16
// kF16Bf16P instance rounds it through bf16 first
template <typename T, int kFault, int N>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const float (&d)[N],
                                       int k) {
  if constexpr (std::is_same<T, __half>::value && kFault == kF16Bf16P) {
    float r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      r[i] = __bfloat162float(__float2bfloat16_rn(d[8 * k + i]));
    wgmma_a_frag<8, T>(a, r, 0);
  } else {
    wgmma_a_frag<N, T>(a, d, k);
  }
}

// a pair of outputs as T; the fp16 kF16Satfinite instance clamps them to
// +-65504 first (so an overflow is not inf, and a nan is a number)
template <typename T, int kFault>
__device__ __forceinline__ uint32_t out_pair(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value && kFault == kF16Satfinite) {
    lo = fminf(fmaxf(lo, -65504.f), 65504.f);
    hi = fminf(fmaxf(hi, -65504.f), 65504.f);
  }
  return apex::pack2<T>(lo, hi);
}

// --- host -----------------------------------------------------------------

// a (d, row, head, batch) map of a strided view of T (bf16 or fp16)
template <typename T = __nv_bfloat16>
inline bool view_map(CUtensorMap* map, const void* base, const View& v, int d,
                     int rows, int heads, int batch) {
  const long long dims[4] = {d, rows, heads, batch};
  const long long strides[3] = {v.r * 2, v.h * 2, v.b * 2};
  const int box[4] = {64, 64, 1, 1};
  return make_tensor_map(map,
                         std::is_same<T, __half>::value
                             ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         4, base, dims, strides, box,
                         CU_TENSOR_MAP_SWIZZLE_128B);
}

// the (sk, sq, hb) fp32 map of the array bias, 32-column x 64-row boxes
inline bool bias_map(CUtensorMap* map, const float* bias, int sq, int sk,
                     int hb) {
  const long long dims[3] = {sk, sq, hb};
  const long long strides[2] = {4LL * sk, 4LL * sk * sq};
  const int box[3] = {32, 64, 1};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, bias, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace flash_sm90
}  // namespace apex
