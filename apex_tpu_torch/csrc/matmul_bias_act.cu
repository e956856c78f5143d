// GEMM with the bias + activation epilogue fused, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/matmul.py::matmul_bias_act (:100; body
// _matmul_kernel :36). Same contract: out = act(x @ w + b) with x (M, K),
// w (K, N), b (N,) or none; the product accumulates in fp32, the epilogue
// adds the bias in fp32, applies none, gelu (tanh approximation), relu or
// sigmoid (_apply_act, :24-33), and casts once to the output dtype —
// the Pallas kernel's rounding points (:45-50). It computes what that
// kernel computes, not its block structure: the reference pads M, N and
// K to its blocks (:75-83); this kernel masks its own edges and pads
// nothing.
//
// Operands by strides. x is read as A (M, K) and w as B (K, N), each with
// a compile-time flag for its contiguous axis, so the three products of
// the fused-dense and MLP paths read views, never copies:
//   forward  y  = x @ weight^T   A K-contiguous, B K-contiguous
//   dgrad    dx = dy @ weight    A K-contiguous, B N-contiguous
//   wgrad    dW = dy^T @ x       A M-contiguous, B N-contiguous
// (weight is torch.nn.Linear's (out, in)). The epilogue's bias and
// activation are compile-time options of the forward layout only; the
// other layouts run without either, which is all the call sites ask.
//
// Bound on this card at the path's shapes. Operations, for the block's
// and the MLP's 1024-wide products: GPT-medium's dense-GELU-dense block
// over 20 x 1024 tokens runs six products of 2 * 20480 * 1024 * 4096 =
// 171.8 GFLOP (0.174 ms each at 989 TFLOP/s dense bf16) against 126-210
// MB moved (0.04-0.06 ms at 3.35 TB/s); the MLP leg's 1024 x 1024 layer
// 68.7 GFLOP per product (0.069 ms). Bytes, for the calls with an
// extent of 1: the 256 -> 1 layer's forward and dgrad and its 1 x 256
// weight gradient read or write 16.8 MB (0.005 ms at 3.35 TB/s) for 17
// MFLOP. Around 300 operations per byte the product is tensor-core
// bound, and the epilogue's bias and activation ride free in registers.
//
// Design (the "wgmma" variant, the path's): a 128 x 128 output tile per
// work unit, one persistent CTA of three warpgroups per SM walking units
// i, i + gridDim.x, ... (tiles in bands of 8 row tiles, column by column,
// where a row of tiles is 16 or more wide or K is split; else row by
// row). One producer thread keeps a ring of 5 shared
// stages filled across units: per 64-deep K step one TMA box of each
// K-major operand (64 x 128) or two of an MN-major one (64 x 64 each),
// written with the 128-byte swizzle, each stage with a full and an empty
// mbarrier; the producer warpgroup hands its registers to the consumers
// (setmaxnreg). Two consumer warpgroups, each on 64 rows of the tile,
// issue wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulators) straight
// from the stages through descriptors, keep one K step of wgmma in
// flight, and release a stage when its wgmma has retired. The operand
// layouts are the tensor maps' and descriptors' business — the inner
// dimension of each map is the operand's contiguous axis, and the wgmma
// transpose bit marks an MN-major operand — so the four (A, B) major
// pairs run one body and nothing is copied. Ragged M, N and K edges: TMA
// reads zeros past each extent (K = 480, N = 1, M = 1 need nothing more).
// The epilogue works on the accumulator fragments in registers (the bias
// read into registers before the K walk): a bf16 output whose rows are
// 16-byte aligned is written into a swizzled shared tile per warpgroup
// and stored by TMA, which clips the M and N edges, while the producer
// already loads the next unit; any other output is stored fragment by
// fragment with guards. Each output is written once.
// Split-K, for calls whose output tiles leave most SMs idle (the MLP's
// weight gradients: 2-64 tiles over K = 32768): the wrapper picks S, a
// work unit is a tile's K slice [z * per, (z + 1) * per) and writes an
// fp32 partial tile to a workspace (S, M, N) that the wrapper allocates;
// a second launch sums the S partials in slice order and applies the
// epilogue (the bias in fp32, the activation, one cast). No atomics: the
// result is bit-identical from run to run.
//
// The "sm80" variant, the kernel's first body, unchanged: for operands
// no tensor map can describe — a base off 16 bytes, or a row stride that
// is no multiple of 8 elements (TMA's rules) — which no call of the
// block or MLP leg passes. A 128 x 128 output tile per CTA of 8 warps
// (each 64 x 32), K in steps of 32 through a double-buffered cp.async
// pipeline into padded shared tiles stored along each operand's
// contiguous axis;
// ldmatrix (.trans where the layout needs it) feeds mma.sync.m16n8k16
// bf16 with fp32 accumulators; the same epilogue. Ragged edges: a 16-byte
// chunk that crosses the K (or M, N) edge copies only its valid bytes and
// zero-fills the rest; a chunk past the edge copies nothing. An operand
// whose 16-byte chunks are not aligned takes a predicated
// element-by-element loader, chosen at launch per operand. The wrapper
// counts an axis of extent 1 as contiguous and prefers an aligned layout,
// so the N = 1 layer's (M, 1) operands are read along M in 16-byte chunks.
// The wrapper picks the variant from the operands' strides; nothing
// retries a failed launch on the other.
//
// fp32 operands take an exact-FFMA kernel (no TF32): 64 x 64 tiles, K in
// steps of 16, each thread a 4 x 4 block of serial fp32 dot products,
// operands by runtime strides, the same epilogue. It is right, not fast.
//
// Entry: apex_matmul_bias_act.
#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"
#include "apex_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kPad = 8;        // elements added to each shared row

enum Act : int { kNone = 0, kGelu = 1, kRelu = 2, kSigmoid = 3 };

struct MmParams {
  const void* a;
  const void* b;
  const void* bias;
  void* c;
  long long lda, ldb, ldc;
  int M, N, K;
  int a_k, b_k;  // A K-contiguous (else M-), B K-contiguous (else N-)
  int a_vec, b_vec, bias_f32, out_f32;
  float* ws;       // split-K: the (S, M, N) fp32 partials
  int kt_split;    // split-K: 64-deep K steps per slice
  int group_m;     // wgmma: row tiles per band of the tile order
};

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  } else if constexpr (ACT == kRelu) {
    return x < 0.f ? 0.f : x;
  } else if constexpr (ACT == kSigmoid) {
    return 1.f / (1.f + expf(-x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float load_bias(const MmParams& p, int col) {
  if (col >= p.N) return 0.f;
  return p.bias_f32 ? static_cast<const float*>(p.bias)[col]
                    : __bfloat162float(static_cast<const bf16*>(p.bias)[col]);
}

// out[row][col] (and [col + 1] when `two`) from fp32 values: one cast
__device__ __forceinline__ void store(const MmParams& p, int row, int col,
                                      float v0, float v1, bool two) {
  if (row >= p.M || col >= p.N) return;
  const long long off = row * p.ldc + col;
  const bool pair = two && col + 1 < p.N && (off & 1) == 0;
  if (p.out_f32) {
    float* o = static_cast<float*>(p.c) + off;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (two && col + 1 < p.N) o[1] = v1;
    }
  } else {
    bf16* o = static_cast<bf16*>(p.c) + off;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      o[0] = __float2bfloat16_rn(v0);
      if (two && col + 1 < p.N) o[1] = __float2bfloat16_rn(v1);
    }
  }
}

// One operand tile of OUTER x INNER elements, INNER along the operand's
// contiguous axis, into a [OUTER][INNER + kPad] shared tile: element
// (o, i) of the tile is src[(o0 + o) * ld + i0 + i], zero past o_lim or
// i_lim. `vec`: 16-byte cp.async chunks (the tail chunk copies its valid
// bytes only); else element by element, synchronously.
template <int OUTER, int INNER>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long ld, int o0, int i0,
                                          int o_lim, int i_lim, bool vec) {
  constexpr int kLd = INNER + kPad;
  if (vec) {
    constexpr int kChunks = INNER / 8;
    static_assert(OUTER * kChunks % kThreads == 0, "tile/thread mismatch");
#pragma unroll
    for (int j = 0; j < OUTER * kChunks / kThreads; ++j) {
      const int c = threadIdx.x + j * kThreads;
      const int o = c / kChunks;
      const int i = (c - o * kChunks) * 8;
      const int go = o0 + o, gi = i0 + i;
      int bytes = 0;
      if (go < o_lim && gi < i_lim) bytes = min(16, 2 * (i_lim - gi));
      apex::cp_async_16_bytes(dst + o * kLd + i,
                              bytes ? src + go * ld + gi : src, bytes);
    }
  } else {
    static_assert(OUTER * INNER % kThreads == 0, "tile/thread mismatch");
#pragma unroll 4
    for (int j = 0; j < OUTER * INNER / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int o = e / INNER;
      const int i = e - o * INNER;
      const int go = o0 + o, gi = i0 + i;
      dst[o * kLd + i] = (go < o_lim && gi < i_lim)
                             ? src[go * ld + gi]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

template <bool A_K, bool B_K, bool BIAS, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
    matmul_bias_act_bf16(const MmParams p) {
  constexpr int kATile = A_K ? kBM * (kBK + kPad) : kBK * (kBM + kPad);
  constexpr int kBTile = B_K ? kBN * (kBK + kPad) : kBK * (kBN + kPad);
  __shared__ __align__(16) unsigned char smem[2 * (kATile + kBTile) * 2];
  bf16* const sA = reinterpret_cast<bf16*>(smem);  // [2][kATile]
  bf16* const sB = sA + 2 * kATile;                 // [2][kBTile]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const bf16* __restrict__ A = static_cast<const bf16*>(p.a);
  const bf16* __restrict__ B = static_cast<const bf16*>(p.b);
  const int KT = (p.K + kBK - 1) / kBK;

  auto load = [&](int s, int kt) {
    const int k0 = kt * kBK;
    bf16* const a = sA + s * kATile;
    bf16* const b = sB + s * kBTile;
    if constexpr (A_K)
      load_tile<kBM, kBK>(a, A, p.lda, m0, k0, p.M, p.K, p.a_vec);
    else
      load_tile<kBK, kBM>(a, A, p.lda, k0, m0, p.K, p.M, p.a_vec);
    if constexpr (B_K)
      load_tile<kBN, kBK>(b, B, p.ldb, n0, k0, p.N, p.K, p.b_vec);
    else
      load_tile<kBK, kBN>(b, B, p.ldb, k0, n0, p.K, p.N, p.b_vec);
    apex::cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  // lane L addresses row (L % 8) of ldmatrix matrix (L / 8)
  const int lr = lane & 7, lm = lane >> 3;
  if (KT > 0) load(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < KT) {
      load(s ^ 1, kt + 1);
      apex::cp_async_wait<1>();
    } else {
      apex::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* const a = sA + s * kATile;
    const bf16* const b = sB + s * kBTile;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm * 64 + mi * 16 + (lm & 1) * 8;
        const int k = ks * 16 + (lm >> 1) * 8;
        if constexpr (A_K)
          apex::ldmatrix_x4(af[mi], a + (m + lr) * (kBK + kPad) + k);
        else
          apex::ldmatrix_x4_trans(af[mi], a + (k + lr) * (kBM + kPad) + m);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        const int n = wn * 32 + np * 16 + (lm >> 1) * 8;
        const int k = ks * 16 + (lm & 1) * 8;
        if constexpr (B_K)
          apex::ldmatrix_x4(r, b + (n + lr) * (kBK + kPad) + k);
        else
          apex::ldmatrix_x4_trans(r, b + (k + lr) * (kBN + kPad) + n);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          apex::mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
    __syncthreads();
  }

  // epilogue on the accumulators: c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][..]
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (BIAS) {
      b0 = load_bias(p, col);
      b1 = load_bias(p, col + 1);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + g + 8 * h;
        store(p, row, col, activate<ACT>(acc[mi][ni][2 * h] + b0),
              activate<ACT>(acc[mi][ni][2 * h + 1] + b1), true);
      }
  }
}

// fp32 operands: exact FFMA, no tensor cores
constexpr int kFM = 64, kFN = 64, kFK = 16;

template <bool BIAS, int ACT>
__global__ void __launch_bounds__(kThreads)
    matmul_bias_act_f32(const MmParams p) {
  __shared__ float sA[kFK][kFM + 4];
  __shared__ float sB[kFK][kFN + 4];
  const float* __restrict__ A = static_cast<const float*>(p.a);
  const float* __restrict__ B = static_cast<const float*>(p.b);
  // A(m, k) = A[m * sam + k * sak], B(k, n) = B[k * sbk + n * sbn]
  const long long sam = p.a_k ? p.lda : 1, sak = p.a_k ? 1 : p.lda;
  const long long sbk = p.b_k ? 1 : p.ldb, sbn = p.b_k ? p.ldb : 1;
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += kFK) {
    // consecutive threads walk each operand's contiguous axis
#pragma unroll
    for (int j = 0; j < kFM * kFK / kThreads; ++j) {
      const int e = tid + j * kThreads;
      const int m = p.a_k ? e / kFK : e % kFM;
      const int k = p.a_k ? e % kFK : e / kFM;
      const int gm = m0 + m, gk = k0 + k;
      sA[k][m] = (gm < p.M && gk < p.K) ? A[gm * sam + gk * sak] : 0.f;
      const int n = p.b_k ? e / kFK : e % kFN;
      const int kb = p.b_k ? e % kFK : e / kFN;
      const int gn = n0 + n, gkb = k0 + kb;
      sB[kb][n] = (gn < p.N && gkb < p.K) ? B[gkb * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sA[kk][ty * 4 + i];
        b[i] = sB[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    const float bj = BIAS ? load_bias(p, col) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      store(p, m0 + ty * 4 + i, col, activate<ACT>(acc[i][j] + bj), 0.f,
            false);
  }
}

// --- the wgmma variant ------------------------------------------------------

constexpr int kWM = 128, kWN = 128, kWK = 64;  // CTA tile, K step
constexpr int kStages = 5;
// the tile order's bands: 8 row tiles when a row of tiles is at least
// 16 wide or K is split, else 1, row by row. Bands let the CTAs in flight
// share a wide B in the L2; where B is narrow it already stays there, and
// the row order keeps each CTA's output writes together.
constexpr int kGroupM = 8, kGroupMinTilesN = 16;
constexpr int kWThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kBoxBytes = 64 * 64 * 2;        // one 64 x 64 bf16 box
constexpr int kATileBytes = kWM * kWK * 2;    // 16 KB
constexpr int kBTileBytes = kWN * kWK * 2;    // 16 KB
constexpr int kStageBytes = kATileBytes + kBTileBytes;
// a consumer warpgroup's bf16 output tile (64 x 128: two swizzled 64 x 64
// boxes) staged for the TMA store
constexpr int kOutBytes = 2 * kBoxBytes;
// the ring, the two output tiles, 1 KB of slack to align them to the
// swizzle's 1024 bytes, and a full and an empty mbarrier per stage
constexpr int kWSmem =
    kStages * kStageBytes + 2 * kOutBytes + 1024 + 2 * kStages * 8;

// the fp32 partials at (row, col) and (row, col + 1) of split-K slice z
__device__ __forceinline__ void store_partial(const MmParams& p, int z,
                                              int row, int col, float v0,
                                              float v1) {
  if (row >= p.M || col >= p.N) return;
  const long long off = (static_cast<long long>(z) * p.M + row) * p.N + col;
  float* o = p.ws + off;
  if (col + 1 < p.N && (off & 1) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    if (col + 1 < p.N) o[1] = v1;
  }
}

// A is K-major when A_K (else M-major), B K-major when B_K (else
// N-major); SPLIT: write fp32 partials, one K slice per work unit.
// Persistent: CTA i takes work units i, i + gridDim.x, ... (unit u is
// output tile u / S, K slice u % S), so the producer loads the next
// unit's first stages while the consumers run this one's epilogue.
// tma_out: a bf16 output whose rows a tensor map describes (tmc), stored
// through shared memory by TMA; else each thread stores its fragment.
template <bool A_K, bool B_K, bool BIAS, int ACT, bool SPLIT>
__global__ void __launch_bounds__(kWThreads, 1)
    matmul_wgmma(const __grid_constant__ CUtensorMap tma,
                 const __grid_constant__ CUtensorMap tmb,
                 const __grid_constant__ CUtensorMap tmc, const MmParams p,
                 int split, int tma_out) {
  using namespace apex::sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t out_tiles = ring + kStages * kStageBytes;
  const uint32_t bars = out_tiles + 2 * kOutBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int tiles_n = (p.N + kWN - 1) / kWN;
  const int tiles_m = (p.M + kWM - 1) / kWM;
  const int units = tiles_n * tiles_m * split;
  const int KT = (p.K + kWK - 1) / kWK;
  // unit u: its tile's origin and its K steps [kt0, kt1). Tiles run in
  // bands of group_m row tiles, column by column within a band, so the
  // CTAs in flight share both operands' tiles in the L2
  auto unit = [&](int u, int& m0, int& n0, int& kt0, int& kt1) {
    const int tile = u / split, z = u - tile * split;
    const int band = tile / (p.group_m * tiles_n);
    const int first = band * p.group_m;
    const int rows = min(p.group_m, tiles_m - first);
    const int in_band = tile - band * p.group_m * tiles_n;
    m0 = (first + in_band % rows) * kWM;
    n0 = in_band / rows * kWN;
    kt0 = SPLIT ? z * p.kt_split : 0;
    kt1 = SPLIT ? min(KT, kt0 + p.kt_split) : KT;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (tid == 0) {
      tma_prefetch(&tma);
      tma_prefetch(&tmb);
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0, kt0, kt1;
        unit(u, m0, n0, kt0, kt1);
        for (int kt = kt0; kt < kt1; ++kt) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), kStageBytes);
          const uint32_t a = ring + stage * kStageBytes, b = a + kATileBytes;
          const int k = kt * kWK;
          if constexpr (A_K) {
            tma_load_2d(a, &tma, k, m0, full(stage));
          } else {
            tma_load_2d(a, &tma, m0, k, full(stage));
            tma_load_2d(a + kBoxBytes, &tma, m0 + 64, k, full(stage));
          }
          if constexpr (B_K) {
            tma_load_2d(b, &tmb, k, n0, full(stage));
          } else {
            tma_load_2d(b, &tmb, n0, k, full(stage));
            tma_load_2d(b + kBoxBytes, &tmb, n0 + 64, k, full(stage));
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // this warpgroup's 64 rows of the tile
    const int lane = tid & 31, warp = tid >> 5;
    // K-major: 32 bytes per 16-deep slice along a 128-byte row; MN-major:
    // 16 rows of 128 bytes per slice, the two 64-wide boxes 8 KB apart
    constexpr uint32_t kAStep = A_K ? 32 : 2048, kBStep = B_K ? 32 : 2048;
    constexpr uint32_t kALbo = A_K ? 16 : kBoxBytes;
    constexpr uint32_t kBLbo = B_K ? 16 : kBoxBytes;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t out = out_tiles + cw * kOutBytes;
    int stage = 0;
    uint32_t phase = 0;
    float acc[64];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int m0, n0, kt0, kt1;
      unit(u, m0, n0, kt0, kt1);
      // the bias of this thread's 32 columns, read before the K walk (the
      // output stores may alias it, so it cannot move past them)
      float bias[32];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        bias[2 * i] = BIAS ? load_bias(p, n0 + i * 8 + 2 * t) : 0.f;
        bias[2 * i + 1] = BIAS ? load_bias(p, n0 + i * 8 + 2 * t + 1) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(full(stage), phase);
        // both layouts put this warpgroup's 64 rows 8 KB into the A tile
        const uint32_t a = ring + stage * kStageBytes + cw * kBoxBytes;
        const uint32_t b = ring + stage * kStageBytes + kATileBytes;
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kWK / 16; ++j)
          wgmma_m64n128k16_ss<A_K ? 0 : 1, B_K ? 0 : 1>(
              acc, wgmma_desc(a + j * kAStep, kALbo, 1024),
              wgmma_desc(b + j * kBStep, kBLbo, 1024), 1);
        wgmma_commit();
        fence_operand(acc);
        wgmma_wait<1>();  // the previous step's wgmma has read its stage
        if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operand(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(empty(prev));

      const int row = m0 + cw * 64 + warp * 16 + g;
      if (SPLIT || !tma_out) {
        const int z = SPLIT ? u % split : 0;
#pragma unroll
        for (int i = 0; i < kWN / 8; ++i) {
          const int col = n0 + i * 8 + 2 * t;
          if constexpr (SPLIT) {
            store_partial(p, z, row, col, acc[4 * i], acc[4 * i + 1]);
            store_partial(p, z, row + 8, col, acc[4 * i + 2],
                          acc[4 * i + 3]);
          } else {
            const float b0 = bias[2 * i], b1 = bias[2 * i + 1];
            store(p, row, col, activate<ACT>(acc[4 * i] + b0),
                  activate<ACT>(acc[4 * i + 1] + b1), true);
            store(p, row + 8, col, activate<ACT>(acc[4 * i + 2] + b0),
                  activate<ACT>(acc[4 * i + 3] + b1), true);
          }
        }
      } else {
        // the epilogue into this warpgroup's staged tile, in the TMA's
        // 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8): the
        // 8 rows a store instruction touches fall in 8 bank groups), once
        // the previous tile's store has read it
        if (tid == 0) bulk_wait_read();
        named_barrier(1 + cw, 128);
#pragma unroll
        for (int i = 0; i < kWN / 8; ++i) {
          const float b0 = bias[2 * i], b1 = bias[2 * i + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = warp * 16 + g + 8 * h;
            const uint32_t at = out + (i >> 3) * kBoxBytes + r * 128 +
                                (((i & 7) ^ (r & 7)) << 4) + t * 4;
            st_shared_u32(at, apex::pack_bf16(
                                  activate<ACT>(acc[4 * i + 2 * h] + b0),
                                  activate<ACT>(acc[4 * i + 2 * h + 1] +
                                                b1)));
          }
        }
        fence_proxy_async();
        named_barrier(1 + cw, 128);
        const int r0 = m0 + cw * 64;
        if (tid == 0 && r0 < p.M) {
          tma_store_2d(&tmc, out, n0, r0);
          if (n0 + 64 < p.N) tma_store_2d(&tmc, out + kBoxBytes, n0 + 64, r0);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait();
  }
}

// split-K's second pass: out = act(sum of the S partials, in slice order,
// + bias), one cast
template <int ACT>
__global__ void __launch_bounds__(256)
    splitk_reduce(const MmParams p, int S) {
  const long long mn = static_cast<long long>(p.M) * p.N;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * 256) {
    float v = p.ws[i];
    for (int z = 1; z < S; ++z) v += p.ws[z * mn + i];
    const int row = static_cast<int>(i / p.N);
    const int col = static_cast<int>(i - static_cast<long long>(row) * p.N);
    if (p.bias != nullptr) v += load_bias(p, col);
    store(p, row, col, activate<ACT>(v), 0.f, false);
  }
}

// the current card's SMs: one persistent CTA each
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// one launch of an instantiation; its shared-memory limit is raised once
template <bool A_K, bool B_K, bool BIAS, int ACT, bool SPLIT>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb,
                         const CUtensorMap& tc, int tma_out,
                         const MmParams& p, int split, cudaStream_t st) {
  auto kernel = matmul_wgmma<A_K, B_K, BIAS, ACT, SPLIT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
  if (attr != cudaSuccess) return attr;
  const long long units = static_cast<long long>((p.N + kWN - 1) / kWN) *
                          ((p.M + kWM - 1) / kWM) * split;
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const int grid = static_cast<int>(units < sms ? units : sms);
  kernel<<<grid, kWThreads, kWSmem, st>>>(ta, tb, tc, p, split, tma_out);
  return cudaGetLastError();
}

template <bool BIAS>
cudaError_t launch_wgmma_fwd(const CUtensorMap& ta, const CUtensorMap& tb,
                             const CUtensorMap& tc, int tma_out,
                             const MmParams& p, int act, cudaStream_t st) {
  switch (act) {
    case kGelu: return launch_wgmma<true, true, BIAS, kGelu, false>(
        ta, tb, tc, tma_out, p, 1, st);
    case kRelu: return launch_wgmma<true, true, BIAS, kRelu, false>(
        ta, tb, tc, tma_out, p, 1, st);
    case kSigmoid: return launch_wgmma<true, true, BIAS, kSigmoid, false>(
        ta, tb, tc, tma_out, p, 1, st);
    default: return launch_wgmma<true, true, BIAS, kNone, false>(
        ta, tb, tc, tma_out, p, 1, st);
  }
}

template <bool SPLIT>
cudaError_t launch_wgmma_layout(const CUtensorMap& ta, const CUtensorMap& tb,
                                const CUtensorMap& tc, int tma_out,
                                const MmParams& p, int split,
                                cudaStream_t st) {
  if (p.a_k)
    return p.b_k ? launch_wgmma<true, true, false, kNone, SPLIT>(
                       ta, tb, tc, tma_out, p, split, st)
                 : launch_wgmma<true, false, false, kNone, SPLIT>(
                       ta, tb, tc, tma_out, p, split, st);
  return p.b_k ? launch_wgmma<false, true, false, kNone, SPLIT>(
                     ta, tb, tc, tma_out, p, split, st)
               : launch_wgmma<false, false, false, kNone, SPLIT>(
                     ta, tb, tc, tma_out, p, split, st);
}

cudaError_t launch_reduce(const MmParams& p, int split, int act,
                          cudaStream_t st) {
  const long long mn = static_cast<long long>(p.M) * p.N;
  const long long want = (mn + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  switch (act) {
    case kGelu: splitk_reduce<kGelu><<<blocks, 256, 0, st>>>(p, split); break;
    case kRelu: splitk_reduce<kRelu><<<blocks, 256, 0, st>>>(p, split); break;
    case kSigmoid:
      splitk_reduce<kSigmoid><<<blocks, 256, 0, st>>>(p, split);
      break;
    default: splitk_reduce<kNone><<<blocks, 256, 0, st>>>(p, split); break;
  }
  return cudaGetLastError();
}

// the wgmma variant: tensor maps for both operands, the product (split
// into `split` K slices when split > 1, then the reduce pass)
cudaError_t run_wgmma(const MmParams& p, int act, int split,
                      cudaStream_t st) {
  CUtensorMap ta, tb;
  const int K = p.K;
  const bool ok =
      (p.a_k ? apex::sm90::make_tensor_map_bf16(&ta, p.a, K, p.M, p.lda, 64,
                                                kWM)
             : apex::sm90::make_tensor_map_bf16(&ta, p.a, p.M, K, p.lda, 64,
                                                64)) &&
      (p.b_k ? apex::sm90::make_tensor_map_bf16(&tb, p.b, K, p.N, p.ldb, 64,
                                                kWN)
             : apex::sm90::make_tensor_map_bf16(&tb, p.b, p.N, K, p.ldb, 64,
                                                64));
  if (!ok) return cudaErrorInvalidValue;
  // a bf16 output whose rows are 16-byte aligned goes out by TMA
  CUtensorMap tc = ta;  // unread unless tma_out
  const int tma_out =
      split == 1 && !p.out_f32 && p.ldc % 8 == 0 &&
      reinterpret_cast<uintptr_t>(p.c) % 16 == 0 &&
      apex::sm90::make_tensor_map_bf16(&tc, p.c, p.N, p.M, p.ldc, 64, 64);
  const bool has_bias = p.bias != nullptr;
  if (split > 1) {
    const cudaError_t err =
        launch_wgmma_layout<true>(ta, tb, tc, 0, p, split, st);
    return err != cudaSuccess ? err : launch_reduce(p, split, act, st);
  }
  if (has_bias || act != kNone)
    return has_bias ? launch_wgmma_fwd<true>(ta, tb, tc, tma_out, p, act, st)
                    : launch_wgmma_fwd<false>(ta, tb, tc, tma_out, p, act,
                                              st);
  return launch_wgmma_layout<false>(ta, tb, tc, tma_out, p, 1, st);
}

template <bool A_K, bool B_K, bool BIAS, int ACT>
cudaError_t launch_bf16(const MmParams& p, cudaStream_t st) {
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  matmul_bias_act_bf16<A_K, B_K, BIAS, ACT><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

template <bool BIAS, int ACT>
cudaError_t launch_f32(const MmParams& p, cudaStream_t st) {
  const dim3 grid((p.N + kFN - 1) / kFN, (p.M + kFM - 1) / kFM);
  matmul_bias_act_f32<BIAS, ACT><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// the forward layout's epilogues
template <bool BIAS>
cudaError_t launch_bf16_fwd(const MmParams& p, int act, cudaStream_t st) {
  switch (act) {
    case kGelu: return launch_bf16<true, true, BIAS, kGelu>(p, st);
    case kRelu: return launch_bf16<true, true, BIAS, kRelu>(p, st);
    case kSigmoid: return launch_bf16<true, true, BIAS, kSigmoid>(p, st);
    default: return launch_bf16<true, true, BIAS, kNone>(p, st);
  }
}

template <bool BIAS>
cudaError_t launch_f32_act(const MmParams& p, int act, cudaStream_t st) {
  switch (act) {
    case kGelu: return launch_f32<BIAS, kGelu>(p, st);
    case kRelu: return launch_f32<BIAS, kRelu>(p, st);
    case kSigmoid: return launch_f32<BIAS, kSigmoid>(p, st);
    default: return launch_f32<BIAS, kNone>(p, st);
  }
}

}  // namespace

// a (A: M x K, element (m, k) at a[m * lda + k] when a_k, else
// a[k * lda + m]), b (B: K x N, element (k, n) at b[n * ldb + k] when
// b_k, else b[k * ldb + n]), bias (N,) or null, c (M x N, row stride
// ldc). dtype: operands' type (0 float32, 1 bfloat16); variant (bf16):
// 0 the sm80 body, 1 the wgmma one; bias_f32 and out_f32 the bias's and
// output's (else bfloat16); act: 0 none, 1 gelu (tanh), 2 relu, 3
// sigmoid; a_vec / b_vec: the operand's base is 16-byte aligned and its
// row stride a multiple of 8 elements (bf16 only; the wgmma variant takes
// only such operands). split: K slices of the wgmma variant (1: none;
// else ws holds split x M x N floats and kt_split 64-deep K steps per
// slice). A bf16 call with a bias or an activation and no split takes the
// forward layout (a_k and b_k) only.
extern "C" int apex_matmul_bias_act(const void* a, const void* b,
                                    const void* bias, void* c, void* ws,
                                    int dtype, int variant, int a_k,
                                    int b_k, int a_vec, int b_vec, int act,
                                    int bias_f32, int out_f32, int M, int N,
                                    int K, long long lda, long long ldb,
                                    long long ldc, int split, int kt_split,
                                    void* stream) {
  const bool has_bias = bias != nullptr;
  const bool wgmma = dtype == apex::kBFloat16 && variant == 1;
  const int tile_m = dtype == apex::kBFloat16 ? kBM : kFM;
  if ((dtype != apex::kFloat32 && dtype != apex::kBFloat16) || M < 1 ||
      N < 1 || K < 0 || act < kNone || act > kSigmoid || lda < 0 ||
      ldb < 0 || ldc < N || (M + tile_m - 1) / tile_m > 65535 ||
      (variant != 0 && variant != 1) || split < 1 || split > 65535 ||
      (split > 1 && (!wgmma || ws == nullptr || kt_split < 1 ||
                     static_cast<long long>(split - 1) * kt_split * kWK >=
                         K)) ||
      (wgmma && (!a_vec || !b_vec || K < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int group_m =
      (N + kWN - 1) / kWN >= kGroupMinTilesN || split > 1 ? kGroupM : 1;
  const MmParams p{a,     b,     bias,     c,       lda,
                   ldb,   ldc,   M,        N,       K,
                   a_k,   b_k,   a_vec,    b_vec,   bias_f32,
                   out_f32, static_cast<float*>(ws), kt_split, group_m};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == apex::kFloat32) {
    const cudaError_t err = has_bias ? launch_f32_act<true>(p, act, st)
                                     : launch_f32_act<false>(p, act, st);
    return static_cast<int>(err);
  }
  if ((has_bias || act != kNone) && split == 1 && (!a_k || !b_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wgmma) return static_cast<int>(run_wgmma(p, act, split, st));
  if (has_bias || act != kNone) {
    const cudaError_t err = has_bias ? launch_bf16_fwd<true>(p, act, st)
                                     : launch_bf16_fwd<false>(p, act, st);
    return static_cast<int>(err);
  }
  cudaError_t err;
  if (a_k)
    err = b_k ? launch_bf16<true, true, false, kNone>(p, st)
              : launch_bf16<true, false, false, kNone>(p, st);
  else
    err = b_k ? launch_bf16<false, true, false, kNone>(p, st)
              : launch_bf16<false, false, false, kNone>(p, st);
  return static_cast<int>(err);
}
