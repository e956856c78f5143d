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
// Bound on this card at the path's shapes: operations. GPT-medium's
// dense-GELU-dense block over 20 x 1024 tokens runs six products of
// 2 * 20480 * 1024 * 4096 = 171.8 GFLOP (0.174 ms each at 989 TFLOP/s
// dense bf16) against 126-210 MB moved (0.04-0.06 ms at 3.35 TB/s); the
// MLP leg's layers likewise, but for the 256 -> 1 layer, which moves
// bytes. At ~300 operations per byte the product is tensor-core bound
// and the epilogue's bias and activation ride free in registers.
//
// Design (simple first; wgmma/TMA is later work): a 128 x 128 output tile
// per CTA of 8 warps (each 64 x 32), K in steps of 32 through a
// double-buffered cp.async pipeline into padded shared tiles stored along
// each operand's contiguous axis; ldmatrix (.trans where the layout needs
// it) feeds mma.sync.m16n8k16 bf16 with fp32 accumulators; the epilogue
// works on the accumulators in registers and writes each output once.
// Ragged edges: a 16-byte chunk that crosses the K (or M, N) edge copies
// only its valid bytes and zero-fills the rest; a chunk past the edge
// copies nothing. An operand whose 16-byte chunks are not aligned (a base
// off 16 bytes, or a row stride that is no multiple of 8 elements) takes a
// predicated element-by-element loader, chosen at launch per operand — a
// loader variant of the same kernel. The wrapper counts an axis of extent
// 1 as contiguous and prefers an aligned layout, so the N = 1 layer's
// (M, 1) operands are read along M in 16-byte chunks.
//
// fp32 operands take an exact-FFMA kernel (no TF32): 64 x 64 tiles, K in
// steps of 16, each thread a 4 x 4 block of serial fp32 dot products,
// operands by runtime strides, the same epilogue. It is right, not fast.
//
// Entry: apex_matmul_bias_act.
#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"

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
// ldc). dtype: operands' type (0 float32, 1 bfloat16); bias_f32 and
// out_f32 the bias's and output's (else bfloat16); act: 0 none, 1 gelu
// (tanh), 2 relu, 3 sigmoid; a_vec / b_vec: the operand's base is 16-byte
// aligned and its row stride a multiple of 8 elements (bf16 only). A
// bf16 call with a bias or an activation takes the forward layout
// (a_k and b_k) only.
extern "C" int apex_matmul_bias_act(const void* a, const void* b,
                                    const void* bias, void* c, int dtype,
                                    int a_k, int b_k, int a_vec, int b_vec,
                                    int act, int bias_f32, int out_f32,
                                    int M, int N, int K, long long lda,
                                    long long ldb, long long ldc,
                                    void* stream) {
  const bool has_bias = bias != nullptr;
  const int tile_m = dtype == apex::kBFloat16 ? kBM : kFM;
  if ((dtype != apex::kFloat32 && dtype != apex::kBFloat16) || M < 1 ||
      N < 1 || K < 0 || act < kNone || act > kSigmoid || lda < 0 ||
      ldb < 0 || ldc < N || (M + tile_m - 1) / tile_m > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const MmParams p{a,   b,   bias, c,   lda,   ldb,   ldc,      M,
                   N,   K,   a_k,  b_k, a_vec, b_vec, bias_f32, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == apex::kFloat32) {
    const cudaError_t err = has_bias ? launch_f32_act<true>(p, act, st)
                                     : launch_f32_act<false>(p, act, st);
    return static_cast<int>(err);
  }
  if (has_bias || act != kNone) {
    if (!a_k || !b_k) return static_cast<int>(cudaErrorInvalidValue);
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
