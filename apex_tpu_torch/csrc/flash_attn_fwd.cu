// Flash-attention forward for Hopper (sm_90a), over three layouts: the
// packed q|k|v projection buffer of the GPT train step, separate
// seq-major q, k and v of the decode engine's prefill, and the bh-flat
// (b, h, s, d) views of the T5 train step.
//
// Replaces apex_tpu/ops/pallas/attention.py::flash_fwd_packed (:464-533;
// packed index maps :490-498), ::flash_fwd_bshd (:803-857) and ::flash_fwd
// (:375-461, the bh-flat pallas_call at :436), all running the kernel body
// _fwd_kernel (:184-297).
// * apex_flash_fwd (packed): qkv (b, s, (h + 2*h_kv)*d) bf16, features
//   ordered q-heads | k-heads | v-heads, read straight out of qkv by base
//   pointer, feature offset and row stride: no slice, no copy.
// * apex_flash_fwd_bshd: q (b, sq, h, d), k and v (b, sk, h_kv, d), each
//   with its own row stride, and bottom-right causal alignment: row r sees
//   columns c <= r + (sk - sq); per-BATCH kv_lens (b,) and the array bias.
// * apex_flash_fwd_flat: q (b, h, sq, d), k and v (b, h_kv, sk, d) and o,
//   each with its own batch, head and row strides (flash_params.cuh), so
//   the transposed (b, h, s, d) views of a projection output need no copy;
//   per-row kv_lens (b*h,).
// The strided entries take the compile-time options of _fwd_kernel:
// kVarlen (columns >= the row's kv length masked, kv tiles wholly past
// the length skipped, a row of length 0 gives o = 0 and lse = 0 as
// :284-291), kRel (the bucketed relative bias, :256-267) and kArr (the
// fp32 (hb, sq, sk) array bias, read straight from device memory: one
// bias row serves every batch row of its head, so it sits in the L2 and
// is not staged through shared memory). Either bias is added to the
// SCALED scores before the masks.
// All: query head t reads kv head t / (h / h_kv); outputs o bf16 and the
// fp32 log-normaliser lse (b*h, sq) (the reference's 8-lane lse carrier
// is a TPU layout rule; here the plain rows).
//
// Bound on this card at the GPT train step's shape (b 20, s 1024, h 8,
// d 128, causal): operations. 4*b*h*s^2*d/2 = 42.9 GFLOP per layer is 43
// us at 989 TFLOP/s dense bf16, against 3*b*s*h*d*2 B = 126 MB of q/k/v/o
// (38 us at 3.35 TB/s) -- close to the ridge, so both matter. The T5
// encoder's (b*h 1536, s 512, d 64) is bytes-bound near the ridge: 403 MB
// of q/k/v/o (120 us) against 103 GFLOP (104 us).
//
// Design, simple and right first:
// * one CTA of 4 warps per (b*h, 64-row query tile); each warp owns 16
//   query rows. The CTA walks 64-row kv tiles only up to the causal
//   diagonal and the row's kv length: the Pallas grid's `run` skip (:239)
//   becomes the loop bound, shifted by off = sk - sq.
// * K and V tiles are double-buffered in shared memory by cp.async, so
//   the next tile's copy overlaps this tile's math; rows past sq, sk or
//   the kv length are zero-filled and their scores masked.
// * both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   fp32 accumulate); the score accumulators, rounded to bf16, are reused
//   in registers as the A operand of P.V.
// * kRel: the head's 2*maxd + 1 lookup values sit in shared memory; each
//   score adds lut[clamp(col - row + k_off - q_off)]. kArr: each score
//   adds bias[r % hb][row][col] (fp32 loads through the read-only path).
// * the rounding points of _fwd_kernel (:251-297): scores fp32 then *scale;
//   masked entries -1e30; an online row max; p = exp(s - m) in fp32; l sums
//   the UNROUNDED p; acc += p.to(bf16) . v in fp32; o = acc / max(l, 1e-30);
//   lse = m + log(max(l, 1e-30)).
// Known weaknesses, for a later change: mma.sync instead of wgmma/TMA;
// causal tiles are uneven work (the diagonal CTAs finish first).
#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"
#include "flash_params.cuh"

namespace {

using bf16 = __nv_bfloat16;
using apex::FlashParams;

constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t tile_smem_bytes() {
  return static_cast<size_t>(kBq + 4 * kBk) * (D + 8) * sizeof(bf16);
}

// kStrided: q, k, v and o each with their own strides, sq != sk. The
// packed instantiation takes k's and v's strides and lengths from q's, o's
// layout from h, and a zero causal offset as compile-time facts, so its
// code is the packed-only kernel's (with them at run time the packed
// forward ran ~10% slower on an H100). kVarlen, kRel and kArr exist only
// with kStrided; kRel and kArr exclude each other.
template <int D, bool kStrided, bool kVarlen, bool kRel, bool kArr>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashParams p) {
  // locals, not the struct's fields, in the body: restrict-qualified
  // pointers and hoisted scalars (read through the struct, the packed
  // forward ran 33% slower on an H100)
  const bf16* __restrict__ pq = p.q;
  const bf16* __restrict__ pk = p.k;
  const bf16* __restrict__ pv = p.v;
  bf16* __restrict__ pout = p.out;
  float* __restrict__ plse = p.lse_out;
  const float* __restrict__ pbias = p.bias;
  const float scale = p.scale;
  const int causal = p.causal;
  const int maxd = p.maxd;
  const int rel_off = p.rel_off;
  const int sq = p.sq;
  const int sk = kStrided ? p.sk : sq;
  const long long q_h = kStrided ? p.q_v.h : D;
  const long long kv_b = kStrided ? p.kv_v.b : p.q_v.b;
  const long long kv_h = kStrided ? p.kv_v.h : D;
  const long long kv_r = kStrided ? p.kv_v.r : p.q_v.r;
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBq * kLd;      // [2][kBk][kLd]
  bf16* v_s = k_s + 2 * kBk * kLd;  // [2][kBk][kLd]
  float* lut_s = reinterpret_cast<float*>(v_s + 2 * kBk * kLd);  // kRel

  const int row_id = blockIdx.x;  // bi * h + head
  const int bi = row_id / p.h;
  const int head = row_id - bi * p.h;
  const int kvh = head / (p.h / p.h_kv);
  const int q0 = blockIdx.y * kBq;
  const int off = kStrided ? sk - sq : 0;  // bottom-right causal alignment
  const bf16* qg = pq + bi * p.q_v.b + head * q_h;
  const bf16* kg = pk + bi * kv_b + kvh * kv_h;
  const bf16* vg = pv + bi * kv_b + kvh * kv_h;

  int kv_lim = sk;  // columns >= kv_lim are masked
  if (kVarlen) kv_lim = apex::kv_len(p.kv_lens, bi, head, p.lens_b, p.lens_h,
                                     sk);
  const int kv_end = causal ? min(kv_lim, q0 + kBq + off) : kv_lim;
  const int nk = (kv_end + kBk - 1) / kBk;

  apex::load_rows<D, kBq, kThreads>(q_s, qg, p.q_v.r, q0, sq);
  apex::load_rows<D, kBk, kThreads>(k_s, kg, kv_r, 0, kv_lim);
  apex::load_rows<D, kBk, kThreads>(v_s, vg, kv_r, 0, kv_lim);
  apex::cp_async_commit();
  if (kRel) {  // visible after the first iteration's __syncthreads
    const int n = 2 * maxd + 1;
    const float* lut = p.lut + static_cast<size_t>(row_id % p.hb) * n;
    for (int i = threadIdx.x; i < n; i += kThreads) lut_s[i] = lut[i];
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16 + g;  // this thread's rows: wrow, wrow + 8
  const int row0 = q0 + wrow;
  const int diag0 = row0 + off;  // the last visible column of row row0

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only, summed last
  float oacc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) oacc[i][c] = 0.f;
  uint32_t qf[D / 16][4];

  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) {
      apex::load_rows<D, kBk, kThreads>(k_s + (buf ^ 1) * kBk * kLd, kg,
                                        kv_r, (j + 1) * kBk, kv_lim);
      apex::load_rows<D, kBk, kThreads>(v_s + (buf ^ 1) * kBk * kLd, vg,
                                        kv_r, (j + 1) * kBk, kv_lim);
      apex::cp_async_commit();
      apex::cp_async_wait<1>();
    } else {
      apex::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* ptr = q_s + wrow * kLd + kk * 16 + 2 * t;
        qf[kk][0] = apex::lds32(ptr);
        qf[kk][1] = apex::lds32(ptr + 8 * kLd);
        qf[kk][2] = apex::lds32(ptr + 8);
        qf[kk][3] = apex::lds32(ptr + 8 * kLd + 8);
      }
    }
    const bf16* kb = k_s + buf * kBk * kLd;
    const bf16* vb = v_s + buf * kBk * kLd;

    // S = Q K^T for this warp's 16 rows x 64 kv columns
    float sc[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBk / 8; ++nt) {
        const bf16* ptr = kb + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        apex::mma_bf16(sc[nt], qf[kk], apex::lds32(ptr),
                       apex::lds32(ptr + 8));
      }
    }

    // scale, bias, mask, online softmax
    const int k0 = j * kBk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int diag = diag0 + (c >> 1) * 8;
        const int col = k0 + nt * 8 + 2 * t + (c & 1);
        const bool ok = col < kv_lim && (!causal || col <= diag);
        float x = sc[nt][c] * scale;
        if (kRel)
          x += lut_s[apex::rel_index(col, row0 + (c >> 1) * 8, rel_off,
                                     maxd)];
        if (kArr)
          x += apex::bias_at(pbias, row_id, p.hb, sq, sk,
                             row0 + (c >> 1) * 8, col);
        const float v = ok ? x : kNegInf;
        sc[nt][c] = v;
        mx[c >> 1] = fmaxf(mx[c >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = expf(m_run[i] - m_new);
      m_run[i] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = expf(sc[nt][c] - m_run[c >> 1]);
        sc[nt][c] = pr;
        ls[c >> 1] += pr;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + ls[i];
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      oacc[dt][0] *= alpha[0];
      oacc[dt][1] *= alpha[0];
      oacc[dt][2] *= alpha[1];
      oacc[dt][3] *= alpha[1];
    }

    // O += P V: p rounded to bf16 (V's dtype) as the A operand
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint32_t a[4] = {
          apex::pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
          apex::pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
          apex::pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          apex::pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        apex::ldmatrix_x4_trans(
            b, vb + (kk * 16 + (lane & 15)) * kLd + dt * 8 + (lane >> 4) * 8);
        apex::mma_bf16(oacc[dt], a, b[0], b[1]);
        apex::mma_bf16(oacc[dt + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration's copy reuses this buffer
  }
  if (nk == 0) apex::cp_async_wait<0>();  // a row of kv length 0

  const int hd = p.h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i] + __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const bool dead = kVarlen && !(l > 0.f);  // no visible column
    l = fmaxf(l, 1e-30f);
    const int row = row0 + i * 8;
    if (row < sq) {
      bf16* orow = kStrided
                       ? pout + bi * p.out_v.b + head * p.out_v.h +
                             static_cast<long long>(row) * p.out_v.r
                       : pout + (static_cast<size_t>(bi) * sq + row) * hd +
                             head * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) = apex::pack_bf16(
            oacc[dt][2 * i] / l, oacc[dt][2 * i + 1] / l);
      }
      if (t == 0)
        plse[static_cast<size_t>(row_id) * sq + row] =
            dead ? 0.f : m_run[i] + logf(l);
    }
  }
}

template <int D, bool kStrided, bool kVarlen, bool kRel, bool kArr>
cudaError_t launch(const FlashParams& p, int b, cudaStream_t stream) {
  size_t smem = tile_smem_bytes<D>();
  if (kRel) smem += (static_cast<size_t>(2 * p.maxd + 1) * 4 + 15) & ~15ull;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kStrided, kVarlen, kRel, kArr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * p.h, (p.sq + kBq - 1) / kBq);
  flash_fwd_kernel<D, kStrided, kVarlen, kRel, kArr>
      <<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kVarlen>
cudaError_t dispatch_bias(const FlashParams& p, int b, cudaStream_t st) {
  if (p.lut != nullptr)
    return launch<D, true, kVarlen, true, false>(p, b, st);
  if (p.bias != nullptr)
    return launch<D, true, kVarlen, false, true>(p, b, st);
  return launch<D, true, kVarlen, false, false>(p, b, st);
}

template <int D>
cudaError_t dispatch(const FlashParams& p, int b, bool strided,
                     cudaStream_t st) {
  if (!strided) return launch<D, false, false, false, false>(p, b, st);
  return p.kv_lens != nullptr ? dispatch_bias<D, true>(p, b, st)
                              : dispatch_bias<D, false>(p, b, st);
}

// the shared argument rules; d picks the compiled head dim
int run(int d, const FlashParams& p, int b, bool strided, void* stream) {
  if (b < 1 || p.sq < 1 || p.sk < 1 || p.h < 1 || p.h_kv < 1 ||
      p.h % p.h_kv || (d != 64 && d != 128) ||
      (p.sq + kBq - 1) / kBq > 65535 || (p.causal && p.sq > p.sk) ||
      static_cast<long long>(b) * p.h > 0x7fffffffLL ||
      (p.lut != nullptr && p.bias != nullptr) ||
      ((p.lut != nullptr || p.bias != nullptr) && p.hb < 1) ||
      (p.lut != nullptr && (p.maxd < 1 || p.maxd > 4096)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d == 128 ? dispatch<128>(p, b, strided, st)
               : dispatch<64>(p, b, strided, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int apex_flash_fwd(const void* qkv, void* out, void* lse, int b,
                              int s, int h, int h_kv, int d, int causal,
                              float scale, void* stream) {
  const bf16* base = static_cast<const bf16*>(qkv);
  const long long feat = static_cast<long long>(h + 2 * h_kv) * d;
  FlashParams p{};
  p.q = base;
  p.k = base + h * d;
  p.v = base + (h + h_kv) * d;
  p.out = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.q_v = {s * feat, d, feat};
  p.sq = p.sk = s;
  p.h = h;
  p.h_kv = h_kv;
  p.causal = causal;
  p.scale = scale;
  return run(d, p, b, false, stream);
}

// q (b, sq, h, d) and k, v (b, sk, h_kv, d) with unit head and feature
// strides; the batch and row strides are the caller's (k and v share
// theirs), so views into a larger buffer need no copy. kv_lens (b,) int32
// per batch or null; bias (hb, sq, sk) fp32 with hb | h, or null.
extern "C" int apex_flash_fwd_bshd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* kv_lens, const void* bias,
                                   long long q_bstride, long long kv_bstride,
                                   int q_stride, int kv_stride, int b, int sq,
                                   int sk, int h, int h_kv, int d, int causal,
                                   float scale, int hb, void* stream) {
  if (q_bstride < 0 || kv_bstride < 0 || q_stride < h * d ||
      kv_stride < h_kv * d || q_stride % 8 || kv_stride % 8 ||
      (bias != nullptr && (hb < 1 || h % hb)))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.bias = static_cast<const float*>(bias);
  p.q_v = {q_bstride, d, q_stride};
  p.kv_v = {kv_bstride, d, kv_stride};
  p.out_v = {static_cast<long long>(sq) * h * d, d,
             static_cast<long long>(h) * d};
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.h_kv = h_kv;
  p.causal = causal;
  p.scale = scale;
  p.hb = hb;
  p.lens_b = 1;  // per batch: the heads share a row's padding
  p.lens_h = 0;
  return run(d, p, b, true, stream);
}

// The bh-flat entry: q (b, h, sq, d), k and v (b, h_kv, sk, d) sharing
// their strides, o (b, h, sq, d), each as (batch, head, row) element
// strides in `strides` (q, kv, o: 9 values; the feature stride is 1 and
// every stride a multiple of 8 elements, so every row is 16-byte
// aligned); lse (b*h, sq) fp32. kv_lens (b*h,) int32 or
// null; lut (hb, 2*maxd + 1) fp32 or null, row r reading lut row r % hb,
// with rel_off = k_offset - q_offset; or bias (hb, sq, sk) fp32 or null,
// row r reading bias row r % hb (at most one of lut and bias).
extern "C" int apex_flash_fwd_flat(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* kv_lens, const void* lut,
                                   const void* bias,
                                   const long long* strides, int b, int h,
                                   int h_kv, int sq, int sk, int d,
                                   int causal, float scale, int maxd,
                                   int rel_off, int hb, void* stream) {
  for (int i = 0; i < 9; ++i)
    if (strides[i] < 0 || strides[i] % 8)
      return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.lut = static_cast<const float*>(lut);
  p.bias = static_cast<const float*>(bias);
  p.q_v = {strides[0], strides[1], strides[2]};
  p.kv_v = {strides[3], strides[4], strides[5]};
  p.out_v = {strides[6], strides[7], strides[8]};
  p.lens_b = h;  // per row
  p.lens_h = 1;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.h_kv = h_kv;
  p.causal = causal;
  p.scale = scale;
  p.maxd = maxd;
  p.rel_off = rel_off;
  p.hb = hb;
  return run(d, p, b, true, stream);
}
