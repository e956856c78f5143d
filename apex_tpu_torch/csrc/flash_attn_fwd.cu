// Flash-attention forward for Hopper (sm_90a), over two layouts: the
// packed q|k|v projection buffer of the train step, and separate
// seq-major q, k and v of the decode engine's prefill.
//
// Replaces apex_tpu/ops/pallas/attention.py::flash_fwd_packed (:464-533;
// packed index maps :490-498) and ::flash_fwd_bshd (:803-857), both
// running the kernel body _fwd_kernel (:184-297).
// * apex_flash_fwd (packed): qkv (b, s, (h + 2*h_kv)*d) bf16, features
//   ordered q-heads | k-heads | v-heads, read straight out of qkv by base
//   pointer, feature offset and row stride: no slice, no copy.
// * apex_flash_fwd_bshd: q (b, sq, h, d), k and v (b, sk, h_kv, d), each
//   with its own row stride (h*d for q and h_kv*d for k and v when they are
//   separate tensors; views of the packed projection pass its width), and
//   bottom-right causal alignment: row r sees columns c <= r + (sk - sq).
// Both: query head t reads kv head t / (h / h_kv); outputs o (b, sq, h*d)
// bf16 and the fp32 log-normaliser lse (b, h, sq) (the reference's
// 8-lane lse carrier is a TPU layout rule; here the plain (b, h, sq)).
// The packed entry passes three pointers into one buffer and sq = sk, so
// it runs exactly the arithmetic it ran before the bshd entry existed.
//
// Bound on this card at the train step's shape (b 20, s 1024, h 8, d 128,
// causal): operations. 4*b*h*s^2*d/2 = 42.9 GFLOP per layer is 43 us at
// 989 TFLOP/s dense bf16, against 3*b*s*h*d*2 B = 126 MB of q/k/v/o (38 us
// at 3.35 TB/s) -- close to the ridge, so both matter. The prefill's
// (b 16, s 512) is bytes-bound: 67 MB (20 us) against 8.7 us of products.
//
// Design, simple and right first:
// * one CTA of 4 warps per (b*h, 64-row query tile); each warp owns 16
//   query rows. The CTA walks 64-row kv tiles only up to the causal
//   diagonal: the Pallas grid's `run` skip (:239) becomes the loop bound,
//   shifted by off = sk - sq.
// * K and V tiles are double-buffered in shared memory by cp.async, so
//   the next tile's copy overlaps this tile's math; rows past sq or sk
//   are zero-filled and their scores masked.
// * both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//   fp32 accumulate); the score accumulators, rounded to bf16, are reused
//   in registers as the A operand of P.V.
// * the rounding points of _fwd_kernel (:251-297): scores fp32 then *scale;
//   masked entries -1e30; an online row max; p = exp(s - m) in fp32; l sums
//   the UNROUNDED p; acc += p.to(bf16) . v in fp32; o = acc / max(l, 1e-30);
//   lse = m + log(max(l, 1e-30)).
// Known weaknesses, for a later change: mma.sync instead of wgmma/TMA;
// causal tiles are uneven work (the diagonal CTAs finish first).
#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBq + 4 * kBk) * (D + 8) * sizeof(bf16);
}

// kBshd: separate q, k, v strides and sq != sk. The packed instantiation
// takes k's and v's strides and lengths from q's and a zero causal offset
// as compile-time facts, so its code is the packed-only kernel's (with
// them at run time the packed forward ran ~10% slower on an H100).
template <int D, bool kBshd>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, size_t q_bstride,
                     size_t kv_bstride_arg, int q_stride, int kv_stride_arg,
                     int sq, int sk_arg, int h, int h_kv, int causal,
                     float scale) {
  const int sk = kBshd ? sk_arg : sq;
  const size_t kv_bstride = kBshd ? kv_bstride_arg : q_bstride;
  const int kv_stride = kBshd ? kv_stride_arg : q_stride;
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBq * kLd;      // [2][kBk][kLd]
  bf16* v_s = k_s + 2 * kBk * kLd;  // [2][kBk][kLd]

  const int bi = blockIdx.x / h;
  const int head = blockIdx.x - bi * h;
  const int kvh = head / (h / h_kv);
  const int q0 = blockIdx.y * kBq;
  const int off = kBshd ? sk - sq : 0;  // bottom-right causal alignment
  const bf16* qg = q + bi * q_bstride + head * D;
  const bf16* kg = k + bi * kv_bstride + kvh * D;
  const bf16* vg = v + bi * kv_bstride + kvh * D;

  const int kv_end = causal ? min(sk, q0 + kBq + off) : sk;
  const int nk = (kv_end + kBk - 1) / kBk;

  apex::load_rows<D, kBq, kThreads>(q_s, qg, q_stride, q0, sq);
  apex::load_rows<D, kBk, kThreads>(k_s, kg, kv_stride, 0, sk);
  apex::load_rows<D, kBk, kThreads>(v_s, vg, kv_stride, 0, sk);
  apex::cp_async_commit();

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
                                        kv_stride, (j + 1) * kBk, sk);
      apex::load_rows<D, kBk, kThreads>(v_s + (buf ^ 1) * kBk * kLd, vg,
                                        kv_stride, (j + 1) * kBk, sk);
      apex::cp_async_commit();
      apex::cp_async_wait<1>();
    } else {
      apex::cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const bf16* p = q_s + wrow * kLd + kk * 16 + 2 * t;
        qf[kk][0] = apex::lds32(p);
        qf[kk][1] = apex::lds32(p + 8 * kLd);
        qf[kk][2] = apex::lds32(p + 8);
        qf[kk][3] = apex::lds32(p + 8 * kLd + 8);
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
        const bf16* p = kb + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        apex::mma_bf16(sc[nt], qf[kk], apex::lds32(p), apex::lds32(p + 8));
      }
    }

    // scale, mask, online softmax
    const int k0 = j * kBk;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int diag = diag0 + (c >> 1) * 8;
        const int col = k0 + nt * 8 + 2 * t + (c & 1);
        const bool ok = col < sk && (!causal || col <= diag);
        const float v = ok ? sc[nt][c] * scale : kNegInf;
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
        const float p = expf(sc[nt][c] - m_run[c >> 1]);
        sc[nt][c] = p;
        ls[c >> 1] += p;
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

  const int hd = h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i] + __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row0 + i * 8;
    if (row < sq) {
      bf16* orow = out + (static_cast<size_t>(bi) * sq + row) * hd + head * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) = apex::pack_bf16(
            oacc[dt][2 * i] / l, oacc[dt][2 * i + 1] / l);
      }
      if (t == 0)
        lse[(static_cast<size_t>(bi) * h + head) * sq + row] =
            m_run[i] + logf(l);
    }
  }
}

template <int D, bool kBshd>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, void* out,
                   void* lse, size_t q_bstride, size_t kv_bstride,
                   int q_stride, int kv_stride, int b, int sq, int sk, int h,
                   int h_kv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, kBshd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (sq + kBq - 1) / kBq);
  flash_fwd_kernel<D, kBshd><<<grid, kThreads, smem, stream>>>(
      q, k, v, static_cast<bf16*>(out), static_cast<float*>(lse), q_bstride,
      kv_bstride, q_stride, kv_stride, sq, sk, h, h_kv, causal, scale);
  return cudaGetLastError();
}

// the shared argument rules; d picks the compiled head dim
template <bool kBshd>
int run(int d, const bf16* q, const bf16* k, const bf16* v, void* out,
        void* lse, size_t q_bstride, size_t kv_bstride, int q_stride,
        int kv_stride, int b, int sq, int sk, int h, int h_kv, int causal,
        float scale, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || h < 1 || h_kv < 1 || h % h_kv ||
      (d != 64 && d != 128) || (sq + kBq - 1) / kBq > 65535 ||
      (causal && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d == 128 ? launch<128, kBshd>(q, k, v, out, lse, q_bstride, kv_bstride,
                                    q_stride, kv_stride, b, sq, sk, h, h_kv,
                                    causal, scale, st)
               : launch<64, kBshd>(q, k, v, out, lse, q_bstride, kv_bstride,
                                   q_stride, kv_stride, b, sq, sk, h, h_kv,
                                   causal, scale, st);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int apex_flash_fwd(const void* qkv, void* out, void* lse, int b,
                              int s, int h, int h_kv, int d, int causal,
                              float scale, void* stream) {
  const bf16* base = static_cast<const bf16*>(qkv);
  const int feat = (h + 2 * h_kv) * d;
  const size_t bstride = static_cast<size_t>(s) * feat;
  return run<false>(d, base, base + h * d, base + (h + h_kv) * d, out, lse,
                    bstride, bstride, feat, feat, b, s, s, h, h_kv, causal,
                    scale, stream);
}

// q (b, sq, h, d) and k, v (b, sk, h_kv, d) with unit head and feature
// strides; the batch and row strides are the caller's (k and v share
// theirs), so views into a larger buffer need no copy
extern "C" int apex_flash_fwd_bshd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   long long q_bstride, long long kv_bstride,
                                   int q_stride, int kv_stride, int b, int sq,
                                   int sk, int h, int h_kv, int d, int causal,
                                   float scale, void* stream) {
  if (q_bstride < 0 || kv_bstride < 0 || q_stride < h * d ||
      kv_stride < h_kv * d || q_stride % 8 || kv_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<true>(d, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), out, lse,
                   static_cast<size_t>(q_bstride),
                   static_cast<size_t>(kv_bstride), q_stride, kv_stride, b,
                   sq, sk, h, h_kv, causal, scale, stream);
}
