// Flash-attention forward over the packed q|k|v projection buffer, for
// Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/attention.py::flash_fwd_packed (:464-533;
// kernel body _fwd_kernel :184-297, packed index maps :490-498). Same
// contract: qkv (b, s, (h + 2*h_kv)*d) bf16, features ordered q-heads |
// k-heads | v-heads; query head t reads kv head t / (h / h_kv). Outputs o
// (b, s, h*d) bf16 and the fp32 log-normaliser lse (b, h, s) (the
// reference's 8-lane lse carrier is a TPU layout rule; here the plain
// (b, h, s)). q, k and v are read straight out of qkv by base pointer,
// feature offset and row stride: no slice, no copy.
//
// Bound on this card at the train step's shape (b 20, s 1024, h 8, d 128,
// causal): operations. 4*b*h*s^2*d/2 = 42.9 GFLOP per layer is 43 us at
// 989 TFLOP/s dense bf16, against 3*b*s*h*d*2 B = 126 MB of q/k/v/o (38 us
// at 3.35 TB/s) -- close to the ridge, so both matter.
//
// Design, simple and right first:
// * one CTA of 4 warps per (b*h, 64-row query tile); each warp owns 16
//   query rows. The CTA walks 64-row kv tiles only up to the causal
//   diagonal: the Pallas grid's `run` skip (:239) becomes the loop bound,
//   with off = 0 because sq = sk.
// * K and V tiles are double-buffered in shared memory by cp.async, so
//   the next tile's copy overlaps this tile's math; rows past s are
//   zero-filled and their scores masked.
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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     float* __restrict__ lse, int s, int h, int h_kv,
                     int causal, float scale) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + kBq * kLd;      // [2][kBk][kLd]
  bf16* v_s = k_s + 2 * kBk * kLd;  // [2][kBk][kLd]

  const int bi = blockIdx.x / h;
  const int head = blockIdx.x - bi * h;
  const int kvh = head / (h / h_kv);
  const int q0 = blockIdx.y * kBq;
  const size_t feat = static_cast<size_t>(h + 2 * h_kv) * D;
  const bf16* base = qkv + static_cast<size_t>(bi) * s * feat;
  const bf16* qg = base + head * D;
  const bf16* kg = base + (h + kvh) * D;
  const bf16* vg = base + (h + h_kv + kvh) * D;

  const int kv_end = causal ? min(s, q0 + kBq) : s;
  const int nk = (kv_end + kBk - 1) / kBk;

  apex::load_rows<D, kBq, kThreads>(q_s, qg, feat, q0, s);
  apex::load_rows<D, kBk, kThreads>(k_s, kg, feat, 0, s);
  apex::load_rows<D, kBk, kThreads>(v_s, vg, feat, 0, s);
  apex::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16 + g;  // this thread's rows: wrow, wrow + 8
  const int row0 = q0 + wrow;

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
      apex::load_rows<D, kBk, kThreads>(k_s + (buf ^ 1) * kBk * kLd, kg, feat,
                                        (j + 1) * kBk, s);
      apex::load_rows<D, kBk, kThreads>(v_s + (buf ^ 1) * kBk * kLd, vg, feat,
                                        (j + 1) * kBk, s);
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
        const int row = row0 + (c >> 1) * 8;
        const int col = k0 + nt * 8 + 2 * t + (c & 1);
        const bool ok = col < s && (!causal || col <= row);
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
    if (row < s) {
      bf16* orow = out + (static_cast<size_t>(bi) * s + row) * hd + head * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) = apex::pack_bf16(
            oacc[dt][2 * i] / l, oacc[dt][2 * i + 1] / l);
      }
      if (t == 0)
        lse[(static_cast<size_t>(bi) * h + head) * s + row] =
            m_run[i] + logf(l);
    }
  }
}

template <int D>
cudaError_t launch(const void* qkv, void* out, void* lse, int b, int s, int h,
                   int h_kv, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + kBq - 1) / kBq);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<float*>(lse), s, h, h_kv, causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int apex_flash_fwd(const void* qkv, void* out, void* lse, int b,
                              int s, int h, int h_kv, int d, int causal,
                              float scale, void* stream) {
  if (b < 1 || s < 1 || h < 1 || h_kv < 1 || h % h_kv ||
      (d != 64 && d != 128) || (s + kBq - 1) / kBq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d == 128 ? launch<128>(qkv, out, lse, b, s, h, h_kv, causal, scale, st)
               : launch<64>(qkv, out, lse, b, s, h, h_kv, causal, scale, st);
  return static_cast<int>(err);
}
