// The "sm80" variant of the array bias's gradient: the port's first dbias
// kernel, kept beside the wgmma/TMA kernel of flash_attn_dbias.cu for the
// A/B timing of the two and for the kernel tests; no path runs it.
// Reached through flash_attn_dbias.cu's entry with variant 0, with its
// argument checks. dbias (hb, sq, sk) fp32 = the UNSCALED dS = P * (dP -
// delta), summed over the q-head rows that share each bias row; this
// kernel computes delta = rowsum(do * o) itself (it reads O).
//
// Design:
// * one CTA of 4 warps per (bias row th, 64-row query tile, 64-column kv
//   tile); each warp owns 16 query rows of the 64 x 64 output tile, whose
//   sum stays in fp32 registers for the whole launch.
// * the CTA walks the nb = rows / hb rows r = bi * hb + th that share bias
//   row th, bi = 0 .. nb - 1 -- the reference's batch-innermost order, so
//   the sum is taken in one fixed order: deterministic, no atomics, each
//   output element written once.
// * per row: the q and do tiles and the row's k and v tiles are copied to
//   shared memory by cp.async (rows past sq, sk or the kv length zero-
//   filled), delta = rowsum(do * o) in fp32 and lse are read from device
//   memory; S = Q K^T and dP = dO V^T run on the tensor cores (mma.sync
//   m16n8k16, bf16 in, fp32 accumulate); p = exp(s * scale + bias - lse)
//   on live entries, 0 elsewhere; acc += p * (dP - delta).
// * a tile above the causal diagonal, or past a row's kv length, adds
//   nothing; a tile no row reaches writes zeros.
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

template <int D>
constexpr size_t dbias_smem_bytes() {
  return static_cast<size_t>(2 * kBq + 2 * kBk) * (D + 8) * sizeof(bf16) +
         2 * kBq * sizeof(float);
}

template <int D, bool kVarlen>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dbias_kernel(const FlashParams p) {
  const bf16* __restrict__ pq = p.q;
  const bf16* __restrict__ pk = p.k;
  const bf16* __restrict__ pv = p.v;
  const bf16* __restrict__ po = p.o;
  const bf16* __restrict__ pdo = p.dout;
  const float* __restrict__ plse = p.lse;
  const float* __restrict__ pbias = p.bias;
  float* __restrict__ pdbias = p.dbias;
  const apex::View q_v = p.q_v, kv_v = p.kv_v, o_v = p.o_v, do_v = p.do_v;
  const float scale = p.scale;
  const int causal = p.causal, h = p.h, group = p.h / p.h_kv;
  const int sq = p.sq, sk = p.sk, coff = p.sk - p.sq;
  const int hb = p.hb, nrows = p.nb;  // nb: the rows sharing a bias row
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kBq * kLd;
  bf16* k_s = do_s + kBq * kLd;
  bf16* v_s = k_s + kBk * kLd;
  float* lse_s = reinterpret_cast<float*>(v_s + kBk * kLd);
  float* delta_s = lse_s + kBq;

  const int th = blockIdx.x;
  const int q0 = blockIdx.y * kBq;
  const int k0 = blockIdx.z * kBk;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16 + g;  // this thread's query rows: wrow, +8

  float acc[kBk / 8][4];
#pragma unroll
  for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;

  // the last visible column of the tile's last row lies left of k0: the
  // whole tile is masked for every row
  const bool tile_live = !causal || k0 <= q0 + kBq - 1 + coff;
  for (int n = 0; tile_live && n < nrows; ++n) {
    const int r = n * hb + th;  // the q-head row: batch bi, head hi
    const int bi = r / h;
    const int hi = r - bi * h;
    const int kvh = hi / group;
    const int kv_lim =
        kVarlen ? apex::kv_len(p.kv_lens, bi, hi, p.lens_b, p.lens_h, sk) : sk;
    if (k0 >= kv_lim) continue;  // the same for every thread of the CTA
    const bf16* kg = pk + bi * kv_v.b + kvh * kv_v.h;
    const bf16* vg = pv + bi * kv_v.b + kvh * kv_v.h;
    const bf16* qg = pq + bi * q_v.b + hi * q_v.h;
    const bf16* og = po + bi * o_v.b + hi * o_v.h;
    const bf16* dog = pdo + bi * do_v.b + hi * do_v.h;
    apex::load_rows<D, kBq, kThreads>(q_s, qg, q_v.r, q0, sq);
    apex::load_rows<D, kBq, kThreads>(do_s, dog, do_v.r, q0, sq);
    apex::load_rows<D, kBk, kThreads>(k_s, kg, kv_v.r, k0, kv_lim);
    apex::load_rows<D, kBk, kThreads>(v_s, vg, kv_v.r, k0, kv_lim);
    apex::cp_async_commit();
    {  // delta and lse of the tile's rows: 2 threads per row
      const int rl = threadIdx.x >> 1;
      const int part = threadIdx.x & 1;
      const int qr = q0 + rl;
      const long long qrc = qr < sq ? qr : 0;
      const float dl = apex::row_delta<D, 2>(dog + qrc * do_v.r,
                                             og + qrc * o_v.r, part);
      if (part == 0) {
        delta_s[rl] = qr < sq ? dl : 0.f;
        lse_s[rl] = qr < sq ? plse[static_cast<size_t>(r) * sq + qr] : 0.f;
      }
    }
    apex::cp_async_wait<0>();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 query rows x 64 kv columns per warp
    float sc[kBk / 8][4], dp[kBk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qp = q_s + wrow * kLd + kk * 16 + 2 * t;
      const bf16* op = do_s + wrow * kLd + kk * 16 + 2 * t;
      const uint32_t qa[4] = {apex::lds32(qp), apex::lds32(qp + 8 * kLd),
                              apex::lds32(qp + 8),
                              apex::lds32(qp + 8 * kLd + 8)};
      const uint32_t oa[4] = {apex::lds32(op), apex::lds32(op + 8 * kLd),
                              apex::lds32(op + 8),
                              apex::lds32(op + 8 * kLd + 8)};
#pragma unroll
      for (int nt = 0; nt < kBk / 8; ++nt) {
        const bf16* kp = k_s + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        const bf16* vp = v_s + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        apex::mma_bf16(sc[nt], qa, apex::lds32(kp), apex::lds32(kp + 8));
        apex::mma_bf16(dp[nt], oa, apex::lds32(vp), apex::lds32(vp + 8));
      }
    }

#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rl = wrow + (c >> 1) * 8;
        const int qr = q0 + rl;
        const int kc = k0 + nt * 8 + 2 * t + (c & 1);
        const bool ok =
            qr < sq && kc < kv_lim && (!causal || kc <= qr + coff);
        const float x = sc[nt][c] * scale +
                        apex::bias_at(pbias, r, hb, sq, sk, qr, kc);
        const float pr = ok ? expf(x - lse_s[rl]) : 0.f;
        acc[nt][c] += pr * (dp[nt][c] - delta_s[rl]);
      }
    }
    __syncthreads();  // the next row's copies reuse the tiles
  }

  float* dst = pdbias + static_cast<size_t>(th) * sq * sk;
#pragma unroll
  for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qr = q0 + wrow + (c >> 1) * 8;
      const int kc = k0 + nt * 8 + 2 * t + (c & 1);
      if (qr < sq && kc < sk)
        dst[static_cast<size_t>(qr) * sk + kc] = acc[nt][c];
    }
  }
}

template <int D, bool kVarlen>
cudaError_t launch(const FlashParams& p, cudaStream_t stream) {
  const size_t smem = dbias_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dbias_kernel<D, kVarlen>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.hb, (p.sq + kBq - 1) / kBq, (p.sk + kBk - 1) / kBk);
  flash_bwd_dbias_kernel<D, kVarlen><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

namespace apex {
namespace flash_dbias_sm80 {

// d picks the compiled head dim; the caller checked the arguments
int run(int d, const FlashParams& p, void* stream) {
  if ((p.sq + kBq - 1) / kBq > 65535 || (p.sk + kBk - 1) / kBk > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool varlen = p.kv_lens != nullptr;
  cudaError_t err;
  if (d == 128)
    err = varlen ? launch<128, true>(p, st) : launch<128, false>(p, st);
  else
    err = varlen ? launch<64, true>(p, st) : launch<64, false>(p, st);
  return static_cast<int>(err);
}

}  // namespace flash_dbias_sm80
}  // namespace apex
