// Flash-attention backward over the packed q|k|v buffer, for Hopper
// (sm_90a): a dK/dV kernel and a dQ kernel.
//
// Replaces apex_tpu/ops/pallas/attention.py::flash_bwd_packed (:592-775):
// all three of its Pallas call sites -- the single-block body
// _bwd_single_block_kernel (:536-589, call :642), which the reference runs
// when the whole sequence is one block (s <= 1024 at its default blocks),
// and the _bwd_dq_kernel / _bwd_dkv_kernel pair (:869-1018, calls :676 and
// :710) for longer sequences. The three compute one function; a 1024 x
// 1024 fp32 score tile is 4 MB, far over a block's 227 KB of shared
// memory, so one tiled design serves every sequence length here.
//
// Inputs: qkv (b, s, (h + 2*h_kv)*d) bf16, o and do (b, s, h*d) bf16, the
// forward's fp32 lse (b, h, s). Outputs dq (b, s, h*d), dk and dv
// (b, s, h_kv*d), all bf16. No packed dqkv is written.
//
// Bound on this card at the train step's shape (b 20, s 1024, h 8, d 128,
// causal): operations. The backward does 2.5x the forward's products
// (dV, dP, dK and dQ, plus the recomputed QK^T): ~107 GFLOP per layer,
// ~108 us at 989 TFLOP/s; this design recomputes QK^T and dP once in each
// kernel, 3.5x the forward's products, for no atomics and no fp32 dq
// round trip through device memory.
//
// Design, simple and right first:
// * dK/dV: one CTA of 4 warps per (b*h_kv, 64-row kv tile); each warp owns
//   16 kv rows. It walks EVERY query head of its kv group and every 32-row
//   query tile from the causal diagonal down, double-buffering q and do
//   tiles by cp.async. Per tile it recomputes S^T = K Q^T on the tensor
//   cores, p = exp(s*scale - lse), delta = rowsum(do * o) in fp32 (read
//   here, as :574-575 does: no prologue pass), then dV += p.to(bf16)^T do,
//   dP^T = V do^T, dS = (p * (dP - delta) * scale).to(bf16), dK += dS^T q.
//   dK and dV of the whole group accumulate in fp32 registers and are cast
//   once -- _group_sum's rule, fp32 before the cross-head sum (:317-324,
//   :631, :657-659).
// * dQ: one CTA per (b*h, 64-row query tile), walking kv tiles up to the
//   diagonal: S, p, dP = do V^T, dS as above, dQ += dS K; its own delta.
// * masks: a score takes part iff its query row < s, its key column < s,
//   and (causal) column <= row; other entries get p = 0, which is the
//   reference's exp(-1e30 - lse).
// Known weaknesses, for a later change: mma.sync instead of wgmma/TMA; K,
// V, q and do fragments are re-read from shared memory for every product.
#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kBkv = 64;       // dK/dV kernel: kv rows per CTA
constexpr int kBqStep = 32;    // dK/dV kernel: query rows per step
constexpr int kBq = 64;        // dQ kernel: query rows per CTA
constexpr int kBk = 64;        // dQ kernel: kv rows per step

template <int D>
constexpr size_t dkv_smem_bytes() {
  return static_cast<size_t>(2 * kBkv + 4 * kBqStep) * (D + 8) * sizeof(bf16) +
         2 * kBqStep * sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return static_cast<size_t>(2 * kBq + 4 * kBk) * (D + 8) * sizeof(bf16) +
         2 * kBq * sizeof(float);
}

// rowsum(do * o) in fp32 over D elements, THREADS_PER_ROW threads per row
// (neighbouring lanes), each reading D / THREADS_PER_ROW elements in
// 16-byte loads
template <int D, int THREADS_PER_ROW>
__device__ __forceinline__ float row_delta(const bf16* dorow, const bf16* orow,
                                           int part) {
  constexpr int kPer = D / THREADS_PER_ROW;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; i += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(dorow + part * kPer + i);
    const uint4 b = *reinterpret_cast<const uint4*>(orow + part * kPer + i);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 x = __bfloat1622float2(a2[k]);
      const float2 y = __bfloat1622float2(b2[k]);
      acc += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int o = 1; o < THREADS_PER_ROW; o <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int s, int h, int h_kv,
                         int causal, float scale) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBkv * kLd;
  bf16* q_s = v_s + kBkv * kLd;          // [2][kBqStep][kLd]
  bf16* do_s = q_s + 2 * kBqStep * kLd;  // [2][kBqStep][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBqStep * kLd);
  float* delta_s = lse_s + kBqStep;

  const int group = h / h_kv;
  const int bi = blockIdx.x / h_kv;
  const int kvh = blockIdx.x - bi * h_kv;
  const int k0 = blockIdx.y * kBkv;
  const size_t feat = static_cast<size_t>(h + 2 * h_kv) * D;
  const int hd = h * D;
  const bf16* base = qkv + static_cast<size_t>(bi) * s * feat;
  const bf16* obase = o + static_cast<size_t>(bi) * s * hd;
  const bf16* dobase = dout + static_cast<size_t>(bi) * s * hd;

  // query tiles from the diagonal down, for each head of the group
  const int qt0 = causal ? k0 / kBqStep : 0;
  const int per = (s + kBqStep - 1) / kBqStep - qt0;
  const int total = group * per;
  auto tile_head = [&](int it) { return kvh * group + it / per; };
  auto tile_q0 = [&](int it) { return (qt0 + it % per) * kBqStep; };

  apex::load_rows<D, kBkv, kThreads>(k_s, base + (h + kvh) * D, feat, k0, s);
  apex::load_rows<D, kBkv, kThreads>(v_s, base + (h + h_kv + kvh) * D, feat,
                                     k0, s);
  apex::load_rows<D, kBqStep, kThreads>(q_s, base + tile_head(0) * D, feat,
                                        tile_q0(0), s);
  apex::load_rows<D, kBqStep, kThreads>(do_s, dobase + tile_head(0) * D, hd,
                                        tile_q0(0), s);
  apex::cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16 + g;  // this thread's kv rows: wrow, wrow + 8

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    const int head = tile_head(it);
    const int q0 = tile_q0(it);
    if (it + 1 < total) {
      const int nh = tile_head(it + 1);
      const int nq0 = tile_q0(it + 1);
      apex::load_rows<D, kBqStep, kThreads>(q_s + (buf ^ 1) * kBqStep * kLd,
                                            base + nh * D, feat, nq0, s);
      apex::load_rows<D, kBqStep, kThreads>(do_s + (buf ^ 1) * kBqStep * kLd,
                                            dobase + nh * D, hd, nq0, s);
      apex::cp_async_commit();
    }
    {  // delta and lse of this tile's rows: 4 threads per row
      const int r = threadIdx.x >> 2;
      const int part = threadIdx.x & 3;
      const int qr = q0 + r;
      const size_t off = static_cast<size_t>(qr < s ? qr : 0) * hd + head * D;
      const float dl = row_delta<D, 4>(dobase + off, obase + off, part);
      if (part == 0) {
        delta_s[r] = qr < s ? dl : 0.f;
        lse_s[r] = qr < s ? lse[(static_cast<size_t>(bi) * h + head) * s + qr]
                          : 0.f;
      }
    }
    if (it + 1 < total)
      apex::cp_async_wait<1>();
    else
      apex::cp_async_wait<0>();
    __syncthreads();
    const bf16* qb = q_s + buf * kBqStep * kLd;
    const bf16* dob = do_s + buf * kBqStep * kLd;

    // S^T = K Q^T and dP^T = V do^T: 16 kv rows x 32 query columns per warp
    float st[kBqStep / 8][4], dpt[kBqStep / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBqStep / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[nt][c] = dpt[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* kp = k_s + wrow * kLd + kk * 16 + 2 * t;
      const bf16* vp = v_s + wrow * kLd + kk * 16 + 2 * t;
      const uint32_t ka[4] = {apex::lds32(kp), apex::lds32(kp + 8 * kLd),
                              apex::lds32(kp + 8),
                              apex::lds32(kp + 8 * kLd + 8)};
      const uint32_t va[4] = {apex::lds32(vp), apex::lds32(vp + 8 * kLd),
                              apex::lds32(vp + 8),
                              apex::lds32(vp + 8 * kLd + 8)};
#pragma unroll
      for (int nt = 0; nt < kBqStep / 8; ++nt) {
        const bf16* qp = qb + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        const bf16* dp = dob + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        apex::mma_bf16(st[nt], ka, apex::lds32(qp), apex::lds32(qp + 8));
        apex::mma_bf16(dpt[nt], va, apex::lds32(dp), apex::lds32(dp + 8));
      }
    }

    // p = exp(s*scale - lse) on live entries, 0 elsewhere; then dS
#pragma unroll
    for (int nt = 0; nt < kBqStep / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kr = k0 + wrow + (c >> 1) * 8;
        const int ql = nt * 8 + 2 * t + (c & 1);
        const int qc = q0 + ql;
        const bool ok = qc < s && kr < s && (!causal || kr <= qc);
        const float p = ok ? expf(st[nt][c] * scale - lse_s[ql]) : 0.f;
        st[nt][c] = p;
        dpt[nt][c] = p * (dpt[nt][c] - delta_s[ql]) * scale;
      }
    }

    // dV += P^T do and dK += dS^T q: A from registers, B (do, q) by
    // transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < kBqStep / 16; ++kk) {
      const uint32_t pa[4] = {
          apex::pack_bf16(st[2 * kk][0], st[2 * kk][1]),
          apex::pack_bf16(st[2 * kk][2], st[2 * kk][3]),
          apex::pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          apex::pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t da[4] = {
          apex::pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
          apex::pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
          apex::pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          apex::pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
      const int lrow = (kk * 16 + (lane & 15)) * kLd + (lane >> 4) * 8;
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        apex::ldmatrix_x4_trans(b, dob + lrow + dt * 8);
        apex::mma_bf16(dv_acc[dt], pa, b[0], b[1]);
        apex::mma_bf16(dv_acc[dt + 1], pa, b[2], b[3]);
        apex::ldmatrix_x4_trans(b, qb + lrow + dt * 8);
        apex::mma_bf16(dk_acc[dt], da, b[0], b[1]);
        apex::mma_bf16(dk_acc[dt + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();  // the next copy reuses this buffer; lse_s/delta_s too
  }

  const int kvd = h_kv * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = k0 + wrow + i * 8;
    if (kr >= s) continue;
    const size_t off = (static_cast<size_t>(bi) * s + kr) * kvd + kvh * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + 2 * t) =
          apex::pack_bf16(dk_acc[dt][2 * i], dk_acc[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + 2 * t) =
          apex::pack_bf16(dv_acc[dt][2 * i], dv_acc[dt][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse, bf16* __restrict__ dq,
                        int s, int h, int h_kv, int causal, float scale) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kBq * kLd;
  bf16* k_s = do_s + kBq * kLd;     // [2][kBk][kLd]
  bf16* v_s = k_s + 2 * kBk * kLd;  // [2][kBk][kLd]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * kBk * kLd);
  float* delta_s = lse_s + kBq;

  const int bi = blockIdx.x / h;
  const int head = blockIdx.x - bi * h;
  const int kvh = head / (h / h_kv);
  const int q0 = blockIdx.y * kBq;
  const size_t feat = static_cast<size_t>(h + 2 * h_kv) * D;
  const int hd = h * D;
  const bf16* base = qkv + static_cast<size_t>(bi) * s * feat;
  const bf16* kg = base + (h + kvh) * D;
  const bf16* vg = base + (h + h_kv + kvh) * D;
  const bf16* obase = o + static_cast<size_t>(bi) * s * hd + head * D;
  const bf16* dobase = dout + static_cast<size_t>(bi) * s * hd + head * D;

  const int kv_end = causal ? min(s, q0 + kBq) : s;
  const int nk = (kv_end + kBk - 1) / kBk;

  apex::load_rows<D, kBq, kThreads>(q_s, base + head * D, feat, q0, s);
  apex::load_rows<D, kBq, kThreads>(do_s, dobase, hd, q0, s);
  apex::load_rows<D, kBk, kThreads>(k_s, kg, feat, 0, s);
  apex::load_rows<D, kBk, kThreads>(v_s, vg, feat, 0, s);
  apex::cp_async_commit();
  {  // delta and lse of the tile's rows: 2 threads per row
    const int r = threadIdx.x >> 1;
    const int part = threadIdx.x & 1;
    const int qr = q0 + r;
    const size_t off = static_cast<size_t>(qr < s ? qr : 0) * hd;
    const float dl = row_delta<D, 2>(dobase + off, obase + off, part);
    if (part == 0) {
      delta_s[r] = qr < s ? dl : 0.f;
      lse_s[r] =
          qr < s ? lse[(static_cast<size_t>(bi) * h + head) * s + qr] : 0.f;
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16 + g;  // this thread's query rows: wrow, wrow + 8

  float dq_acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq_acc[i][c] = 0.f;

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
    const bf16* kb = k_s + buf * kBk * kLd;
    const bf16* vb = v_s + buf * kBk * kLd;

    // S = Q K^T and dP = do V^T: 16 query rows x 64 kv columns per warp
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
        const bf16* kp = kb + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        const bf16* vp = vb + (nt * 8 + g) * kLd + kk * 16 + 2 * t;
        apex::mma_bf16(sc[nt], qa, apex::lds32(kp), apex::lds32(kp + 8));
        apex::mma_bf16(dp[nt], oa, apex::lds32(vp), apex::lds32(vp + 8));
      }
    }

    const int k0 = j * kBk;
#pragma unroll
    for (int nt = 0; nt < kBk / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rl = wrow + (c >> 1) * 8;
        const int qr = q0 + rl;
        const int kc = k0 + nt * 8 + 2 * t + (c & 1);
        const bool ok = qr < s && kc < s && (!causal || kc <= qr);
        const float p = ok ? expf(sc[nt][c] * scale - lse_s[rl]) : 0.f;
        dp[nt][c] = p * (dp[nt][c] - delta_s[rl]) * scale;
      }
    }

    // dQ += dS K: A = dS rounded to bf16, B (K) by transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      const uint32_t a[4] = {
          apex::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
          apex::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
          apex::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          apex::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t b[4];
        apex::ldmatrix_x4_trans(
            b, kb + (kk * 16 + (lane & 15)) * kLd + dt * 8 + (lane >> 4) * 8);
        apex::mma_bf16(dq_acc[dt], a, b[0], b[1]);
        apex::mma_bf16(dq_acc[dt + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next iteration's copy reuses this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + wrow + i * 8;
    if (qr >= s) continue;
    bf16* row = dq + (static_cast<size_t>(bi) * s + qr) * hd + head * D;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + 2 * t) =
          apex::pack_bf16(dq_acc[dt][2 * i], dq_acc[dt][2 * i + 1]);
  }
}

template <int D>
cudaError_t launch_dkv(const void* qkv, const void* o, const void* dout,
                       const void* lse, void* dk, void* dv, int b, int s,
                       int h, int h_kv, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h_kv, (s + kBkv - 1) / kBkv);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, h, h_kv, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* qkv, const void* o, const void* dout,
                      const void* lse, void* dq, int b, int s, int h,
                      int h_kv, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * h, (s + kBq - 1) / kBq);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<bf16*>(dq), s, h, h_kv, causal, scale);
  return cudaGetLastError();
}

bool bad_shape(int b, int s, int h, int h_kv, int d) {
  return b < 1 || s < 1 || h < 1 || h_kv < 1 || h % h_kv ||
         (d != 64 && d != 128) || (s + kBqStep - 1) / kBqStep > 65535;
}

}  // namespace

extern "C" int apex_flash_bwd_dkv(const void* qkv, const void* o,
                                  const void* dout, const void* lse, void* dk,
                                  void* dv, int b, int s, int h, int h_kv,
                                  int d, int causal, float scale,
                                  void* stream) {
  if (bad_shape(b, s, h, h_kv, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d == 128 ? launch_dkv<128>(qkv, o, dout, lse, dk, dv, b, s, h, h_kv,
                                 causal, scale, st)
               : launch_dkv<64>(qkv, o, dout, lse, dk, dv, b, s, h, h_kv,
                                causal, scale, st);
  return static_cast<int>(err);
}

extern "C" int apex_flash_bwd_dq(const void* qkv, const void* o,
                                 const void* dout, const void* lse, void* dq,
                                 int b, int s, int h, int h_kv, int d,
                                 int causal, float scale, void* stream) {
  if (bad_shape(b, s, h, h_kv, d))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d == 128 ? launch_dq<128>(qkv, o, dout, lse, dq, b, s, h, h_kv, causal,
                                scale, st)
               : launch_dq<64>(qkv, o, dout, lse, dq, b, s, h, h_kv, causal,
                               scale, st);
  return static_cast<int>(err);
}
