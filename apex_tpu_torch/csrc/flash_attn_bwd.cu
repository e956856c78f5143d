// Flash-attention backward for Hopper (sm_90a): a dK/dV kernel and a dQ
// kernel, over the packed q|k|v buffer of the GPT train step, the bh-flat
// (b, h, s, d) views of the T5 train step and the seq-major (b, s, h, d)
// q/k/v of the BERT train step; the dK/dV kernel also computes the
// bucket-table gradient of the relative bias.
//
// Replaces apex_tpu/ops/pallas/attention.py::flash_bwd_packed (:592-775):
// all three of its Pallas call sites -- the single-block body
// _bwd_single_block_kernel (:536-589, call :642), which the reference runs
// when the whole sequence is one block (s <= 1024 at its default blocks),
// and the _bwd_dq_kernel / _bwd_dkv_kernel pair (:869-1018, calls :676 and
// :710) for longer sequences. The three compute one function; a 1024 x
// 1024 fp32 score tile is 4 MB, far over a block's 227 KB of shared
// memory, so one tiled design serves every sequence length here. And
// replaces ::flash_bwd (:1249-1411) of the bh-flat layout: its dQ (:1277)
// and dK/dV (:1302) calls with kv_lens and the bucketed rel_bias, and
// _dtable_pallas (:1212; body _bwd_dtable_kernel, :1114-1203), a third
// pass that recomputes dS with both products per tile to sum it by bucket.
// Here dS already sits in the dK/dV kernel's registers: the table
// gradient costs no third pass and no extra launch. And replaces
// ::flash_bwd_bshd (:1395-1530), its dQ (:1455) and dK/dV (:1486) calls,
// with per-batch kv_lens and the array bias (whose gradient is
// flash_attn_dbias.cu's); the reference's per-q-head fp32 dK/dV partials
// summed outside (:1473-1511) are summed over the group in-kernel here.
//
// Entries: apex_flash_bwd_dkv / apex_flash_bwd_dq (packed): qkv (b, s,
// (h + 2*h_kv)*d), o and do (b, s, h*d), lse (b, h, s) -> dq (b, s, h*d),
// dk and dv (b, s, h_kv*d). apex_flash_bwd_flat_dkv / _dq: q, k, v, o,
// do, dq, dk and dv as (batch, head, row)-strided views
// (flash_params.cuh), sq != sk with bottom-right causal alignment, and the
// forward's compile-time options kVarlen, kRel and kArr (the array bias,
// read from device memory per score), and kv_lens read at bi * lens_b +
// hi * lens_h; the seq-major (b, s, h, d) tensors go through the same
// entries as the flat layout's head-stride-d case with per-batch kv_lens
// (lens_b = 1, lens_h = 0). All bf16 with fp32 lse.
// The packed and the strided families are separate kernels of one design:
// one templated body with the packed layout as a compile-time case ran the
// packed pair slower on an H100 than these kernels do (timed in turns in
// one call), where sharing the forward's body cost nothing once its
// pointers and scalars were locals.
//
// Bound on this card at the GPT train step's shape (b 20, s 1024, h 8,
// d 128, causal): operations. The backward does 2.5x the forward's products
// (dV, dP, dK and dQ, plus the recomputed QK^T): ~107 GFLOP per layer,
// ~108 us at 989 TFLOP/s; this design recomputes QK^T and dP once in each
// kernel, 3.5x the forward's products, for no atomics and no fp32 dq
// round trip through device memory.
//
// Design, simple and right first:
// * dK/dV: one CTA of 4 warps per (b*h_kv, 64-row kv tile); each warp owns
//   16 kv rows. It walks EVERY query head of its kv group whose kv length
//   reaches the tile, and every 32-row query tile from the causal diagonal
//   down, double-buffering q and do tiles by cp.async. Per tile it
//   recomputes S^T = K Q^T on the tensor cores, p = exp(s*scale [+ bias] -
//   lse), delta = rowsum(do * o) in fp32 (read here, as :574-575 does: no
//   prologue pass), then dV += p.to(bf16)^T do, dP^T = V do^T, dS =
//   (p * (dP - delta) * scale).to(bf16), dK += dS^T q. dK and dV of the
//   whole group accumulate in fp32 registers and are cast once --
//   _group_sum's rule, fp32 before the cross-head sum (:317-324, :631,
//   :657-659). A kv tile no query head reaches writes zeros.
// * the table gradient (kRel): each warp stores its 16 x 32 tile of the
//   UNSCALED fp32 dS (the bias enters after the scale, :346-353) in shared
//   memory; lane L sums the tile's diagonals L - 31 and L + 1 (one offset
//   each); the sums go to per-CTA bins of the clamped offset (shared
//   atomics, distinct bins within a warp; the two clamped end bins are
//   summed over the warp first). When the CTA is done with a head, its
//   bins are folded into buckets through `bucket` and each nonzero bucket
//   is added to dtab[head % hb][bucket] with one fp32 atomicAdd.
// * dQ: one CTA per (b*h, 64-row query tile), walking kv tiles up to the
//   diagonal and the row's kv length: S, p, dP = do V^T, dS as above,
//   dQ += dS K; its own delta.
// * masks: a score takes part iff its query row < sq, its key column <
//   sk and < the row's kv length, and (causal) column <= row + sk - sq;
//   other entries get p = 0, which is the reference's exp(-1e30 - lse).
// Known weaknesses, for a later change: mma.sync instead of wgmma/TMA; K,
// V, q and do fragments are re-read from shared memory for every product.
#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"
#include "flash_params.cuh"

namespace {

using bf16 = __nv_bfloat16;
using apex::FlashParams;

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kBkv = 64;       // dK/dV kernel: kv rows per CTA
constexpr int kBqStep = 32;    // dK/dV kernel: query rows per step
constexpr int kBq = 64;        // dQ kernel: query rows per CTA
constexpr int kBk = 64;        // dQ kernel: kv rows per step
constexpr int kDsLd = kBqStep + 1;  // flat dK/dV kRel: dS tile row pitch
constexpr int kMaxBuckets = 128;

size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

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

using apex::row_delta;

// --- the packed kernels -------------------------------------------------------

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

// --- the bh-flat kernels: strided operands, kVarlen, kRel ------------------

// Fold a head's offset bins into its buckets and add each nonzero bucket
// to dtab[row % hb] with one atomic. Call after a __syncthreads() that
// follows the last bin update; leaves the bins zeroed.
__device__ void flush_bins(const FlashParams& p, float* bins, float* bsum,
                           int row) {
  const int n = 2 * p.maxd + 1;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float x = bins[i];
    if (x != 0.f) atomicAdd(&bsum[p.bucket[i]], x);
    bins[i] = 0.f;
  }
  __syncthreads();
  float* dst = p.dtab + static_cast<size_t>(row % p.hb) * p.nb;
  for (int i = threadIdx.x; i < p.nb; i += kThreads) {
    const float x = bsum[i];
    if (x != 0.f) atomicAdd(&dst[i], x);
    bsum[i] = 0.f;
  }
}

template <int D, bool kVarlen, bool kRel, bool kArr>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_flat_dkv_kernel(const FlashParams p) {
  const long long q_h = p.q_v.h, kv_b = p.kv_v.b, kv_h = p.kv_v.h;
  const long long kv_r = p.kv_v.r;
  const int sk = p.sk, coff = p.sk - p.sq;  // bottom-right causal offset
  // locals, not the struct's fields, in the body: restrict-qualified
  // pointers and hoisted scalars (see flash_attn_fwd.cu)
  const bf16* __restrict__ pq = p.q;
  const bf16* __restrict__ pk = p.k;
  const bf16* __restrict__ pv = p.v;
  const bf16* __restrict__ po = p.o;
  const bf16* __restrict__ pdo = p.dout;
  const float* __restrict__ plse = p.lse;
  const int* __restrict__ kv_lens = p.kv_lens;
  const float* __restrict__ pbias = p.bias;
  const apex::View q_v = p.q_v, o_v = p.o_v, do_v = p.do_v;
  const float scale = p.scale;
  const int causal = p.causal, h = p.h, h_kv = p.h_kv;
  const int maxd = p.maxd, rel_off = p.rel_off;
  const int sq = p.sq;
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBkv * kLd;
  bf16* q_s = v_s + kBkv * kLd;          // [2][kBqStep][kLd]
  bf16* do_s = q_s + 2 * kBqStep * kLd;  // [2][kBqStep][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kBqStep * kLd);
  float* delta_s = lse_s + kBqStep;
  // kRel: [4 warps][16][kDsLd] dS tiles, the lookup, the offset bins and
  // the bucket sums
  float* ds_s = delta_s + kBqStep;
  float* lut_s = ds_s + 4 * 16 * kDsLd;
  const int nlut = kRel ? 2 * maxd + 1 : 0;
  float* bins_s = lut_s + nlut;
  float* bsum_s = bins_s + nlut;

  const int group = h / h_kv;
  const int bi = blockIdx.x / h_kv;
  const int kvh = blockIdx.x - bi * h_kv;
  const int k0 = blockIdx.y * kBkv;
  const bf16* kg = pk + bi * kv_b + kvh * kv_h;
  const bf16* vg = pv + bi * kv_b + kvh * kv_h;
  // the group's query heads whose kv length reaches this tile
  auto live = [&](int i) {
    return !kVarlen || k0 < apex::kv_len(kv_lens, bi, kvh * group + i,
                                         p.lens_b, p.lens_h, sk);
  };
  int nlive = group;
  if (kVarlen) {
    nlive = 0;
    for (int i = 0; i < group; ++i) nlive += live(i);
  }
  auto nth_live = [&](int n) {
    if (!kVarlen) return n;
    for (int i = 0; i < group; ++i)
      if (live(i) && n-- == 0) return i;
    return 0;
  };

  // query tiles from the diagonal down (row r sees column c iff c <= r +
  // off), for each live head of the group
  const int qt0 = causal ? max(k0 - coff, 0) / kBqStep : 0;
  const int per = (sq + kBqStep - 1) / kBqStep - qt0;
  const int total = nlive * per;
  auto tile_q0 = [&](int it) { return (qt0 + it % per) * kBqStep; };
  auto q_base = [&](int head) {
    return pq + bi * q_v.b + head * q_h;
  };
  auto do_base = [&](int head) {
    return pdo + bi * do_v.b + head * do_v.h;
  };

  apex::load_rows<D, kBkv, kThreads>(k_s, kg, kv_r, k0, sk);
  apex::load_rows<D, kBkv, kThreads>(v_s, vg, kv_r, k0, sk);
  if (total > 0) {
    const int h0 = kvh * group + nth_live(0);
    apex::load_rows<D, kBqStep, kThreads>(q_s, q_base(h0), q_v.r,
                                          tile_q0(0), sq);
    apex::load_rows<D, kBqStep, kThreads>(do_s, do_base(h0), do_v.r,
                                          tile_q0(0), sq);
  }
  apex::cp_async_commit();
  if (kRel) {
    for (int i = threadIdx.x; i < nlut; i += kThreads) bins_s[i] = 0.f;
    for (int i = threadIdx.x; i < p.nb; i += kThreads) bsum_s[i] = 0.f;
  }

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

  int cur_head = -1;  // the head whose lookup and bins are loaded
  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    const int head = kvh * group + nth_live(it / per);
    const int row = bi * h + head;
    const int q0 = tile_q0(it);
    const int kv_lim =
        kVarlen ? apex::kv_len(kv_lens, bi, head, p.lens_b, p.lens_h, sk)
                : sk;
    if (kRel && head != cur_head) {
      // the previous iteration ended in __syncthreads(): its bin updates
      // are done and nothing reads the lookup any more
      if (cur_head >= 0) {
        flush_bins(p, bins_s, bsum_s, bi * h + cur_head);
        __syncthreads();
      }
      const float* lut = p.lut + static_cast<size_t>(row % p.hb) * nlut;
      for (int i = threadIdx.x; i < nlut; i += kThreads) lut_s[i] = lut[i];
      cur_head = head;
    }
    if (it + 1 < total) {
      const int nh = kvh * group + nth_live((it + 1) / per);
      const int nq0 = tile_q0(it + 1);
      apex::load_rows<D, kBqStep, kThreads>(q_s + (buf ^ 1) * kBqStep * kLd,
                                            q_base(nh), q_v.r, nq0, sq);
      apex::load_rows<D, kBqStep, kThreads>(do_s + (buf ^ 1) * kBqStep * kLd,
                                            do_base(nh), do_v.r, nq0, sq);
      apex::cp_async_commit();
    }
    {  // delta and lse of this tile's rows: 4 threads per row
      const int r = threadIdx.x >> 2;
      const int part = threadIdx.x & 3;
      const int qr = q0 + r;
      const long long qrc = qr < sq ? qr : 0;
      const float dl = row_delta<D, 4>(
          pdo + bi * do_v.b + head * do_v.h + qrc * do_v.r,
          po + bi * o_v.b + head * o_v.h + qrc * o_v.r, part);
      if (part == 0) {
        delta_s[r] = qr < sq ? dl : 0.f;
        lse_s[r] = qr < sq ? plse[static_cast<size_t>(row) * sq + qr] : 0.f;
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

    // p = exp(s*scale [+ bias] - lse) on live entries, 0 elsewhere; then dS
    float* dsw = ds_s + warp * 16 * kDsLd;
#pragma unroll
    for (int nt = 0; nt < kBqStep / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kr = k0 + wrow + (c >> 1) * 8;
        const int ql = nt * 8 + 2 * t + (c & 1);
        const int qc = q0 + ql;
        const bool ok =
            qc < sq && kr < kv_lim && (!causal || kr <= qc + coff);
        float x = st[nt][c] * scale;
        if (kRel) x += lut_s[apex::rel_index(kr, qc, rel_off, maxd)];
        if (kArr) x += apex::bias_at(pbias, row, p.hb, sq, sk, qc, kr);
        const float pr = ok ? expf(x - lse_s[ql]) : 0.f;
        st[nt][c] = pr;
        const float ds = pr * (dpt[nt][c] - delta_s[ql]);
        if (kRel) dsw[(g + (c >> 1) * 8) * kDsLd + ql] = ds;
        dpt[nt][c] = ds * scale;
      }
    }
    if (kRel) {
      // the warp's 16 x 32 tile of unscaled dS by diagonal: local offset
      // dd = kv row - query column in [-31, 15]; lane L sums dd = L - 31
      // and (L < 15) dd = L + 1
      __syncwarp();
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        if (r <= lane) sum_a += dsw[r * kDsLd + r + 31 - lane];
        if (r > lane) sum_b += dsw[r * kDsLd + r - lane - 1];
      }
      const int base = k0 + warp * 16 - q0;  // + dd = kv row - query row
      const int ia = apex::rel_index(base + lane - 31, 0, rel_off, maxd);
      const int ib = apex::rel_index(base + lane + 1, 0, rel_off, maxd);
      const int top = 2 * maxd;
      float lo = (ia == 0 ? sum_a : 0.f) + (ib == 0 ? sum_b : 0.f);
      float hi = (ia == top ? sum_a : 0.f) + (ib == top ? sum_b : 0.f);
      lo = apex::warp_sum(lo);
      hi = apex::warp_sum(hi);
      if (ia != 0 && ia != top && sum_a != 0.f) atomicAdd(&bins_s[ia], sum_a);
      if (lane < 15 && ib != 0 && ib != top && sum_b != 0.f)
        atomicAdd(&bins_s[ib], sum_b);
      if (lane == 0) {
        if (lo != 0.f) atomicAdd(&bins_s[0], lo);
        if (hi != 0.f) atomicAdd(&bins_s[top], hi);
      }
      __syncwarp();  // the next tile rewrites dsw
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
  if (total == 0) apex::cp_async_wait<0>();
  if (kRel && cur_head >= 0) {
    flush_bins(p, bins_s, bsum_s, bi * h + cur_head);
  }

  const long long dkv_b = p.dkv_v.b, dkv_h = p.dkv_v.h, dkv_r = p.dkv_v.r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kr = k0 + wrow + i * 8;
    if (kr >= sk) continue;
    const long long off = bi * dkv_b + kvh * dkv_h + kr * dkv_r;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(p.dk + off + dt * 8 + 2 * t) =
          apex::pack_bf16(dk_acc[dt][2 * i], dk_acc[dt][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(p.dv + off + dt * 8 + 2 * t) =
          apex::pack_bf16(dv_acc[dt][2 * i], dv_acc[dt][2 * i + 1]);
    }
  }
}

template <int D, bool kVarlen, bool kRel, bool kArr>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_flat_dq_kernel(const FlashParams p) {
  const long long q_h = p.q_v.h, kv_b = p.kv_v.b, kv_h = p.kv_v.h;
  const long long kv_r = p.kv_v.r;
  const int sk = p.sk, coff = p.sk - p.sq;  // bottom-right causal offset
  const bf16* __restrict__ pq = p.q;
  const bf16* __restrict__ pk = p.k;
  const bf16* __restrict__ pv = p.v;
  const bf16* __restrict__ po = p.o;
  const bf16* __restrict__ pdo = p.dout;
  const float* __restrict__ plse = p.lse;
  bf16* __restrict__ pdq = p.out;
  const float* __restrict__ pbias = p.bias;
  const float scale = p.scale;
  const int causal = p.causal, h = p.h, h_kv = p.h_kv;
  const int maxd = p.maxd, rel_off = p.rel_off;
  const int sq = p.sq;
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + kBq * kLd;
  bf16* k_s = do_s + kBq * kLd;     // [2][kBk][kLd]
  bf16* v_s = k_s + 2 * kBk * kLd;  // [2][kBk][kLd]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * kBk * kLd);
  float* delta_s = lse_s + kBq;
  float* lut_s = delta_s + kBq;  // kRel

  const int row_id = blockIdx.x;  // bi * h + head
  const int bi = row_id / h;
  const int head = row_id - bi * h;
  const int kvh = head / (h / h_kv);
  const int q0 = blockIdx.y * kBq;
  const bf16* kg = pk + bi * kv_b + kvh * kv_h;
  const bf16* vg = pv + bi * kv_b + kvh * kv_h;
  const bf16* qg = pq + bi * p.q_v.b + head * q_h;
  const bf16* og = po + bi * p.o_v.b + head * p.o_v.h;
  const bf16* dog = pdo + bi * p.do_v.b + head * p.do_v.h;

  int kv_lim = sk;
  if (kVarlen) kv_lim = apex::kv_len(p.kv_lens, bi, head, p.lens_b, p.lens_h,
                                     sk);
  const int kv_end = causal ? min(kv_lim, q0 + kBq + coff) : kv_lim;
  const int nk = (kv_end + kBk - 1) / kBk;

  apex::load_rows<D, kBq, kThreads>(q_s, qg, p.q_v.r, q0, sq);
  apex::load_rows<D, kBq, kThreads>(do_s, dog, p.do_v.r, q0, sq);
  apex::load_rows<D, kBk, kThreads>(k_s, kg, kv_r, 0, kv_lim);
  apex::load_rows<D, kBk, kThreads>(v_s, vg, kv_r, 0, kv_lim);
  apex::cp_async_commit();
  {  // delta and lse of the tile's rows: 2 threads per row
    const int r = threadIdx.x >> 1;
    const int part = threadIdx.x & 1;
    const int qr = q0 + r;
    const long long qrc = qr < sq ? qr : 0;
    const float dl = row_delta<D, 2>(dog + qrc * p.do_v.r,
                                     og + qrc * p.o_v.r, part);
    if (part == 0) {
      delta_s[r] = qr < sq ? dl : 0.f;
      lse_s[r] = qr < sq ? plse[static_cast<size_t>(row_id) * sq + qr] : 0.f;
    }
  }
  if (kRel) {
    const int n = 2 * maxd + 1;
    const float* lut = p.lut + static_cast<size_t>(row_id % p.hb) * n;
    for (int i = threadIdx.x; i < n; i += kThreads) lut_s[i] = lut[i];
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
        const bool ok =
            qr < sq && kc < kv_lim && (!causal || kc <= qr + coff);
        float x = sc[nt][c] * scale;
        if (kRel) x += lut_s[apex::rel_index(kc, qr, rel_off, maxd)];
        if (kArr) x += apex::bias_at(pbias, row_id, p.hb, sq, sk, qr, kc);
        const float pr = ok ? expf(x - lse_s[rl]) : 0.f;
        dp[nt][c] = pr * (dp[nt][c] - delta_s[rl]) * scale;
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
  if (nk == 0) apex::cp_async_wait<0>();  // a row of kv length 0

  const long long dq_b = p.out_v.b, dq_h = p.out_v.h, dq_r = p.out_v.r;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = q0 + wrow + i * 8;
    if (qr >= sq) continue;
    bf16* dst = pdq + bi * dq_b + head * dq_h + qr * dq_r;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8 + 2 * t) =
          apex::pack_bf16(dq_acc[dt][2 * i], dq_acc[dt][2 * i + 1]);
  }
}

template <int D, bool kVarlen, bool kRel, bool kArr>
cudaError_t launch_flat_dkv(const FlashParams& p, int b, cudaStream_t stream) {
  size_t smem = dkv_smem_bytes<D>();
  if (kRel)
    smem += align16((4 * 16 * kDsLd + 2 * (2 * p.maxd + 1) + kMaxBuckets) *
                    sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_flat_dkv_kernel<D, kVarlen, kRel, kArr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * p.h_kv, (p.sk + kBkv - 1) / kBkv);
  flash_bwd_flat_dkv_kernel<D, kVarlen, kRel, kArr>
      <<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kVarlen, bool kRel, bool kArr>
cudaError_t launch_flat_dq(const FlashParams& p, int b, cudaStream_t stream) {
  size_t smem = dq_smem_bytes<D>();
  if (kRel) smem += align16((2 * p.maxd + 1) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_flat_dq_kernel<D, kVarlen, kRel, kArr>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b * p.h, (p.sq + kBq - 1) / kBq);
  flash_bwd_flat_dq_kernel<D, kVarlen, kRel, kArr>
      <<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// one launcher per kernel over the options the arguments ask for
template <int D, bool kDkv, bool kVarlen>
cudaError_t dispatch_bias(const FlashParams& p, int b, cudaStream_t st) {
#define APEX_LAUNCH(R, A)                                 \
  (kDkv ? launch_flat_dkv<D, kVarlen, R, A>(p, b, st) \
        : launch_flat_dq<D, kVarlen, R, A>(p, b, st))
  if (p.lut != nullptr) return APEX_LAUNCH(true, false);
  if (p.bias != nullptr) return APEX_LAUNCH(false, true);
  return APEX_LAUNCH(false, false);
#undef APEX_LAUNCH
}

template <int D, bool kDkv>
cudaError_t dispatch(const FlashParams& p, int b, cudaStream_t st) {
  return p.kv_lens != nullptr ? dispatch_bias<D, kDkv, true>(p, b, st)
                              : dispatch_bias<D, kDkv, false>(p, b, st);
}

template <bool kDkv>
int run(int d, const FlashParams& p, int b, void* stream) {
  if (b < 1 || p.sq < 1 || p.sk < 1 || p.h < 1 || p.h_kv < 1 ||
      p.h % p.h_kv || (d != 64 && d != 128) ||
      (p.sq + kBqStep - 1) / kBqStep > 65535 ||
      (p.sk + kBkv - 1) / kBkv > 65535 || (p.causal && p.sq > p.sk) ||
      static_cast<long long>(b) * p.h > 0x7fffffffLL ||
      (p.lut != nullptr && p.bias != nullptr) ||
      (p.bias != nullptr && p.hb < 1) ||
      (p.lut != nullptr &&
       (p.maxd < 1 || p.maxd > 4096 || p.hb < 1 || p.nb < 1 ||
        p.nb > kMaxBuckets || (kDkv && (!p.bucket || !p.dtab)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = d == 128 ? dispatch<128, kDkv>(p, b, st)
                                   : dispatch<64, kDkv>(p, b, st);
  return static_cast<int>(err);
}

// the bh-flat entries' shared arguments: `strides` holds (batch, head,
// row) element strides of q, k/v, o, do and the output(s) (dq, or dk/dv):
// 15 values, each a multiple of 8 elements (16-byte aligned rows)
bool flat_params(FlashParams& p, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse,
                 const void* kv_lens, const void* lut, const void* bucket,
                 const void* bias, const long long* strides, int h, int h_kv,
                 int sq, int sk, int causal, float scale, int maxd,
                 int rel_off, int hb, int nb, int lens_b, int lens_h) {
  for (int i = 0; i < 15; ++i)
    if (strides[i] < 0 || strides[i] % 8) return false;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.lut = static_cast<const float*>(lut);
  p.bucket = static_cast<const int*>(bucket);
  p.bias = static_cast<const float*>(bias);
  p.q_v = {strides[0], strides[1], strides[2]};
  p.kv_v = {strides[3], strides[4], strides[5]};
  p.o_v = {strides[6], strides[7], strides[8]};
  p.do_v = {strides[9], strides[10], strides[11]};
  p.out_v = p.dkv_v = {strides[12], strides[13], strides[14]};
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.h_kv = h_kv;
  p.causal = causal;
  p.scale = scale;
  p.maxd = maxd;
  p.rel_off = rel_off;
  p.hb = hb;
  p.nb = nb;
  p.lens_b = lens_b;
  p.lens_h = lens_h;
  return true;
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

// dk, dv (b, h_kv, sk, d) and, with a lut, the bucket-table gradient
// added into dtab (hb, nb) fp32, which the caller zeroes on the stream;
// bias (hb, sq, sk) fp32 or null (at most one of lut and bias); kv_lens
// int32 at bi * lens_b + hi * lens_h, or null. A seq-major (bshd) tensor
// is the head-stride-d case of these views, with per-batch kv_lens
// (lens_b = 1, lens_h = 0).
extern "C" int apex_flash_bwd_flat_dkv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dk, void* dv, void* dtab,
    const void* kv_lens, const void* lut, const void* bucket,
    const void* bias, const long long* strides, int b, int h, int h_kv,
    int sq, int sk, int d, int causal, float scale, int maxd, int rel_off,
    int hb, int nb, int lens_b, int lens_h, void* stream) {
  FlashParams p{};
  if (!flat_params(p, q, k, v, o, dout, lse, kv_lens, lut, bucket, bias,
                   strides, h, h_kv, sq, sk, causal, scale, maxd, rel_off, hb,
                   nb, lens_b, lens_h))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dtab = static_cast<float*>(dtab);
  return run<true>(d, p, b, stream);
}

extern "C" int apex_flash_bwd_flat_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, const void* kv_lens,
    const void* lut, const void* bias, const long long* strides, int b,
    int h, int h_kv, int sq, int sk, int d, int causal, float scale,
    int maxd, int rel_off, int hb, int lens_b, int lens_h, void* stream) {
  FlashParams p{};
  if (!flat_params(p, q, k, v, o, dout, lse, kv_lens, lut, nullptr, bias,
                   strides, h, h_kv, sq, sk, causal, scale, maxd, rel_off, hb,
                   1, lens_b, lens_h))
    return static_cast<int>(cudaErrorInvalidValue);
  p.out = static_cast<bf16*>(dq);
  return run<false>(d, p, b, stream);
}
