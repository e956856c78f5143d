// The "sm80" variant of the flash-attention backward: the port's first
// dK/dV and dQ kernels (mma.sync on 4-warp CTAs, cp.async double
// buffering), kept beside the wgmma/TMA pair of flash_attn_bwd.cu for the
// A/B timing of the two and for the kernel tests; no train path runs
// them. They take every layout the wgmma pair takes -- the packed q|k|v
// buffer, the bh-flat views and the seq-major tensors -- as (batch, head,
// row)-strided views (flash_params.cuh), with kv_lens, the bucketed
// relative bias (kRel: the table gradient summed in the dK/dV kernel) and
// the array bias (kArr, read from device memory per score). Each kernel
// computes delta = rowsum(do * o) from O itself. Reached through
// flash_attn_bwd.cu's entries with variant 0.
//
// Design:
// * dK/dV: one CTA of 4 warps per (b*h_kv, 64-row kv tile); each warp owns
//   16 kv rows. It walks EVERY query head of its kv group whose kv length
//   reaches the tile, and every 32-row query tile from the causal diagonal
//   down, double-buffering q and do tiles by cp.async. Per tile it
//   recomputes S^T = K Q^T on the tensor cores, p = exp(s*scale [+ bias] -
//   lse), delta = rowsum(do * o) in fp32, then dV += p.to(bf16)^T do, dP^T
//   = V do^T, dS = (p * (dP - delta) * scale).to(bf16), dK += dS^T q. dK
//   and dV of the whole group accumulate in fp32 registers and are cast
//   once. A kv tile no query head reaches writes zeros.
// * the table gradient (kRel): each warp stores its 16 x 32 tile of the
//   UNSCALED fp32 dS in shared memory; lane L sums the tile's diagonals
//   L - 31 and L + 1; the sums go to per-CTA bins of the clamped offset,
//   folded into buckets when the CTA is done with a head and added to
//   dtab[head % hb][bucket] with one fp32 atomicAdd each.
// * dQ: one CTA per (b*h, 64-row query tile), walking kv tiles up to the
//   diagonal and the row's kv length: S, p, dP = do V^T, dS as above,
//   dQ += dS K; its own delta.
// * masks: a score takes part iff its query row < sq, its key column <
//   sk and < the row's kv length, and (causal) column <= row + sk - sq.
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

}  // namespace

namespace apex {
namespace flash_bwd_sm80 {

// the entries of flash_attn_bwd.cu call these for variant 0
int run_dkv(int d, const FlashParams& p, int b, void* stream) {
  return run<true>(d, p, b, stream);
}

int run_dq(int d, const FlashParams& p, int b, void* stream) {
  return run<false>(d, p, b, stream);
}

}  // namespace flash_bwd_sm80
}  // namespace apex
