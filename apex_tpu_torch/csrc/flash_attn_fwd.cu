// Flash-attention forward for Hopper (sm_90a) on wgmma and TMA: one kernel
// body for every layout the port has -- the packed q|k|v projection buffer
// of the GPT train step, the seq-major (b, s, h, d) q/k/v of the decode
// engine's prefill and the BERT train step, and the bh-flat (b, h, s, d)
// views of the T5 train step -- with kv_lens, the bucketed relative bias
// and the array bias.
//
// Replaces apex_tpu/ops/pallas/attention.py::flash_fwd_packed (:464-533,
// the pallas_call at :506), ::flash_fwd_bshd (:803-857, :831) and
// ::flash_fwd (:375-461, the bh-flat pallas_call at :436), all three
// running the kernel body _fwd_kernel (:184-297). Outputs: o bf16 and the
// natural-log normaliser lse (b*h, sq) fp32 (the reference's 8-lane lse
// carrier is a TPU layout rule; here the plain rows).
//
// fp16 (amp's strict-fp16 GPT step): the body is a template on the element
// type, and flash_attn_fwd_f16.cu compiles its fp16 instance (the packed
// entry apex_flash_fwd_f16, d 64 and 128, without kv_lens, bias or
// dropout) in a translation unit of its own, so the bf16 instances stay
// the code they were. Scores and the softmax stay fp32; P is rounded to
// fp16 (round to nearest) as the A operand of the m64nNk16 f32.f16.f16
// product, o to fp16 by round-to-nearest, so an overflow is inf. The
// reference sends fp16 to XLA (Mosaic has no f16); Hopper's tensor cores
// take it at the bf16 rate.
//
// Entries: apex_flash_fwd (packed), apex_flash_fwd_bshd and
// apex_flash_fwd_flat, variant 1 (this file's kernel) or 0
// (flash_attn_fwd_sm80.cu's first mma.sync kernel, for the A/B timing and
// the kernel tests). The layout lives only in the host's tensor maps: one
// 4-D TMA map (d, row, head, batch) per q, k and v from the views'
// strides (flash_sm90.cuh); the packed buffer is the map over its three
// sections (head stride d, row stride (h + 2*h_kv)*d), a seq-major tensor
// the head-stride-d case. So the bshd prefill on views of one packed
// buffer and the packed entry run the same code on the same bytes:
// bit-identical results.
//
// Bound on this card: at the GPT train step's call (b 20, s 1024, h 8, d
// 128, causal) operations, 4 d per causal score pair: 43 us at 989
// TFLOP/s, against 126 MB of q/k/v/o (38 us at 3.35 TB/s); at T5's encoder
// (b*h 1536, 512^2, d 64) bytes, 403 MB (120 us) against 103 GFLOP (104
// us); with T5's array bias (hb 12) its 12.6 MB more.
//
// Design:
// * 384 threads: warpgroup 0 the producer (warp 0 issues the TMA loads;
//   all four copy an array bias that no tensor map describes; it hands its
//   registers to the consumers by setmaxnreg 40/232), two consumer
//   warpgroups of 64 query rows each: a tile is 128 query rows of one
//   (batch, head). Tiles go head by head (those in flight share their
//   head's K and V in the L2), within a head the last query tiles first
//   (causal: the longest, so the short diagonal ones fill the tail).
// * Tiles of equal work (no causal mask, or one query tile a head: T5's
//   encoder, cross and 114-row decoder calls, BERT) go to one CTA an SM,
//   CTA c walking tiles c, c + #SMs, ...: the producer loads the next
//   tile's K/V (and at d 64 its Q, into a second buffer) while the
//   consumers finish this one (one CTA a tile left the SM idle through
//   each short tile's loads and stores, and ran T5's 114-row decoder call
//   slower than the sm80 kernel). Causal tiles of uneven work (GPT, the
//   prefill) get one CTA each, the longest first, as the SMs free up.
// * Q is loaded once a tile; K and V go through a ring of 128-row kv
//   tiles (64 with the array bias at d 128), each stage with a full and an
//   empty mbarrier (FwdCfg). The kv walk stops at the
//   causal diagonal (bottom-right alignment: row r sees column c <= r + sk
//   - sq) and at the head's kv length; a warpgroup skips a tile wholly
//   above its rows' diagonal.
// * Measured and dropped: issuing stage j's S = Q K^T together with stage
//   j-1's P.V so the softmax of S_j overlaps the tensor cores (FA3's
//   intra-warpgroup overlap) ran slower at every call timed (GPT's and
//   T5's), as deferred waits did in the backward pair.
// * S = Q K^T: wgmma with both operands from shared memory, K-major. The
//   online softmax runs in registers: the running row max m over the
//   scores (raw without a bias, scale > 0 keeping the order; scaled and
//   biased with one), p = 2^(s log2e' - m log2e') with the scale folded
//   into log2e', l sums the UNROUNDED p, and a tile wholly inside the
//   masks skips the mask selects. P . V: wgmma with A from registers (the
//   score accumulators rounded to bf16 are that A fragment, no shuffle) and
//   V read MN-major through the descriptor's transpose bit.
// * The array bias (kArr): the CTA's (128 query rows x kv tile) block of
//   the fp32 (hb, sq, sk) bias rides each ring stage (64 KB at d 64, 2
//   stages; 32 KB of a 64-row kv tile at d 128, 3 stages: within the 227
//   KB), by TMA or cp.async (flash_sm90.cuh); each score reads its bias
//   from shared memory, none from device memory. kRel: the 2*maxd + 1 lookup values of every bias row
//   in shared memory where they fit (else the tile's row's, reloaded when
//   it changes), read per score through the clamped offset, at fixed
//   distances from a per-thread base where no offset clamps, or as one
//   value where all clamp to one end.
// * The reference's rounding points (_fwd_kernel :251-297): scores fp32,
//   * scale, + bias; masked scores -1e30; l sums the unrounded p; p rounded
//   to bf16 for P.V; o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30))
//   in the natural log (the backward reads it); a row of kv length 0 gives
//   o = 0 and lse = 0. The exponent is the MUFU's 2^x (relative error
//   ~2^-22) with log2 e folded into the scale. o is stored from registers
//   (4-byte stores, a quad's 16 bytes a row), lse by the rows' lane 0.
// * Dropout (_fwd_kernel :191-196, :269-272): instances of their own
//   (kDrop; with the bucketed bias, the array bias or neither: the kArr
//   instance adds the staged bias to the scaled scores before the masks,
//   as the dropout-free one), compiled in flash_attn_fwd_dropout.cu
//   beside this file, so the dropout-free kernels are the code they were
//   (a uniform runtime branch cost the GPT and T5 calls 2-5%, PERF.md).
//   After the stage's p, each score's keep bit from dropout_hash.cuh on
//   (q-head row u.row, query row, key column) -- the key and the thread's
//   two query rows' keys a stage, one fmix32 a score -- and p *= scale or
//   0 before the bf16 A fragment of P.V; l sums the un-dropped p, so lse
//   equals the dropout-free call's bit for bit.
// * Deterministic: no atomics; bit-identical from run to run.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; the sm80 kernel
// timed in turns in brackets, then SDPA's forward, then the bound), ms:
// GPT packed 0.140 [0.285] 0.099 0.050; decode prefill 0.0497 [0.0819]
// 0.0337 0.0201; BERT 0.108 [0.171] 0.151 0.032; T5's encoder 0.387
// unpadded, 0.415 padded [0.759, 0.644] (SDPA 0.557 padded) 0.107-0.121;
// its decoder 0.071 [0.079] 0.052 0.027; its cross call 0.094-0.096
// [0.157-0.183] 0.124-0.133; the array bias at the encoder 0.446
// [2.480] 0.466 0.125 (1.15x the unbiased call), at the decoder 0.102
// [0.134] 0.053, bshd hb 1 0.149 [0.491] 0.195. Still held back: one
// CTA an SM whose two consumer warpgroups each wait for S, do the
// softmax, then wait for P.V; short rows (T5's 114) are latency-bound;
// the decoder's bias (rows of 456 bytes) is copied by cp.async.
// Registers: 168 a thread at launch, no spill but 8-16 bytes at d 128
// with a bias or the lookup (the kArr x kDrop instances: 12 bytes of
// spill stores at d 64, 8 at d 128). With dropout 0.1 (the kDrop
// instances, the same registers and spills; chip_smoke.py's
// flash_dropout_times, NVIDIA H100 80GB HBM3 at 700 W), ms: GPT 0.2203
// (1.55x its dropout-free call), BERT 0.1734 (1.63x), T5's encoder 0.7201
// (1.76x); the hash is about 13 integer operations a score against the
// 4d = 512 of the two products.
#include <cstdint>
#include <type_traits>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"
#include "apex_sm90.cuh"
#include "flash_params.cuh"
#include "flash_sm90.cuh"

namespace apex {
namespace flash_fwd_sm80 {
int run(int d, const FlashParams& p, int b, bool strided, void* stream);
}  // namespace flash_fwd_sm80
// the dropout instances (kDrop), compiled in flash_attn_fwd_dropout.cu
namespace flash_fwd_dropout {
int run(int d, const FlashParams& p, int b, int bias_tma, void* stream);
}  // namespace flash_fwd_dropout
}  // namespace apex

namespace {

using bf16 = __nv_bfloat16;
using apex::FlashParams;
using namespace apex::sm90;
using namespace apex::flash_sm90;

constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kBqCta = 128;    // query rows per CTA (64 per warpgroup)
constexpr float kNegInf = -1e30f;

// The tiles and shared memory: kv rows per stage 128, or 64 with the array
// bias at d 128 (its 128 x kBk fp32 block rides the stage). Layout: the Q
// buffers (128 rows each; two at d 64, so a CTA that walks several tiles
// loads the next tile's Q while it computes this one's), the ring of (K, V
// [, bias]) -- 3 stages, 2 at d 64 with the array bias (a 64 KB bias block
// a stage: 225 KB in all) and at d 128 with the lookup --
// the barriers, then (kRel) the lookup. At d 64 the array bias and the
// lookup take the same tiles, so T5's materialized and bucketed paths
// give bit-identical forwards.
template <int D, int BIAS>
struct FwdCfg {
  static constexpr int kBk = BIAS == kArr && D == 128 ? 64 : 128;
  static constexpr int kQBufs = D == 64 ? 2 : 1;
  static constexpr int kStages =
      (D == 128 && BIAS == kRel) || (D == 64 && BIAS == kArr) ? 2 : 3;
  static constexpr int kQ = D / 64 * 2 * kBox;
  static constexpr int kK = D / 64 * (kBk / 64) * kBox;
  static constexpr int kBias = BIAS == kArr ? kBqCta * kBk * 4 : 0;
  static constexpr int kStage = 2 * kK + kBias;
  static constexpr int kRing = kQBufs * kQ;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kLut = kBars + 128;
  static size_t bytes(int nlut) {
    return 1024 + kLut + (BIAS == kRel ? 4 * nlut : 0);
  }
  static_assert(kQBufs <= 4 && kStages <= 4, "the barriers' 128 bytes");
};

// T: the element type; kF16Fault: an fp16 instance's planted fault
template <int D, int BIAS, bool kDrop, typename T = bf16, int kF16Fault = 0>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_bias,
                    const apex::FlashParamsT<T> p, int bias_tma) {
  constexpr int f16_fault = kF16Fault;  // 0 in every bf16 instance
  using C = FwdCfg<D, BIAS>;
  constexpr int kBk = C::kBk, kS = C::kStages, kQB = C::kQBufs;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t ring = base + C::kRing;
  const uint32_t bars = base + C::kBars;
  // the barriers: Q full and empty (4 each at most), then the ring's full
  // and empty (4 each at most): 128 bytes (4 Q buffers and 4 stages at d
  // 64 timed no faster on T5's calls than 2 and 3)
  auto qfull = [&](int b) { return bars + 8 * b; };
  auto qempty = [&](int b) { return bars + 32 + 8 * b; };
  auto full = [&](int s) { return bars + 64 + 8 * s; };
  auto empty = [&](int s) { return bars + 64 + 8 * (kS + s); };

  const int h = p.h, sq = p.sq, sk = p.sk;
  const int coff = sk - sq;  // bottom-right causal offset
  const int causal = p.causal;
  const int nq = (sq + kBqCta - 1) / kBqCta;
  const int ntiles = p.tiles;
  // tile t: head by head, within a head the last query tiles first; CTA c
  // walks tiles c, c + gridDim.x, ...
  struct Tile {
    int row, bi, head, q0, kv_lim, nk;
  };
  auto tile_at = [&](int t) {
    Tile u;
    u.row = t / nq;  // bi * h + head
    u.bi = u.row / h;
    u.head = u.row - u.bi * h;
    u.q0 = (nq - 1 - (t - u.row * nq)) * kBqCta;
    u.kv_lim = p.kv_lens ? apex::kv_len(p.kv_lens, u.bi, u.head, p.lens_b,
                                        p.lens_h, sk)
                         : sk;
    const int kv_end =
        causal ? min(u.kv_lim, u.q0 + kBqCta + coff) : u.kv_lim;
    u.nk = kv_end > 0 ? (kv_end + kBk - 1) / kBk : 0;
    return u;
  };
  const bool copy_bias = BIAS == kArr && !bias_tma;

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kQB; ++b) {
      mbar_init(qfull(b), 1);
      mbar_init(qempty(b), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < kS; ++s) {
      // the TMA bytes' arrival, and each bias-copying producer warp's
      mbar_init(full(s), copy_bias ? 5 : 1);
      mbar_init(empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    // warp 0 issues the TMA loads; with a bias no map describes, all four
    // warps copy it
    const int pw = threadIdx.x >> 5;
    if (pw == 0 || copy_bias) {
      if (threadIdx.x == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_k);
        tma_prefetch(&tm_v);
      }
      const bool tb = BIAS == kArr && bias_tma;
      int it = 0;  // the ring's stage count over the CTA's tiles
      for (int t = blockIdx.x, ti = 0; t < ntiles; t += gridDim.x, ++ti) {
        const Tile u = tile_at(t);
        const int kvh = u.head / (h / p.h_kv);
        if (threadIdx.x == 0) {  // Q, once its buffer's last tile let it go
          const int qb = ti % kQB;
          mbar_wait(qempty(qb), ((ti / kQB) & 1) ^ 1);
          mbar_expect_tx(qfull(qb), C::kQ);
          load_rows<D>(base + qb * C::kQ, &tm_q, kBqCta, u.q0, u.head, u.bi,
                       qfull(qb));
        }
        for (int j = 0; j < u.nk; ++j, ++it) {
          const int s = it % kS;
          const uint32_t ph = (it / kS) & 1;
          const uint32_t st = ring + s * C::kStage;
          mbar_wait(empty(s), ph ^ 1);
          if (threadIdx.x == 0) {
            mbar_expect_tx(full(s), 2 * C::kK + (tb ? C::kBias : 0));
            load_rows<D>(st, &tm_k, kBk, j * kBk, kvh, u.bi, full(s));
            load_rows<D>(st + C::kK, &tm_v, kBk, j * kBk, kvh, u.bi,
                         full(s));
            if (tb)
              stage_bias_tma<kBqCta, kBk>(st + 2 * C::kK, &tm_bias,
                                          u.row % p.hb, u.q0, j * kBk,
                                          full(s));
          }
          if (copy_bias) {
            stage_bias_copy<kBqCta, kBk>(st + 2 * C::kK, p.bias,
                                         u.row % p.hb, u.q0, j * kBk, sq, sk,
                                         threadIdx.x);
            __syncwarp();
            if (lane == 0) mbar_arrive(full(s));
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // this warpgroup's 64 query rows
    const int tid = threadIdx.x - 128;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const float scale = p.scale;
    const int maxd = p.maxd, rel_off = p.rel_off;
    float* const lut_s = reinterpret_cast<float*>(gbase + C::kLut);
    const int r0 = cw * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    // the running max is over the raw scores without a bias (scale > 0
    // keeps their order; m = the raw max * scale exactly), over the scaled
    // and biased ones with a bias; the exponent's multiplier follows
    constexpr bool kBiased = BIAS != kNone;
    const float mul = kBiased ? kLog2e : scale * kLog2e;
    const float mscale = kBiased ? 1.f : scale;  // m in the scores' units
    const long long o_b = p.out_v.b, o_h = p.out_v.h, o_r = p.out_v.r;
    int it = 0, lut_row = -1;
    float o[D / 2], sc[kBk / 2];
    for (int tt = blockIdx.x, ti = 0; tt < ntiles; tt += gridDim.x, ++ti) {
      const Tile u = tile_at(tt);
      const int q0 = u.q0, kv_lim = u.kv_lim;
      const int wq0 = q0 + cw * 64;  // this warpgroup's first row
      // the lookup: every bias row's at the CTA's first tile where they all
      // fit (p.lut_rows == hb), else the tile's row, once every consumer is
      // done with the last
      const int nlut = 2 * maxd + 1;
      const int lrow = p.lut_rows == 1 ? u.row % p.hb : 0;
      if (BIAS == kRel && lrow != lut_row) {
        if (lut_row >= 0) named_barrier(1, 256);
        lut_row = lrow;
        const float* lut = p.lut + static_cast<size_t>(lrow) * nlut;
        for (int i = tid; i < p.lut_rows * nlut; i += 256) lut_s[i] = lut[i];
        named_barrier(1, 256);
      }
      const float* lut_h =
          lut_s + (p.lut_rows == 1 ? 0 : (u.row % p.hb) * nlut);
      const int qb = ti % kQB;
      const uint32_t q_s = base + qb * C::kQ;
      zero(o);
      float m_run[2] = {kNegInf, kNegInf};
      float l_run[2] = {0.f, 0.f};  // this thread's columns only, summed last
      mbar_wait(qfull(qb), (ti / kQB) & 1);
      for (int j = 0; j < u.nk; ++j, ++it) {
        const int s = it % kS;
        const uint32_t ph = (it / kS) & 1;
        const uint32_t st = ring + s * C::kStage;
        const uint32_t k_st = st, v_st = st + C::kK;
        const float* bias_s =
            reinterpret_cast<const float*>(gbase + (st - base) + 2 * C::kK);
        const int kc0 = j * kBk;
        mbar_wait(full(s), ph);
        const bool skip = wq0 >= sq || (causal && kc0 > wq0 + 63 + coff);
        if (!skip) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<kBk, T>(sc, kmajor(q_s, kBqCta, kk, cw * 64),
                          kmajor(k_st, kBk, kk, 0), kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operand(sc);
          // rows past sq are never stored: only the kv masks apply
          const bool inside = kc0 + kBk <= kv_lim &&
                              (!causal || kc0 + kBk - 1 <= wq0 + coff);
          const int n_lo = kc0 - (wq0 + 63) + rel_off;
          const int n_hi = kc0 + kBk - 1 - wq0 + rel_off;
          const bool one_bin =
              BIAS == kRel && (n_lo >= maxd || n_hi <= -maxd);
          const bool unclamped = BIAS == kRel && n_lo > -maxd && n_hi < maxd;
          const int bin = n_lo >= maxd ? 2 * maxd : 0;
          // unclamped: score (c, i)'s offset is this thread's base + 8 i +
          // (c & 1) - 8 (c >> 1)
          const float* lut_at =
              lut_h + maxd + (kc0 - q0 - r0 + 2 * t + rel_off);
          auto elem = [&](auto masked, auto lut_mode) {
            constexpr int kMode = decltype(lut_mode)::value;
#pragma unroll
            for (int i = 0; i < kBk / 8; ++i) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int hh = c >> 1;
                const int rl = r0 + 8 * hh;
                const int qr = q0 + rl;
                const int cl = 8 * i + 2 * t + (c & 1);
                const int kc = kc0 + cl;
                float x = sc[4 * i + c];
                if (kBiased) x *= scale;
                if (BIAS == kRel)
                  x += kMode == kLutOne   ? lut_h[bin]
                       : kMode == kLutRow ? lut_at[8 * i + (c & 1) - 8 * hh]
                                          : lut_h[apex::rel_index(
                                                kc, qr, rel_off, maxd)];
                if (BIAS == kArr) x += bias_s[bias_offset<kBk>(rl, cl)];
                if (decltype(masked)::value)
                  x = kc < kv_lim && (!causal || kc <= qr + coff) ? x
                                                                  : kNegInf;
                sc[4 * i + c] = x;
              }
            }
          };
          auto run = [&](auto lut_mode) {
            if (inside)
              elem(std::false_type{}, lut_mode);
            else
              elem(std::true_type{}, lut_mode);
          };
          if (BIAS == kRel && one_bin)
            run(LutMode<kLutOne>{});
          else if (BIAS == kRel && unclamped)
            run(LutMode<kLutRow>{});
          else
            run(LutMode<kLutClamp>{});
          // the online softmax: the new row max, the old sums' rescale, p
          float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
          for (int i = 0; i < kBk / 8; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              mx[c >> 1] = fmaxf(mx[c >> 1], sc[4 * i + c]);
          float alpha[2], ml[2], ls[2] = {0.f, 0.f};
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
            alpha[hh] = ex2((m_run[hh] - mx[hh]) * mul);
            m_run[hh] = mx[hh];
            ml[hh] = mx[hh] * mul;
          }
#pragma unroll
          for (int i = 0; i < kBk / 8; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float pr = ex2(fmaf(sc[4 * i + c], mul, -ml[c >> 1]));
              sc[4 * i + c] = pr;
              ls[c >> 1] += pr;
            }
          }
          // dropout (the kDrop instances): l keeps the un-dropped p; P.V
          // takes p * scale where kept (_fwd_kernel :269-272)
          if (kDrop) {
            const uint32_t dthresh = p.drop.thresh;
            const float dscale = p.drop.scale;
            // the key of q-head row u.row, this thread's two query rows'
            const int trow = p.drop.fault == apex::kDropKeyKvHead
                                 ? u.bi * p.h_kv + u.head / (h / p.h_kv)
                                 : u.row;
            const uint32_t dkey =
                apex::drop_key(p.drop.seed, static_cast<uint32_t>(trow));
            const uint32_t drk[2] = {apex::drop_row_key(dkey, q0 + r0),
                                     apex::drop_row_key(dkey, q0 + r0 + 8)};
            auto mask = [&](auto swap) {
#pragma unroll
              for (int i = 0; i < kBk / 8; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const int hh = c >> 1;
                  const uint32_t kc = kc0 + 8 * i + 2 * t + (c & 1);
                  sc[4 * i + c] *=
                      apex::drop_keep_at<decltype(swap)::value>(
                          dkey, drk[hh], q0 + r0 + 8 * hh, kc, dthresh)
                          ? dscale
                          : 0.f;
                }
            };
            if (p.drop.fault == apex::kDropSwapRowCol)
              mask(std::true_type{});
            else
              mask(std::false_type{});
            if (p.drop.fault == apex::kDropLFromDropped) {
              ls[0] = ls[1] = 0.f;
#pragma unroll
              for (int i = 0; i < kBk / 8; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) ls[c >> 1] += sc[4 * i + c];
            }
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            l_run[hh] = l_run[hh] * alpha[hh] + ls[hh];
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            o[4 * i] *= alpha[0];
            o[4 * i + 1] *= alpha[0];
            o[4 * i + 2] *= alpha[1];
            o[4 * i + 3] *= alpha[1];
          }
          uint32_t pa[kBk / 16][4];
#pragma unroll
          for (int kk = 0; kk < kBk / 16; ++kk)
            a_frag<T, f16_fault>(pa[kk], sc, kk);
          fence_operand(o);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBk / 16; ++kk)
            wgmma_rs<D, T>(o, pa[kk], mnmajor(v_st, kk, kBk * 128));
          wgmma_commit();
          wgmma_wait<0>();
          fence_operand(o);
        }
        if (lane == 0) mbar_arrive(empty(s));
      }
      // every product that reads this Q buffer is complete
      if (lane == 0) mbar_arrive(qempty(qb));

#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float l = l_run[hh] + __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const bool dead = !(l > 0.f);  // no visible column (kv length 0)
        l = fmaxf(l, 1e-30f);
        const float inv = 1.f / l;  // o = acc / l within an ulp, then T
        const int qr = q0 + r0 + 8 * hh;
        if (qr >= sq) continue;
        T* dst = p.out + u.bi * o_b + u.head * o_h + qr * o_r;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(dst + 8 * i + 2 * t) =
              out_pair<T, f16_fault>(o[4 * i + 2 * hh] * inv,
                                     o[4 * i + 2 * hh + 1] * inv);
        if (t == 0)
          p.lse_out[static_cast<size_t>(u.row) * sq + qr] =
              dead ? 0.f : m_run[hh] * mscale + logf(l);
      }
    }
  }
}

// --- host -----------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, bias;
};

// every map of a call; the bias's only when it goes by TMA (else the
// kernel never reads it)
template <typename T>
bool make_maps(Maps& m, const apex::FlashParamsT<T>& p, int b, int d,
               int bias_tma) {
  if (!view_map<T>(&m.q, p.q, p.q_v, d, p.sq, p.h, b) ||
      !view_map<T>(&m.k, p.k, p.kv_v, d, p.sk, p.h_kv, b) ||
      !view_map<T>(&m.v, p.v, p.kv_v, d, p.sk, p.h_kv, b))
    return false;
  m.bias = m.q;
  if (p.bias != nullptr && bias_tma)
    return bias_map(&m.bias, p.bias, p.sq, p.sk, p.hb);
  return true;
}

template <int D, int BIAS, bool kDrop, typename T, int F = 0>
cudaError_t launch(const Maps& m, const apex::FlashParamsT<T>& p0,
                   unsigned ctas, int bias_tma, cudaStream_t st) {
  auto kernel = flash_fwd_wgmma<D, BIAS, kDrop, T, F>;
  apex::FlashParamsT<T> p = p0;
  // kRel: every bias row's lookup in shared memory where they fit (T5: 12
  // rows of 257 values), else one row at a time
  const size_t nlut = 2 * p.maxd + 1;
  const size_t room = 232448 - FwdCfg<D, BIAS>::bytes(0);
  p.lut_rows = BIAS == kRel && 4 * nlut * p.hb <= room ? p.hb : 1;
  const size_t smem = FwdCfg<D, BIAS>::bytes(p.lut_rows * nlut);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kThreads, smem, st>>>(m.q, m.k, m.v, m.bias, p, bias_tma);
  return cudaGetLastError();
}

// the instance of a call's options; the fp16 instances have none but
// their planted faults
template <int D, bool kDrop, typename T>
cudaError_t dispatch(const Maps& m, const apex::FlashParamsT<T>& p,
                     unsigned ctas, int bias_tma, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.lut != nullptr)
      return launch<D, kRel, kDrop, T>(m, p, ctas, bias_tma, st);
    if (p.bias != nullptr)
      return launch<D, kArr, kDrop, T>(m, p, ctas, bias_tma, st);
  } else {
    if (p.drop.fault == kF16Bf16P)
      return launch<D, kNone, kDrop, T, kF16Bf16P>(m, p, ctas, bias_tma, st);
    if (p.drop.fault == kF16Satfinite)
      return launch<D, kNone, kDrop, T, kF16Satfinite>(m, p, ctas, bias_tma,
                                                       st);
  }
  return launch<D, kNone, kDrop, T>(m, p, ctas, bias_tma, st);
}

// the SMs of the current device, asked once per device
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// the wgmma kernel's launch: the tensor maps, the tiles, the grid; kDrop
// picks the dropout instances, T the element type
template <bool kDrop, typename T = bf16>
int run_wgmma(int d, const apex::FlashParamsT<T>& p, int b, int bias_tma,
              void* stream) {
  const int nq = (p.sq + kBqCta - 1) / kBqCta;
  const long long tiles = static_cast<long long>(b) * p.h * nq;
  Maps m;
  if (tiles > 0x7fffffffLL || !make_maps(m, p, b, d, bias_tma))
    return static_cast<int>(cudaErrorInvalidValue);
  apex::FlashParamsT<T> pt = p;
  pt.tiles = static_cast<int>(tiles);
  // tiles of equal work (no causal mask, or one query tile a head) go to
  // one CTA an SM, each walking several, so a tile's loads overlap the one
  // before; causal tiles of uneven work one CTA each, the longest first,
  // as the SMs free up
  const bool even = !p.causal || nq == 1;
  const long long sms = sm_count();
  const long long ctas = even && tiles > sms ? sms : tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned n = static_cast<unsigned>(ctas);
  const cudaError_t err =
      d == 128 ? dispatch<128, kDrop, T>(m, pt, n, bias_tma, st)
               : dispatch<64, kDrop, T>(m, pt, n, bias_tma, st);
  return static_cast<int>(err);
}

#if !defined(APEX_FLASH_DROPOUT_TU) && !defined(APEX_FLASH_F16_TU)
// the argument rules both variants share; d picks the compiled head dim;
// `strided`: the sm80 variant's instantiation for views with their own
// strides (else the packed one's). Dropout: the wgmma kernel only
int run(int d, const FlashParams& p, int b, bool strided, int variant,
        int bias_tma, void* stream) {
  const bool drop = p.drop.thresh > 0;
  if ((drop && (variant != 1 || p.drop.thresh > (1u << 24))) ||
      b < 1 || p.sq < 1 || p.sk < 1 || p.h < 1 || p.h_kv < 1 ||
      p.h % p.h_kv || (d != 64 && d != 128) || (p.causal && p.sq > p.sk) ||
      static_cast<long long>(b) * p.h > 0x7fffffffLL ||
      (p.lut != nullptr && p.bias != nullptr) ||
      ((p.lut != nullptr || p.bias != nullptr) && p.hb < 1) ||
      (p.lut != nullptr && (p.maxd < 1 || p.maxd > 4096)) ||
      (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 0) return apex::flash_fwd_sm80::run(d, p, b, strided, stream);
  if (drop) return apex::flash_fwd_dropout::run(d, p, b, bias_tma, stream);
  return run_wgmma<false>(d, p, b, bias_tma, stream);
}
#endif

}  // namespace

#if defined(APEX_FLASH_DROPOUT_TU)
int apex::flash_fwd_dropout::run(int d, const FlashParams& p, int b,
                                 int bias_tma, void* stream) {
  return run_wgmma<true>(d, p, b, bias_tma, stream);
}
#elif defined(APEX_FLASH_F16_TU)
// The packed entry's fp16 instance (amp's strict-fp16 GPT step): qkv (b,
// s, (h + 2*h_kv)*d) fp16 as apex_flash_fwd's, o (b, s, h*d) fp16 and lse
// (b*h, s) fp32; the wgmma kernel without kv_lens, bias or dropout. fault:
// a planted Fp16Fault (0 sound).
extern "C" int apex_flash_fwd_f16(const void* qkv, void* out, void* lse,
                                  int b, int s, int h, int h_kv, int d,
                                  int causal, float scale, int fault,
                                  void* stream) {
  if (b < 1 || s < 1 || h < 1 || h_kv < 1 || h % h_kv ||
      (d != 64 && d != 128) ||
      static_cast<long long>(b) * h > 0x7fffffffLL ||
      (fault != apex::flash_sm90::kF16Sound &&
       fault != apex::flash_sm90::kF16Bf16P &&
       fault != apex::flash_sm90::kF16Satfinite))
    return static_cast<int>(cudaErrorInvalidValue);
  const __half* base = static_cast<const __half*>(qkv);
  const long long feat = static_cast<long long>(h + 2 * h_kv) * d;
  apex::FlashParamsT<__half> p{};
  p.q = base;
  p.k = base + h * d;
  p.v = base + (h + h_kv) * d;
  p.out = static_cast<__half*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.q_v = {s * feat, d, feat};
  p.kv_v = p.q_v;
  p.out_v = {static_cast<long long>(s) * h * d, d,
             static_cast<long long>(h) * d};
  p.sq = p.sk = s;
  p.h = h;
  p.h_kv = h_kv;
  p.causal = causal;
  p.scale = scale;
  p.hb = 1;
  p.lens_b = h;
  p.lens_h = 1;
  p.drop.fault = fault;
  return run_wgmma<false, __half>(d, p, b, 0, stream);
}
#else

// Every entry's drop_seed (the int32 seed's bits), drop_thresh (the 24-bit
// threshold; 0: no dropout), drop_scale (float32(1 / (1 - rate))) and
// drop_fault (DropFault; 0 sound): the probabilities' dropout, on variant
// 1 only (with the bucketed bias, the array bias or neither).
//
// The packed entry: qkv (b, s, (h + 2*h_kv)*d) bf16, features ordered
// q-heads | k-heads | v-heads, read straight out of qkv (no slice, no
// copy); o (b, s, h*d) bf16 and lse (b*h, s) fp32. kv_lens (b*h,) int32 per
// row or null (the path passes none: the chip checks' planted fault does).
extern "C" int apex_flash_fwd(const void* qkv, void* out, void* lse,
                              const void* kv_lens, int b, int s, int h,
                              int h_kv, int d, int causal, float scale,
                              int variant, unsigned drop_seed,
                              int drop_thresh, float drop_scale,
                              int drop_fault, void* stream) {
  const bf16* base = static_cast<const bf16*>(qkv);
  const long long feat = static_cast<long long>(h + 2 * h_kv) * d;
  FlashParams p{};
  p.q = base;
  p.k = base + h * d;
  p.v = base + (h + h_kv) * d;
  p.out = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_v = {s * feat, d, feat};
  p.kv_v = p.q_v;
  p.out_v = {static_cast<long long>(s) * h * d, d,
             static_cast<long long>(h) * d};
  p.sq = p.sk = s;
  p.h = h;
  p.h_kv = h_kv;
  p.causal = causal;
  p.scale = scale;
  p.hb = 1;
  p.lens_b = h;  // per row
  p.lens_h = 1;
  p.drop = {drop_seed, static_cast<uint32_t>(drop_thresh), drop_scale,
            drop_fault};
  return run(d, p, b, kv_lens != nullptr, variant, 0, stream);
}

// q (b, sq, h, d) and k, v (b, sk, h_kv, d) with unit head and feature
// strides; the batch and row strides are the caller's (k and v share
// theirs), so views into a larger buffer need no copy. kv_lens (b,) int32
// per batch or null; bias (hb, sq, sk) fp32 with hb | h, or null; or the
// bucketed bias: lut (hb, 2 * maxd + 1) fp32 with hb | h (head t reads
// lookup row t % hb: the b-major rows' r % hb) and rel_off, or null.
// bias_tma: the wgmma variant stages the bias by TMA (sk a multiple of 4,
// base 16-byte aligned), else by cp.async.
extern "C" int apex_flash_fwd_bshd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* kv_lens, const void* bias,
                                   long long q_bstride, long long kv_bstride,
                                   int q_stride, int kv_stride, int b, int sq,
                                   int sk, int h, int h_kv, int d, int causal,
                                   float scale, int hb, int variant,
                                   int bias_tma, unsigned drop_seed,
                                   int drop_thresh, float drop_scale,
                                   int drop_fault, const void* lut, int maxd,
                                   int rel_off, void* stream) {
  if (q_bstride < 0 || kv_bstride < 0 || q_stride < h * d ||
      kv_stride < h_kv * d || q_stride % 8 || kv_stride % 8 ||
      ((bias != nullptr || lut != nullptr) && (hb < 1 || h % hb)))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.bias = static_cast<const float*>(bias);
  p.lut = static_cast<const float*>(lut);
  p.maxd = maxd;
  p.rel_off = rel_off;
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
  p.drop = {drop_seed, static_cast<uint32_t>(drop_thresh), drop_scale,
            drop_fault};
  return run(d, p, b, true, variant, bias_tma, stream);
}

// The bh-flat entry: q (b, h, sq, d), k and v (b, h_kv, sk, d) sharing
// their strides, o (b, h, sq, d), each as (batch, head, row) element
// strides in `strides` (q, kv, o: 9 values; the feature stride is 1 and
// every stride a multiple of 8 elements, so every row is 16-byte
// aligned); lse (b*h, sq) fp32. kv_lens (b*h,) int32 or
// null; lut (hb, 2*maxd + 1) fp32 or null, row r reading lut row r % hb,
// with rel_off = k_offset - q_offset; or bias (hb, sq, sk) fp32 or null,
// row r reading bias row r % hb (at most one of lut and bias); bias_tma as
// the bshd entry's.
extern "C" int apex_flash_fwd_flat(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   const void* kv_lens, const void* lut,
                                   const void* bias,
                                   const long long* strides, int b, int h,
                                   int h_kv, int sq, int sk, int d,
                                   int causal, float scale, int maxd,
                                   int rel_off, int hb, int variant,
                                   int bias_tma, unsigned drop_seed,
                                   int drop_thresh, float drop_scale,
                                   int drop_fault, void* stream) {
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
  p.drop = {drop_seed, static_cast<uint32_t>(drop_thresh), drop_scale,
            drop_fault};
  return run(d, p, b, true, variant, bias_tma, stream);
}
#endif  // APEX_FLASH_DROPOUT_TU, APEX_FLASH_F16_TU
