// Flash-attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel on wgmma and TMA, one body each for every layout the port has --
// the packed q|k|v buffer of the GPT train step, the bh-flat (b, h, s, d)
// views of the T5 train step and the seq-major (b, s, h, d) q/k/v of the
// BERT train step -- with kv_lens, the bucketed relative bias (whose table
// gradient the dK/dV kernel sums) and the array bias.
//
// Replaces apex_tpu/ops/pallas/attention.py::flash_bwd_packed (:592-775):
// its single-block body _bwd_single_block_kernel (call :642) and the
// _bwd_dq_kernel / _bwd_dkv_kernel pair (:869-1018, calls :676 and :710);
// ::flash_bwd (:1249-1411) of the bh-flat layout, its dQ (:1277) and dK/dV
// (:1302) calls and _dtable_pallas (:1212, a third pass that recomputes dS
// to sum it by bucket; here dS already sits in the dK/dV kernel's
// registers); and ::flash_bwd_bshd (:1395-1530), its dQ (:1455) and dK/dV
// (:1486) calls. The reference's per-q-head fp32 dK/dV partials summed
// outside (:1473-1511) are summed over the group in-kernel here.
//
// fp16 (amp's strict-fp16 GPT step): both bodies are templates on the
// element type; flash_attn_bwd_f16.cu compiles their fp16 instances (the
// entries apex_flash_bwd_dq_f16 and apex_flash_bwd_dkv_f16, on the packed
// buffer's views, d 64 and 128, without kv_lens, bias or dropout) in a
// translation unit of its own, so the bf16 instances stay the code they
// were. S, dP, delta and the sums stay fp32; P and dS are rounded to fp16
// (round to nearest) as the products' A operands, as the plain version
// rounds them to the inputs' dtype: a dS past 65504 is inf, one below
// 6e-8 is 0, and dq, dk and dv overflow to inf, which the loss scaler
// reads as a skipped step.
//
// Layouts. Every operand is a (batch, head, row)-strided view with a unit
// feature stride (flash_params.cuh). The layout lives only in the host's
// tensor maps: one 4-D TMA map (d, row, head, batch) per q, k, v and do,
// from those strides, loaded in 64-row x 64-feature boxes with the
// 128-byte swizzle (d 128 is two boxes). The packed buffer is the map over
// its three sections (head stride d, row stride (h + 2*h_kv)*d), a
// seq-major tensor the head-stride-d case. A map's row extent is sq or sk,
// so TMA reads zeros past the end of a head (T5's 114, any tail) and
// never the next head's rows.
//
// Call order: dQ first. It is the only pass that reads O: it writes delta
// = rowsum(do * o) in fp32 ((b*h, sq), beside dq), and dK/dV reads delta.
//
// Bound on this card at the GPT train step's shape (b 20, s 1024, h 8,
// d 128, causal): operations. The backward needs QK^T, dP, dV, dK and dQ
// once per causal pair (10d operations); this pair recomputes QK^T and dP
// in each kernel (14d), for no atomics and no fp32 dq round trip through
// device memory.
//
// Design (tiles chosen for the registers and the 227 KB of shared memory
// at d 128, and for as much MMA work per barrier at d 64; DkvCfg, DqCfg):
// * Both kernels: 384 threads, warpgroup 0 the producer (warp 0 issues
//   the TMA loads and stages lse and delta; all four copy a bias that no
//   tensor map describes; the warpgroup hands its registers to the
//   consumers by setmaxnreg), two consumer warpgroups of 64 rows each. A
//   ring of 3 stages (2 where a bias block or the table's dS tiles take
//   the room), each with a full and an empty mbarrier.
// * dK/dV: one CTA per (b*h_kv, 128-row kv tile), CTAs kv head by kv head
//   (those in flight share their heads' Q and dO in the L2: 7% faster at
//   GPT's call than kv-tile-major) and within a head in kv-tile order
//   (causal: the longest first). K and V are loaded once. The ring holds
//   (Q, dO, lse, delta [, bias]) over the query tiles (128 rows at d 64,
//   64 at d 128 and with the array bias) the mask lets reach the tile --
//   from the causal diagonal down -- for each query head of the kv group
//   whose kv length reaches it. Per stage and warpgroup: S^T = K Q^T and
//   dP^T = V dO^T (wgmma, both operands from shared memory, K-major),
//   P^T = exp2(S^T scale log2 e [+ bias^T log2 e] - lse log2 e) and the
//   unscaled dS^T = P^T (dP^T - delta) in registers (a stage wholly inside
//   the masks skips them), then dV += P^T dO and dK += dS^T scale Q (wgmma
//   with A from registers -- the accumulators of the first two products
//   rounded to bf16 are that A fragment, no shuffle -- and B MN-major
//   through the transpose bit). dK and dV of the whole kv group stay in
//   fp32 registers with one cast at the end (the reference's _group_sum
//   rule); a kv tile no query head reaches writes zeros. A warpgroup
//   skips a stage its rows cannot see (causal, kv_len).
// * dQ: one CTA per (b*h, 128-row query tile), head by head (sharing K and
//   V in the L2), within a head the last query tiles first (causal: the
//   longest). Q and dO are loaded once; the ring holds (K, V
//   [, bias]) in kv tiles (128 rows at d 64, 64 at d 128) up to the causal
//   diagonal and the row's kv length. S = Q K^T and dP = dO V^T from
//   shared memory, dS in registers, dQ += dS K (A from registers, K
//   MN-major).
// * The array bias (kArr) is staged per stage in shared memory: the fp32
//   (bias row r % hb, query tile, kv tile) block in 64 x 32 boxes with the
//   128-byte swizzle, by TMA when a map describes it (sk a multiple of 4
//   and a 16-byte aligned base), else by 8- or 4-byte cp.async of the
//   producer warpgroup into the same layout (T5's decoder: sk 114, rows of
//   456 bytes). The consumers read it in the accumulator's fragment layout
//   (the swizzle puts the dK/dV kernel's reads in 32 distinct banks); no
//   score reads L2.
// * The bucketed bias (kRel): its lookup in shared memory (where it fits;
//   else read through the L1), read per score through the clamped offset,
//   or -- in a stage where no offset clamps -- at compile-time distances
//   from a per-thread base, or as one value where all clamp to one end.
//   The table gradient: each warp stages its 16 x kBq tile of
//   the UNSCALED fp32 dS^T from the wgmma accumulator in shared memory;
//   lane L sums the tile's diagonals L + 1 - kBq + 32 j and L + 1 into the
//   CTA's bins of their clamped offsets (distinct within a warp but for
//   the two clamped ends, summed over the warp first); a stage whose
//   offsets all clamp to one end skips the tile and sums into one bin.
//   When the CTA is done with a head, its bins are folded into buckets
//   through `bucket` and added to dtab[head % hb] with one fp32 atomicAdd
//   per bucket.
// * masks: a score takes part iff its query row < sq, its key column < sk
//   and < the row's kv length, and (causal) column <= row + sk - sq; other
//   entries get p = 0 by a select (rows past sq included: TMA filled them
//   with zeros and their lse is not a row's). A fully masked tile is
//   never loaded.
// * Dropout (_bwd_dq_kernel :929, _bwd_dkv_kernel :996-1008): instances
//   of their own (kDrop; with the bucketed bias, the array bias or
//   neither), compiled in
//   flash_attn_bwd_dropout.cu beside this file, so the dropout-free
//   kernels are the code they were (a uniform runtime branch cost GPT's
//   dQ 6%, PERF.md). Each score's keep bit from dropout_hash.cuh on (q-head row --
//   under GQA the q head's, never the kv head's -- query row, key column),
//   the same global coordinates the masks use, so any tiling rebuilds the
//   forward's mask. Both kernels scale dP by 1/(1 - rate) or 0 before
//   dS = P (dP - delta) (delta = rowsum(dO O) of the dropped O needs
//   nothing); dK/dV keeps the stage's bits in registers and gives dV the
//   dropped, rescaled P. The table gradient sums this dS.
//   Measured with dropout 0.1 (chip_smoke.py's flash_dropout_times, NVIDIA
//   H100 80GB HBM3 at 700 W), dQ / dK-dV ms: GPT 0.2478 / 0.3851 (1.35x
//   / 1.57x the dropout-free calls), BERT 0.2060 / 0.3433 (1.45x /
//   1.98x), T5's encoder 0.8399 / 1.6862 (1.47x / 1.65x). The kDrop dK/dV
//   instances spill (260 bytes at d 128, 860-928 at d 64: the stage's
//   keep bits and the hash beside S^T, dP^T, dK and dV); the dQ ones do
//   not. The kArr x kDrop instances (ptxas, 168 registers): dK/dV 196
//   bytes of spill stores at d 128 and none at d 64 (its 64-row stage
//   halves S^T and dP^T), dQ 4 bytes at d 64 and none at d 128.
// * Determinism: dq, dk and dv use no atomics and are bit-identical from
//   run to run; the table gradient keeps its fp32 atomics.
//
// Entries: apex_flash_bwd_dq and apex_flash_bwd_dkv, variant 1 (this
// file's kernels) or 0 (flash_attn_bwd_sm80.cu's mma.sync pair, which
// reads O in both kernels and ignores delta).
#include <cstdint>
#include <type_traits>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"
#include "apex_sm90.cuh"
#include "flash_params.cuh"
#include "flash_sm90.cuh"

namespace apex {
namespace flash_bwd_sm80 {
int run_dkv(int d, const FlashParams& p, int b, void* stream);
int run_dq(int d, const FlashParams& p, int b, void* stream);
}  // namespace flash_bwd_sm80
// the dropout instances (kDrop), compiled in flash_attn_bwd_dropout.cu
namespace flash_bwd_dropout {
int run(bool dkv, int d, const FlashParams& p, int b, int bias_tma,
        void* stream);
}  // namespace flash_bwd_dropout
}  // namespace apex

namespace {

using bf16 = __nv_bfloat16;
using apex::FlashParams;
using namespace apex::sm90;
using namespace apex::flash_sm90;

constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kBkv = 128;      // dK/dV: kv rows per CTA (64 per warpgroup)
constexpr int kBqCta = 128;    // dQ: query rows per CTA (64 per warpgroup)
constexpr int kMaxBuckets = 128;
constexpr int kMaxDist = 4096;

// The dK/dV kernel's tiles and shared memory. Query rows per stage: 128
// at d 64, 64 at d 128 -- the most the registers hold (S^T and dP^T of 64
// x kBq each, dK and dV of 64 x d, all fp32: 192 a thread either way), so
// a d-64 stage does as much MMA work per barrier as a d-128 one; 64 with
// the array bias at d 64 too (two 128 x 128 fp32 bias blocks and their
// operands overflow the 227 KB). Stages: 3, or 2 where the bias block
// (d 128) or the table's dS tiles take the room. Layout: K and V (128
// rows each), the ring of (Q, dO [, bias]), each stage's lse and delta,
// the barriers, then (kRel) the warps' dS tiles, the offset bins and the
// bucket sums.
template <int D, int BIAS>
struct DkvCfg {
  static constexpr int kBq = D == 64 && BIAS != kArr ? 128 : 64;
  static constexpr int kStages =
      BIAS == kRel || (BIAS == kArr && D == 128) ? 2 : 3;
  static constexpr int kKv = D / 64 * 2 * kBox;
  static constexpr int kQ = D / 64 * (kBq / 64) * kBox;
  static constexpr int kBias = BIAS == kArr ? kBq * kBkv * 4 : 0;
  static constexpr int kStage = 2 * kQ + kBias;
  static constexpr int kRing = 2 * kKv;
  static constexpr int kStats = kRing + kStages * kStage;
  static constexpr int kBars = kStats + kStages * 2 * kBq * 4;
  // a warp's 16 x kBq dS tile: row pitch 8 mod 32 words, so the float2
  // stores of a half-warp and the diagonal reads hit distinct banks
  static constexpr int kDsLd = kBq + 8;
  static constexpr int kDs = kBars + 64;
  static constexpr int kBins = kDs + (BIAS == kRel ? 8 * 16 * kDsLd * 4 : 0);
  // the lookup and the offsets' buckets too, after the bins and bucket
  // sums, where they fit (else both are read from device memory)
  static constexpr int kRoom = 232448 - 1024 - kBins - 4 * kMaxBuckets;
  __host__ __device__ static bool tables_in_smem(int nbins) {
    return BIAS == kRel && 12 * nbins <= kRoom;
  }
  static size_t bytes(int nbins) {
    return 1024 + kBins +
           (BIAS == kRel ? 4 * (nbins + kMaxBuckets) +
                               (tables_in_smem(nbins) ? 8 * nbins : 0)
                         : 0);
  }
};

// The dQ kernel's: kv rows per stage 128 at d 64, 64 at d 128 (S and dP
// of 64 x kBk, dQ of 64 x d); 3 stages, 2 with the bias block. Layout: Q
// and dO (128 rows each), the ring of (K, V [, bias]), the CTA's delta,
// the barriers, then (kRel) the lookup.
template <int D, int BIAS>
struct DqCfg {
  static constexpr int kBk = D == 64 ? 128 : 64;
  static constexpr int kStages = BIAS == kArr ? 2 : 3;
  static constexpr int kQ = D / 64 * 2 * kBox;
  static constexpr int kK = D / 64 * (kBk / 64) * kBox;
  static constexpr int kBias = BIAS == kArr ? kBqCta * kBk * 4 : 0;
  static constexpr int kStage = 2 * kK + kBias;
  static constexpr int kRing = 2 * kQ;
  static constexpr int kDelta = kRing + kStages * kStage;
  static constexpr int kBars = kDelta + kBqCta * 4;
  static constexpr int kLut = kBars + 64;
  static size_t bytes(int nlut) {
    return 1024 + kLut + (BIAS == kRel ? 4 * nlut : 0);
  }
};

// --- dK/dV ----------------------------------------------------------------

// T: the element type; kF16Fault: an fp16 instance's planted fault
template <int D, int BIAS, bool kDrop, typename T = bf16, int kF16Fault = 0>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_bias,
                        const apex::FlashParamsT<T> p, int bias_tma) {
  constexpr int f16_fault = kF16Fault;  // 0 in every bf16 instance
  using C = DkvCfg<D, BIAS>;
  constexpr int kBq = C::kBq, kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + C::kKv;
  const uint32_t ring = base + C::kRing;
  float* const stats = reinterpret_cast<float*>(gbase + C::kStats);
  const uint32_t bars = base + C::kBars;
  const uint32_t kvbar = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (kS + s); };

  const int h = p.h, h_kv = p.h_kv, sq = p.sq, sk = p.sk;
  const int coff = sk - sq;  // bottom-right causal offset
  const int causal = p.causal;
  const int group = h / h_kv;
  const int nkv = (sk + kBkv - 1) / kBkv;
  // kv head by kv head, so the CTAs in flight share their heads' Q and
  // dO in the L2; within a head the kv tiles in order (causal: the
  // longest first)
  const int bkv = blockIdx.x / nkv;
  const int kt = blockIdx.x - bkv * nkv;
  const int bi = bkv / h_kv, kvh = bkv - bi * h_kv;
  const int k0 = kt * kBkv;
  const int* __restrict__ kv_lens = p.kv_lens;
  auto head_len = [&](int head) {
    return kv_lens ? apex::kv_len(kv_lens, bi, head, p.lens_b, p.lens_h, sk)
                   : sk;
  };
  // the group's query heads whose kv length reaches this tile, then the
  // query tiles from the diagonal down for each
  int nlive = group;
  if (kv_lens) {
    nlive = 0;
    for (int i = 0; i < group; ++i) nlive += k0 < head_len(kvh * group + i);
  }
  auto nth_live = [&](int n) {
    if (!kv_lens) return n;
    for (int i = 0; i < group; ++i)
      if (k0 < head_len(kvh * group + i) && n-- == 0) return i;
    return 0;
  };
  const int qt0 = causal ? max(k0 - coff, 0) / kBq : 0;
  const int per = (sq + kBq - 1) / kBq - qt0;
  const int total = nlive * per;
  const bool copy_bias = BIAS == kArr && !bias_tma;

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kS; ++s) {
      // the TMA bytes' arrival, then each staging producer warp's
      mbar_init(full(s), copy_bias ? 5 : 2);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    // warp 0 issues the TMA loads and stages lse and delta; with a bias
    // no map describes, all four warps copy it
    const int pw = threadIdx.x >> 5;
    if (pw == 0 || copy_bias) {
      if (threadIdx.x == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_do);
        mbar_expect_tx(kvbar, 2 * C::kKv);
        load_rows<D>(k_s, &tm_k, kBkv, k0, kvh, bi, kvbar);
        load_rows<D>(v_s, &tm_v, kBkv, k0, kvh, bi, kvbar);
      }
      const bool tb = BIAS == kArr && bias_tma;
      for (int it = 0; it < total; ++it) {
        const int s = it % kS;
        const uint32_t ph = (it / kS) & 1;
        const int head = kvh * group + nth_live(it / per);
        const int q0 = (qt0 + it % per) * kBq;
        const int row = bi * h + head;
        const uint32_t st = ring + s * C::kStage;
        mbar_wait(empty(s), ph ^ 1);
        // the TMA loads first, then lse and delta (plain loads, whose
        // latency overlaps the copies), then the second arrival
        if (threadIdx.x == 0) {
          mbar_expect_tx(full(s), 2 * C::kQ + (tb ? C::kBias : 0));
          load_rows<D>(st, &tm_q, kBq, q0, head, bi, full(s));
          load_rows<D>(st + C::kQ, &tm_do, kBq, q0, head, bi, full(s));
          if (tb)
            stage_bias_tma<kBq, kBkv>(st + 2 * C::kQ, &tm_bias, row % p.hb,
                                      q0, k0, full(s));
        }
        if (copy_bias)
          stage_bias_copy<kBq, kBkv>(st + 2 * C::kQ, p.bias, row % p.hb, q0,
                                     k0, sq, sk, threadIdx.x);
        if (pw == 0) {
          float* lse_s = stats + s * 2 * kBq;
          for (int j = lane; j < kBq; j += 32) {
            const int qr = q0 + j;
            const bool ok = qr < sq;
            const size_t at = static_cast<size_t>(row) * sq + (ok ? qr : 0);
            lse_s[j] = ok ? p.lse[at] * kLog2e : 0.f;
            lse_s[kBq + j] = ok ? p.delta[at] : 0.f;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full(s));
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;              // this warpgroup's 64 kv rows
    const int tid = threadIdx.x - 128;  // 0..255 over both warpgroups
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int kv_lo = k0 + cw * 64;
    const float scale = p.scale, sl2 = scale * kLog2e;
    const int maxd = p.maxd, rel_off = p.rel_off;
    float* const ds_w = reinterpret_cast<float*>(gbase + C::kDs) +
                        (cw * 4 + warp) * 16 * C::kDsLd;
    const int nbins = BIAS == kRel ? 2 * maxd + 1 : 0;
    float* const bins_s = reinterpret_cast<float*>(gbase + C::kBins);
    float* const bsum_s = bins_s + nbins;
    float* const lut_s = bsum_s + kMaxBuckets;
    int* const bucket_s = reinterpret_cast<int*>(lut_s + nbins);
    const bool tables = C::tables_in_smem(nbins);
    const float* lut = p.lut;
    const int* bucket = p.bucket;

    float dk[D / 2], dv[D / 2], sc[kBq / 2], dp[kBq / 2];
    zero(dk);
    zero(dv);
    zero(sc);
    zero(dp);
    if (BIAS == kRel) {
      for (int i = tid; i < nbins; i += 256) bins_s[i] = 0.f;
      for (int i = tid; i < kMaxBuckets; i += 256) bsum_s[i] = 0.f;
      if (tables) {  // read at every flush: staged once
        for (int i = tid; i < nbins; i += 256) bucket_s[i] = p.bucket[i];
        bucket = bucket_s;
      }
    }
    // the bins of the finished head -> its buckets -> dtab[drow]; the 256
    // consumer threads, after a barrier that follows the last bin update
    auto flush = [&](int drow) {
      for (int i = tid; i < nbins; i += 256) {
        const float x = bins_s[i];
        if (x != 0.f) atomicAdd(&bsum_s[bucket[i]], x);
        bins_s[i] = 0.f;
      }
      named_barrier(1, 256);
      float* dst = p.dtab + static_cast<size_t>(drow % p.hb) * p.nb;
      for (int i = tid; i < p.nb; i += 256) {
        const float x = bsum_s[i];
        if (x != 0.f) atomicAdd(&dst[i], x);
        bsum_s[i] = 0.f;
      }
    };
    int cur_head = -1;
    if (BIAS == kRel && total > 0) {
      // the first head's lookup while K and V arrive; later heads' (GQA)
      // at their first stage
      cur_head = kvh * group + nth_live(0);
      lut = p.lut + static_cast<size_t>((bi * h + cur_head) % p.hb) * nbins;
      if (tables) {
        for (int i = tid; i < nbins; i += 256) lut_s[i] = lut[i];
        lut = lut_s;
      }
      named_barrier(1, 256);  // the bins zeroed, the tables staged
    }
    mbar_wait(kvbar, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % kS;
      const uint32_t ph = (it / kS) & 1;
      const int head = kvh * group + nth_live(it / per);
      const int q0 = (qt0 + it % per) * kBq;
      const int row = bi * h + head;
      const int kv_lim = head_len(head);
      if (BIAS == kRel && head != cur_head) {
        // both warpgroups: the last head's bin updates are done
        named_barrier(1, 256);
        if (cur_head >= 0) {
          flush(bi * h + cur_head);
          named_barrier(1, 256);
        }
        lut = p.lut + static_cast<size_t>(row % p.hb) * nbins;
        if (tables) {
          for (int i = tid; i < nbins; i += 256) lut_s[i] = lut[i];
          lut = lut_s;
          named_barrier(1, 256);
        }
        cur_head = head;
      }
      const uint32_t st = ring + s * C::kStage;
      const uint32_t q_st = st, do_st = st + C::kQ;
      const float* lse_s = stats + s * 2 * kBq;
      const float* delta_s = lse_s + kBq;
      const float* bias_s =
          reinterpret_cast<const float*>(gbase + (st - base) + 2 * C::kQ);
      mbar_wait(full(s), ph);
      const bool skip = kv_lo >= kv_lim ||
                        (causal && kv_lo > q0 + kBq - 1 + coff);
      if (!skip) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kBq, T>(sc, kmajor(k_s, kBkv, kk, cw * 64),
                        kmajor(q_st, kBq, kk, 0), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kBq, T>(dp, kmajor(v_s, kBkv, kk, cw * 64),
                        kmajor(do_st, kBq, kk, 0), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(sc);
        fence_operand(dp);
        // dropout (the kDrop instances; _bwd_dkv_kernel :996-1008): the
        // keep bits of this stage's scores (query row qc of q-head row
        // `row`, key column kr), dP^T *= scale or 0 before dS^T; P^T takes
        // them after, for dV
        uint32_t dbits[kBq / 64] = {};
        if (kDrop) {
          // the planted fault kDropNoDkvDsMask leaves dP unmasked
          const uint32_t dthresh = p.drop.thresh;
          const bool ds_mask = p.drop.fault != apex::kDropNoDkvDsMask;
          const float dkeep = ds_mask ? p.drop.scale : 1.f;
          const float dgone = ds_mask ? 0.f : 1.f;
          const int trow =
              p.drop.fault == apex::kDropKeyKvHead ? bkv : row;
          const uint32_t dkey =
              apex::drop_key(p.drop.seed, static_cast<uint32_t>(trow));
          auto mask = [&](auto swap) {
#pragma unroll
            for (int i = 0; i < kBq / 8; ++i)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const uint32_t qc = q0 + 8 * i + 2 * t + cc;
                const uint32_t rk =
                    decltype(swap)::value ? 0u : apex::drop_row_key(dkey, qc);
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const int e = 4 * i + 2 * hh + cc;
                  const uint32_t kr = kv_lo + warp * 16 + g + 8 * hh;
                  const bool keep = apex::drop_keep_at<decltype(swap)::value>(
                      dkey, rk, qc, kr, dthresh);
                  dbits[e >> 5] |= static_cast<uint32_t>(keep) << (e & 31);
                  dp[e] *= keep ? dkeep : dgone;
                }
              }
          };
          if (p.drop.fault == apex::kDropSwapRowCol)
            mask(std::true_type{});
          else
            mask(std::false_type{});
        }
        // kRel: a stage whose offsets all clamp to one end (|kv - q| at or
        // past max_distance) reads one lookup value and sums into one bin
        const int n_lo = kv_lo - (q0 + kBq - 1) + rel_off;
        const int n_hi = kv_lo + 63 - q0 + rel_off;
        const bool one_bin =
            BIAS == kRel && (n_lo >= maxd || n_hi <= -maxd);
        const bool unclamped = BIAS == kRel && n_lo > -maxd && n_hi < maxd;
        const int bin = n_lo >= maxd ? 2 * maxd : 0;
        // unclamped: score (c, i)'s offset is this thread's base + 8 (c >> 1)
        // - 8 i - (c & 1)
        const float* lut_row =
            BIAS == kRel
                ? lut + maxd + (kv_lo + warp * 16 + g - q0 - 2 * t + rel_off)
                : nullptr;
        // sc: S^T (kv row, query column) -> P^T; dp: dP^T -> the
        // unscaled dS^T. Exponents in base 2 (lse stored times log2 e); a
        // stage wholly inside the masks skips them
        const bool inside = q0 + kBq <= sq && kv_lo + 64 <= kv_lim &&
                            (!causal || kv_lo + 63 <= q0 + coff);
        auto elem = [&](auto masked, auto lut_mode) {
          constexpr int kMode = decltype(lut_mode)::value;
#pragma unroll
          for (int i = 0; i < kBq / 8; ++i) {
            const float2 l2 =
                *reinterpret_cast<const float2*>(lse_s + 8 * i + 2 * t);
            const float2 dl =
                *reinterpret_cast<const float2*>(delta_s + 8 * i + 2 * t);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int rl = warp * 16 + g + 8 * (c >> 1);  // kv row in WG
              const int kr = kv_lo + rl;
              const int ql = 8 * i + 2 * t + (c & 1);
              const int qc = q0 + ql;
              float x = fmaf(sc[4 * i + c], sl2, -((c & 1) ? l2.y : l2.x));
              if (BIAS == kRel)
                x = fmaf(kMode == kLutOne   ? lut[bin]
                         : kMode == kLutRow ? lut_row[8 * (c >> 1) - 8 * i -
                                                      (c & 1)]
                                            : lut[apex::rel_index(
                                                  kr, qc, rel_off, maxd)],
                         kLog2e, x);
              if (BIAS == kArr)
                x = fmaf(bias_s[bias_offset<kBkv>(ql, cw * 64 + rl)], kLog2e,
                         x);
              float pr = ex2(x);
              if (decltype(masked)::value)
                pr = qc < sq && kr < kv_lim && (!causal || kr <= qc + coff)
                         ? pr
                         : 0.f;
              sc[4 * i + c] = pr;
              dp[4 * i + c] = pr * (dp[4 * i + c] - ((c & 1) ? dl.y : dl.x));
            }
          }
        };
        if (BIAS == kRel && one_bin) {
          if (inside)
            elem(std::false_type{}, LutMode<kLutOne>{});
          else
            elem(std::true_type{}, LutMode<kLutOne>{});
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kBq / 2; ++j) sum += dp[j];
          sum = apex::warp_sum(sum);
          if (lane == 0 && sum != 0.f) atomicAdd(&bins_s[bin], sum);
        } else if (BIAS == kRel && unclamped) {
          if (inside)
            elem(std::false_type{}, LutMode<kLutRow>{});
          else
            elem(std::true_type{}, LutMode<kLutRow>{});
        } else {
          if (inside)
            elem(std::false_type{}, LutMode<kLutClamp>{});
          else
            elem(std::true_type{}, LutMode<kLutClamp>{});
        }
        if (kDrop) {  // dV = (P^T dropped and rescaled) dO
          const float dscale = p.drop.scale;
#pragma unroll
          for (int e = 0; e < kBq / 2; ++e)
            sc[e] *= (dbits[e >> 5] >> (e & 31)) & 1u ? dscale : 0.f;
        }
        if (BIAS == kRel && !one_bin) {
#pragma unroll
          for (int i = 0; i < kBq / 8; ++i)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              *reinterpret_cast<float2*>(
                  ds_w + (g + 8 * hh) * C::kDsLd + 8 * i + 2 * t) =
                  make_float2(dp[4 * i + 2 * hh], dp[4 * i + 2 * hh + 1]);
        }
#pragma unroll
        for (int j = 0; j < kBq / 2; ++j) dp[j] *= scale;
        uint32_t pa[kBq / 16][4], da[kBq / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBq / 16; ++kk) {
          a_frag<T, f16_fault>(pa[kk], sc, kk);
          a_frag<T, f16_fault>(da[kk], dp, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBq / 16; ++kk)
          wgmma_rs<D, T>(dv, pa[kk], mnmajor(do_st, kk, kBq * 128));
#pragma unroll
        for (int kk = 0; kk < kBq / 16; ++kk)
          wgmma_rs<D, T>(dk, da[kk], mnmajor(q_st, kk, kBq * 128));
        wgmma_commit();
        if (BIAS == kRel && !one_bin) {
          // the warp's 16 x kBq tile of unscaled dS^T by diagonal: local
          // offset dd = kv row - query column in [1 - kBq, 15]; lane L
          // sums dd = L + 1 - kBq + 32 j (j < kBq / 32) and L + 1 (L < 15)
          // into the bins of their clamped offsets (distinct within the
          // warp but for the two clamped ends, summed over the warp first)
          __syncwarp();
          const int n0 = kv_lo + warp * 16 - q0 + rel_off;  // + dd
          const int top = 2 * maxd;
          float lo = 0.f, hi = 0.f;
#pragma unroll
          for (int j = 0; j <= kBq / 32; ++j) {
            const int dd = lane + 1 - kBq + 32 * j;
            if (j == kBq / 32 && lane >= 15) break;
            float sum = 0.f;
#pragma unroll
            for (int r = 0; r < 16; ++r) {
              const int col = r - dd;
              if (col >= 0 && col < kBq) sum += ds_w[r * C::kDsLd + col];
            }
            const int idx = min(max(n0 + dd, -maxd), maxd) + maxd;
            if (idx == 0)
              lo += sum;
            else if (idx == top)
              hi += sum;
            else if (sum != 0.f)
              atomicAdd(&bins_s[idx], sum);
          }
          lo = apex::warp_sum(lo);
          hi = apex::warp_sum(hi);
          if (lane == 0) {
            if (lo != 0.f) atomicAdd(&bins_s[0], lo);
            if (hi != 0.f) atomicAdd(&bins_s[top], hi);
          }
          __syncwarp();  // the next stage rewrites ds_w
        }
        wgmma_wait<0>();
        fence_operand(dk);
        fence_operand(dv);
      }
      if (lane == 0) mbar_arrive(empty(s));
    }
    if (BIAS == kRel && cur_head >= 0) {
      named_barrier(1, 256);
      flush(bi * h + cur_head);
    }

    const long long dkv_b = p.dkv_v.b, dkv_h = p.dkv_v.h, dkv_r = p.dkv_v.r;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kr = kv_lo + warp * 16 + g + 8 * hh;
      if (kr >= sk) continue;
      const long long off = bi * dkv_b + kvh * dkv_h + kr * dkv_r;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(p.dk + off + 8 * i + 2 * t) =
            out_pair<T, f16_fault>(dk[4 * i + 2 * hh],
                                   dk[4 * i + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(p.dv + off + 8 * i + 2 * t) =
            out_pair<T, f16_fault>(dv[4 * i + 2 * hh],
                                   dv[4 * i + 2 * hh + 1]);
      }
    }
  }
}

// --- dQ -------------------------------------------------------------------

template <int D, int BIAS, bool kDrop, typename T = bf16, int kF16Fault = 0>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_bias,
                       const apex::FlashParamsT<T> p, int bias_tma) {
  constexpr int f16_fault = kF16Fault;  // 0 in every bf16 instance
  using C = DqCfg<D, BIAS>;
  constexpr int kBk = C::kBk, kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + C::kQ;
  const uint32_t ring = base + C::kRing;
  const uint32_t bars = base + C::kBars;
  const uint32_t qbar = bars;
  auto full = [&](int s) { return bars + 8 + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 8 * (kS + s); };

  const int h = p.h, sq = p.sq, sk = p.sk;
  const int coff = sk - sq;
  const int causal = p.causal;
  const int nq = (sq + kBqCta - 1) / kBqCta;
  // head by head, so the CTAs in flight share their heads' K and V in the
  // L2; within a head the last query tiles first (causal: the longest)
  const int row = blockIdx.x / nq;  // bi * h + head
  const int qt = nq - 1 - static_cast<int>(blockIdx.x - row * nq);
  const int bi = row / h, head = row - bi * h;
  const int kvh = head / (h / p.h_kv);
  const int q0 = qt * kBqCta;
  const int kv_lim =
      p.kv_lens ? apex::kv_len(p.kv_lens, bi, head, p.lens_b, p.lens_h, sk)
                : sk;
  const int kv_end = causal ? min(kv_lim, q0 + kBqCta + coff) : kv_lim;
  const int nk = kv_end > 0 ? (kv_end + kBk - 1) / kBk : 0;
  const bool copy_bias = BIAS == kArr && !bias_tma;

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
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
        tma_prefetch(&tm_k);
        tma_prefetch(&tm_v);
        mbar_expect_tx(qbar, 2 * C::kQ);
        load_rows<D>(q_s, &tm_q, kBqCta, q0, head, bi, qbar);
        load_rows<D>(do_s, &tm_do, kBqCta, q0, head, bi, qbar);
      }
      const bool tb = BIAS == kArr && bias_tma;
      for (int j = 0; j < nk; ++j) {
        const int s = j % kS;
        const uint32_t ph = (j / kS) & 1;
        const uint32_t st = ring + s * C::kStage;
        mbar_wait(empty(s), ph ^ 1);
        if (threadIdx.x == 0) {
          mbar_expect_tx(full(s), 2 * C::kK + (tb ? C::kBias : 0));
          load_rows<D>(st, &tm_k, kBk, j * kBk, kvh, bi, full(s));
          load_rows<D>(st + C::kK, &tm_v, kBk, j * kBk, kvh, bi, full(s));
          if (tb)
            stage_bias_tma<kBqCta, kBk>(st + 2 * C::kK, &tm_bias, row % p.hb,
                                        q0, j * kBk, full(s));
        }
        if (copy_bias) {
          stage_bias_copy<kBqCta, kBk>(st + 2 * C::kK, p.bias, row % p.hb,
                                       q0, j * kBk, sq, sk, threadIdx.x);
          __syncwarp();
          if (lane == 0) mbar_arrive(full(s));
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // this warpgroup's 64 query rows
    const int tid = threadIdx.x - 128;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const float scale = p.scale, sl2 = scale * kLog2e;
    const int maxd = p.maxd, rel_off = p.rel_off;
    float* const delta_s = reinterpret_cast<float*>(gbase + C::kDelta);
    float* const lut_s = reinterpret_cast<float*>(gbase + C::kLut);

    // the prologue's reads first (lse, the lookup), then delta, so their
    // latencies overlap
    const int r0 = cw * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qr = q0 + r0 + 8 * hh;
      lse_r[hh] =
          qr < sq ? p.lse[static_cast<size_t>(row) * sq + qr] * kLog2e : 0.f;
    }
    if (BIAS == kRel) {
      const int n = 2 * maxd + 1;
      const float* lut = p.lut + static_cast<size_t>(row % p.hb) * n;
      for (int i = tid; i < n; i += 256) lut_s[i] = lut[i];
    }
    {  // delta of the CTA's rows, 2 threads a row: the only read of O
      const int r = tid >> 1, part = tid & 1;
      const int qr = q0 + r;
      const long long qrc = qr < sq ? qr : 0;
      const float dl = apex::row_delta<D, 2, T>(
          p.dout + bi * p.do_v.b + head * p.do_v.h + qrc * p.do_v.r,
          p.o + bi * p.o_v.b + head * p.o_v.h + qrc * p.o_v.r, part);
      if (part == 0) {
        delta_s[r] = qr < sq ? dl : 0.f;
        if (qr < sq) p.delta[static_cast<size_t>(row) * sq + qr] = dl;
      }
    }
    named_barrier(1, 256);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) dl_r[hh] = delta_s[r0 + 8 * hh];
    const int wq0 = q0 + cw * 64;  // this warpgroup's first query row

    float dq[D / 2], sc[kBk / 2], dp[kBk / 2];
    zero(dq);
    zero(sc);
    zero(dp);
    mbar_wait(qbar, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % kS;
      const uint32_t ph = (j / kS) & 1;
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
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kBk, T>(dp, kmajor(do_s, kBqCta, kk, cw * 64),
                        kmajor(v_st, kBk, kk, 0), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(sc);
        fence_operand(dp);
        // dropout (the kDrop instances): dP *= scale or 0 before dS
        // (_bwd_dq_kernel :929), from the keys of q-head row `row` and this
        // thread's two query rows
        if (kDrop) {
          const uint32_t dthresh = p.drop.thresh;
          const float dscale = p.drop.scale;
          const int trow =
              p.drop.fault == apex::kDropKeyKvHead ? bi * p.h_kv + kvh : row;
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
                dp[4 * i + c] *=
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
        }
        // sc: S -> P; dp: dP -> dS (scaled); base-2 exponents and the
        // lookup's modes as in dK/dV
        const bool inside = wq0 + 64 <= sq && kc0 + kBk <= kv_lim &&
                            (!causal || kc0 + kBk - 1 <= wq0 + coff);
        const int n_lo = kc0 - (wq0 + 63) + rel_off;
        const int n_hi = kc0 + kBk - 1 - wq0 + rel_off;
        const bool one_bin =
            BIAS == kRel && (n_lo >= maxd || n_hi <= -maxd);
        const bool unclamped = BIAS == kRel && n_lo > -maxd && n_hi < maxd;
        const int bin = n_lo >= maxd ? 2 * maxd : 0;
        // unclamped: score (c, i)'s offset is this thread's base + 8 i +
        // (c & 1) - 8 (c >> 1)
        const float* lut_row =
            lut_s + maxd + (kc0 - q0 - r0 + 2 * t + rel_off);
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
              float x = fmaf(sc[4 * i + c], sl2, -lse_r[hh]);
              if (BIAS == kRel)
                x = fmaf(kMode == kLutOne   ? lut_s[bin]
                         : kMode == kLutRow ? lut_row[8 * i + (c & 1) -
                                                      8 * hh]
                                            : lut_s[apex::rel_index(
                                                  kc, qr, rel_off, maxd)],
                         kLog2e, x);
              if (BIAS == kArr)
                x = fmaf(bias_s[bias_offset<kBk>(rl, cl)], kLog2e, x);
              float pr = ex2(x);
              if (decltype(masked)::value)
                pr = qr < sq && kc < kv_lim && (!causal || kc <= qr + coff)
                         ? pr
                         : 0.f;
              dp[4 * i + c] = pr * (dp[4 * i + c] - dl_r[hh]) * scale;
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
        uint32_t da[kBk / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBk / 16; ++kk)
          a_frag<T, f16_fault>(da[kk], dp, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBk / 16; ++kk)
          wgmma_rs<D, T>(dq, da[kk], mnmajor(k_st, kk, kBk * 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(dq);
      }
      if (lane == 0) mbar_arrive(empty(s));
    }

    const long long dq_b = p.out_v.b, dq_h = p.out_v.h, dq_r = p.out_v.r;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qr = q0 + r0 + 8 * hh;
      if (qr >= sq) continue;
      T* dst = p.out + bi * dq_b + head * dq_h + qr * dq_r;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dst + 8 * i + 2 * t) =
            out_pair<T, f16_fault>(dq[4 * i + 2 * hh],
                                   dq[4 * i + 2 * hh + 1]);
    }
  }
}

// --- host -----------------------------------------------------------------

struct Maps {
  CUtensorMap q, k, v, dout, bias;
};

// every map of a call; the bias's only when it goes by TMA (else the
// kernel never reads it)
template <typename T>
bool make_maps(Maps& m, const apex::FlashParamsT<T>& p, int b, int d,
               int bias_tma) {
  if (!view_map<T>(&m.q, p.q, p.q_v, d, p.sq, p.h, b) ||
      !view_map<T>(&m.k, p.k, p.kv_v, d, p.sk, p.h_kv, b) ||
      !view_map<T>(&m.v, p.v, p.kv_v, d, p.sk, p.h_kv, b) ||
      !view_map<T>(&m.dout, p.dout, p.do_v, d, p.sq, p.h, b))
    return false;
  m.bias = m.q;
  if (p.bias != nullptr && bias_tma)
    return bias_map(&m.bias, p.bias, p.sq, p.sk, p.hb);
  return true;
}

template <int D, int BIAS, bool kDrop, typename T, int F = 0>
cudaError_t launch_dkv(const Maps& m, const apex::FlashParamsT<T>& p, int b,
                       int bias_tma, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_wgmma<D, BIAS, kDrop, T, F>;
  const size_t smem = DkvCfg<D, BIAS>::bytes(2 * p.maxd + 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long grid =
      static_cast<long long>(b) * p.h_kv * ((p.sk + kBkv - 1) / kBkv);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, m.bias, p, bias_tma);
  return cudaGetLastError();
}

template <int D, int BIAS, bool kDrop, typename T, int F = 0>
cudaError_t launch_dq(const Maps& m, const apex::FlashParamsT<T>& p, int b,
                      int bias_tma, cudaStream_t st) {
  auto kernel = flash_bwd_dq_wgmma<D, BIAS, kDrop, T, F>;
  const size_t smem = DqCfg<D, BIAS>::bytes(2 * p.maxd + 1);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long grid =
      static_cast<long long>(b) * p.h * ((p.sq + kBqCta - 1) / kBqCta);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, m.bias, p, bias_tma);
  return cudaGetLastError();
}

// the instance of a call's options; the fp16 instances have none but
// their planted faults
template <bool kDkv, int D, bool kDrop, typename T>
cudaError_t dispatch(const Maps& m, const apex::FlashParamsT<T>& p, int b,
                     int bias_tma, cudaStream_t st) {
#define APEX_LAUNCH(K, DROP, F) \
  (kDkv ? launch_dkv<D, K, DROP, T, F>(m, p, b, bias_tma, st) \
        : launch_dq<D, K, DROP, T, F>(m, p, b, bias_tma, st))
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.lut != nullptr) return APEX_LAUNCH(kRel, kDrop, 0);
    if (p.bias != nullptr) return APEX_LAUNCH(kArr, kDrop, 0);
  } else {
    if (p.drop.fault == kF16Bf16P) return APEX_LAUNCH(kNone, kDrop, kF16Bf16P);
    if (p.drop.fault == kF16Satfinite)
      return APEX_LAUNCH(kNone, kDrop, kF16Satfinite);
  }
  return APEX_LAUNCH(kNone, kDrop, 0);
#undef APEX_LAUNCH
}

// the checks both variants share; dropout only on variant 1
template <typename T>
bool bad_call(const apex::FlashParamsT<T>& p, int b, int d, bool dkv,
              int variant) {
  return (p.drop.thresh > 0 &&
          (variant != 1 || p.drop.thresh > (1u << 24))) ||
         b < 1 || p.sq < 1 || p.sk < 1 || p.h < 1 || p.h_kv < 1 ||
         p.h % p.h_kv || (d != 64 && d != 128) ||
         (p.causal && p.sq > p.sk) ||
         static_cast<long long>(b) * p.h > 0x7fffffffLL ||
         (p.lut != nullptr && p.bias != nullptr) ||
         (p.bias != nullptr && p.hb < 1) ||
         (p.lut != nullptr &&
          (p.maxd < 1 || p.maxd > kMaxDist || p.hb < 1 || p.nb < 1 ||
           p.nb > kMaxBuckets || (dkv && (!p.bucket || !p.dtab))));
}

// the wgmma kernels' launch: the tensor maps and the grid; kDrop picks the
// dropout instances, T the element type
template <bool kDkv, bool kDrop, typename T = bf16>
int run_wgmma(int d, const apex::FlashParamsT<T>& p, int b, int bias_tma,
              void* stream) {
  const long long tiles =
      kDkv ? static_cast<long long>(b) * p.h_kv * ((p.sk + kBkv - 1) / kBkv)
           : static_cast<long long>(b) * p.h * ((p.sq + kBqCta - 1) / kBqCta);
  Maps m;
  if (p.delta == nullptr || tiles > 0x7fffffffLL ||
      !make_maps(m, p, b, d, bias_tma))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      d == 128 ? dispatch<kDkv, 128, kDrop, T>(m, p, b, bias_tma, st)
               : dispatch<kDkv, 64, kDrop, T>(m, p, b, bias_tma, st);
  return static_cast<int>(err);
}

#if !defined(APEX_FLASH_DROPOUT_TU) && !defined(APEX_FLASH_F16_TU)
template <bool kDkv>
int run(int d, const FlashParams& p, int b, int variant, int bias_tma,
        void* stream) {
  if (bad_call(p, b, d, kDkv, variant) || (variant != 0 && variant != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 0)
    return kDkv ? apex::flash_bwd_sm80::run_dkv(d, p, b, stream)
                : apex::flash_bwd_sm80::run_dq(d, p, b, stream);
  if (p.drop.thresh > 0)
    return apex::flash_bwd_dropout::run(kDkv, d, p, b, bias_tma, stream);
  return run_wgmma<kDkv, false>(d, p, b, bias_tma, stream);
}

#endif

#ifndef APEX_FLASH_DROPOUT_TU
// the entries' shared arguments: `strides` holds (batch, head, row)
// element strides of q, k/v, o, do and the output(s) (dq, or dk/dv): 15
// values, each a multiple of 8 elements (16-byte aligned rows)
template <typename T>
bool flat_params(apex::FlashParamsT<T>& p, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const void* lse,
                 const void* delta, const void* kv_lens, const void* lut,
                 const void* bucket, const void* bias,
                 const long long* strides, int h, int h_kv, int sq, int sk,
                 int causal, float scale, int maxd, int rel_off, int hb,
                 int nb, int lens_b, int lens_h, unsigned drop_seed,
                 int drop_thresh, float drop_scale, int drop_fault) {
  for (int i = 0; i < 15; ++i)
    if (strides[i] < 0 || strides[i] % 8) return false;
  p.drop = {drop_seed, static_cast<uint32_t>(drop_thresh), drop_scale,
            drop_fault};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
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
#endif

}  // namespace

#if defined(APEX_FLASH_DROPOUT_TU)
int apex::flash_bwd_dropout::run(bool dkv, int d, const FlashParams& p, int b,
                                 int bias_tma, void* stream) {
  return dkv ? run_wgmma<true, true>(d, p, b, bias_tma, stream)
             : run_wgmma<false, true>(d, p, b, bias_tma, stream);
}
#elif defined(APEX_FLASH_F16_TU)
namespace {

// the fp16 entries' rules: the packed path's calls, causal or not, without
// kv_lens, bias, lookup or dropout; fault a planted Fp16Fault (0 sound)
template <bool kDkv>
int run_f16(const apex::FlashParamsT<__half>& p, int b, int d, int fault,
            void* stream) {
  if (bad_call(p, b, d, kDkv, 1) ||
      (fault != apex::flash_sm90::kF16Sound &&
       fault != apex::flash_sm90::kF16Bf16P &&
       fault != apex::flash_sm90::kF16Satfinite))
    return static_cast<int>(cudaErrorInvalidValue);
  apex::FlashParamsT<__half> pf = p;
  pf.drop.fault = fault;
  return run_wgmma<kDkv, false, __half>(d, pf, b, 0, stream);
}

}  // namespace

// The backward pair's fp16 instances (amp's strict-fp16 GPT step), on the
// packed buffer's views as apex_flash_bwd_dq's and apex_flash_bwd_dkv's:
// q, o, do, dq (b, h, sq, d), k, v, dk, dv (b, h_kv, sk, d) fp16, lse and
// delta (b*h, sq) fp32 (dQ writes delta, dK/dV reads it).
extern "C" int apex_flash_bwd_dq_f16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta,
    const long long* strides, int b, int h, int h_kv, int sq, int sk, int d,
    int causal, float scale, int fault, void* stream) {
  apex::FlashParamsT<__half> p{};
  if (!flat_params(p, q, k, v, o, dout, lse, delta, nullptr, nullptr,
                   nullptr, nullptr, strides, h, h_kv, sq, sk, causal, scale,
                   0, 0, 1, 1, h, 1, 0u, 0, 1.f, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  p.out = static_cast<__half*>(dq);
  return run_f16<false>(p, b, d, fault, stream);
}

extern "C" int apex_flash_bwd_dkv_f16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int b, int h, int h_kv, int sq, int sk, int d,
    int causal, float scale, int fault, void* stream) {
  apex::FlashParamsT<__half> p{};
  if (!flat_params(p, q, k, v, o, dout, lse, delta, nullptr, nullptr,
                   nullptr, nullptr, strides, h, h_kv, sq, sk, causal, scale,
                   0, 0, 1, 1, h, 1, 0u, 0, 1.f, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dk = static_cast<__half*>(dk);
  p.dv = static_cast<__half*>(dv);
  return run_f16<true>(p, b, d, fault, stream);
}
#else

// dq and delta (b*h, sq) fp32 (written by variant 1; variant 0 computes
// its own and leaves delta alone). Operands as (batch, head, row)-strided
// views: q, o, do, dq (b, h, sq, d), k, v (b, h_kv, sk, d), bf16; lse
// (b*h, sq) fp32; kv_lens int32 at bi * lens_b + hi * lens_h, or null;
// lut (hb, 2 * maxd + 1) fp32 (the bucketed bias) or bias (hb, sq, sk)
// fp32 (the array bias), or neither. bias_tma: the wgmma variant stages
// the bias by TMA (sk a multiple of 4, base 16-byte aligned), else by
// cp.async. A seq-major tensor is the head-stride-d case of these views,
// with per-batch kv_lens (lens_b = 1, lens_h = 0); the packed buffer the
// views of its sections. drop_seed, drop_thresh (0: no dropout),
// drop_scale and drop_fault as the forward entries' (variant 1); both
// entries rebuild the forward's mask.
extern "C" int apex_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta,
    const void* kv_lens, const void* lut, const void* bias,
    const long long* strides, int b, int h, int h_kv, int sq, int sk, int d,
    int causal, float scale, int maxd, int rel_off, int hb, int lens_b,
    int lens_h, int variant, int bias_tma, unsigned drop_seed,
    int drop_thresh, float drop_scale, int drop_fault, void* stream) {
  FlashParams p{};
  if (!flat_params(p, q, k, v, o, dout, lse, delta, kv_lens, lut, nullptr,
                   bias, strides, h, h_kv, sq, sk, causal, scale, maxd,
                   rel_off, hb, 1, lens_b, lens_h, drop_seed, drop_thresh,
                   drop_scale, drop_fault))
    return static_cast<int>(cudaErrorInvalidValue);
  p.out = static_cast<bf16*>(dq);
  return run<false>(d, p, b, variant, bias_tma, stream);
}

// dk, dv (b, h_kv, sk, d) and, with a lut, the bucket-table gradient
// added into dtab (hb, nb) fp32, which the caller zeroes on the stream.
// Variant 1 reads delta, which the dQ entry wrote; variant 0 reads O.
extern "C" int apex_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
    void* dtab, const void* kv_lens, const void* lut, const void* bucket,
    const void* bias, const long long* strides, int b, int h, int h_kv,
    int sq, int sk, int d, int causal, float scale, int maxd, int rel_off,
    int hb, int nb, int lens_b, int lens_h, int variant, int bias_tma,
    unsigned drop_seed, int drop_thresh, float drop_scale, int drop_fault,
    void* stream) {
  FlashParams p{};
  if (!flat_params(p, q, k, v, o, dout, lse, delta, kv_lens, lut, bucket,
                   bias, strides, h, h_kv, sq, sk, causal, scale, maxd,
                   rel_off, hb, nb, lens_b, lens_h, drop_seed, drop_thresh,
                   drop_scale, drop_fault))
    return static_cast<int>(cudaErrorInvalidValue);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dtab = static_cast<float*>(dtab);
  return run<true>(d, p, b, variant, bias_tma, stream);
}
#endif  // APEX_FLASH_DROPOUT_TU, APEX_FLASH_F16_TU
