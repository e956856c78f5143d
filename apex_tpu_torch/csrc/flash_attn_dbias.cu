// The gradient of flash attention's additive array bias for Hopper
// (sm_90a) on wgmma and TMA: dbias (hb, sq, sk) fp32 = the UNSCALED dS =
// P * (dP - delta), summed over the q-head rows that share each bias row.
//
// Replaces apex_tpu/ops/pallas/attention.py::_dbias_pallas (:1095-1111;
// body _bwd_dbias_kernel, :1021-1092), which all three layouts of the
// reference launch when flash_attention gets an array bias. The bias enters
// the scores after the 1/sqrt(d) scale, so its cotangent is dS before the
// scale (:1028-1031). delta = rowsum(do * o) is an operand, as in the
// reference (:1039): the wgmma dQ kernel (flash_attn_bwd.cu) writes it, so
// this kernel reads no O.
//
// Entry: apex_flash_bwd_dbias, variant 1 (this file's kernel) or 0
// (flash_attn_dbias_sm80.cu's first mma.sync kernel, which computes delta
// from O and ignores the delta operand). q, o, do (b, h, sq, d) and k, v
// (b, h_kv, sk, d) as (batch, head, row)-strided views (flash_params.cuh),
// so the bh-flat operands and the seq-major (b, s, h, d) tensors seen as
// (b, h, s, d) are one case; lse and delta (b*h, sq) fp32; kv_lens per row
// or per batch through the lens strides, as the forward and the dQ/dK/dV
// kernels read them; the bias (hb, sq, sk) fp32 that the forward added,
// row r reading bias row r % hb.
//
// Bound on this card at the T5 encoder's call (b*h 1536, 512 x 512, d 64,
// hb 12): bytes. The function reads q, k, v, do (403 MB), lse and delta
// (6.3 MB) and the bias (12.6 MB) once and writes dbias once (12.6 MB):
// 434 MB, 0.130 ms at 3.35 TB/s, against 4*d operations per live score
// pair (QK^T, dO V^T: ~0.1 TFLOP, 0.1 ms at 989 TFLOP/s).
//
// Design:
// * The output tiles: 128 query rows x 64 key columns. The host splits
//   the nb = b*h / hb rows that share a bias row into S contiguous groups
//   (S >= 1, chosen so the grid of hb x tiles x S CTAs covers the card's
//   SMs about twice: T5's decoder call has 24 tiles, so S 11; its encoder
//   384, so S 1). One CTA per (group, bias row th, query tile, kv tile),
//   in that order (the CTAs in flight share their rows' Q, dO, K and V in
//   the L2).
// * 384 threads: warpgroup 0 the producer (warp 0 issues the TMA loads and
//   stages lse and delta; setmaxnreg 40/232), two consumer warpgroups of
//   64 query rows. A ring of (Q, dO, K, V, lse, delta) stages over the
//   group's rows r = n * hb + th, in increasing n -- 3 stages at d 64, 2 at
//   d 128 -- loads the next rows while the current one computes; a row
//   whose kv length does not reach the tile, or a tile wholly above the
//   causal diagonal, is never loaded.
// * Per row and warpgroup: S = Q K^T and dP = dO V^T (wgmma, both operands
//   from shared memory, K-major: the wgmma dQ kernel's two products), p =
//   2^(s scale log2e + bias log2e - lse log2e) and acc += p (dP - delta)
//   in fp32 registers (a tile wholly inside the masks skips the mask
//   selects). The bias tile is the same for every row the CTA walks: each
//   consumer thread reads its 32 entries once into registers, pre-scaled
//   by log2 e; no score reads it from device memory again.
// * Split, fixed-order sums: with S = 1 the CTA writes dbias; else its
//   partial goes to a workspace (S, hb, sq, sk) fp32 and a second kernel
//   adds the S partials in group order. No atomics: bit-identical from run
//   to run. The order -- within a group the rows in increasing n, then the
//   groups in order -- differs from the reference's strict batch-innermost
//   sum only in the grouping of the fp32 additions.
// * Masks: a score takes part iff its query row < sq, its key column < sk
//   and < the row's kv length, and (causal) column <= row + sk - sq; other
//   entries add nothing (rows past sq included: TMA filled them with
//   zeros). A tile no row reaches writes zeros; every element is written.
// * Dropout (_bwd_dbias_kernel :1083; the kDrop instance): dS = P (M/(1-r)
//   dP - delta), the mask M rebuilt from dropout_hash.cuh on (q-head row r
//   = n * hb + th -- the flattened (batch, head) row bi * h + hi of the
//   views, the row the forward hashed; the reference's r = n * hb + th,
//   :1036-1037 -- query row, key column). A row's key is one fmix32, each
//   thread's two query rows' keys one each, then one fmix32 a score. The
//   groups and their fixed-order sums do not change, so dbias stays
//   bit-identical from run to run.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W; the sm80 kernel
// timed in turns in brackets, then SDPA's backward with the float mask's
// gradient, then the bound), ms: T5's encoder 0.545 [3.364] 3.320 0.130,
// padded 0.531 [3.335] 3.085 0.114; its decoder (S 11) 0.054 [1.303]
// 0.243 0.028; bshd hb 1 (S 8) 0.189 [4.837] 1.066 0.033. Still held
// back at the encoder (4.2x its bound): each 128 x 64 tile reads its
// rows' Q and dO (128 rows) and K and V (64) from the L2 once per tile,
// eight kv tiles sharing each Q tile.
#include <cstdint>
#include <type_traits>

#include "apex_cuda.cuh"
#include "apex_sm90.cuh"
#include "flash_params.cuh"
#include "flash_sm90.cuh"

namespace apex {
namespace flash_dbias_sm80 {
int run(int d, const FlashParams& p, void* stream);
}  // namespace flash_dbias_sm80
}  // namespace apex

namespace {

using apex::FlashParams;
using namespace apex::sm90;
using namespace apex::flash_sm90;

constexpr int kThreads = 384;  // warpgroup 0 produces, 1 and 2 consume
constexpr int kBq = 128;       // query rows per tile (64 per warpgroup)
constexpr int kBk = 64;        // key columns per tile
constexpr int kMaxSplits = 64;

// The ring: each stage (Q, dO: 128 rows; K, V: 64 rows; lse and delta of
// the 128 query rows); 3 stages at d 64 (48 KB each), 2 at d 128 (96 KB).
template <int D>
struct DbiasCfg {
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kQ = D / 64 * 2 * kBox;
  static constexpr int kK = D / 64 * kBox;
  static constexpr int kStage = 2 * kQ + 2 * kK;
  static constexpr int kStats = kStages * kStage;
  static constexpr int kBars = kStats + kStages * 2 * kBq * 4;
  static constexpr size_t bytes() { return 1024 + kBars + 64; }
};

template <int D, bool kDrop>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dbias_wgmma(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const FlashParams p, float* __restrict__ out,
                          int splits) {
  using C = DbiasCfg<D>;
  constexpr int kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  float* const stats = reinterpret_cast<float*>(gbase + C::kStats);
  const uint32_t bars = base + C::kBars;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kS + s); };

  const int h = p.h, sq = p.sq, sk = p.sk, hb = p.hb;
  const int coff = sk - sq;  // bottom-right causal offset
  const int causal = p.causal;
  const int group = h / p.h_kv;
  const int nqt = (sq + kBq - 1) / kBq, nkt = (sk + kBk - 1) / kBk;
  // (group, bias row, query tile, kv tile), the kv tile fastest
  long long id = blockIdx.x;
  const int kt = static_cast<int>(id % nkt);
  id /= nkt;
  const int qt = static_cast<int>(id % nqt);
  id /= nqt;
  const int th = static_cast<int>(id % hb);
  const int split = static_cast<int>(id / hb);
  const int q0 = qt * kBq, k0 = kt * kBk;
  const int nb = p.nb;  // the rows sharing a bias row
  const int n0 = static_cast<int>(static_cast<long long>(split) * nb / splits);
  const int n1 =
      static_cast<int>(static_cast<long long>(split + 1) * nb / splits);
  // the last visible column of the tile's last row lies left of k0: the
  // tile is masked for every row
  const bool tile_live = !causal || k0 <= q0 + kBq - 1 + coff;
  const int* __restrict__ kv_lens = p.kv_lens;
  auto row_len = [&](int r) {
    const int bi = r / h;
    return kv_lens ? apex::kv_len(kv_lens, bi, r - bi * h, p.lens_b,
                                  p.lens_h, sk)
                   : sk;
  };

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full(s), 2);   // the TMA bytes' arrival, then the stats'
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32 && tile_live) {  // warp 0
      if (lane == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_k);
        tma_prefetch(&tm_v);
        tma_prefetch(&tm_do);
      }
      int it = 0;
      for (int n = n0; n < n1; ++n) {
        const int r = n * hb + th;  // the q-head row: batch bi, head hi
        if (k0 >= row_len(r)) continue;
        const int bi = r / h, hi = r - bi * h, kvh = hi / group;
        const int s = it % kS;
        const uint32_t ph = (it / kS) & 1;
        ++it;
        const uint32_t st = base + s * C::kStage;
        mbar_wait(empty(s), ph ^ 1);
        // the TMA loads first, then lse and delta (plain loads, whose
        // latency overlaps the copies), then the second arrival
        if (lane == 0) {
          mbar_expect_tx(full(s), C::kStage);
          load_rows<D>(st, &tm_q, kBq, q0, hi, bi, full(s));
          load_rows<D>(st + C::kQ, &tm_do, kBq, q0, hi, bi, full(s));
          load_rows<D>(st + 2 * C::kQ, &tm_k, kBk, k0, kvh, bi, full(s));
          load_rows<D>(st + 2 * C::kQ + C::kK, &tm_v, kBk, k0, kvh, bi,
                       full(s));
        }
        float* lse_s = stats + s * 2 * kBq;
        for (int j = lane; j < kBq; j += 32) {
          const int qr = q0 + j;
          const bool ok = qr < sq;
          const size_t at = static_cast<size_t>(r) * sq + (ok ? qr : 0);
          lse_s[j] = ok ? p.lse[at] * kLog2e : 0.f;
          lse_s[kBq + j] = ok ? p.delta[at] : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full(s));
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // this warpgroup's 64 query rows
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const float sl2 = p.scale * kLog2e;
    const int r0 = cw * 64 + warp * 16 + g;  // this thread's rows: r0, r0 + 8
    const int wq0 = q0 + cw * 64;            // this warpgroup's first row
    // this thread's entries of the bias tile, read once: (row r0 + 8 (c >>
    // 1), column 8 i + 2 t + (c & 1)) for entry 4 i + c, times log2 e
    float bias2[kBk / 2];
    {
      const float* brow = p.bias + static_cast<size_t>(th) * sq * sk;
#pragma unroll
      for (int i = 0; i < kBk / 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qr = q0 + r0 + 8 * (c >> 1);
          const int kc = k0 + 8 * i + 2 * t + (c & 1);
          bias2[4 * i + c] =
              qr < sq && kc < sk
                  ? __ldg(brow + static_cast<size_t>(qr) * sk + kc) * kLog2e
                  : 0.f;
        }
    }
    float acc[kBk / 2], sc[kBk / 2], dp[kBk / 2];
    zero(acc);
    zero(sc);
    zero(dp);
    int it = 0;
    for (int n = n0; tile_live && n < n1; ++n) {
      const int r = n * hb + th;
      const int kv_lim = row_len(r);
      if (k0 >= kv_lim) continue;  // the same for every thread of the CTA
      const int s = it % kS;
      const uint32_t ph = (it / kS) & 1;
      ++it;
      const uint32_t st = base + s * C::kStage;
      const uint32_t q_st = st, do_st = st + C::kQ;
      const uint32_t k_st = st + 2 * C::kQ, v_st = k_st + C::kK;
      const float* lse_s = stats + s * 2 * kBq;
      const float* delta_s = lse_s + kBq;
      mbar_wait(full(s), ph);
      const bool skip = wq0 >= sq || (causal && k0 > wq0 + 63 + coff);
      if (!skip) {
        const float l2[2] = {lse_s[r0], lse_s[r0 + 8]};
        const float dl[2] = {delta_s[r0], delta_s[r0 + 8]};
        // dropout: the key of q-head row r (the planted kDropKeyKvHead: its
        // kv head's row) and this thread's two query rows' keys
        uint32_t dkey = 0, drk[2] = {0u, 0u};
        if (kDrop) {
          const int bi = r / h;
          const int trow = p.drop.fault == apex::kDropKeyKvHead
                               ? bi * p.h_kv + (r - bi * h) / group
                               : r;
          dkey = apex::drop_key(p.drop.seed, static_cast<uint32_t>(trow));
          drk[0] = apex::drop_row_key(dkey, q0 + r0);
          drk[1] = apex::drop_row_key(dkey, q0 + r0 + 8);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kBk>(sc, kmajor(q_st, kBq, kk, cw * 64),
                        kmajor(k_st, kBk, kk, 0), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<kBk>(dp, kmajor(do_st, kBq, kk, cw * 64),
                        kmajor(v_st, kBk, kk, 0), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(sc);
        fence_operand(dp);
        const bool inside = wq0 + 64 <= sq && k0 + kBk <= kv_lim &&
                            (!causal || k0 + kBk - 1 <= wq0 + coff);
        // dropout: dP *= 1/(1 - r) or 0 by the keep bit, before dS (the
        // planted kDropNoDbiasDpMask leaves dP unmasked)
        if (kDrop && p.drop.fault != apex::kDropNoDbiasDpMask) {
          const uint32_t dthresh = p.drop.thresh;
          const float dscale = p.drop.scale;
          auto mask = [&](auto swap) {
#pragma unroll
            for (int i = 0; i < kBk / 8; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int hh = c >> 1;
                const uint32_t kc = k0 + 8 * i + 2 * t + (c & 1);
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
        auto elem = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < kBk / 8; ++i) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int hh = c >> 1;
              const int qr = q0 + r0 + 8 * hh;
              const int kc = k0 + 8 * i + 2 * t + (c & 1);
              float pr = ex2(fmaf(sc[4 * i + c], sl2, bias2[4 * i + c]) -
                             l2[hh]);
              if (decltype(masked)::value)
                pr = qr < sq && kc < kv_lim && (!causal || kc <= qr + coff)
                         ? pr
                         : 0.f;
              acc[4 * i + c] = fmaf(pr, dp[4 * i + c] - dl[hh],
                                    acc[4 * i + c]);
            }
          }
        };
        if (inside)
          elem(std::false_type{});
        else
          elem(std::true_type{});
      }
      if (lane == 0) mbar_arrive(empty(s));
    }

    // the CTA's partial (or, with one group, dbias itself)
    float* dst = out + (static_cast<size_t>(split) * hb + th) * sq * sk;
    const bool pairs = (sk & 1) == 0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qr = q0 + r0 + 8 * hh;
      if (qr >= sq) continue;
      float* drow = dst + static_cast<size_t>(qr) * sk;
#pragma unroll
      for (int i = 0; i < kBk / 8; ++i) {
        const int kc = k0 + 8 * i + 2 * t;
        const float a = acc[4 * i + 2 * hh], b = acc[4 * i + 2 * hh + 1];
        if (pairs && kc + 1 < sk) {
          *reinterpret_cast<float2*>(drow + kc) = make_float2(a, b);
        } else {
          if (kc < sk) drow[kc] = a;
          if (kc + 1 < sk) drow[kc + 1] = b;
        }
      }
    }
  }
}

// dbias = the S partials summed in group order, 4 elements a thread where
// the count allows (n % 4 == 0: every partial starts 16-byte aligned)
__global__ void flash_dbias_reduce(const float* __restrict__ ws,
                                   float* __restrict__ dbias, long long n,
                                   int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n % 4 == 0) {
    for (; 4 * i < n; i += stride) {
      float4 s = reinterpret_cast<const float4*>(ws)[i];
      for (int k = 1; k < splits; ++k) {
        const float4 x = reinterpret_cast<const float4*>(ws + k * n)[i];
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      reinterpret_cast<float4*>(dbias)[i] = s;
    }
  } else {
    for (; i < n; i += stride) {
      float s = ws[i];
      for (int k = 1; k < splits; ++k) s += ws[k * n + i];
      dbias[i] = s;
    }
  }
}

template <int D, bool kDrop>
cudaError_t launch(const FlashParams& p, int b, float* ws, int splits,
                   cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo;
  if (!view_map(&tq, p.q, p.q_v, D, p.sq, p.h, b) ||
      !view_map(&tk, p.k, p.kv_v, D, p.sk, p.h_kv, b) ||
      !view_map(&tv, p.v, p.kv_v, D, p.sk, p.h_kv, b) ||
      !view_map(&tdo, p.dout, p.do_v, D, p.sq, p.h, b))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dbias_wgmma<D, kDrop>;
  const size_t smem = DbiasCfg<D>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long grid = static_cast<long long>(splits) * p.hb *
                         ((p.sq + kBq - 1) / kBq) * ((p.sk + kBk - 1) / kBk);
  float* out = splits > 1 ? ws : p.dbias;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, st>>>(
      tq, tk, tv, tdo, p, out, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = static_cast<long long>(p.hb) * p.sq * p.sk;
  const long long work = n % 4 == 0 ? n / 4 : n;
  const long long want = (work + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  flash_dbias_reduce<<<blocks, 256, 0, st>>>(ws, p.dbias, n, splits);
  return cudaGetLastError();
}

}  // namespace

// dbias (hb, sq, sk) fp32, every element written. `strides` holds the
// (batch, head, row) element strides of q, k/v, o and do (12 values,
// multiples of 8: 16-byte aligned rows); delta (b*h, sq) fp32, the wgmma
// dQ kernel's side output (variant 1; variant 0 computes its own from o);
// kv_lens int32 at bi * lens_b + hi * lens_h, or null; bias (hb, sq, sk)
// fp32, hb | b*h. Variant 1 sums the nb = b*h / hb sharing rows in
// `splits` contiguous groups, each CTA's partial into ws (splits, hb, sq,
// sk) fp32 when splits > 1, then adds them in group order. drop_seed,
// drop_thresh (0: no dropout), drop_scale and drop_fault as the flash
// entries' (variant 1 only): dS from the dropped dP, the mask the forward
// drew for q-head row bi * h + hi.
extern "C" int apex_flash_bwd_dbias(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* delta, const void* bias,
    void* dbias, void* ws, const void* kv_lens, const long long* strides,
    int b, int h, int h_kv, int sq, int sk, int d, int causal, float scale,
    int hb, int lens_b, int lens_h, int splits, int variant,
    unsigned drop_seed, int drop_thresh, float drop_scale, int drop_fault,
    void* stream) {
  for (int i = 0; i < 12; ++i)
    if (strides[i] < 0 || strides[i] % 8)
      return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(b) * h;
  if (b < 1 || h < 1 || h_kv < 1 || h % h_kv || sq < 1 || sk < 1 ||
      (d != 64 && d != 128) || (causal && sq > sk) || hb < 1 || rows % hb ||
      rows > 0x7fffffffLL || bias == nullptr || dbias == nullptr ||
      (variant != 0 && variant != 1) ||
      (drop_thresh != 0 &&
       (variant != 1 || drop_thresh < 0 || drop_thresh > (1 << 24))))
    return static_cast<int>(cudaErrorInvalidValue);
  FlashParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(const_cast<void*>(delta));
  p.bias = static_cast<const float*>(bias);
  p.dbias = static_cast<float*>(dbias);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.q_v = {strides[0], strides[1], strides[2]};
  p.kv_v = {strides[3], strides[4], strides[5]};
  p.o_v = {strides[6], strides[7], strides[8]};
  p.do_v = {strides[9], strides[10], strides[11]};
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.h_kv = h_kv;
  p.causal = causal;
  p.scale = scale;
  p.hb = hb;
  p.lens_b = lens_b;
  p.lens_h = lens_h;
  p.nb = static_cast<int>(rows / hb);
  p.drop = {drop_seed, static_cast<uint32_t>(drop_thresh), drop_scale,
            drop_fault};
  if (variant == 0) return apex::flash_dbias_sm80::run(d, p, stream);
  const long long tiles = static_cast<long long>(hb) * ((sq + kBq - 1) / kBq) *
                          ((sk + kBk - 1) / kBk);
  if (delta == nullptr || splits < 1 || splits > kMaxSplits ||
      splits > p.nb || tiles * splits > 0x7fffffffLL ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  const bool drop = drop_thresh > 0;
  const cudaError_t err =
      d == 128 ? (drop ? launch<128, true>(p, b, wsp, splits, st)
                       : launch<128, false>(p, b, wsp, splits, st))
               : (drop ? launch<64, true>(p, b, wsp, splits, st)
                       : launch<64, false>(p, b, wsp, splits, st));
  return static_cast<int>(err);
}
