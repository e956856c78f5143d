// Decode attention: one query token per (batch, kv head) row against a KV
// cache, for Hopper (sm_90a), in two addressings of one kernel body:
//
// * paged (apex_paged_decode_attn): replaces
//   apex_tpu/ops/pallas/decode_attention.py::decode_attn_paged_fwd (:211).
//   q (b*h_kv, group, d) holds each kv head's group of query heads; the
//   pool (num_blocks, h_kv, bs, d) is shared by every slot; block_tables
//   (b, nb) names slot i's j-th logical block; lengths (b,) counts live
//   rows per slot.
// * contiguous (apex_decode_attn): replaces ::decode_attn_fwd (:149-200),
//   the decode engine's cache. k and v are (rows, max_s, d) with rows =
//   b*h_kv, a free view of the (b, h_kv, max_s, d) cache; lengths (b,) is
//   read at row / h_kv, as the paged kernel reads it. Block j of row r is
//   rows [j*128, j*128 + 128) of that row: the table lookup becomes
//   r*nb + j.
// Output (rows, group, d) in q's dtype.
//
// Bound on this card: HBM bytes. Every live K/V row is read once and each
// row costs 4*group*d operations against 2*2*d bytes (bf16), far below the
// ~295 operations per byte where an H100's tensor cores become the limit.
// At the serving slice's shapes (8 slots x 512 live rows x 8 kv heads x d
// 128, bf16) one layer reads 2*8*512*8*128*2 B = 16.8 MB: ~5 us at
// 3.35 TB/s; at the decode engine's (16 x 8 rows, ~640 live) 42 MB, ~12 us.
// Those rows alone (64 and 128, one CTA each) would leave SMs idle, each
// CTA walking its blocks in turn with little in flight.
//
// Design (the host's plan, ops/decode_attention.py::_decode_plan, picks
// the split S, the ring's tiles and the shared memory from the shapes):
// * each row's kv walk is split over a thread-block cluster of S CTAs
//   (S in 1, 2, 4, 8; grid rows * S, cluster (S, 1, 1)). The CTA of rank r
//   walks the row's live blocks r, r + S, r + 2S, ...: a strided share
//   balances any live prefix. Blocks past the row's length are never
//   loaded (the Pallas grid's `j*bk < kvlen` skip), and within the last
//   block only the live rows are loaded, scored and summed — the
//   reference's -1e30 mask (:124).
// * whole blocks come in by the bulk-copy engine: at (pool block, kv
//   head) a block's live rows are one contiguous run of live * d elements,
//   so one thread issues one 1-D cp.async.bulk for a K block and one for a
//   V block, completing on an mbarrier. A ring of `tiles` slots (each one
//   K or one V block, K and V alternating) keeps the CTA's next loads in
//   flight while it computes: the slot freed by a block's scores (K) or by
//   the previous block's PV product (V) is refilled at the next block
//   barrier. The CTA's first loads leave before anything else: their table
//   entries are read beside the length.
// * 256 threads (8 warps, so that the SM has warps to switch between while
//   a block's loads land). Scores: 8 lanes share a row, each taking 16-byte
//   chunks c, c + 8, ... of K and q (kept in q's dtype), so a quarter-warp
//   reads one row's 128 contiguous bytes (no bank conflict) and q stays in
//   registers across the rows; three xor-shuffles add the lanes' parts.
//   The softmax then takes one thread a row, and the PV product gives each
//   thread 16 bytes of a V row's columns and every (threads / (d / 16-byte
//   chunks))-th row. At G = 1 a tensor-core tile would be 1/64 full, so
//   both products stay on the CUDA cores in fp32. G (1, 2, 4, 8, 16) is a
//   template parameter.
// * the online softmax runs in fp32 from m = -1e30; p is rounded to V's
//   dtype before the PV product (:137) and l sums the unrounded p. After
//   the walk each CTA sums its warps' PV parts in warp order into its state
//   (acc[G][d], m, l). Rank r > 0 stores its state into rank 0's shared
//   memory (distributed shared memory), each warp then arrives on rank 0's
//   merge mbarrier with release semantics, and the CTA exits; rank 0 waits
//   on it, rescales every state by exp(m_r - max m), sums them in rank
//   order and writes acc / max(l, 1e-30) — a length-0 row, or a split with
//   no live block (m = -1e30, l = 0), contributes zeros (:145). A cluster
//   barrier arrived at the start and waited on before the stores makes sure
//   rank 0's barrier is set up first. No workspace, no atomics, no second
//   launch: the merge order is fixed, so the output is the same bits from
//   run to run. Every CTA, whatever its share of the walk, arrives.
//
// Options (each a template instance of the one body; the host's plan takes
// them into the shared memory it sizes):
// * quantized pools (kv_dtype 1 = int8, 2 = fp8 e4m3; paged, bf16 q):
//   replaces the Pallas kernel's `quant` branch (_decode_kernel,
//   decode_attention.py:99-103, :123-127). The pools hold 1-byte cells and
//   k_scale, v_scale (num_blocks, bs) fp32 hold one scale a block row,
//   shared by the kv heads and found through the same table entry. A ring
//   slot holds bs x d bytes, and beside it its block's scales, which the
//   same mbarrier counts: one more bulk copy of the live rows' scales,
//   rounded up to 4 rows (16 bytes; bs is a multiple of 4). Cells convert
//   to fp32 exactly (int8 by a byte permute into 2^23's mantissa and one
//   add, fp8 by the hardware's fp8x2 -> half2 cvt); the row's K scale
//   multiplies the row's dot product (q . k) * s_k, and its V scale
//   multiplies p before the PV product, so the loops add no multiply a
//   cell. p is NOT rounded to a
//   storage type (the reference keeps it fp32 here). The score lanes read
//   16-byte chunks (8-byte at d 64: 8 lanes still cover a row), the PV
//   threads 8-byte ones (8 columns each, as at bf16). Bound: half the bf16
//   pool's bytes, plus 4 bytes a live row for each scale plane.
// * the causal bucketed relative bias (rel, bf16 q; both addressings):
//   replaces the Pallas kernel's `rel` option (:108-118). The bias at
//   column col of a row of length len is the table's value at the bucket
//   of offset col - (len - 1) <= 0, clamped at -maxd (every farther offset
//   falls in the last bucket). The host passes BucketedBias's per-head
//   lookup (heads, 2 * maxd + 1), built by the integer-exact bucket
//   function the flash kernels use; the CTA copies its group's first
//   maxd + 1 values of each query head into shared memory beside q, and
//   adds lut[maxd + col - (len - 1)] to the scaled score (len the slot's
//   length as given, past the table too: the query's position). The reference
//   refuses a quantized pool with a bias, and so does every entry here.
// The quantized and the biased instances live in translation units of
// their own (paged_decode_attn_quant.cu, paged_decode_attn_rel.cu, which
// include this file), so the build compiles them beside the float ones.

#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

#include "apex_cuda.cuh"
#include "apex_sm90.cuh"

namespace apex {

// a decode launch as the entries pass it to the instance that runs it
struct DecodeArgs {
  bool paged;
  int dtype;     // q's and the output's: kFloat32 or kBFloat16
  int kv_dtype;  // the pools': 0 q's dtype, 1 int8, 2 fp8 e4m3
  int d, group;
  const void *q, *k, *v;
  const float *k_scale, *v_scale;  // (num_blocks, bs) fp32, kv_dtype != 0
  const int *tables, *lengths;
  const float* lut;  // (h, 2 * maxd + 1) fp32, or null
  void* out;
  int rows, h_kv, bs, nb, maxd;
  float scale;
  int splits, tiles, smem;
  cudaStream_t stream;
};

// the instances of the two other translation units
namespace decode_quant {
cudaError_t launch(const DecodeArgs& a);
cudaError_t clusters(const DecodeArgs& a, int* n);
}  // namespace decode_quant
namespace decode_rel {
cudaError_t launch(const DecodeArgs& a);
cudaError_t clusters(const DecodeArgs& a, int* n);
}  // namespace decode_rel

}  // namespace apex

namespace {

namespace sm90 = apex::sm90;
using bf16 = __nv_bfloat16;
using fp8 = __nv_fp8_e4m3;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 128;  // a block's rows at most: one a softmax thread
constexpr int kMaxTiles = 4;
constexpr int kMaxSmem = 232448;  // a CTA's most on sm_90 (227 KB)
constexpr int kMaxDistance = 4096;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr size_t round_up(size_t x, size_t m) {
  return (x + m - 1) / m * m;
}

// Byte offsets of a CTA's dynamic shared memory; the host's plan
// (decode_smem in ops/decode_attention.py) computes the same total:
//   ring    tiles slots of bs x d cells; after the walk the warps' PV
//           sums (warps x G x d fp32) overlay it
//   q       G x d elements (q's dtype)
//   s       2 (parity) x G x bs fp32: a block's scores, then its p
//   red     the per-warp maxima and sums, 2 x warps x G fp32
//   sc      quantized pools: tiles slots of bs fp32, each ring slot's
//           block's scales
//   lut     the bias: G x (maxd + 1) fp32, the group's query heads'
//           values at offsets -maxd .. 0
//   state   splits slots of (acc G x d, m G, l G) fp32: the CTA's own in
//           slot 0; at rank 0, rank r's in slot r
//   bars    tiles ring mbarriers, then the merge mbarrier
struct Layout {
  size_t q, s, red, sc, lut, state, state_bytes, bars, total;
  __host__ __device__ Layout(int elem, int kv_elem, bool quant, int lut_len,
                             int d, int group, int bs, int tiles,
                             int splits) {
    const size_t ring = static_cast<size_t>(tiles) * bs * d * kv_elem;
    const size_t parts = static_cast<size_t>(kWarps) * group * d * 4;
    q = round_up(ring > parts ? ring : parts, 128);
    s = q + round_up(static_cast<size_t>(group) * d * elem, 16);
    red = s + round_up(2 * static_cast<size_t>(group) * bs * 4, 16);
    sc = red + round_up(2 * kWarps * static_cast<size_t>(group) * 4, 16);
    lut = sc + (quant ? round_up(static_cast<size_t>(tiles) * bs * 4, 16)
                      : 0);
    state = lut + round_up(static_cast<size_t>(group) * lut_len * 4, 16);
    state_bytes = round_up((static_cast<size_t>(group) * d + 2 * group) * 4,
                           16);
    bars = state + splits * state_bytes;
    total = bars + (static_cast<size_t>(tiles) + 1) * 8;
  }
};

// the 4 one-byte cells of w as floats, exactly. int8: each cell's bits
// with the sign flipped (c + 128, 0..255) become the low mantissa byte of
// 2^23 (one byte permute), and 2^23 + 128 is subtracted (one add): the
// integer-to-float conversion's unit runs at a quarter of the adds' rate
template <typename TK>
__device__ __forceinline__ void bytes4(uint32_t w, float* f) {
  if constexpr (std::is_same<TK, int8_t>::value) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) -
             8388736.f;
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>(w >> (16 * j)), __NV_E4M3);
      const float2 t = __half22float2(__half2(h));
      f[2 * j] = t.x;
      f[2 * j + 1] = t.y;
    }
  }
}

// N consecutive elements at p (16-byte loads; 8-byte ones for 8 one-byte
// cells) as floats
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float (&f)[N]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      f[4 * i] = __uint_as_float(v.x);
      f[4 * i + 1] = __uint_as_float(v.y);
      f[4 * i + 2] = __uint_as_float(v.z);
      f[4 * i + 3] = __uint_as_float(v.w);
    }
  } else if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 t = __bfloat1622float2(h[j]);
        f[8 * i + 2 * j] = t.x;
        f[8 * i + 2 * j + 1] = t.y;
      }
    }
  } else if constexpr (N == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    bytes4<T>(v.x, f);
    bytes4<T>(v.y, f + 4);
    bytes4<T>(v.z, f + 8);
    bytes4<T>(v.w, f + 12);
  } else {
    static_assert(N == 8, "one-byte cells load 8 or 16 at a time");
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    bytes4<T>(v.x, f);
    bytes4<T>(v.y, f + 4);
  }
}

// T: q's and the output's type; TK: the pool's cells (T, or int8_t / fp8
// for a quantized pool, with k_scale/v_scale). kPaged: block j of row
// `row` is pool row table[slot, j] * h_kv + kv head; otherwise (tables
// unused) block j of the row's own contiguous max_s strip, row * nb + j.
// kRel: the causal bucketed bias from `lut`.
template <typename T, typename TK, int D, int G, bool kPaged, bool kRel>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const TK* __restrict__ k_pool,
                  const TK* __restrict__ v_pool,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths,
                  const float* __restrict__ lut, T* __restrict__ out,
                  int h_kv, int bs, int nb, int splits, int tiles, int maxd,
                  float scale) {
  constexpr bool kQuant = sizeof(TK) == 1;
  static_assert(!kQuant || kPaged, "quantized pools are paged");
  // scores: 8 lanes a row, each lane kLaneChunks chunks of kSVec cells
  constexpr int kSBytes = D * sizeof(TK) / 8 < 16 ? D * sizeof(TK) / 8 : 16;
  constexpr int kSVec = kSBytes / sizeof(TK);
  constexpr int kLaneChunks = D / kSVec / 8;
  // PV: kVec columns a thread (16 bytes of T, 8 one-byte cells)
  constexpr int kVec = sizeof(TK) == 4 ? 4 : 8;
  constexpr int kChunks = D / kVec;          // column groups a row
  constexpr int kParts = kThreads / kChunks;  // row subsets of the PV
  const int lut_len = kRel ? maxd + 1 : 0;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(sizeof(T), sizeof(TK), kQuant, lut_len, D, G, bs, tiles,
                   splits);
  TK* ring = reinterpret_cast<TK*>(smem);
  float* part_s = reinterpret_cast<float*>(smem);  // after the walk
  const T* q_s = reinterpret_cast<const T*>(smem + lay.q);
  float* s_s = reinterpret_cast<float*>(smem + lay.s);
  float* red_max = reinterpret_cast<float*>(smem + lay.red);
  float* red_sum = red_max + kWarps * G;
  float* sc_s = reinterpret_cast<float*>(smem + lay.sc);
  float* lut_s = reinterpret_cast<float*>(smem + lay.lut);
  float* state = reinterpret_cast<float*>(smem + lay.state);
  const uint32_t bar0 = sm90::smem_u32(smem + lay.bars);
  const uint32_t merge_bar = bar0 + 8 * tiles;

  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int row = blockIdx.x / splits;  // slot * h_kv + kv head
  const int slot = row / h_kv;
  const int kvh = row - slot * h_kv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int srow = tid >> 3;     // scores: rows srow, srow + 32, ...
  const int sc = tid & 7;        // ... chunks sc, sc + 8, ... of each
  const int cg = tid % kChunks;  // PV: columns [cg*kVec, +kVec) ...
  const int part = tid / kChunks;  // ... of rows part, part + kParts, ...
  // a length past the row's nb blocks means every row of them is live;
  // the bias's query sits at the unclamped length - 1, as the reference's
  const int qpos = lengths[slot] - 1;
  const int len = max(0, min(qpos + 1, nb * bs));
  const int nblk = (len + bs - 1) / bs;
  const int mine = nblk > rank ? (nblk - rank + splits - 1) / splits : 0;
  const int ntiles = 2 * mine;  // K and V of each of this split's blocks

  const int* trow = kPaged ? tables + static_cast<size_t>(slot) * nb : tables;
  // tile t: the K (t even) or V (t odd) block of this split's block t / 2,
  // j = rank + (t / 2) * splits; `id` its table entry (paged)
  auto table_id = [&](int t) {
    return kPaged ? trow[rank + (t >> 1) * splits] : 0;
  };
  auto issue = [&](int t, int id) {
    const int j = rank + (t >> 1) * splits;
    const size_t prow = kPaged ? static_cast<size_t>(id) * h_kv + kvh
                               : static_cast<size_t>(row) * nb + j;
    const TK* src = ((t & 1) ? v_pool : k_pool) + prow * bs * D;
    const int live = min(bs, len - j * bs);
    const uint32_t bytes = static_cast<uint32_t>(live * D * sizeof(TK));
    const int s = t % tiles;
    if constexpr (kQuant) {
      // the live rows' scales, rounded up to 4 rows (16 bytes)
      const uint32_t sbytes = static_cast<uint32_t>(((live + 3) & ~3) * 4);
      sm90::mbar_expect_tx(bar0 + 8 * s, bytes + sbytes);
      sm90::bulk_load(sm90::smem_u32(sc_s + static_cast<size_t>(s) * bs),
                      ((t & 1) ? v_scale : k_scale) +
                          static_cast<size_t>(id) * bs,
                      sbytes, bar0 + 8 * s);
    } else {
      sm90::mbar_expect_tx(bar0 + 8 * s, bytes);
    }
    sm90::bulk_load(sm90::smem_u32(ring + static_cast<size_t>(s) * bs * D),
                    src, bytes, bar0 + 8 * s);
  };

  // warp 0 starts the first `tiles` loads, one lane a tile: each lane's
  // table entry is read beside the length (within the row's nb entries,
  // whether live or not), the barriers are set up meanwhile. The cluster
  // barrier's arrive follows the barriers' setup (published to the cluster
  // by the fence), its wait comes after the walk: no peer reaches rank 0's
  // merge barrier before it is set up
  if (warp == 0) {
    const bool first = lane < tiles && rank + (lane >> 1) * splits < nb;
    const int id = first ? table_id(lane) : 0;
    if (lane == 0) {
      for (int s = 0; s < tiles; ++s) sm90::mbar_init(bar0 + 8 * s, 1);
      sm90::mbar_init(merge_bar, max(1, (splits - 1) * kWarps));
      sm90::fence_barrier_init();
    }
    __syncwarp();
    if (splits > 1) sm90::cluster_arrive_relaxed();
    if (lane < min(tiles, ntiles)) issue(lane, id);
  } else if (splits > 1) {
    sm90::cluster_arrive_relaxed();
  }
  {  // q and the bias's lookup, read beside the length (a CTA with no
     // block reads them unused)
    T* qw = reinterpret_cast<T*>(smem + lay.q);
    for (int i = tid; i < G * D; i += kThreads)
      qw[i] = q[static_cast<size_t>(row) * G * D + i];
    if constexpr (kRel) {
      for (int i = tid; i < G * lut_len; i += kThreads) {
        const int g = i / lut_len;
        lut_s[i] = lut[static_cast<size_t>(kvh * G + g) * (2 * maxd + 1) +
                       (i - g * lut_len)];
      }
    }
  }
  __syncthreads();  // q_s, lut_s and the ring's barriers

  // the running softmax state, identical in every thread
  float m_run[G], l_run[G], acc[G][kVec];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < mine; ++i) {
    const int col0 = (rank + i * splits) * bs;  // the block's first column
    const int live = min(bs, len - col0);
    float* sb = s_s + (i & 1) * G * bs;  // parity: PV reads the last one
    // the two refills at this block's barrier: the slots of the previous
    // block's V (tile 2i - 1) and of this block's K (tile 2i); lanes 0 and
    // 1 of warp 0 read their table entries now, ahead of the wait
    const int refill = 2 * i - 1 + lane + tiles;
    const bool refills = warp == 0 && lane < 2 && 2 * i - 1 + lane >= 0 &&
                         refill < ntiles;
    const int refill_id = refills ? table_id(refill) : 0;

    // scores in fp32, 8 lanes a row, the lanes' parts added by xor-shuffles
    // (every lane ends with the row's same sum)
    const int k_slot = (2 * i) % tiles;
    sm90::mbar_wait(bar0 + 8 * k_slot, ((2 * i) / tiles) & 1);
    const TK* kt = ring + static_cast<size_t>(k_slot) * bs * D;
    const float* ksc = sc_s + static_cast<size_t>(k_slot) * bs;
    const int row_steps = (live + 31) >> 5;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float qf[kLaneChunks][kSVec];
#pragma unroll
      for (int c = 0; c < kLaneChunks; ++c)
        load_floats<T, kSVec>(q_s + g * D + (sc + 8 * c) * kSVec, qf[c]);
      float mx = kNegInf;
#pragma unroll 4
      for (int k = 0; k < row_steps; ++k) {
        const int r = srow + 32 * k;
        // a row past the live ones reads the last live row, then is dropped
        const TK* kr = kt + static_cast<size_t>(min(r, live - 1)) * D;
        float t0 = 0.f, t1 = 0.f;
#pragma unroll
        for (int c = 0; c < kLaneChunks; ++c) {
          float kf[kSVec];
          load_floats<TK, kSVec>(kr + (sc + 8 * c) * kSVec, kf);
#pragma unroll
          for (int e = 0; e < kSVec; e += 2) {
            t0 += qf[c][e] * kf[e];
            t1 += qf[c][e + 1] * kf[e + 1];
          }
        }
        float dot = t0 + t1;
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        if (r < live) {
          if constexpr (kQuant) dot *= ksc[r];
          dot *= scale;
          if constexpr (kRel)
            dot += lut_s[g * lut_len + max(0, maxd + col0 + r - qpos)];
          mx = fmaxf(mx, dot);
          if (sc == 0) sb[g * bs + r] = dot;
        }
      }
      mx = apex::warp_max(mx);
      if (lane == 0) red_max[warp * G + g] = mx;
    }
    __syncthreads();  // scores and maxima published; the K slot and the
                      // last V slot are read by every thread
    if (refills) issue(refill, refill_id);

    // online softmax, one thread a row: the block's max, p = exp(s - m_new)
    // (a float pool's p rounded to V's dtype for the PV product, over the
    // score; a quantized pool's kept fp32), the block's sum of the
    // unrounded p
    float alpha[G];
    const bool mine_row = tid < live;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = red_max[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, red_max[w * G + g]);
      const float m_new = fmaxf(m_run[g], mx);
      alpha[g] = expf(m_run[g] - m_new);
      m_run[g] = m_new;
      const float p = mine_row ? expf(sb[g * bs + tid] - m_new) : 0.f;
      const float ps = apex::warp_sum(p);
      if (lane == 0) red_sum[warp * G + g] = ps;
      if (mine_row)
        sb[g * bs + tid] =
            kQuant ? p : apex::to_float(apex::from_float<T>(p));
    }
    const int v_slot = (2 * i + 1) % tiles;
    sm90::mbar_wait(bar0 + 8 * v_slot, ((2 * i + 1) / tiles) & 1);
    __syncthreads();  // p and the sums published

    // PV: thread (part, cg) owns columns [cg*kVec, +kVec) for rows part,
    // part + kParts, ... of the block
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float ps = red_sum[g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) ps += red_sum[w * G + g];
      l_run[g] = l_run[g] * alpha[g] + ps;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= alpha[g];
    }
    const TK* vt = ring + static_cast<size_t>(v_slot) * bs * D;
    const float* vsc = sc_s + static_cast<size_t>(v_slot) * bs;
#pragma unroll 4
    for (int r = part; r < live; r += kParts) {
      float vf[kVec];
      load_floats<TK, kVec>(vt + static_cast<size_t>(r) * D + cg * kVec, vf);
      const float vs = kQuant ? vsc[r] : 1.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = kQuant ? sb[g * bs + r] * vs : sb[g * bs + r];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] += p * vf[e];
      }
    }
    // the next block's barrier orders these reads before any refill of
    // this V slot or rewrite of these scores' parity buffer
  }

  // the CTA's state: each warp's lanes of one column group summed by
  // xor-shuffles, then the warps' sums in warp order, over the ring (every
  // issued tile has been waited on, so no copy is still landing)
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
#pragma unroll
      for (int o = kChunks; o < 32; o <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  __syncthreads();
  if (lane < kChunks) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* dst = reinterpret_cast<float4*>(
          part_s + (static_cast<size_t>(warp) * G + g) * D + cg * kVec);
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        dst[e / 4] = make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2],
                                 acc[g][e + 3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float a = part_s[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += part_s[w * G * D + i];
    state[i] = a;
  }
  if (tid == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      state[G * D + g] = m_run[g];
      state[G * D + G + g] = l_run[g];
    }
  }
  __syncthreads();

  const size_t slot_floats = lay.state_bytes / 4;
  if (splits > 1) {
    sm90::cluster_wait();  // every CTA of the cluster has started
    if (rank > 0) {
      // into rank 0's slot `rank`, then each warp arrives on its barrier
      const uint32_t dst = sm90::cluster_map(
          sm90::smem_u32(state + rank * slot_floats), 0);
      for (int i = tid; i < static_cast<int>(slot_floats / 4);
           i += kThreads)
        sm90::st_cluster_v4(dst + 16 * i,
                            reinterpret_cast<const float4*>(state)[i]);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive_cluster(sm90::cluster_map(merge_bar, 0));
      return;  // nothing reads this CTA's shared memory
    }
    sm90::mbar_wait_cluster(merge_bar, 0);
  }
  // rank 0 merges the states in rank order
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float mx = kNegInf;
    for (int r = 0; r < splits; ++r)
      mx = fmaxf(mx, state[r * slot_floats + G * D + g]);
    float l = 0.f, a = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* st = state + r * slot_floats;
      const float w = expf(st[G * D + g] - mx);
      l += w * st[G * D + G + g];
      a += w * st[i];
    }
    out[static_cast<size_t>(row) * G * D + i] =
        apex::from_float<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, typename TK>
using KernelFn = void (*)(const T*, const TK*, const TK*, const float*,
                          const float*, const int*, const int*, const float*,
                          T*, int, int, int, int, int, int, float);

template <typename T, typename TK>
struct Kernel {
  KernelFn<T, TK> fn;
  cudaError_t ready;  // raising the dynamic shared-memory ceiling
};

// one instance, its shared-memory ceiling raised once
template <typename T, typename TK, int D, int G, bool kPaged, bool kRel>
Kernel<T, TK> instance() {
  static const cudaError_t ready = cudaFuncSetAttribute(
      decode_kernel<T, TK, D, G, kPaged, kRel>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return {decode_kernel<T, TK, D, G, kPaged, kRel>, ready};
}

template <typename T, typename TK, int D, bool kPaged, bool kRel>
Kernel<T, TK> instance_of_group(int group) {
  switch (group) {
    case 1:
      return instance<T, TK, D, 1, kPaged, kRel>();
    case 2:
      return instance<T, TK, D, 2, kPaged, kRel>();
    case 4:
      return instance<T, TK, D, 4, kPaged, kRel>();
    case 8:
      return instance<T, TK, D, 8, kPaged, kRel>();
    case 16:
      return instance<T, TK, D, 16, kPaged, kRel>();
    default:
      return {nullptr, cudaErrorInvalidValue};
  }
}

// a quantized pool has only the paged instances
template <typename T, typename TK, bool kRel>
Kernel<T, TK> instance_of(bool paged, int d, int group) {
  if constexpr (sizeof(TK) == 1) {
    if (!paged) return {nullptr, cudaErrorInvalidValue};
    if (d == 128) return instance_of_group<T, TK, 128, true, kRel>(group);
    if (d == 64) return instance_of_group<T, TK, 64, true, kRel>(group);
  } else {
    if (d == 128)
      return paged ? instance_of_group<T, TK, 128, true, kRel>(group)
                   : instance_of_group<T, TK, 128, false, kRel>(group);
    if (d == 64)
      return paged ? instance_of_group<T, TK, 64, true, kRel>(group)
                   : instance_of_group<T, TK, 64, false, kRel>(group);
  }
  return {nullptr, cudaErrorInvalidValue};
}

// grid rows * splits CTAs in clusters of (splits, 1, 1)
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  Launch(int ctas, int splits, int smem, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = splits;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
};

template <typename T, typename TK, bool kRel>
cudaError_t launch_t(const apex::DecodeArgs& a) {
  const Kernel<T, TK> kern = instance_of<T, TK, kRel>(a.paged, a.d, a.group);
  if (kern.fn == nullptr || kern.ready != cudaSuccess) return kern.ready;
  Launch l(a.rows * a.splits, a.splits, a.smem, a.stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, kern.fn, static_cast<const T*>(a.q),
      static_cast<const TK*>(a.k), static_cast<const TK*>(a.v), a.k_scale,
      a.v_scale, a.tables, a.lengths, a.lut, static_cast<T*>(a.out), a.h_kv,
      a.bs, a.nb, a.splits, a.tiles, a.maxd, a.scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename TK, bool kRel>
cudaError_t clusters_t(const apex::DecodeArgs& a, int* n) {
  const Kernel<T, TK> kern = instance_of<T, TK, kRel>(a.paged, a.d, a.group);
  if (kern.fn == nullptr || kern.ready != cudaSuccess) return kern.ready;
  Launch l(a.splits, a.splits, a.smem, nullptr);
  return cudaOccupancyMaxActiveClusters(n, kern.fn, &l.cfg);
}

}  // namespace

#if defined(APEX_DECODE_QUANT_TU)
// the int8 and fp8 pools' instances (bf16 q, paged)
cudaError_t apex::decode_quant::launch(const DecodeArgs& a) {
  return a.kv_dtype == 1 ? launch_t<bf16, int8_t, false>(a)
                         : launch_t<bf16, fp8, false>(a);
}
cudaError_t apex::decode_quant::clusters(const DecodeArgs& a, int* n) {
  return a.kv_dtype == 1 ? clusters_t<bf16, int8_t, false>(a, n)
                         : clusters_t<bf16, fp8, false>(a, n);
}
#elif defined(APEX_DECODE_REL_TU)
// the bucketed bias's instances (bf16, both addressings)
cudaError_t apex::decode_rel::launch(const DecodeArgs& a) {
  return launch_t<bf16, bf16, true>(a);
}
cudaError_t apex::decode_rel::clusters(const DecodeArgs& a, int* n) {
  return clusters_t<bf16, bf16, true>(a, n);
}
#else
namespace {

// what every launch checks of the plan and the options it is given: a
// quantized pool (paged, bf16 q, bs a multiple of 4) or the bias (bf16
// q, maxd in [1, 4096]), never both
bool bad_plan(int dtype, int kv_dtype, int maxd, int d, int group, int bs,
              int splits, int tiles, int smem) {
  if ((d != 64 && d != 128) ||
      (dtype != apex::kFloat32 && dtype != apex::kBFloat16) || bs < 1 ||
      bs > kMaxRows || tiles < 2 || tiles > kMaxTiles ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      kv_dtype < 0 || kv_dtype > 2 || maxd < 0 || maxd > kMaxDistance ||
      ((kv_dtype != 0 || maxd != 0) && dtype != apex::kBFloat16) ||
      (kv_dtype != 0 && (maxd != 0 || bs % 4)))
    return true;
  const int elem = dtype == apex::kBFloat16 ? 2 : 4;
  return smem > kMaxSmem ||
         static_cast<size_t>(smem) <
             Layout(elem, kv_dtype != 0 ? 1 : elem, kv_dtype != 0,
                    maxd != 0 ? maxd + 1 : 0, d, group, bs, tiles, splits)
                 .total;
}

cudaError_t run(const apex::DecodeArgs& a) {
  if (a.kv_dtype != 0) return apex::decode_quant::launch(a);
  if (a.lut != nullptr) return apex::decode_rel::launch(a);
  return a.dtype == apex::kBFloat16 ? launch_t<bf16, bf16, false>(a)
                                    : launch_t<float, float, false>(a);
}

}  // namespace

// splits, tiles, smem: the host's plan (_decode_plan). kv_dtype 0: the
// pools hold q's dtype; 1 int8, 2 fp8 e4m3, with k_scale, v_scale
// (num_blocks, bs) fp32. lut (h, 2 * maxd + 1) fp32 and maxd >= 1: the
// causal bucketed bias; null and 0 without
extern "C" int apex_paged_decode_attn(const void* q, const void* k_pool,
                                      const void* v_pool, const void* tables,
                                      const void* lengths, void* out,
                                      int dtype, int b, int h_kv, int group,
                                      int d, int bs, int nb, float scale,
                                      int splits, int tiles, int smem,
                                      const void* k_scale,
                                      const void* v_scale, int kv_dtype,
                                      const void* lut, int maxd,
                                      void* stream) {
  if (b < 1 || h_kv < 1 || nb < 1 || (lut != nullptr) != (maxd > 0) ||
      (kv_dtype != 0) != (k_scale != nullptr && v_scale != nullptr) ||
      bad_plan(dtype, kv_dtype, maxd, d, group, bs, splits, tiles, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  apex::DecodeArgs a{true, dtype, kv_dtype, d, group, q, k_pool, v_pool,
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale),
                     static_cast<const int*>(tables),
                     static_cast<const int*>(lengths),
                     static_cast<const float*>(lut), out, b * h_kv, h_kv,
                     bs, nb, maxd, scale, splits, tiles, smem,
                     static_cast<cudaStream_t>(stream)};
  return static_cast<int>(run(a));
}

// k, v (b * h_kv, max_s, d) with max_s a multiple of 128; lengths (b,);
// lut and maxd as the paged entry's
extern "C" int apex_decode_attn(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int dtype,
                                int b, int h_kv, int group, int d, int max_s,
                                float scale, int splits, int tiles, int smem,
                                const void* lut, int maxd, void* stream) {
  if (b < 1 || h_kv < 1 || max_s < kMaxRows || max_s % kMaxRows ||
      (lut != nullptr) != (maxd > 0) ||
      bad_plan(dtype, 0, maxd, d, group, kMaxRows, splits, tiles, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  apex::DecodeArgs a{false, dtype, 0, d, group, q, k, v, nullptr, nullptr,
                     nullptr, static_cast<const int*>(lengths),
                     static_cast<const float*>(lut), out, b * h_kv, h_kv,
                     kMaxRows, max_s / kMaxRows, maxd, scale, splits, tiles,
                     smem, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(run(a));
}

// how many clusters of the plan's CTAs the card can hold at once
// (cudaOccupancyMaxActiveClusters) into *n; 0 means the launch is refused.
// kv_dtype and maxd pick the instance, as the entries' do
extern "C" int apex_decode_attn_clusters(int paged, int dtype, int d,
                                         int group, int bs, int splits,
                                         int tiles, int smem, int kv_dtype,
                                         int maxd, int* n) {
  if (bad_plan(dtype, kv_dtype, maxd, d, group, bs, splits, tiles, smem) ||
      (kv_dtype != 0 && !paged))
    return static_cast<int>(cudaErrorInvalidValue);
  apex::DecodeArgs a{};
  a.paged = paged != 0;
  a.dtype = dtype;
  a.kv_dtype = kv_dtype;
  a.d = d;
  a.group = group;
  a.maxd = maxd;
  a.splits = splits;
  a.smem = smem;
  cudaError_t err;
  if (kv_dtype != 0)
    err = apex::decode_quant::clusters(a, n);
  else if (maxd != 0)
    err = apex::decode_rel::clusters(a, n);
  else
    err = dtype == apex::kBFloat16 ? clusters_t<bf16, bf16, false>(a, n)
                                   : clusters_t<float, float, false>(a, n);
  return static_cast<int>(err);
}
#endif
