// The sampling filter split over a thread-block cluster (fused_sample.cu):
// each row's V scores are spread over the S CTAs of a cluster, and every
// row-wide quantity is merged across the cluster through distributed
// shared memory, in rank order. sample_filter.cuh (one CTA a row, 48-step
// bisections) stays for the verify kernels.
//
// * The thresholds are exact order statistics found by radix select on
//   the order-preserving 32-bit key of each fp32 score: 4 rounds of 8-bit
//   digits, each a 256-bin histogram per CTA (integer counts for top-k,
//   fixed-point masses exp(s - m) * 2^40 for top-p), merged across the
//   cluster, then a suffix scan that picks the largest digit whose
//   cumulative count or mass still reaches the target. Integer sums do not
//   depend on their order, so shared atomics fill the histograms and the
//   result is the same bits on every run.
// * top-k keeps {key(s) >= the k-th largest key}: ties at the k-th value
//   all kept, as the reference's converged bisection keeps them. top-p
//   keeps {key(s) >= t}, t the largest key with sum over key >= t of
//   exp(s - m) >= p * z (the reference's predicate; the answer is always
//   a live entry's key, so the bisection's start at the live minimum and
//   the filtered -1e30 entries, whose mass is 0, change nothing).
// * -0.0 keys as +0.0, so key(s) >= key(t) exactly when s >= t.
#pragma once

#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_sm90.cuh"

namespace apex {
namespace sample {

constexpr int kBins = 256;
constexpr int kScanWarps = kBins / 32;
constexpr int kMaxSplits = 8;
// top-p after top-k gathers the live entries into rank 0 when there are at
// most this many (one for each of a CTA's first 256 threads)
constexpr int kGather = 256;
constexpr float kFiltered = -1e30f;
// fixed-point scale of a mass exp(s - m) in [0, 1]: 2^40, so a row of
// 49152 masses sums below 2^56
constexpr float kMassScale = 1099511627776.f;

// order-preserving key of an fp32 score (-0.0 as +0.0)
__device__ __forceinline__ uint32_t score_key(float f) {
  uint32_t b = __float_as_uint(f);
  if ((b << 1) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the fp32 score of a key (score_key's inverse)
__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the cluster barrier's arrive, releasing this thread's earlier writes
// (its histogram atomics, its stores into another CTA) at cluster scope;
// sm90::cluster_wait acquires them
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// loads and stores at a shared::cluster address (sm90::cluster_map). The
// loads name no memory clobber, so the ranks' loads of a merge are issued
// together, not one latency after another; the cluster barrier before
// them orders them after the peers' writes
__device__ __forceinline__ unsigned long long ld_cluster_u64(uint32_t addr) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];\n" : "=l"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_cluster_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
               : "memory");
}

// a CTA's shared state
struct Shared {
  unsigned long long hist[2][kBins];  // by round parity
  unsigned long long warp_tot[kScanWarps];
  unsigned long long above;  // the selected digit's mass above it
  unsigned long long reach;  // ... and at and above it
  uint32_t digit;
  uint32_t max_key;   // this CTA's largest key
  uint32_t gmax_key;  // the cluster's
  uint32_t best[kMaxSplits];  // rank 0: each rank's draw (x bits, index)
  int best_i[kMaxSplits];
  float warp_best[32];
  int warp_best_i[32];
  uint32_t warp_word[32];
  // rank 0: each rank's gathered live entries at [rank * kGather, ...)
  // (key, perturbed score, index) and their counts; then the entries'
  // keys and masses, compacted
  uint32_t g_key[kMaxSplits * kGather];
  float g_x[kMaxSplits * kGather];
  int g_i[kMaxSplits * kGather];
  uint32_t g_count[kMaxSplits];
  uint32_t c_key[kGather];
  unsigned long long c_q[kGather];
};

// (best, best_i) <- the larger of it and (x, i), ties to the lower index
__device__ __forceinline__ void argmax_step(float& best, int& best_i, float x,
                                            int i) {
  if (x > best || (x == best && i < best_i)) {
    best = x;
    best_i = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& best, int& best_i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmax_step(best, best_i, __shfl_xor_sync(0xffffffffu, best, o),
                __shfl_xor_sync(0xffffffffu, best_i, o));
}

// the CTA's largest word, returned to every thread
__device__ __forceinline__ uint32_t block_max_u32(Shared& sh, uint32_t v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) sh.warp_word[warp] = v;
  __syncthreads();
  v = 0u;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    v = max(v, sh.warp_word[w]);
  return v;
}

// the CTA's draw into thread 0's (best, best_i): the warps', then theirs
// in warp order
__device__ __forceinline__ void block_argmax(Shared& sh, float& best,
                                             int& best_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(best, best_i);
  if (lane == 0) {
    sh.warp_best[warp] = best;
    sh.warp_best_i[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      argmax_step(best, best_i, sh.warp_best[w], sh.warp_best_i[w]);
}

// one thread's entry into a round's histogram, summed within the warp
// first: one shared atomic for each distinct bin of a warp (the first
// round's bins are few, and same-address atomics serialize). Counts by
// their match groups, masses by a warp sum for each distinct bin in turn
__device__ __forceinline__ void add_count(Shared& sh, int buf, bool hit,
                                          uint32_t bin) {
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if (hit) {
    const unsigned peers = __match_any_sync(hits, bin);
    if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
      atomicAdd(&sh.hist[buf][bin],
                static_cast<unsigned long long>(__popc(peers)));
  }
}

__device__ __forceinline__ void add_mass(Shared& sh, int buf, bool hit,
                                         uint32_t bin,
                                         unsigned long long q) {
  const int lane = threadIdx.x & 31;
  unsigned pending = __ballot_sync(0xffffffffu, hit);
  while (pending) {
    const int leader = __ffs(pending) - 1;
    const uint32_t b = __shfl_sync(0xffffffffu, bin, leader);
    const bool mine = hit && bin == b;
    unsigned long long v = mine ? q : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == leader) atomicAdd(&sh.hist[buf][b], v);
    pending &= ~__ballot_sync(0xffffffffu, mine);
  }
}

// the cluster's largest key, from each of the first `ranks` CTAs' (after
// a cluster barrier), into sh.gmax_key by thread 0
__device__ __forceinline__ void merge_max_key(Shared& sh, int ranks) {
  if (threadIdx.x == 0) {
    const uint32_t a = sm90::smem_u32(&sh.max_key);
    uint32_t k[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      k[r] = r < ranks ? ld_cluster_u32(sm90::cluster_map(a, r)) : 0u;
    uint32_t m = 0u;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) m = max(m, k[r]);
    sh.gmax_key = m;
  }
}

// The end of one radix round, once this CTA's entries are in
// sh.hist[buf]: the cluster barrier (`overlap` runs between its arrive and
// its wait), each bin summed over the first `ranks` CTAs in rank order
// (the other parity's histogram zeroed for the next round), and the
// largest digit d with above + (the merged bins >= d) >= target. With
// top_p >= 0 the target is first set to top_p times the merged total (the
// first top-p round: the total is z); with max_too the cluster's largest
// key is merged too (sh.gmax_key). Returns d; `above` becomes the mass of
// the bins above d, added to what was above before.
template <typename Overlap>
__device__ __forceinline__ uint32_t select_digit(Shared& sh, int buf,
                                                 int ranks,
                                                 unsigned long long& above,
                                                 double& target, float top_p,
                                                 bool max_too,
                                                 Overlap&& overlap) {
  cluster_arrive();
  overlap();
  sm90::cluster_wait();
  if (max_too) merge_max_key(sh, ranks);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long bin = 0, suf = 0;
  if (t < kBins) {
    const uint32_t a = sm90::smem_u32(&sh.hist[buf][t]);
    unsigned long long part[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      part[r] = r < ranks ? ld_cluster_u64(sm90::cluster_map(a, r)) : 0ull;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) bin += part[r];  // rank order
    sh.hist[buf ^ 1][t] = 0ull;
    // the warp's suffix sums: lane l gets the bins l..31 of its warp
    suf = bin;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_down_sync(0xffffffffu, suf, o);
      if (lane + o < 32) suf += y;
    }
    if (lane == 0) sh.warp_tot[warp] = suf;
  }
  __syncthreads();
  unsigned long long total = 0, higher = 0;
#pragma unroll
  for (int w = 0; w < kScanWarps; ++w) {
    const unsigned long long v = sh.warp_tot[w];
    total += v;
    if (w > warp) higher += v;
  }
  if (top_p >= 0.f)
    target = static_cast<double>(top_p) * static_cast<double>(total);
  if (t < kBins) {
    suf += higher;  // the merged bins t..255
    const bool in = static_cast<double>(above + suf) >= target;
    const bool next_in = static_cast<double>(above + suf - bin) >= target;
    if (in && !next_in) {
      sh.digit = static_cast<uint32_t>(t);
      sh.above = above + suf - bin;
      sh.reach = above + suf;
    }
  }
  __syncthreads();
  above = sh.above;
  return sh.digit;
}

}  // namespace sample
}  // namespace apex
