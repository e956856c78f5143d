// The sampling filter split over a thread-block cluster, shared by the
// fused sampler (fused_sample.cu) and the speculative verify kernels
// (fused_verify.cu), as the reference shares
// apex_tpu/ops/pallas/sampling.py's helpers with ops/pallas/verify.py: each
// row's V scores are spread over the S CTAs of a cluster, and every
// row-wide quantity is merged across the cluster through distributed
// shared memory, in rank order. The per-row pieces both kernels run are
// here: the share's loads, the keys and the largest key, the top-k rounds,
// the fixed-point masses, top-p over the top-k survivors (gathered into
// rank 0, or by mass rounds), the rank-ordered merge of the draws, and the
// host side of their cluster launches.
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

#include <climits>
#include <cmath>
#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_sm90.cuh"
#include "row_io.cuh"

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

// a CTA's shared state for one row's work (both kernels)
struct RowShared {
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
};

// top-p's: plus rank 0's gathered live entries
struct Shared : RowShared {
  // rank 0: each rank's gathered live entries at [rank * kGather, ...)
  // (key, the kernel's x, tagged index) and their counts; then the
  // entries' keys and masses, compacted
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
__device__ __forceinline__ uint32_t block_max_u32(RowShared& sh,
                                                  uint32_t v) {
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
__device__ __forceinline__ void block_argmax(RowShared& sh, float& best,
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
__device__ __forceinline__ void add_count(RowShared& sh, int buf, bool hit,
                                          uint32_t bin) {
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if (hit) {
    const unsigned peers = __match_any_sync(hits, bin);
    if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
      atomicAdd(&sh.hist[buf][bin],
                static_cast<unsigned long long>(__popc(peers)));
  }
}

__device__ __forceinline__ void add_mass(RowShared& sh, int buf, bool hit,
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
__device__ __forceinline__ void merge_max_key(RowShared& sh, int ranks) {
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
__device__ __forceinline__ uint32_t select_digit(RowShared& sh, int buf,
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

// --- the per-row pieces of both kernels -------------------------------------
// A rank's share of a row is [begin, end); its thread tid holds the 8-value
// chunks tid, tid + T, tid + 2T, ... (T threads), P values in registers:
// value i = 8 c + k is element share_elem(begin, i).

__device__ __forceinline__ int share_elem(int begin, int i) {
  return begin + 8 * (static_cast<int>(threadIdx.x) +
                      static_cast<int>(blockDim.x) * (i >> 3)) +
         (i & 7);
}

// this thread's P values of the share of a logit row (s, in fp32) and of
// its noise row (x), each loaded once; 16-byte loads where `vec` (share
// and V multiples of 8, rows 16-byte aligned). Returns the mask of the
// values that lie in the share.
template <typename T, int P>
__device__ __forceinline__ uint32_t load_share(const T* __restrict__ lrow,
                                               const float* __restrict__ urow,
                                               int begin, int end, bool vec,
                                               float (&s)[P], float (&x)[P]) {
  constexpr int kChunks = P / 8;
  uint32_t valid = 0u;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int e0 = share_elem(begin, 8 * c);
    float* sc = s + 8 * c;
    float* uc = x + 8 * c;
    if (vec && e0 < end) {
      if constexpr (sizeof(T) == 2) {
        unpack_chunk<__nv_bfloat16>(
            *reinterpret_cast<const uint4*>(lrow + e0), sc);
      } else {
        unpack_chunk<float>(*reinterpret_cast<const uint4*>(lrow + e0), sc);
        unpack_chunk<float>(*reinterpret_cast<const uint4*>(lrow + e0 + 4),
                            sc + 4);
      }
      unpack_chunk<float>(*reinterpret_cast<const uint4*>(urow + e0), uc);
      unpack_chunk<float>(*reinterpret_cast<const uint4*>(urow + e0 + 4),
                          uc + 4);
      valid |= 0xffu << (8 * c);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool in = e0 + k < end;
        sc[k] = in ? to_float(lrow[e0 + k]) : 0.f;
        uc[k] = in ? urow[e0 + k] : 0.5f;
        if (in) valid |= 1u << (8 * c + k);
      }
    }
  }
  return valid;
}

// the histograms and this CTA's largest key, cleared before a row's rounds
// (a __syncthreads must follow)
__device__ __forceinline__ void clear_row(RowShared& sh) {
  const int tid = threadIdx.x;
  if (tid < kBins) {
    sh.hist[0][tid] = 0ull;
    sh.hist[1][tid] = 0ull;
  }
  if (tid == 0) sh.max_key = 0u;
}

// key = score_key(s * (1/T)), and the largest valid key into sh.max_key
template <int P>
__device__ __forceinline__ void score_keys(RowShared& sh, const float (&s)[P],
                                           uint32_t valid, float inv_temp,
                                           uint32_t (&key)[P]) {
  uint32_t kmax = 0u;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    key[i] = score_key(s[i] * inv_temp);
    if ((valid >> i) & 1u) kmax = max(kmax, key[i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
  if ((threadIdx.x & 31) == 0) atomicMax(&sh.max_key, kmax);
}

// The top-k threshold: the k-th largest key of the row over the first
// `ranks` CTAs, by 4 radix rounds (counts in sh.hist[buf], buf flipped
// each round); the first round also merges the cluster's largest key into
// sh.gmax_key, and overlap() runs inside each round's barrier. sh.reach is
// then the count at and above the threshold.
template <int P, typename Overlap>
__device__ __forceinline__ uint32_t top_k_keep(RowShared& sh,
                                               const uint32_t (&key)[P],
                                               uint32_t valid, int top_k,
                                               int ranks, int& buf,
                                               Overlap&& overlap) {
  uint32_t prefix = 0u;
  unsigned long long above = 0ull;
  double target = static_cast<double>(top_k);
  for (int shift = 24; shift >= 0; shift -= 8) {
    const uint32_t hi = shift == 24 ? 0u : ~0u << (shift + 8);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const bool hit = ((valid >> i) & 1u) && ((key[i] ^ prefix) & hi) == 0u;
      add_count(sh, buf, hit, (key[i] >> shift) & 0xffu);
    }
    const uint32_t d = select_digit(sh, buf, ranks, above, target, -1.f,
                                    shift == 24, overlap);
    prefix |= d << shift;
    buf ^= 1;
  }
  return prefix;
}

// a mass e = exp(s - m) in [0, 1] in fixed point: sums of these are exact
// in any order
__device__ __forceinline__ unsigned long long to_mass(float e) {
  return __float2ull_rn(e * kMassScale);
}

// the fixed-point mass of a kept score's key, m the row's largest score
__device__ __forceinline__ unsigned long long key_mass(uint32_t key, float m) {
  return to_mass(expf(key_score(key) - m));
}

// this thread's draw -> its warp's -> the CTA's (the warps' merged in one
// warp) -> rank 0's sh.best[rank] and sh.best_i[rank], stored by thread 0;
// rank 0 merges them with merge_draws after the next cluster barrier. Ties
// go to the lower index at every step, so the result is the CTA's lowest
// index among its largest values, whatever the order of the merges
__device__ __forceinline__ void send_draw(RowShared& sh, float best,
                                          int best_i, int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(best, best_i);
  if (lane == 0) {
    sh.warp_best[warp] = best;
    sh.warp_best_i[warp] = best_i;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool in = lane < static_cast<int>(blockDim.x >> 5);
  best = in ? sh.warp_best[lane] : -INFINITY;
  best_i = in ? sh.warp_best_i[lane] : INT_MAX;
  warp_argmax(best, best_i);
  if (lane == 0) {
    st_cluster_u32(sm90::cluster_map(sm90::smem_u32(&sh.best[rank]), 0),
                   __float_as_uint(best));
    st_cluster_u32(sm90::cluster_map(sm90::smem_u32(&sh.best_i[rank]), 0),
                   static_cast<uint32_t>(best_i));
  }
}

// rank 0: the first `ranks` ranks' draws merged in rank order, ties to the
// lower index
__device__ __forceinline__ int merge_draws(const RowShared& sh, int ranks) {
  float best = __uint_as_float(sh.best[0]);
  int best_i = sh.best_i[0];
  for (int r = 1; r < ranks; ++r)
    argmax_step(best, best_i, __uint_as_float(sh.best[r]), sh.best_i[r]);
  return best_i;
}

// --- top-p over the top-k survivors -----------------------------------------

// After a top-k that left at most kGather survivors (sh.reach): every rank
// stores its values with key >= keep -- key, x[i], element index | tag(i)
// -- into rank 0's g_key/g_x/g_i at [rank * kGather, ...) and their count
// into g_count[rank], then the cluster barrier. Afterwards rank 0 finds
// the threshold among them (gathered_top_p) and finishes the row alone;
// the other ranks are done with it.
template <int P, typename Tag>
__device__ __forceinline__ void gather_survivors(
    Shared& sh, const uint32_t (&key)[P], const float (&x)[P],
    uint32_t valid, uint32_t keep, int begin, int rank, Tag&& tag) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t live = 0u;
  int n_live = 0;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (((valid >> i) & 1u) && key[i] >= keep) {
      live |= 1u << i;
      ++n_live;
    }
  // this thread's place among its CTA's survivors: after its warp's lower
  // lanes and the lower warps
  int incl = n_live;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sh.warp_word[warp] = static_cast<uint32_t>(incl);
  __syncthreads();
  int off = incl - n_live, total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    const int c = static_cast<int>(sh.warp_word[w]);
    if (w < warp) off += c;
    total += c;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (((live >> i) & 1u) && off < kGather) {
      const int slot = rank * kGather + off;
      st_cluster_u32(sm90::cluster_map(sm90::smem_u32(&sh.g_key[slot]), 0),
                     key[i]);
      st_cluster_u32(sm90::cluster_map(sm90::smem_u32(&sh.g_x[slot]), 0),
                     __float_as_uint(x[i]));
      st_cluster_u32(sm90::cluster_map(sm90::smem_u32(&sh.g_i[slot]), 0),
                     static_cast<uint32_t>(share_elem(begin, i)) | tag(i));
      ++off;
    }
  }
  if (threadIdx.x == 0)
    st_cluster_u32(sm90::cluster_map(sm90::smem_u32(&sh.g_count[rank]), 0),
                   static_cast<uint32_t>(min(total, kGather)));
  // every rank's survivors are in rank 0, every read of a peer done
  cluster_arrive();
  sm90::cluster_wait();
}

// rank 0's thread t after gather_survivors: the t-th gathered entry of the
// first `ranks` ranks in rank order, at g_*[slot], and whether top-p keeps
// it. keep is the largest gathered key whose mass at and above it reaches
// top_p times the gathered mass, with the masses of top_p_rounds (the same
// integers, so the same threshold); sh.c_q[t] holds the entry's mass.
struct Gathered {
  uint32_t keep;
  int slot;
  bool kept;
};

__device__ __forceinline__ Gathered gathered_top_p(Shared& sh, int ranks,
                                                   float m, float top_p) {
  const int tid = threadIdx.x;
  int n = 0, r = 0, at = tid;
  for (int q = 0; q < ranks; ++q) n += static_cast<int>(sh.g_count[q]);
  while (r < ranks && at >= static_cast<int>(sh.g_count[r]))
    at -= static_cast<int>(sh.g_count[r++]);
  const bool mine = tid < n;
  Gathered g;
  g.slot = r * kGather + at;
  const uint32_t kt = mine ? sh.g_key[g.slot] : 0u;
  if (mine) {
    sh.c_key[tid] = kt;
    sh.c_q[tid] = key_mass(kt, m);
  }
  __syncthreads();
  unsigned long long z = 0ull, above = 0ull;
  for (int j = 0; j < n; ++j) {
    const unsigned long long q = sh.c_q[j];
    z += q;
    if (sh.c_key[j] >= kt) above += q;
  }
  const double target = static_cast<double>(top_p) * static_cast<double>(z);
  g.keep = block_max_u32(
      sh, mine && static_cast<double>(above) >= target ? kt : 0u);
  g.kept = mine && kt >= g.keep;
  return g;
}

// top-p by 4 mass rounds of select_digit: mass(i) is value i's fixed-point
// mass (0 where the value is filtered or invalid), the target top_p times
// the first round's total. Returns the threshold key.
template <int P, typename Mass>
__device__ __forceinline__ uint32_t top_p_rounds(RowShared& sh,
                                                 const uint32_t (&key)[P],
                                                 float top_p, int ranks,
                                                 int& buf, Mass&& mass) {
  auto nothing = []() {};
  uint32_t prefix = 0u;
  unsigned long long above = 0ull;
  double target = 0.0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    const uint32_t hi = shift == 24 ? 0u : ~0u << (shift + 8);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const unsigned long long q = mass(i);
      add_mass(sh, buf, q != 0ull && ((key[i] ^ prefix) & hi) == 0u,
               (key[i] >> shift) & 0xffu, q);
    }
    const uint32_t d = select_digit(sh, buf, ranks, above, target,
                                    shift == 24 ? top_p : -1.f, false,
                                    nothing);
    prefix |= d << shift;
    buf ^= 1;
  }
  return prefix;
}

// --- the host side of both kernels' launches --------------------------------

// a CTA's threads at most: 512 (128 registers a thread)
constexpr int kMaxThreads = 512;

// a grid of `ctas` CTAs in clusters of (splits, 1, 1)
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  ClusterLaunch(int ctas, int splits, int threads, cudaStream_t stream)
      : cfg{} {
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = splits;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
};

// what every launch checks of the plan it is given: S in 1-8, whole
// warps, at least the scan's 256 threads, the shares cover the row in
// multiples of 8, and (in_registers) the threads hold the share
inline bool bad_plan(int dtype, int V, int splits, int threads, int values,
                     int share, bool in_registers) {
  if ((dtype != kFloat32 && dtype != kBFloat16) || V < 1 ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      (values != 8 && values != 16 && values != 32))
    return true;
  return threads % 32 != 0 || threads < kBins || threads > kMaxThreads ||
         share < 8 || share % 8 != 0 ||
         static_cast<long long>(share) * splits < V ||
         (in_registers && static_cast<long long>(threads) * values < share);
}

inline bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace sample
}  // namespace apex
