// Speculative decoding's verify tail: target logit rows + drafted tokens ->
// (accepted length, [winning node,] next token), one launch per call, for
// Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/verify.py::fused_verify_fwd (:262-301;
// kernel body _verify_kernel :245-259) and ::fused_verify_tree_fwd
// (:326-370; _verify_tree_kernel :304-323), written from the reference's
// helpers (row_argmax, verify_greedy, verify_sampled, tree_accepted_path,
// verify_tree_greedy, verify_tree_sampled :66-242), not carried over block
// by block:
// * both kernels are one body over a draft tree. Node 0 is the committed
//   pending token; node c >= 1 is a drafted token whose target
//   distribution is logit row parent(c). The chain is the one-branch tree:
//   node c = draft c - 1, parent c - 1, so row i verifies draft i and the
//   bonus row k has no child. The tree reads tokens, parents and the
//   ancestor-or-self closure anc from its operands.
// * every verify row on its own thread-block cluster: b * N1 clusters of S
//   CTAs in one launch (the host's plan, ops/fused_verify.py::_verify_plan,
//   from the shapes and the SM count alone). Rank r holds the contiguous
//   share [r * share, (r + 1) * share) of the row's logits (and, sampled,
//   of its Gumbel noise).
// * greedy: each rank walks its share with 16-byte loads for its argmax in
//   fp32 (ties to the lowest index); rank 0 merges the ranks' in rank
//   order: cand[r]. Node c is accepted iff cand[parent(c)] == token[c].
// * sampled, on the sampler's own device code (sample_cluster.cuh): the
//   share held in registers, s = fp32(logit) * (1/T) as its
//   order-preserving key, the top-k threshold by 4 radix rounds (ties at
//   the k-th value kept, as the reference's converged bisection keeps
//   them), m the cluster's largest score, then top-p over the top-k
//   survivors (verify.py:99-125, 199-242 through sampling.py's
//   filtered_scaled) as the sampler takes it: after a top-k that left at
//   most kGather entries every rank stores its survivors (key, Gumbel
//   term, index) into rank 0, which finds the threshold among them and
//   finishes the row alone; otherwise (top_k 0, or ties at the k-th value
//   past kGather) 4 mass rounds of select_digit with the top-p target.
//   Either way the kept set is {key >= t}, t the largest key whose mass at
//   and above it reaches top_p * z over the top-k survivors (the crossing
//   token and its ties kept), taken before any drafted token is filtered.
//   Top-p runs in an instance of its own (kTopP), so the greedy and
//   sampled modes without it carry neither its shared memory (the
//   gathered survivors, 27.7 KB) nor its registers.
//   z and each drafted child's mass are fixed-point integers exp(s - m) *
//   2^40 summed over the kept set (a filtered token has mass 0), so child
//   c of row r is accepted iff u_acc[c] < q[c] / z, the same bits on every
//   run. Row r's candidate is the Gumbel-argmax s + (-logf(-logf(u))) over
//   the kept set with EVERY real drafted child's token filtered
//   (verify.py:235-241; a filtered entry takes the reference's -1e30 + its
//   Gumbel term, which rounds to -1e30: with nothing left the candidate is
//   index 0), merged at rank 0 in rank order together with the ranks'
//   masses: one cluster barrier after the rounds.
// * the tree resolved in the same launch, with no float atomics: rank 0 of
//   each row's cluster publishes cand[r] (and, sampled, its children's
//   accept flags) into fixed slots of a workspace, tagged with the call's
//   epoch, and adds one to its batch row's arrival counter with a
//   release-acquire atomic. The
//   cluster that arrives last reads the slots (an untagged one counts as
//   never published: candidate -1, flag false), finds each node's depth
//   and whether its whole root path is accepted (one thread a node; the
//   tree's anc staged as bits in shared memory at the start), takes the
//   deepest such node, ties to the lowest (verify.py:156-159), writes the
//   verdict and resets the counter to 0. A second launch for the
//   resolution was not taken: at these sizes an empty launch costs
//   0.0018-0.0020 ms, about as much as the whole greedy verify should.
// * logf/expf are the accurate ones: the library is built without
//   --use_fast_math. NO_DRAFT (-1) never equals a token, so a padded node
//   is never accepted.
//
// Bound on this card: bytes. The logits (and, sampled, the Gumbel noise)
// are read once: at the spec leg's (1, 9, 32768) bf16 that is 0.6 MB
// greedy, 1.8 MB sampled: 0.18-0.53 us at 3.35 TB/s, below a launch's own
// cost. What sets the time is latency: the launch, one wave of loads, the
// cluster barriers (greedy 1, sampled 5 with top-k; top-p adds 1 after a
// gathering top-k, else 4 mass rounds), the counter's atomic and the last
// cluster's resolution.
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "sample_cluster.cuh"

namespace {

namespace sm90 = apex::sm90;
namespace smp = apex::sample;

using smp::aligned;
using smp::kMaxThreads;

constexpr int kMaxNodes = 128;
constexpr int kWords = kMaxNodes / 32;
constexpr int kNoDraft = -1;
// a gathered survivor's index, marked as a drafted child of its row
constexpr uint32_t kChildBit = 1u << 30;

// planted faults, for the tests only: the last rank left out of every
// merge; row 0's slots never published; top-p skipped
enum Fault : int {
  kNoFault = 0,
  kDropLastRank = 1,
  kNoPublish = 2,
  kNoTopP = 3
};

// the sampler's row state (with top-p, rank 0's gathered survivors too)
// and the verify's own
template <bool kTopP>
struct VerifyShared
    : std::conditional_t<kTopP, smp::Shared, smp::RowShared> {
  unsigned long long z_part[smp::kMaxSplits];  // rank 0: each rank's mass
  unsigned long long warp_z[32];
  int kid_tok[kMaxNodes];  // the row's drafted children's tokens in [0, V)
  int n_kids;
  int last;                // this cluster arrived last for its batch row
  unsigned long long z;    // rank 0: the row's mass
  int cand[kMaxNodes];     // the resolver's: every row's candidate
  uint32_t acc_bits[kWords];
  uint32_t anc_bits[kMaxNodes][kWords];  // tree: node i's root path
};

// a slot: the call's epoch above, the value below
__device__ __forceinline__ void publish(unsigned long long* slot,
                                        unsigned epoch, int v) {
  *slot = (static_cast<unsigned long long>(epoch) << 32) |
          static_cast<uint32_t>(v);
}

// one more arrival at a batch row's counter: the previous count. Release:
// the CTA's slot stores before it (joined by the __syncthreads before)
// reach the GPU first; acquire: the resolver's reads after it (joined by
// the __syncthreads after) see every earlier arrival's. One acq_rel atomic
// in place of a fence on each side ran 0.55 us faster a call
__device__ __forceinline__ unsigned arrive(unsigned* counter) {
  unsigned prev;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(prev)
               : "l"(counter)
               : "memory");
  return prev;
}

__device__ __forceinline__ void st_cluster_u64(uint32_t addr,
                                               unsigned long long v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;\n" ::"r"(addr), "l"(v)
               : "memory");
}

// kTopP: the instance that takes top-p (its shared memory holds the
// gathered survivors); the other runs greedy and sampled without it
template <typename T, int P, bool kTree, bool kTopP>
__global__ void __launch_bounds__(kMaxThreads)
    verify_kernel(const T* __restrict__ logits, const int* __restrict__ toks,
                  const int* __restrict__ parents, const int* __restrict__ anc,
                  const float* __restrict__ u_acc,
                  const float* __restrict__ u_gum, int* __restrict__ a_out,
                  int* __restrict__ j_out, int* __restrict__ next_out,
                  unsigned long long* __restrict__ slots,
                  unsigned* __restrict__ arrivals, unsigned epoch, int n1,
                  int V, int splits, int share, int sampled, float inv_temp,
                  int top_k, float top_p, bool vec, int fault) {
  __shared__ VerifyShared<kTopP> sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int row = blockIdx.x / splits;  // (batch row, verify row)
  const int bi = row / n1, r = row - bi * n1;
  const int ranks = fault == kDropLastRank ? splits - 1 : splits;
  const int begin = rank * share;
  const int end = min(V, begin + share);
  const size_t nodes = static_cast<size_t>(bi) * n1;
  const T* lrow = logits + static_cast<size_t>(row) * V;
  const bool publishes = !(fault == kNoPublish && r == 0);
  const bool top_p_on = kTopP && fault != kNoTopP;

  // thread c < n1 holds node c's token and parent
  int tok = kNoDraft, par = -1;
  if (tid >= 1 && tid < n1) {
    tok = kTree ? toks[nodes + tid] : toks[nodes + tid - 1];
    par = kTree ? parents[nodes + tid] : tid - 1;
  }
  const bool kid = par == r;  // node tid is a drafted child of this row
  const bool kid_in = kid && tok >= 0 && tok < V;
  // rank 0 (sampled): the child's logit and acceptance draw, in flight
  // from the start
  float kid_logit = 0.f, kid_u = 1.f;
  if (sampled && rank == 0 && kid_in) {
    kid_logit = apex::to_float(lrow[tok]);
    kid_u = u_acc[nodes + (kTree ? tid : tid - 1)];
  }
  // rank 0 (tree): anc as bits, each warp a (node, 32-node word) in turn,
  // for the resolver
  const int words = (n1 + 31) >> 5;
  if (kTree && rank == 0) {
    for (int p = warp; p < n1 * words; p += nthreads >> 5) {
      const int i = p / words, j = 32 * (p - i * words) + lane;
      const bool on = j < n1 && anc[(nodes + i) * n1 + j] != 0;
      const uint32_t w = __ballot_sync(0xffffffffu, on);
      if (lane == 0) sh.anc_bits[i][p - i * words] = w;
    }
  }

  int cand = 0;  // rank 0's thread 0: this row's candidate
  if (!sampled) {
    // every CTA of the cluster has started before a store into rank 0
    sm90::cluster_arrive_relaxed();
    float best = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll 4
    for (int e0 = begin + 8 * tid; e0 < end; e0 += 8 * nthreads) {
      float v[8];
      if (vec) {  // share and V multiples of 8: the chunk is whole
        if constexpr (sizeof(T) == 2) {
          apex::unpack_chunk<__nv_bfloat16>(
              *reinterpret_cast<const uint4*>(lrow + e0), v);
        } else {
          apex::unpack_chunk<float>(
              *reinterpret_cast<const uint4*>(lrow + e0), v);
          apex::unpack_chunk<float>(
              *reinterpret_cast<const uint4*>(lrow + e0 + 4), v + 4);
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[k] = e0 + k < end ? apex::to_float(lrow[e0 + k]) : -INFINITY;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (e0 + k < end) smp::argmax_step(best, best_i, v[k], e0 + k);
    }
    sm90::cluster_wait();
    smp::send_draw(sh, best, best_i, rank);
    // every CTA's argmax is in rank 0
    smp::cluster_arrive();
    sm90::cluster_wait();
    if (rank != 0) return;
    if (tid == 0) cand = smp::merge_draws(sh, ranks);
  } else {
    float s[P], x[P];
    const uint32_t valid = smp::load_share<T, P>(
        lrow, u_gum + static_cast<size_t>(row) * V, begin, end, vec, s, x);
    smp::clear_row(sh);
    if (tid == 0) sh.n_kids = 0;
    __syncthreads();
    if (kid_in) sh.kid_tok[atomicAdd(&sh.n_kids, 1)] = tok;
    uint32_t key[P];
    smp::score_keys(sh, s, valid, inv_temp, key);

    // x = -log(-log u), the Gumbel term alone: run inside the first
    // cluster barrier
    bool drawn = false;
    auto gumbel = [&]() {
      if (drawn) return;
#pragma unroll
      for (int i = 0; i < P; ++i) x[i] = -logf(-logf(x[i]));
      drawn = true;
    };
    int buf = 0;
    uint32_t keep = 0u;  // the kept keys are those >= keep
    if (top_k > 0) {
      keep = smp::top_k_keep(sh, key, valid, top_k, ranks, buf, gumbel);
    } else {  // the largest score, merged on its own
      smp::cluster_arrive();
      gumbel();
      sm90::cluster_wait();
      smp::merge_max_key(sh, ranks);
      __syncthreads();
    }
    const float m = smp::key_score(sh.gmax_key);

    // this thread's values that are drafted children's tokens
    uint32_t drop = 0u;
    for (int j = 0; j < sh.n_kids; ++j) {
      const int at = sh.kid_tok[j] - begin;
      if (at >= 0 && at < end - begin) {
        const int chunk = at >> 3;
        if (chunk % nthreads == tid)
          drop |= 1u << (8 * (chunk / nthreads) + (at & 7));
      }
    }
    // top-k left at most kGather survivors: every rank stores its own
    // (key, Gumbel term, index with the drafted-child bit) into rank 0,
    // which finds the top-p threshold among them with the rounds' integer
    // masses and finishes the row alone
    if (top_p_on && top_k > 0 && sh.reach <= smp::kGather) {
      if constexpr (kTopP) {
        smp::gather_survivors(sh, key, x, valid, keep, begin, rank,
                              [&](int i) {
                                return ((drop >> i) & 1u) ? kChildBit : 0u;
                              });
        if (rank != 0) return;
        const smp::Gathered g = smp::gathered_top_p(sh, ranks, m, top_p);
        keep = g.keep;
        unsigned long long z = g.kept ? sh.c_q[tid] : 0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          z += __shfl_xor_sync(0xffffffffu, z, o);
        if (lane == 0) sh.warp_z[warp] = z;
        float best = -INFINITY;
        int best_i = INT_MAX;
        if (g.kept && !(sh.g_i[g.slot] & kChildBit)) {
          best = smp::key_score(sh.c_key[tid]) + sh.g_x[g.slot];
          best_i = static_cast<int>(sh.g_i[g.slot]);
        }
        smp::block_argmax(sh, best, best_i);  // its barrier publishes warp_z
        if (tid == 0) {
          unsigned long long zr = 0ull;
          for (int w = 0; w < nthreads / 32; ++w) zr += sh.warp_z[w];
          sh.z = zr;
          // nothing kept but drafted children: every entry at -1e30
          cand = best_i == INT_MAX ? 0 : best_i;
        }
      }
    } else {
      if (top_p_on) {
        // top-p by 4 mass rounds over the top-k survivors: the target is
        // top_p times the first round's total, z over the survivors
        keep = smp::top_p_rounds(sh, key, top_p, ranks, buf, [&](int i) {
          return ((valid >> i) & 1u) && key[i] >= keep
                     ? smp::key_mass(key[i], m)
                     : 0ull;
        });
      }
      // the kept entries' mass, and the draw over the kept entries that
      // are no drafted child (the rest at the reference's -1e30 + Gumbel)
      unsigned long long z = 0ull;
      float best = -INFINITY;
      int best_i = INT_MAX;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (!((valid >> i) & 1u)) continue;
        const bool kept = key[i] >= keep;
        if (kept) z += smp::key_mass(key[i], m);
        const float xi = ((kept && !((drop >> i) & 1u))
                              ? smp::key_score(key[i])
                              : smp::kFiltered) +
                         x[i];
        if (xi > best) {
          best = xi;
          best_i = smp::share_elem(begin, i);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        z += __shfl_xor_sync(0xffffffffu, z, o);
      if (lane == 0) sh.warp_z[warp] = z;
      smp::send_draw(sh, best, best_i, rank);  // its barrier publishes warp_z
      if (tid == 0) {
        unsigned long long zc = 0ull;
        for (int w = 0; w < nthreads / 32; ++w) zc += sh.warp_z[w];
        st_cluster_u64(
            sm90::cluster_map(sm90::smem_u32(&sh.z_part[rank]), 0), zc);
      }
      // every CTA's draw and mass are in rank 0, every read of a peer done
      smp::cluster_arrive();
      sm90::cluster_wait();
      if (rank != 0) return;
      if (tid == 0) {
        unsigned long long zr = 0ull;
        for (int q = 0; q < ranks; ++q) zr += sh.z_part[q];
        sh.z = zr;
        cand = smp::merge_draws(sh, ranks);
      }
    }
    __syncthreads();
    if (kid && publishes) {  // node tid's accept flag
      unsigned long long q = 0ull;
      if (kid_in) {
        const uint32_t k = smp::score_key(kid_logit * inv_temp);
        if (k >= keep) q = smp::key_mass(k, m);
      }
      const bool acc = static_cast<double>(kid_u) <
                       static_cast<double>(q) / static_cast<double>(sh.z);
      publish(&slots[2 * (nodes + tid) + 1], epoch, acc ? 1 : 0);
    }
  }

  // rank 0 of every row: its slots are out; the last row of its batch row
  // to arrive resolves the batch row
  if (tid == 0 && publishes) publish(&slots[2 * (nodes + r)], epoch, cand);
  __syncthreads();
  if (tid == 0)
    sh.last = arrive(&arrivals[bi]) == static_cast<unsigned>(n1 - 1);
  __syncthreads();
  if (!sh.last) return;

  // every row's candidate (sampled: every node's accept flag) from its slot
  bool acc = false;
  if (tid < n1) {
    const unsigned long long cs = __ldcg(&slots[2 * (nodes + tid)]);
    sh.cand[tid] =
        (cs >> 32) == epoch ? static_cast<int>(static_cast<uint32_t>(cs)) : -1;
    if (sampled && tid >= 1 && par >= 0 && par < n1) {
      const unsigned long long as = __ldcg(&slots[2 * (nodes + tid) + 1]);
      acc = (as >> 32) == epoch && static_cast<uint32_t>(as) != 0u;
    }
  }
  __syncthreads();
  if (!sampled && tid >= 1 && tid < n1 && par >= 0 && par < n1)
    acc = tok >= 0 && sh.cand[par] == tok;
  if (tid == 0) acc = true;  // the pending token is committed
  if (warp < words) {
    const uint32_t bits = __ballot_sync(0xffffffffu, tid < n1 && acc);
    if (lane == 0) sh.acc_bits[warp] = bits;
  }
  __syncthreads();
  // node tid's depth and whether its whole root path is accepted, as
  // (depth + 1, 255 - node): the largest is the deepest, ties to the
  // lowest node
  uint32_t v = 0u;
  if (tid < n1) {
    int depth = -1;
    bool ok = true;
    for (int w = 0; w < words; ++w) {
      uint32_t path;
      if (kTree) {
        path = sh.anc_bits[tid][w];
      } else {  // the chain: node i's root path is nodes 0..i
        const int lo = 32 * w;
        path = tid < lo ? 0u : tid - lo >= 31 ? ~0u : (2u << (tid - lo)) - 1u;
      }
      depth += __popc(path);
      ok = ok && (path & ~sh.acc_bits[w]) == 0u;
    }
    if (ok) v = (static_cast<uint32_t>(depth + 1) << 8) | (255u - tid);
  }
  if (warp < words) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) sh.warp_word[warp] = v;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < words; ++w) v = max(v, sh.warp_word[w]);
    const int winner = 255 - static_cast<int>(v & 255u);
    a_out[bi] = static_cast<int>(v >> 8) - 1;
    if (kTree) j_out[bi] = winner;
    next_out[bi] = sh.cand[winner];
    arrivals[bi] = 0u;
  }
}

template <typename T, bool kTree>
using KernelFn = void (*)(const T*, const int*, const int*, const int*,
                          const float*, const float*, int*, int*, int*,
                          unsigned long long*, unsigned*, unsigned, int, int,
                          int, int, int, float, int, float, bool, int);

template <typename T, bool kTree, bool kTopP>
KernelFn<T, kTree> instance_of(int values) {
  switch (values) {
    case 8:
      return verify_kernel<T, 8, kTree, kTopP>;
    case 16:
      return verify_kernel<T, 16, kTree, kTopP>;
    case 32:
      return verify_kernel<T, 32, kTree, kTopP>;
    default:
      return nullptr;
  }
}

template <typename T, bool kTree>
KernelFn<T, kTree> instance_of(int values, bool top_p) {
  return top_p ? instance_of<T, kTree, true>(values)
               : instance_of<T, kTree, false>(values);
}

template <bool kTree>
int run(const void* logits, const void* toks, const void* parents,
        const void* anc, const void* u_acc, const void* u_gum, void* a_out,
        void* j_out, void* next_out, void* slots, void* arrivals, int epoch,
        int dtype, int b, int n1, int V, int sampled, float inv_temp,
        int top_k, int use_top_p, float top_p, int splits, int threads,
        int values, int share, int fault, void* stream) {
  if (b < 1 || n1 < 2 || n1 > kMaxNodes ||
      (sampled && V > 49152) || top_k < 0 || top_k > V || epoch == 0 ||
      (use_top_p && (!sampled || !(top_p > 0.f && top_p <= 1.f))) ||
      fault < kNoFault || fault > kNoTopP ||
      reinterpret_cast<uintptr_t>(slots) % 8 != 0 ||
      smp::bad_plan(dtype, V, splits, threads, values, share, sampled) ||
      static_cast<long long>(b) * n1 * splits > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec =
      V % 8 == 0 && aligned(logits) && (!sampled || aligned(u_gum));
  smp::ClusterLaunch l(b * n1 * splits, splits, threads,
           static_cast<cudaStream_t>(stream));
  cudaError_t err;
  if (dtype == apex::kBFloat16) {
    const auto kern = instance_of<__nv_bfloat16, kTree>(values, use_top_p);
    err = cudaLaunchKernelEx(
        &l.cfg, kern, static_cast<const __nv_bfloat16*>(logits),
        static_cast<const int*>(toks), static_cast<const int*>(parents),
        static_cast<const int*>(anc), static_cast<const float*>(u_acc),
        static_cast<const float*>(u_gum), static_cast<int*>(a_out),
        static_cast<int*>(j_out), static_cast<int*>(next_out),
        static_cast<unsigned long long*>(slots),
        static_cast<unsigned*>(arrivals), static_cast<unsigned>(epoch), n1,
        V, splits, share, sampled, inv_temp, top_k, top_p, vec, fault);
  } else {
    const auto kern = instance_of<float, kTree>(values, use_top_p);
    err = cudaLaunchKernelEx(
        &l.cfg, kern, static_cast<const float*>(logits),
        static_cast<const int*>(toks), static_cast<const int*>(parents),
        static_cast<const int*>(anc), static_cast<const float*>(u_acc),
        static_cast<const float*>(u_gum), static_cast<int*>(a_out),
        static_cast<int*>(j_out), static_cast<int*>(next_out),
        static_cast<unsigned long long*>(slots),
        static_cast<unsigned*>(arrivals), static_cast<unsigned>(epoch), n1,
        V, splits, share, sampled, inv_temp, top_k, top_p, vec, fault);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, bool kTree>
cudaError_t occupancy(int splits, int threads, int values, bool top_p,
                      int* out) {
  const KernelFn<T, kTree> kern = instance_of<T, kTree>(values, top_p);
  if (kern == nullptr) return cudaErrorInvalidValue;
  smp::ClusterLaunch l(splits, splits, threads, nullptr);
  cudaError_t err = cudaOccupancyMaxActiveClusters(&out[0], kern, &l.cfg);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  return err;
}

}  // namespace

// logits (b, k+1, V); drafted (b, k+1) int32 with the bonus entry NO_DRAFT;
// u_acc (b, k+1) and u_gum (b, k+1, V) fp32, read only when sampled.
// slots (2 b (k+1) u64) and arrivals (b u32, zero between calls): the
// wrapper's workspace; epoch: this call's tag, never 0. use_top_p, top_p:
// the nucleus filter after top-k (sampled only). splits, threads, values,
// share: the host's plan (_verify_plan); fault: 0, or a planted fault of
// the tests
extern "C" int apex_fused_verify(const void* logits, const void* drafted,
                                 const void* u_acc, const void* u_gum,
                                 void* a_out, void* next_out, void* slots,
                                 void* arrivals, int epoch, int dtype, int b,
                                 int k1, int V, int sampled, float inv_temp,
                                 int top_k, int use_top_p, float top_p,
                                 int splits, int threads, int values,
                                 int share, int fault, void* stream) {
  return run<false>(logits, drafted, nullptr, nullptr, u_acc, u_gum, a_out,
                    nullptr, next_out, slots, arrivals, epoch, dtype, b, k1,
                    V, sampled, inv_temp, top_k, use_top_p, top_p, splits,
                    threads, values, share, fault, stream);
}

// logits (b, N1, V); tokens, parents (b, N1) and anc (b, N1, N1) int32;
// u_acc (b, N1) and u_gum (b, N1, V) fp32, read only when sampled; the
// rest as apex_fused_verify
extern "C" int apex_fused_verify_tree(
    const void* logits, const void* tokens, const void* parents,
    const void* anc, const void* u_acc, const void* u_gum, void* a_out,
    void* j_out, void* next_out, void* slots, void* arrivals, int epoch,
    int dtype, int b, int n1, int V, int sampled, float inv_temp, int top_k,
    int use_top_p, float top_p, int splits, int threads, int values,
    int share, int fault, void* stream) {
  return run<true>(logits, tokens, parents, anc, u_acc, u_gum, a_out, j_out,
                   next_out, slots, arrivals, epoch, dtype, b, n1, V, sampled,
                   inv_temp, top_k, use_top_p, top_p, splits, threads, values,
                   share, fault, stream);
}

// for the plan's clusters (tree or chain instance, with or without
// top-p): out[0] how many the card holds at once
// (cudaOccupancyMaxActiveClusters; 0 means the launch is refused), out[1]
// a CTA's static shared memory in bytes
extern "C" int apex_fused_verify_occupancy(int tree, int use_top_p,
                                           int dtype, int V, int splits,
                                           int threads, int values,
                                           int share, int* out) {
  if (smp::bad_plan(dtype, V, splits, threads, values, share, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool p = use_top_p != 0;
  cudaError_t err;
  if (dtype == apex::kBFloat16)
    err = tree ? occupancy<__nv_bfloat16, true>(splits, threads, values, p,
                                                out)
               : occupancy<__nv_bfloat16, false>(splits, threads, values, p,
                                                 out);
  else
    err = tree ? occupancy<float, true>(splits, threads, values, p, out)
               : occupancy<float, false>(splits, threads, values, p, out);
  return static_cast<int>(err);
}
