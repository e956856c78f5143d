// Fused sampling tail: one logits row -> temperature -> top-k -> top-p ->
// Gumbel-argmax -> one int32 token, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/sampling.py::fused_sample_fwd (:156; kernel
// body _sample_kernel :140), written from the reference's helpers
// (apply_top_k, apply_top_p, gumbel_argmax :96-125), not carried over
// block by block. The device code of the filter is sample_cluster.cuh.
//
// * Each row is split over a thread-block cluster of S CTAs (the host's
//   plan, ops/sampling.py::_sample_plan: S in 1, 2, 4, 8 so that rows * S
//   stays within one CTA an SM; a round's merge and barrier cost more at
//   16, which was slower in every timed call). Rank r holds the
//   contiguous share [r * share, (r + 1) * share) of the row and of its
//   noise in registers (`P` values a thread, loaded once with 16-byte
//   loads), s = fp32(logit) * (1/T), kept as its key.
// * top-k and top-p thresholds: 4 rounds of radix select each
//   (sample_cluster.cuh) instead of the reference's 48 bisection steps;
//   exp(s - m) is computed once a value and kept for the top-p rounds.
//   Top-p after a top-k that left at most 256 live entries (the serve's
//   top-k 50) takes no rounds: every rank stores its live entries into
//   rank 0, which finds the threshold among them with the same integer
//   masses (the same threshold) and draws.
//   Every row-wide quantity (the largest score, the counts and masses of
//   each round, the draw) is formed per CTA, then read by every CTA from
//   each rank's shared memory in rank order after a cluster barrier. No
//   float atomics and no second launch: the same inputs give the same
//   token on every run.
// * the draw is argmax(s + (-logf(-logf(u)))) over the kept entries, ties
//   to the lowest index; the Gumbel term is computed between the first
//   cluster barrier's arrive and its wait. Each rank stores its draw into
//   rank 0's shared memory, and rank 0 writes the token.
// * logf/expf are the accurate ones: the library is built without
//   --use_fast_math.
//
// Bound on this card: bytes at the serve's (8, 32768) (bf16 logits and
// fp32 noise read once: 0.47 us at 3.35 TB/s; about 40 fp32 operations a
// value, 0.16 us of 67 TFLOP/s). What sets the time is latency: the
// launch, the loads, and one cluster barrier with a 256-bin merge and scan
// for each of the (at most) 9 dependent rounds; the serve's knobs take 5.
#include <climits>
#include <cmath>
#include <cstdint>

#include "row_io.cuh"
#include "sample_cluster.cuh"

namespace {

namespace sm90 = apex::sm90;

using apex::sample::aligned;
using apex::sample::kBins;
using apex::sample::kMaxThreads;
using apex::sample::Shared;

// planted faults, for the tests only: the last rank left out of every
// merge
enum Fault : int { kNoFault = 0, kDropLastRank = 1 };

template <typename T, int P>
__global__ void __launch_bounds__(kMaxThreads)
    fused_sample_kernel(const T* __restrict__ logits,
                        const float* __restrict__ u, int* __restrict__ out,
                        int V, int splits, int share, float inv_temp,
                        int top_k, int use_top_p, float top_p, bool vec,
                        int fault) {
  constexpr bool kKeepMass = P <= 16;
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(sm90::cluster_ctarank());
  const int row = blockIdx.x / splits;
  const int ranks = fault == kDropLastRank ? splits - 1 : splits;
  const int begin = rank * share;
  const int end = min(V, begin + share);
  const T* lrow = logits + static_cast<size_t>(row) * V;
  const float* urow = u + static_cast<size_t>(row) * V;

  // the thread keeps its scores as keys, and the noise (then the perturbed
  // scores) in x
  float s[P], x[P];
  const uint32_t valid = apex::sample::load_share<T, P>(lrow, urow, begin,
                                                        end, vec, s, x);
  apex::sample::clear_row(sh);
  __syncthreads();

  uint32_t key[P];
  apex::sample::score_keys(sh, s, valid, inv_temp, key);

  // x = s + (-log(-log u)): run between the first barrier's arrive and wait
  bool drawn = false;
  auto gumbel = [&]() {
    if (drawn) return;
#pragma unroll
    for (int i = 0; i < P; ++i)
      x[i] = apex::sample::key_score(key[i]) + (-logf(-logf(x[i])));
    drawn = true;
  };

  int buf = 0;
  uint32_t keep = 0u;  // the kept keys are those >= keep
  if (top_k > 0)
    keep = apex::sample::top_k_keep(sh, key, valid, top_k, ranks, buf,
                                    gumbel);
  if (use_top_p && top_k > 0 && sh.reach <= apex::sample::kGather) {
    // top-k left at most kGather live entries: rank 0 gathers them (key,
    // perturbed score, index), finds the top-p threshold among them and
    // draws, with the same integer masses as the rounds below
    apex::sample::gather_survivors(sh, key, x, valid, keep, begin, rank,
                                   [](int) { return 0u; });
    if (rank != 0) return;
    const apex::sample::Gathered g = apex::sample::gathered_top_p(
        sh, ranks, apex::sample::key_score(sh.gmax_key), top_p);
    float best = -INFINITY;
    int best_i = INT_MAX;
    if (g.kept) {
      best = sh.g_x[g.slot];
      best_i = sh.g_i[g.slot];
    }
    apex::sample::block_argmax(sh, best, best_i);
    if (tid == 0) out[row] = best_i;
    return;
  }
  if (use_top_p) {
    if (top_k == 0) {  // the largest score, merged on its own
      apex::sample::cluster_arrive();
      gumbel();
      sm90::cluster_wait();
      apex::sample::merge_max_key(sh, ranks);
      __syncthreads();
    }
    // e = exp(s - m) over the live entries, computed once a value and
    // kept for every round (at 32 values a thread the registers hold no
    // third array: there each round computes it again)
    const float m = apex::sample::key_score(sh.gmax_key);
    auto mass = [&](int i) {
      const bool live = ((valid >> i) & 1u) && key[i] >= keep;
      return live ? expf(apex::sample::key_score(key[i]) - m) : 0.f;
    };
    float e[kKeepMass ? P : 1];
    if constexpr (kKeepMass) {
#pragma unroll
      for (int i = 0; i < P; ++i) e[i] = mass(i);
    }
    keep = apex::sample::top_p_rounds(
        sh, key, top_p, ranks, buf, [&](int i) {
          if constexpr (kKeepMass)
            return apex::sample::to_mass(e[i]);
          else
            return apex::sample::to_mass(mass(i));
        });
  }
  if (top_k == 0 && !use_top_p) {  // no round ran: every CTA has started
    apex::sample::cluster_arrive();
    gumbel();
    sm90::cluster_wait();
  }

  // the draw: this thread's, the warp's, the CTA's, then rank 0 takes the
  // ranks' in rank order
  float best = -INFINITY;
  int best_i = INT_MAX;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (((valid >> i) & 1u) && key[i] >= keep && x[i] > best) {
      best = x[i];
      best_i = apex::sample::share_elem(begin, i);
    }
  apex::sample::send_draw(sh, best, best_i, rank);
  // every CTA's draw is in rank 0, and every read of a peer is done
  apex::sample::cluster_arrive();
  sm90::cluster_wait();
  if (rank == 0 && tid == 0) out[row] = apex::sample::merge_draws(sh, ranks);
}

template <typename T>
using KernelFn = void (*)(const T*, const float*, int*, int, int, int,
                          float, int, int, float, bool, int);

template <typename T>
KernelFn<T> instance_of(int values) {
  switch (values) {
    case 8:
      return fused_sample_kernel<T, 8>;
    case 16:
      return fused_sample_kernel<T, 16>;
    case 32:
      return fused_sample_kernel<T, 32>;
    default:
      return nullptr;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const void* u, void* out, int b,
                   int V, float inv_temp, int top_k, int use_top_p,
                   float top_p, int splits, int threads, int values,
                   int share, int fault, cudaStream_t stream) {
  const KernelFn<T> kern = instance_of<T>(values);
  if (kern == nullptr) return cudaErrorInvalidValue;
  const bool vec = V % 8 == 0 && aligned(logits) && aligned(u);
  apex::sample::ClusterLaunch l(b * splits, splits, threads, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, kern, static_cast<const T*>(logits),
      static_cast<const float*>(u), static_cast<int*>(out), V, splits, share,
      inv_temp, top_k, use_top_p, top_p, vec, fault);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t max_clusters(int splits, int threads, int values, int* n) {
  const KernelFn<T> kern = instance_of<T>(values);
  if (kern == nullptr) return cudaErrorInvalidValue;
  apex::sample::ClusterLaunch l(splits, splits, threads, nullptr);
  return cudaOccupancyMaxActiveClusters(n, kern, &l.cfg);
}

}  // namespace

// logits (b, V) of dtype, u (b, V) fp32 in (0, 1), out (b,) int32.
// splits, threads, values, share: the host's plan (_sample_plan); fault:
// 0, or a planted fault of the tests
extern "C" int apex_fused_sample(const void* logits, const void* u,
                                 void* out, int dtype, int b, int V,
                                 float inv_temp, int top_k, int use_top_p,
                                 float top_p, int splits, int threads,
                                 int values, int share, int fault,
                                 void* stream) {
  if (b < 1 || top_k < 0 || top_k > V || fault < kNoFault ||
      fault > kDropLastRank ||
      apex::sample::bad_plan(dtype, V, splits, threads, values, share,
                             true))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? launch<__nv_bfloat16>(logits, u, out, b, V, inv_temp, top_k,
                                  use_top_p, top_p, splits, threads, values,
                                  share, fault, s)
          : launch<float>(logits, u, out, b, V, inv_temp, top_k, use_top_p,
                          top_p, splits, threads, values, share, fault, s);
  return static_cast<int>(err);
}

// how many clusters of the plan's CTAs the card can hold at once
// (cudaOccupancyMaxActiveClusters) into *n; 0 means the launch is refused
extern "C" int apex_fused_sample_clusters(int dtype, int V, int splits,
                                          int threads, int values, int share,
                                          int* n) {
  if (apex::sample::bad_plan(dtype, V, splits, threads, values, share,
                             true))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? max_clusters<__nv_bfloat16>(splits, threads, values, n)
          : max_clusters<float>(splits, threads, values, n);
  return static_cast<int>(err);
}
