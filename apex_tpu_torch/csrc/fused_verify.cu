// Speculative decoding's verify tail: target logit rows + drafted tokens ->
// (accepted length, [winning node,] next token), one kernel per call, for
// Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/verify.py::fused_verify_fwd (:262-301;
// kernel body _verify_kernel :245-259) and ::fused_verify_tree_fwd
// (:326-370; _verify_tree_kernel :304-323), written from the reference's
// helpers (row_argmax, verify_greedy, verify_sampled, tree_accepted_path,
// verify_tree_greedy, verify_tree_sampled :66-242):
// * both kernels are one body over a draft tree. Node 0 is the committed
//   pending token; node c >= 1 is a drafted token whose target
//   distribution is logit row parent(c). The chain is the one-branch tree:
//   node c = draft c - 1, parent c - 1, so row i verifies draft i and the
//   bonus row k has no child. The tree reads tokens, parents and the
//   ancestor-or-self closure anc from its operands.
// * greedy: cand[r] = argmax of row r in fp32 (ties to the lowest index);
//   node c is accepted iff cand[parent(c)] == token[c].
// * sampled: row r is scaled and filtered (temperature, top-k) by the
//   sampler's own device code (sample_filter.cuh) with its top-p off, as
//   DecodeEngine has no top-p. Node c is accepted
//   iff u_acc < exp(s[token] - m) / sum(exp(s - m)) over its parent's row
//   (a filtered token has p = 0 and is always rejected); row r's
//   correction candidate is the Gumbel-argmax of its row with EVERY real
//   drafted child's token filtered (verify.py:235-241), on u_gum's row r.
// * the winner is the deepest node whose whole root path is accepted, ties
//   to the lowest node (verify.py:156-159); the next token is the winner
//   row's candidate. NO_DRAFT (-1) never equals a token, so a padded node
//   is never accepted.
// * one CTA of 1024 threads per batch row walks the N1 rows in turn (each
//   a block-wide pass over V), then thread 0 resolves the tree from N1
//   per-node values held in shared memory.
//
// Bound on this card: bytes. The logits (and, sampled, the Gumbel noise)
// are read once: at the slice's (1, 9, 32768) bf16 that is 0.6 MB greedy,
// 1.8 MB sampled: 0.18-0.53 us at 3.35 TB/s, below a launch's own cost.
// Greedy is one reduction per row; sampled mode runs the sampler's 96
// dependent block-wide bisection reductions per row, in turn, on one SM:
// spreading the rows over CTAs (a grid of (b, N1) and a last-CTA combine)
// is the obvious next step.
#include <cstdint>

#include "sample_filter.cuh"

namespace {

using apex::filter::kFiltered;
using apex::filter::kThreads;
using apex::filter::kWarps;

constexpr int kMaxNodes = 128;
constexpr int kNoDraft = -1;

template <typename T, bool kTree>
__global__ void __launch_bounds__(kThreads)
    verify_kernel(const T* __restrict__ logits, const int* __restrict__ toks,
                  const int* __restrict__ parents, const int* __restrict__ anc,
                  const float* __restrict__ u_acc,
                  const float* __restrict__ u_gum, int* __restrict__ a_out,
                  int* __restrict__ j_out, int* __restrict__ next_out, int n1,
                  int V, int sampled, float inv_temp, int top_k) {
  extern __shared__ float s[];  // one filtered row (sampled mode)
  __shared__ float red[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int tok[kMaxNodes], par[kMaxNodes], cand[kMaxNodes];
  __shared__ float ratio[kMaxNodes];  // p(token[c]) under its parent's row
  const int bi = blockIdx.x;

  for (int c = threadIdx.x; c < n1; c += kThreads) {
    if (kTree) {
      tok[c] = c == 0 ? kNoDraft : toks[static_cast<size_t>(bi) * n1 + c];
      par[c] = c == 0 ? 0 : parents[static_cast<size_t>(bi) * n1 + c];
    } else {  // toks = drafted (b, k+1), bonus entry NO_DRAFT
      tok[c] = c == 0 ? kNoDraft : toks[static_cast<size_t>(bi) * n1 + c - 1];
      par[c] = c == 0 ? 0 : c - 1;
    }
    ratio[c] = 0.f;
  }
  __syncthreads();

  for (int r = 0; r < n1; ++r) {
    const size_t row = (static_cast<size_t>(bi) * n1 + r) * V;
    if (!sampled) {
      float best = -INFINITY;
      int best_i = V;
      for (int i = threadIdx.x; i < V; i += kThreads) {
        const float x = apex::to_float(logits[row + i]);
        if (x > best) {
          best = x;
          best_i = i;
        }
      }
      const int am = apex::filter::block_argmax(best, best_i, red, red_i);
      if (threadIdx.x == 0) cand[r] = am;
      continue;
    }
    apex::filter::load_filtered(s, logits + row, V, inv_temp, top_k,
                                /*use_top_p=*/0, 1.f, red);
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < V; i += kThreads) mx = fmaxf(mx, s[i]);
    const float m = apex::filter::block_max(mx, red);
    float z = 0.f;
    for (int i = threadIdx.x; i < V; i += kThreads) z += expf(s[i] - m);
    z = apex::filter::block_sum(z, red);
    if (threadIdx.x == 0) {
      // every child's acceptance mass first, then filter the children out
      for (int c = 1; c < n1; ++c) {
        const int t = tok[c];
        if (par[c] == r && t >= 0 && t < V) ratio[c] = expf(s[t] - m) / z;
      }
      for (int c = 1; c < n1; ++c) {
        const int t = tok[c];
        if (par[c] == r && t >= 0 && t < V) s[t] = kFiltered;
      }
    }
    __syncthreads();
    const int draw = apex::filter::gumbel_argmax(s, u_gum + row, V, red,
                                                 red_i);
    if (threadIdx.x == 0) cand[r] = draw;
    __syncthreads();  // s is reloaded for the next row
  }

  if (threadIdx.x != 0) return;
  bool acc[kMaxNodes];
  acc[0] = true;  // the pending token is committed
  for (int c = 1; c < n1; ++c) {
    const int t = tok[c];
    if (t == kNoDraft) {
      acc[c] = false;
    } else if (sampled) {
      acc[c] = u_acc[static_cast<size_t>(bi) * n1 + (kTree ? c : c - 1)] <
               ratio[c];
    } else {
      acc[c] = cand[par[c]] == t;
    }
  }
  int best_depth = -1, winner = n1;
  for (int i = 0; i < n1; ++i) {
    bool ok = true;
    int depth = -1;
    if (kTree) {
      const int* arow = anc + (static_cast<size_t>(bi) * n1 + i) * n1;
      for (int j = 0; j < n1; ++j) {
        if (arow[j] != 0) {
          ++depth;
          ok = ok && acc[j];
        }
      }
    } else {  // the chain: node i's root path is nodes 0..i
      depth = i;
      for (int j = 0; j <= i; ++j) ok = ok && acc[j];
    }
    if (ok && depth > best_depth) {  // strict: ties keep the lowest node
      best_depth = depth;
      winner = i;
    }
  }
  a_out[bi] = best_depth;
  if (kTree) j_out[bi] = winner;
  next_out[bi] = cand[winner];
}

template <typename T, bool kTree>
cudaError_t launch(const void* logits, const void* toks, const void* parents,
                   const void* anc, const void* u_acc, const void* u_gum,
                   void* a_out, void* j_out, void* next_out, int b, int n1,
                   int V, int sampled, float inv_temp, int top_k,
                   cudaStream_t stream) {
  const size_t smem = sampled ? static_cast<size_t>(V) * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      verify_kernel<T, kTree>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  verify_kernel<T, kTree><<<b, kThreads, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(toks),
      static_cast<const int*>(parents), static_cast<const int*>(anc),
      static_cast<const float*>(u_acc), static_cast<const float*>(u_gum),
      static_cast<int*>(a_out), static_cast<int*>(j_out),
      static_cast<int*>(next_out), n1, V, sampled, inv_temp, top_k);
  return cudaGetLastError();
}

template <bool kTree>
int run(const void* logits, const void* toks, const void* parents,
        const void* anc, const void* u_acc, const void* u_gum, void* a_out,
        void* j_out, void* next_out, int dtype, int b, int n1, int V,
        int sampled, float inv_temp, int top_k, void* stream) {
  if (b < 1 || n1 < 2 || n1 > kMaxNodes || V < 1 ||
      (sampled && V > 49152) ||
      (dtype != apex::kFloat32 && dtype != apex::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? launch<__nv_bfloat16, kTree>(logits, toks, parents, anc, u_acc,
                                         u_gum, a_out, j_out, next_out, b, n1,
                                         V, sampled, inv_temp, top_k, st)
          : launch<float, kTree>(logits, toks, parents, anc, u_acc, u_gum,
                                 a_out, j_out, next_out, b, n1, V, sampled,
                                 inv_temp, top_k, st);
  return static_cast<int>(err);
}

}  // namespace

// logits (b, k+1, V); drafted (b, k+1) int32 with the bonus entry NO_DRAFT;
// u_acc (b, k+1) and u_gum (b, k+1, V) fp32, read only when sampled
extern "C" int apex_fused_verify(const void* logits, const void* drafted,
                                 const void* u_acc, const void* u_gum,
                                 void* a_out, void* next_out, int dtype,
                                 int b, int k1, int V, int sampled,
                                 float inv_temp, int top_k, void* stream) {
  return run<false>(logits, drafted, nullptr, nullptr, u_acc, u_gum, a_out,
                    nullptr, next_out, dtype, b, k1, V, sampled, inv_temp,
                    top_k, stream);
}

// logits (b, N1, V); tokens, parents (b, N1) and anc (b, N1, N1) int32;
// u_acc (b, N1) and u_gum (b, N1, V) fp32, read only when sampled
extern "C" int apex_fused_verify_tree(const void* logits, const void* tokens,
                                      const void* parents, const void* anc,
                                      const void* u_acc, const void* u_gum,
                                      void* a_out, void* j_out,
                                      void* next_out, int dtype, int b,
                                      int n1, int V, int sampled,
                                      float inv_temp, int top_k,
                                      void* stream) {
  return run<true>(logits, tokens, parents, anc, u_acc, u_gum, a_out, j_out,
                   next_out, dtype, b, n1, V, sampled, inv_temp, top_k,
                   stream);
}
