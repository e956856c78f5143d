// LayerNorm and RMSNorm past hidden 4096, forward and backward, for Hopper
// (sm_90a).
//
// Replaces apex_tpu/ops/pallas/layer_norm.py::ln_fwd (:102) and ::ln_bwd
// (:186) at the hidden sizes layer_norm.cu does not take: 4097 to 65536
// (FastLayerNorm's range, and the widest row the reference measured). The
// contract is layer_norm.cu's: fp32 arithmetic; the forward writes y in x's
// dtype and the per-row fp32 mean and rstd, two-pass (the mean, then the
// mean of (x - mean)^2); the backward reads them back and writes dx, and
// dgamma/dbeta summed in an order fixed by the row count and the hidden
// size alone. Parameters fp32 or bf16 with fp32 or bf16 x, fp32 or fp16
// with fp16 x; the affine (none, gamma, gamma and beta) a template option.
//
// Bound on this card: bytes. A forward row at 8192 in bf16 is 16 KB read
// and 16 KB written; ten fp32 operations an element are far below the
// card's rate. What is hard is that a row no longer fits one warp group's
// registers, and the widest rows (65536: 128 KB in bf16, 256 KB in fp32;
// the backward's x and dy together 256 KB in bf16) not one CTA's 227 KB
// of shared memory.
//
// Design: a thread holds 16 elements of a row (two 16-byte chunks of a
// 16-bit row, four of an fp32 row), a CTA at most 16 warps of them (8192
// elements), and a row takes a thread-block cluster of R CTAs, R = ceil(
// hidden / 8192) or more (at most 8; the host's plan raises R where few
// rows would leave SMs idle). The row stays in registers as raw 16-byte
// chunks, read from device memory once; each sum crosses the row in a
// fixed order: a warp's lanes by xor shuffles (every lane the same bits),
// the CTA's warps in warp order through shared memory, then the cluster's
// ranks in rank order through distributed shared memory (each CTA pushes
// its sum into a slot of every peer by st.async, counted on the peer's
// mbarrier, and adds the slots in rank order once its own mbarrier's
// phase completes). Slots alternate by parity. A cluster walks every
// clusters-th row with the next row's chunks in flight (the fp32
// backward, whose chunks fill the registers, without); no release fence
// in the merge waits for those loads (a cluster barrier's release did,
// and held the widest rows at 7-8 us a row on an H100).
//
// A hidden that is no multiple of the chunk, or an unaligned tensor, moves
// element by element: thread j of the row's G threads takes the elements
// (c * V + k) * G + j (coalesced), packed into the same raw chunks.
//
// dgamma/dbeta without atomics: the plan fixes P partial rows from the row
// count and hidden size (never the card); cluster p owns rows p, p + P,
// ..., each thread sums its columns over them in registers and writes
// them into row p of a (P, 2, hidden) fp32 buffer; a second launch sums
// the P rows of every column in order. P is at most rows / 32 (at least
// 1), so the buffer stays within a twelfth of the call's bytes.
//
// Planted faults (fault 1: the row's last 16-byte chunk left out of the
// statistics; fault 2: the last rank's partial, or with one rank the last
// warp's, not merged) exist so that chip_smoke.py shows its checks refuse
// them; 0 computes the function.
#include <cstdint>
#include <type_traits>

#include "apex_cuda.cuh"
#include "apex_sm90.cuh"
#include "row_io.cuh"

namespace {

namespace sm90 = apex::sm90;

constexpr int kMaxHidden = 65536;
constexpr int kElems = 16;     // elements of a row a thread holds
constexpr int kMaxWarps = 16;  // warps a CTA
constexpr int kMaxRanks = 8;   // CTAs a cluster (the portable size)
constexpr int kRedRows = 16;   // partial rows summed a column, in parallel

enum Affine : int { kNone = 0, kWeight = 1, kWeightBias = 2 };
enum Fault : int { kNoFault = 0, kDropTail = 1, kDropRank = 2 };

template <typename T>
using HalfParam = typename std::conditional<std::is_same<T, __half>::value,
                                            __half, __nv_bfloat16>::type;

template <typename P>
__device__ __forceinline__ float load_param(const void* p, bool w_half,
                                            int i, int n) {
  if (i >= n) return 0.f;
  return w_half ? apex::to_float(static_cast<const P*>(p)[i])
                : static_cast<const float*>(p)[i];
}

template <typename P>
__device__ __forceinline__ void store_param(void* p, bool w_half, int i,
                                            float v) {
  if (w_half)
    static_cast<P*>(p)[i] = apex::from_float<P>(v);
  else
    static_cast<float*>(p)[i] = v;
}

// the cluster barrier with release and acquire: what every thread of the
// cluster wrote to shared memory before it is seen after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// 8 bytes into another CTA's shared memory (an address of cluster_map),
// counted as complete_tx bytes on that CTA's mbarrier: no fence, so the
// storing thread waits for none of its own loads in flight
__device__ __forceinline__ void st_async_f2(uint32_t addr, float x, float y,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "f"(x), "f"(y), "r"(bar)
      : "memory");
}

// The row's thread layout: G threads over R ranks, thread gj of the row
// (rank * blockDim + threadIdx) holding C chunks of V elements.
struct RowLayout {
  int n, G, gj, rank, ranks, warps, warp, lane;
  bool vec;
  // element k of the thread's chunk c
  __device__ __forceinline__ int index(int c, int k, int V) const {
    return vec ? (c * G + gj) * V + k : (c * V + k) * G + gj;
  }
};

// The row's two sums (a, b) over every thread of the cluster, in a fixed
// order: lanes by xor shuffles, warps in order, ranks in order. A CTA's
// sum crosses the cluster by st.async into slot [rank] of every peer,
// counted on the peer's mbarrier, which each CTA waits on before adding
// the slots in rank order (its own sum in its own place): no release
// fence, so the next row's loads stay in flight through the merge (a
// cluster barrier's release waited for them). Slots and mbarriers
// alternate by `phase` parity: a CTA sends merge m + 2 only after every
// peer's merge m + 1 sum reached it, which each peer sent after reading
// its merge m slots; warps likewise by the CTA barrier of the merge
// between.
struct Merger {
  float2* red;     // [2][kMaxWarps] the CTA's warps' sums
  float2* slots;   // [2][kMaxRanks] the ranks' sums, pushed by each rank
  uint64_t* bars;  // [2] mbarriers: the peers' sums of a merge arrived
  int phase;
  int fault;

  __device__ __forceinline__ float2 operator()(const RowLayout& L, float a,
                                               float b) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    float2* slot = red + (phase & 1) * kMaxWarps;
    if (L.lane == 0) slot[L.warp] = make_float2(a, b);
    __syncthreads();
    const int wn =
        fault == kDropRank && L.ranks == 1 ? L.warps - 1 : L.warps;
    a = 0.f;
    b = 0.f;
    for (int w = 0; w < wn; ++w) {
      const float2 p = slot[w];
      a += p.x;
      b += p.y;
    }
    if (L.ranks > 1) {
      float2* slot = slots + (phase & 1) * kMaxRanks;
      const uint32_t bar = sm90::smem_u32(bars + (phase & 1));
      if (threadIdx.x == 0)
        sm90::mbar_expect_tx(bar, (L.ranks - 1) * sizeof(float2));
      if (L.warp == 0 && L.lane < L.ranks && L.lane != L.rank)
        st_async_f2(sm90::cluster_map(sm90::smem_u32(slot + L.rank), L.lane),
                    a, b, sm90::cluster_map(bar, L.lane));
      sm90::mbar_wait(bar, (phase >> 1) & 1);
      const float2 mine = make_float2(a, b);
      const int rn = fault == kDropRank ? L.ranks - 1 : L.ranks;
      a = 0.f;
      b = 0.f;
      for (int r = 0; r < rn; ++r) {
        const float2 p = r == L.rank ? mine : slot[r];
        a += p.x;
        b += p.y;
      }
    }
    ++phase;
    return make_float2(a, b);
  }
};

// the thread's C chunks of row `row` as raw 16-byte chunks: 16-byte loads
// (vec) or the layout's elements one by one; zeros past the row
template <typename T, int C>
__device__ __forceinline__ void fetch_row(const T* __restrict__ base,
                                          int row, const RowLayout& L,
                                          uint4 (&dst)[C]) {
  constexpr int V = apex::Chunk<T>::kVec;
  const T* r = base + static_cast<size_t>(row) * L.n;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (L.vec) {
      const int i0 = L.index(c, 0, V);
      dst[c] = i0 < L.n ? *reinterpret_cast<const uint4*>(r + i0)
                        : make_uint4(0u, 0u, 0u, 0u);
    } else {
      T* e = reinterpret_cast<T*>(&dst[c]);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = L.index(c, k, V);
        e[k] = i < L.n ? r[i] : apex::from_float<T>(0.f);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_elems(T* __restrict__ r, int c,
                                            const RowLayout& L,
                                            const float* v) {
  constexpr int V = apex::Chunk<T>::kVec;
  if (L.vec) {
    const int i0 = L.index(c, 0, V);
    if (i0 < L.n) apex::store_chunk(r, i0, L.n, true, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int i = L.index(c, k, V);
      if (i < L.n) r[i] = apex::from_float<T>(v[k]);
    }
  }
}

// the parameters of the thread's elements in fp32, 0 past the row
template <typename T, int C>
__device__ __forceinline__ void load_params(const void* __restrict__ p,
                                            bool w_half, const RowLayout& L,
                                            float* out) {
  constexpr int V = apex::Chunk<T>::kVec;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < V; ++k)
      out[c * V + k] =
          load_param<HalfParam<T>>(p, w_half, L.index(c, k, V), L.n);
}

// the merge's mbarriers, one arrival (the CTA's expect_tx) a phase, set up
// before any peer may send: a cluster barrier after the initialisation
__device__ __forceinline__ void init_merge(uint64_t* bars, int ranks) {
  if (ranks == 1) return;
  if (threadIdx.x == 0) {
    sm90::mbar_init(sm90::smem_u32(bars), 1);
    sm90::mbar_init(sm90::smem_u32(bars + 1), 1);
    sm90::fence_barrier_init();
  }
  cluster_sync();
}

__device__ __forceinline__ RowLayout row_layout(int n, int ranks, bool vec) {
  RowLayout L;
  L.n = n;
  L.ranks = ranks;
  L.rank = ranks > 1 ? static_cast<int>(sm90::cluster_ctarank()) : 0;
  L.warps = blockDim.x >> 5;
  L.G = ranks * blockDim.x;
  L.gj = L.rank * blockDim.x + threadIdx.x;
  L.warp = threadIdx.x >> 5;
  L.lane = threadIdx.x & 31;
  L.vec = vec;
  return L;
}

// --- the forward ------------------------------------------------------------

template <typename T, int kAff>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    ln_fwd_wide_kernel(const T* __restrict__ x, const void* __restrict__ w,
                       const void* __restrict__ b, T* __restrict__ y,
                       float* __restrict__ mean_out,
                       float* __restrict__ rstd_out, int rows, int n,
                       int ranks, float eps, bool rms, bool vec, bool w_half,
                       int fault) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = kElems / V;
  __shared__ float2 red[2 * kMaxWarps];
  __shared__ float2 slots[2 * kMaxRanks];
  __shared__ uint64_t bars[2];
  const RowLayout L = row_layout(n, ranks, vec);
  init_merge(bars, ranks);
  Merger merge{red, slots, bars, 0, fault};
  const int cluster = blockIdx.x / ranks;
  const int clusters = gridDim.x / ranks;
  const int count =
      cluster < rows ? (rows - cluster + clusters - 1) / clusters : 0;
  // the elements the statistics take: all but, under the planted fault,
  // the row's last 16-byte chunk
  const int tail = fault == kDropTail ? ((n - 1) / V) * V : n;
  const float nf = static_cast<float>(n);

  uint4 raw[C];
  if (count > 0) fetch_row<T, C>(x, cluster, L, raw);
  float g[kAff >= kWeight ? kElems : 1];
  float be[kAff == kWeightBias ? kElems : 1];
  if constexpr (kAff >= kWeight) load_params<T, C>(w, w_half, L, g);
  if constexpr (kAff == kWeightBias) load_params<T, C>(b, w_half, L, be);

  for (int it = 0; it < count; ++it) {
    const int row = cluster + it * clusters;
    float v[kElems];
#pragma unroll
    for (int c = 0; c < C; ++c) apex::unpack_chunk<T>(raw[c], v + c * V);
    if (it + 1 < count) fetch_row<T, C>(x, row + clusters, L, raw);
    float mu = 0.f;
    if (!rms) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (L.index(c, k, V) < tail) t += v[c * V + k];
      mu = merge(L, t, 0.f).x / nf;
    }
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = L.index(c, k, V);
        const float d = i < n ? v[c * V + k] - mu : 0.f;
        v[c * V + k] = d;
        if (i < tail) ss = fmaf(d, d, ss);
      }
    const float rstd = rsqrtf(merge(L, ss, 0.f).x / nf + eps);
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      float o = v[e] * rstd;
      if constexpr (kAff >= kWeight) o *= g[e];
      if constexpr (kAff == kWeightBias) o += be[e];
      v[e] = o;
    }
    T* yr = y + static_cast<size_t>(row) * n;
#pragma unroll
    for (int c = 0; c < C; ++c) store_elems<T>(yr, c, L, v + c * V);
    if (L.gj == 0) {
      mean_out[row] = mu;
      rstd_out[row] = rstd;
    }
  }
  // no CTA leaves while a peer's store into its shared memory may be in
  // flight
  if (ranks > 1) cluster_sync();
}

// --- the backward -----------------------------------------------------------

// dx per row; with kW the cluster's partial row of (dgamma, dbeta). kPre:
// the next row's chunks in flight (the 16-bit types; an fp32 row's chunks
// and the parameter sums fill the registers without)
template <typename T, bool kW, bool kPre>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    ln_bwd_wide_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const void* __restrict__ w, T* __restrict__ dx,
                       float* __restrict__ part, int rows, int n, int ranks,
                       bool rms, bool vec, bool w_half, int fault) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = kElems / V;
  __shared__ float2 red[2 * kMaxWarps];
  __shared__ float2 slots[2 * kMaxRanks];
  __shared__ uint64_t bars[2];
  const RowLayout L = row_layout(n, ranks, vec);
  init_merge(bars, ranks);
  Merger merge{red, slots, bars, 0, fault};
  // cluster p of P owns rows p, p + P, ...: a function of the plan alone
  const int p = blockIdx.x / ranks;
  const int parts = gridDim.x / ranks;
  const int count = p < rows ? (rows - p + parts - 1) / parts : 0;
  const int tail = fault == kDropTail ? ((n - 1) / V) * V : n;
  const float inv_n = 1.f / static_cast<float>(n);

  float g[kW ? kElems : 1], dg[kW ? kElems : 1], db[kW ? kElems : 1];
  if constexpr (kW) {
    load_params<T, C>(w, w_half, L, g);
#pragma unroll
    for (int e = 0; e < kElems; ++e) dg[e] = db[e] = 0.f;
  }
  uint4 rx[C], rd[C], nx[kPre ? C : 1], nd[kPre ? C : 1];
  if constexpr (kPre) {
    if (count > 0) {
      fetch_row<T, C>(x, p, L, nx);
      fetch_row<T, C>(dy, p, L, nd);
    }
  }
  for (int it = 0; it < count; ++it) {
    const int row = p + it * parts;
    if constexpr (kPre) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        rx[c] = nx[c];
        rd[c] = nd[c];
      }
      if (it + 1 < count) {
        fetch_row<T, C>(x, row + parts, L, nx);
        fetch_row<T, C>(dy, row + parts, L, nd);
      }
    } else {
      fetch_row<T, C>(x, row, L, rx);
      fetch_row<T, C>(dy, row, L, rd);
    }
    const float mu = mean[row];
    const float rs = rstd[row];
    const float shift = rms ? 0.f : -mu * rs;
    // first pass: the two sums (and the parameter sums); elements past the
    // row load as 0, so their d is 0 and they add nothing
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float xv[V], dv[V];
      apex::unpack_chunk<T>(rx[c], xv);
      apex::unpack_chunk<T>(rd[c], dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = fmaf(xv[k], rs, shift);
        float d = dv[k];
        if constexpr (kW) {
          dg[c * V + k] = fmaf(d, xh, dg[c * V + k]);
          db[c * V + k] += d;
          d *= g[c * V + k];
        }
        if (L.index(c, k, V) < tail) {
          s1 += d;
          s2 = fmaf(d, xh, s2);
        }
      }
    }
    const float2 s = merge(L, s1, s2);
    const float c1 = rms ? 0.f : s.x * inv_n;
    const float c2 = s.y * inv_n;
    // second pass: dx from the chunks again
    T* dxr = dx + static_cast<size_t>(row) * n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float xv[V], dv[V];
      apex::unpack_chunk<T>(rx[c], xv);
      apex::unpack_chunk<T>(rd[c], dv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = fmaf(xv[k], rs, shift);
        float d = dv[k];
        if constexpr (kW) d *= g[c * V + k];
        xv[k] = (d - c1 - xh * c2) * rs;
      }
      store_elems<T>(dxr, c, L, xv);
    }
  }
  if constexpr (kW) {
    float* pr = part + static_cast<size_t>(p) * 2 * n;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = L.index(c, k, V);
        if (i < n) {
          pr[i] = dg[c * V + k];
          pr[n + i] = db[c * V + k];
        }
      }
  }
  if (ranks > 1) cluster_sync();
}

// dgamma (blockIdx.y 0) or dbeta (1) of 32 columns: thread row ty sums the
// partial rows ty, ty + kRedRows, ... in order, then the kRedRows sums are
// added in order
template <typename P>
__global__ void __launch_bounds__(32 * kRedRows)
    ln_bwd_wide_reduce_kernel(const float* __restrict__ part, void* dw,
                              void* db, int parts, int n, bool w_half) {
  __shared__ float s[kRedRows][33];
  void* out = blockIdx.y ? db : dw;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  float a = 0.f;
  if (col < n) {
    const float* q = part + static_cast<size_t>(blockIdx.y) * n + col;
#pragma unroll 4
    for (int r = ty; r < parts; r += kRedRows)
      a += q[static_cast<size_t>(r) * 2 * n];
  }
  s[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && col < n) {
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kRedRows; ++r) t += s[r][tx];
    store_param<P>(out, w_half, col, t);
  }
}

// --- launches -----------------------------------------------------------------

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ctas CTAs of `threads` in clusters of (ranks, 1, 1)
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kern)(Exp...), int ctas, int threads, int ranks,
                   cudaStream_t st, Act... args) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, static_cast<Exp>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t fwd_t(const void* x, const void* w, const void* b, void* y,
                  void* mean, void* rstd, int affine, bool rms, int rows,
                  int n, float eps, int warps, int ranks, int clusters,
                  bool w_half, int fault, cudaStream_t st) {
  const bool vec = n % apex::Chunk<T>::kVec == 0 && aligned(x) &&
                   aligned(y);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  const int ctas = clusters * ranks, threads = warps * 32;
  if (affine == kWeightBias)
    return launch(ln_fwd_wide_kernel<T, kWeightBias>, ctas, threads, ranks,
                  st, xp, w, b, yp, mp, rp, rows, n, ranks, eps, rms, vec,
                  w_half, fault);
  if (affine == kWeight)
    return launch(ln_fwd_wide_kernel<T, kWeight>, ctas, threads, ranks, st,
                  xp, w, b, yp, mp, rp, rows, n, ranks, eps, rms, vec,
                  w_half, fault);
  return launch(ln_fwd_wide_kernel<T, kNone>, ctas, threads, ranks, st, xp,
                w, b, yp, mp, rp, rows, n, ranks, eps, rms, vec, w_half,
                fault);
}

template <typename T>
cudaError_t bwd_t(const void* dy, const void* x, const void* mean,
                  const void* rstd, const void* w, void* dx, void* part,
                  void* dw, void* db, bool rms, int rows, int n, int warps,
                  int ranks, int parts, bool w_half, int fault,
                  cudaStream_t st) {
  constexpr bool kPre = sizeof(T) == 2;
  const bool vec = n % apex::Chunk<T>::kVec == 0 && aligned(dy) &&
                   aligned(x) && aligned(dx);
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  const int ctas = parts * ranks, threads = warps * 32;
  if (w == nullptr)
    return launch(ln_bwd_wide_kernel<T, false, kPre>, ctas, threads, ranks,
                  st, dyp, xp, mp, rp, w, dxp, pp, rows, n, ranks, rms, vec,
                  w_half, fault);
  const cudaError_t err =
      launch(ln_bwd_wide_kernel<T, true, kPre>, ctas, threads, ranks, st,
             dyp, xp, mp, rp, w, dxp, pp, rows, n, ranks, rms, vec, w_half,
             fault);
  if (err != cudaSuccess) return err;
  ln_bwd_wide_reduce_kernel<HalfParam<T>>
      <<<dim3((n + 31) / 32, db != nullptr ? 2 : 1), 32 * kRedRows, 0,
         st>>>(pp, dw, db, parts, n, w_half);
  return cudaGetLastError();
}

bool dtype_ok(int dtype) {
  return dtype == apex::kFloat32 || dtype == apex::kBFloat16 ||
         dtype == apex::kFloat16;
}

bool param_ok(int dtype, int w_dtype) {
  return w_dtype == apex::kFloat32 ||
         w_dtype == (dtype == apex::kFloat16 ? apex::kFloat16
                                             : apex::kBFloat16);
}

// whether the plan's row shape covers a row of n and fits the kernels
bool shape_ok(int n, int warps, int ranks) {
  return n >= 1 && n <= kMaxHidden && warps >= 1 && warps <= kMaxWarps &&
         ranks >= 1 && ranks <= kMaxRanks &&
         ranks * warps * 32 * kElems >= n;
}

}  // namespace

// x, y (rows, n) of dtype; w, b (n,) of w_dtype (param_ok) or null by
// `affine`; mean, rstd (rows,) fp32. warps, ranks, clusters: the host's
// plan (ops/layer_norm.py::_wide_fwd_plan); fault: 0, or a planted fault
extern "C" int apex_ln_fwd_wide(const void* x, const void* w, const void* b,
                                void* y, void* mean, void* rstd, int dtype,
                                int w_dtype, int affine, int rms, int rows,
                                int n, float eps, int warps, int ranks,
                                int clusters, int fault, void* stream) {
  if (!dtype_ok(dtype) || !param_ok(dtype, w_dtype) || rows < 1 ||
      !shape_ok(n, warps, ranks) || clusters < 1 || affine < kNone ||
      affine > kWeightBias || (affine >= kWeight && w == nullptr) ||
      (affine == kWeightBias && b == nullptr) || fault < kNoFault ||
      fault > kDropRank)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_half = w_dtype != apex::kFloat32;
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? fwd_t<__nv_bfloat16>(x, w, b, y, mean, rstd, affine, rms != 0,
                                 rows, n, eps, warps, ranks, clusters, w_half,
                                 fault, st)
      : dtype == apex::kFloat16
          ? fwd_t<__half>(x, w, b, y, mean, rstd, affine, rms != 0, rows, n,
                          eps, warps, ranks, clusters, w_half, fault, st)
          : fwd_t<float>(x, w, b, y, mean, rstd, affine, rms != 0, rows, n,
                         eps, warps, ranks, clusters, w_half, fault, st);
  return static_cast<int>(err);
}

// dy, x, dx (rows, n) of dtype; mean, rstd (rows,) fp32; w (n,) or null.
// With w: part (parts, 2, n) fp32 scratch, dw (n,) and db (n,) or null in
// w's dtype. warps, ranks, parts: the host's plan
// (ops/layer_norm.py::_wide_bwd_plan); fault: 0, or a planted fault
extern "C" int apex_ln_bwd_wide(const void* dy, const void* x,
                                const void* mean, const void* rstd,
                                const void* w, void* dx, void* part, void* dw,
                                void* db, int dtype, int w_dtype, int rms,
                                int rows, int n, int warps, int ranks,
                                int parts, int fault, void* stream) {
  if (!dtype_ok(dtype) || !param_ok(dtype, w_dtype) || rows < 1 ||
      !shape_ok(n, warps, ranks) || parts < 1 ||
      (w != nullptr && (part == nullptr || dw == nullptr)) ||
      fault < kNoFault || fault > kDropRank)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_half = w_dtype != apex::kFloat32;
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? bwd_t<__nv_bfloat16>(dy, x, mean, rstd, w, dx, part, dw, db,
                                 rms != 0, rows, n, warps, ranks, parts,
                                 w_half, fault, st)
      : dtype == apex::kFloat16
          ? bwd_t<__half>(dy, x, mean, rstd, w, dx, part, dw, db, rms != 0,
                          rows, n, warps, ranks, parts, w_half, fault, st)
          : bwd_t<float>(dy, x, mean, rstd, w, dx, part, dw, db, rms != 0,
                         rows, n, warps, ranks, parts, w_half, fault, st);
  return static_cast<int>(err);
}
