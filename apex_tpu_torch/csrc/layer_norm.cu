// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/layer_norm.py::ln_fwd (:102; body
// _ln_fwd_kernel :42) and ::ln_bwd (:186; body _ln_bwd_kernel :123). Same
// contract: rows of (rows, hidden) x in fp32 arithmetic; the forward writes
// y in x's dtype and the per-row fp32 mean and rstd, the backward reads
// them back instead of reducing again. Statistics are two-pass from
// registers: the mean, then the mean of (x - mean)^2 (never E[x^2] -
// mean^2). RMSNorm writes mean 0 and skips the centring. The affine
// (gamma, or gamma and beta) is a compile-time option; the parameters may
// be fp32 or bf16 with fp32 or bf16 x, fp32 or fp16 with fp16 x. The fp16
// instances (amp's strict-fp16 step under O2 and O3) are the bf16 ones
// with fp16 loads and round-to-nearest stores: an overflow reaches dx, or
// dgamma/dbeta, as inf.
//
// Entries: apex_ln_fwd and apex_ln_bwd (the backward is two launches: the
// row kernel, then the parameter reduction).
//
// Bound on this card at the GPT train step (20480 rows x 1024, bf16):
// bytes. The forward reads x once and writes y (84 MB, 0.025 ms at 3.35
// TB/s); the backward reads dy and x and writes dx (126 MB, 0.038 ms).
// About ten fp32 operations per element are far below the card's rate.
// What keeps the backward from the bound is latency: every row's two sums
// cross the warps holding it before its dx can be written, so it needs
// many warps an SM as well as rows in flight.
//
// Forward: a row is spread over a group of W warps with the backward's
// shape (C chunks a thread, at most 16 elements; W from the hidden size),
// so a thread holds one or two 16-byte chunks of a row (1024 in bf16: 4
// warps of one chunk). The host's plan (ops/layer_norm.py::_fwd_plan)
// picks the groups a CTA and the grid from the rows and the SM count: at
// the serve and decode legs' few rows one row a group and one group a
// CTA, the rows over as many SMs as there are rows, so a call pays one
// memory latency (the row's chunks and gamma/beta as 16-byte vectors, in
// one batch of loads); at the train legs' many rows a grid of resident
// CTAs whose groups walk their rows with the next D - 1 rows' chunks
// already in flight in registers while they reduce the current one
// (D = fwd_depth(C)), gamma and beta held in registers across rows. The
// row's two sums cross the group's warps through shared memory at the
// group's own named barrier, added in warp order, so y, mean and rstd are
// the same bits on every run. A hidden that is no multiple of the chunk
// (or an unaligned tensor) loads element by element, without the
// registers in flight.
//
// Backward: a row is spread over a group of W warps, so a thread holds at
// most 16 elements of it (C chunks, W from {1, 2, 3, 4, 6, 8} by the
// hidden size: 768 in bf16 is 3 warps of one chunk a lane, no idle lane;
// 1024 is 4; 4096 is 8 warps of two chunks). A CTA holds as many groups as
// fit in 16 warps at one chunk a thread (64 registers, two CTAs an SM: 32
// warps to hide the row's reduction latency) or 8 warps at more. Each
// group keeps S - 1 rows of x, dy, mean and rstd in flight ahead of the
// row it reduces: every thread copies its own chunks into a ring of S
// shared-memory stages with cp.async and reads them back after its own
// wait, so no barrier guards the ring. The row's two sums (sum d, sum d *
// xhat) cross the group's warps through shared memory at the group's own
// named barrier, added in warp order. A hidden that is no multiple of the
// chunk loads element by element, without the ring.
//
// dgamma/dbeta without atomics, bit-reproducible: with nb CTAs, CTA c owns
// the fixed rows c, c + nb, ..., rows_per_cta of them (ops/layer_norm.py
// picks the count from the row count alone; the stride makes the CTAs
// stream one contiguous window of rows together), its groups take those
// rows interleaved and keep fp32 partials of their columns in registers; the
// groups' partials are added in group order through shared memory into
// one (2, hidden) row of the partial buffer; a second launch sums the
// buffer's rows in a fixed order per column and casts to the parameters'
// dtype. The order depends on the row count and the hidden size alone,
// never on the card. The TPU kernel's revisited output block (a sum
// carried along a sequential grid) does not carry over to a card whose
// CTAs run in no order.
#include <cstdint>
#include <type_traits>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"
#include "row_io.cuh"

namespace {

constexpr int kMaxHidden = 32 * 128;

enum Affine : int { kNone = 0, kWeight = 1, kWeightBias = 2 };

// the 16-bit parameter type beside fp32 (the w_half flag) of a kernel of
// x's type T: fp16 with fp16 x (amp's O2 and O3 at fp16), else bf16. So
// the weight's dtype code has three values, and the fp32 and bf16 kernels
// are the code they were.
template <typename T>
using HalfParam = typename std::conditional<std::is_same<T, __half>::value,
                                            __half, __nv_bfloat16>::type;

// element i of a float32 (w_half false) or P (true) vector, 0 past n
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

// --- the backward -----------------------------------------------------------
//
// A row group of W warps owns one row at a time; thread j of the group
// holds the C 16-byte chunks j, j + 32W, ... of the row (E = C * V
// elements). A CTA holds R row groups, and the groups walk the CTA's
// fixed rows interleaved.
constexpr int kRedRows = 16;  // partial rows summed a column, in parallel

// warps a CTA holds: 16 for one chunk a thread (two such CTAs an SM at 64
// registers a thread), else 8
__host__ __device__ constexpr int bwd_cta_warps(int c) {
  return c == 1 ? 16 : 8;
}
__host__ __device__ constexpr int bwd_groups(int c, int w) {
  return w >= bwd_cta_warps(c) ? 1 : bwd_cta_warps(c) / w;
}
__host__ __device__ constexpr int bwd_threads(int c, int w) {
  return bwd_groups(c, w) * w * 32;
}
// rows in the cp.async ring of each group: S - 1 rows in flight
__host__ __device__ constexpr int bwd_stages(int c) { return c == 1 ? 4 : 3; }

// shared memory: [R][S][G] (mean, rstd) pairs, [R][2][W] (sum d, sum d*xh)
// pairs, then the [R][S][2][C][G] ring of x and dy chunks (after the walk,
// with R > 1, the (2, n) sum of the groups' dgamma/dbeta partials)
template <int C, int W>
size_t bwd_smem(int n) {
  constexpr int R = bwd_groups(C, W), G = 32 * W, S = bwd_stages(C);
  const size_t ring = static_cast<size_t>(R) * S * 2 * C * G * 16;
  const size_t acc = R > 1 ? static_cast<size_t>(2) * n * sizeof(float) : 0;
  return static_cast<size_t>(R) * S * G * sizeof(float2) +
         static_cast<size_t>(R) * 2 * W * sizeof(float2) +
         (ring > acc ? ring : acc);
}

// the threads of one row group meet at their own barrier (1 + group)
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the two sums of a row over a warp, side by side
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// dx per row; with kW also the CTA's (2, n) partial row of (dgamma, dbeta)
template <typename T, int C, int W, bool kW>
__global__ void __launch_bounds__(bwd_threads(C, W), C == 1 ? 2 : 1)
    ln_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const void* __restrict__ w,
                  T* __restrict__ dx, float* __restrict__ part, int rows,
                  int n, int rows_per_cta, bool rms, bool vec, bool w_half) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int E = C * V;
  constexpr int R = bwd_groups(C, W), G = 32 * W, S = bwd_stages(C);
  extern __shared__ __align__(16) unsigned char smem[];
  float2* stats = reinterpret_cast<float2*>(smem);
  float2* sums = stats + R * S * G;
  uint4* ring = reinterpret_cast<uint4*>(sums + R * 2 * W);
  const int grp = threadIdx.x / G;
  const int j = threadIdx.x % G;
  const int warp = j >> 5, lane = j & 31;
  float g[kW ? E : 1], dg[kW ? E : 1], db[kW ? E : 1];
  if constexpr (kW) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        g[c * V + k] =
            load_param<HalfParam<T>>(w, w_half, (j + G * c) * V + k, n);
        dg[c * V + k] = 0.f;
        db[c * V + k] = 0.f;
      }
  }
  const float inv_n = 1.f / static_cast<float>(n);
  // CTA c owns rows c, c + nb, c + 2 nb, ... (rows_per_cta of them, nb the
  // CTA count), so the CTAs together stream one contiguous window of rows;
  // group g takes the CTA's rows g, g + R, ... of those
  const int nb = gridDim.x;
  const int owned = min(rows_per_cta, (rows - blockIdx.x + nb - 1) / nb);
  const int count = grp < owned ? (owned - grp + R - 1) / R : 0;
  const int first = blockIdx.x + grp * nb;
  const int step = R * nb;
  uint4* my_ring = ring + grp * S * 2 * C * G;
  float2* my_stats = stats + grp * S * G;
  // each thread copies, and later reads, only its own chunks and its own
  // (mean, rstd) slot: its cp.async wait alone orders them
  auto prefetch = [&](int it) {
    const int row = first + it * step;
    const size_t off = static_cast<size_t>(row) * n;
    const int st = it % S;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (j + G * c) * V;
      if (i0 < n) {
        apex::cp_async_16_bytes(my_ring + ((st * 2) * C + c) * G + j,
                                x + off + i0, 16);
        apex::cp_async_16_bytes(my_ring + ((st * 2 + 1) * C + c) * G + j,
                                dy + off + i0, 16);
      }
    }
    apex::cp_async_small(&my_stats[st * G + j].x, mean + row, 4);
    apex::cp_async_small(&my_stats[st * G + j].y, rstd + row, 4);
  };
  if (vec) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < count) prefetch(s);
      apex::cp_async_commit();
    }
  }
  for (int it = 0; it < count; ++it) {
    const int row = first + it * step;
    const size_t off = static_cast<size_t>(row) * n;
    float xv[E], gv[E], mu, rs;
    if (vec) {
      if (it + S - 1 < count) prefetch(it + S - 1);
      apex::cp_async_commit();
      apex::cp_async_wait<S - 1>();
      const int st = it % S;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if ((j + G * c) * V < n) {
          apex::unpack_chunk<T>(my_ring[((st * 2) * C + c) * G + j],
                                xv + c * V);
          apex::unpack_chunk<T>(my_ring[((st * 2 + 1) * C + c) * G + j],
                                gv + c * V);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) xv[c * V + k] = gv[c * V + k] = 0.f;
        }
      }
      const float2 ms = my_stats[st * G + j];
      mu = ms.x;
      rs = ms.y;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        apex::load_chunk(x + off, (j + G * c) * V, n, false, 0.f,
                         xv + c * V);
        apex::load_chunk(dy + off, (j + G * c) * V, n, false, 0.f,
                         gv + c * V);
      }
      mu = mean[row];
      rs = rstd[row];
    }
    // elements past the row load as 0: their d is 0, so they add nothing
    const float shift = rms ? 0.f : -mu * rs;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float xh = fmaf(xv[e], rs, shift);
      float d = gv[e];
      if constexpr (kW) {
        dg[e] = fmaf(d, xh, dg[e]);
        db[e] += d;
        d *= g[e];
      }
      xv[e] = xh;
      gv[e] = d;
      s1 += d;
      s2 = fmaf(d, xh, s2);
    }
    warp_sum2(s1, s2);
    if (rms) s1 = 0.f;
    if constexpr (W > 1) {
      // the group's warps' sums, added in warp order; two slots by row
      // parity, so a warp that runs ahead never overwrites a slot still read
      float2* slot = sums + (grp * 2 + (it & 1)) * W;
      if (lane == 0) slot[warp] = make_float2(s1, s2);
      group_sync(1 + grp, G);
      s1 = 0.f;
      s2 = 0.f;
#pragma unroll
      for (int wi = 0; wi < W; ++wi) {
        const float2 p = slot[wi];
        s1 += p.x;
        s2 += p.y;
      }
    }
    const float c2 = s2 * inv_n;
    const float c1 = s1 * inv_n;
#pragma unroll
    for (int e = 0; e < E; ++e) xv[e] = (gv[e] - c1 - xv[e] * c2) * rs;
#pragma unroll
    for (int c = 0; c < C; ++c)
      apex::store_chunk(dx + off, (j + G * c) * V, n, vec, xv + c * V);
  }
  if constexpr (kW) {
    float* pr = part + static_cast<size_t>(blockIdx.x) * 2 * n;
    if constexpr (R == 1) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int i = (j + G * c) * V + k;
          if (i < n) {
            pr[i] = dg[c * V + k];
            pr[n + i] = db[c * V + k];
          }
        }
    } else {
      // thread j of every group owns the same columns: add the groups'
      // partials in group order in shared memory, then write the CTA's row
      float* acc = reinterpret_cast<float*>(ring);
      __syncthreads();  // every group is done with the ring
      for (int gi = 0; gi < R; ++gi) {
        if (grp == gi) {
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const int i = (j + G * c) * V + k;
              if (i < n) {
                acc[i] = (gi ? acc[i] : 0.f) + dg[c * V + k];
                acc[n + i] = (gi ? acc[n + i] : 0.f) + db[c * V + k];
              }
            }
        }
        __syncthreads();
      }
      for (int i = threadIdx.x; i < 2 * n; i += R * G) pr[i] = acc[i];
    }
  }
}

// dgamma (blockIdx.y 0) or dbeta (1) of 32 columns: thread row ty sums the
// partial rows ty, ty + kRedRows, ... in order, then the kRedRows sums are
// added in order
template <typename P>
__global__ void __launch_bounds__(32 * kRedRows)
    ln_bwd_reduce_kernel(const float* __restrict__ part, void* dw, void* db,
                         int parts, int n, bool w_half) {
  __shared__ float s[kRedRows][33];
  void* out = blockIdx.y ? db : dw;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  float a = 0.f;
  if (col < n) {
    const float* p = part + static_cast<size_t>(blockIdx.y) * n + col;
#pragma unroll 4
    for (int r = ty; r < parts; r += kRedRows)
      a += p[static_cast<size_t>(r) * 2 * n];
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

// --- the forward -----------------------------------------------------------
//
// A row group of W warps owns one row at a time, thread j of the group the
// C 16-byte chunks j, j + 32W, ... of it (the backward's shape, bwd_shape);
// a CTA holds the plan's groups, and group g of CTA c walks rows
// c * groups + g, then every (grid * groups)-th row after it.

// rows of a group in flight: the current one and fwd_depth - 1 ahead, in
// registers (2 at one or two chunks a thread, 1 at four; at one chunk 3 or
// 4 rows ran no faster, or spilled, at 64 registers)
__host__ __device__ constexpr int fwd_depth(int c) { return c <= 2 ? 2 : 1; }
// a CTA's threads at most: 16 warps at one chunk a thread (64 registers,
// two CTAs an SM), else 8 (128 registers)
__host__ __device__ constexpr int fwd_max_threads(int c) {
  return c == 1 ? 512 : 256;
}

// the V parameters from element i on (one chunk's) in fp32, 0 past n: as
// 16-byte (8-byte for four bf16) vectors where pvec, else one by one
template <int V, typename P>
__device__ __forceinline__ void load_param_chunk(const void* __restrict__ p,
                                                 bool w_half, int i, int n,
                                                 bool pvec, float* out) {
  if (pvec && i + V <= n) {
    if (w_half) {
      const P* q = static_cast<const P*>(p) + i;
      if constexpr (V == 8) {
        apex::unpack_chunk<P>(*reinterpret_cast<const uint4*>(q), out);
      } else {  // fp32 x's bf16 parameters
        static_assert(std::is_same<P, __nv_bfloat16>::value, "bf16 pairs");
        const uint2 r = *reinterpret_cast<const uint2*>(q);
        out[0] = __uint_as_float(r.x << 16);
        out[1] = __uint_as_float(r.x & 0xffff0000u);
        out[2] = __uint_as_float(r.y << 16);
        out[3] = __uint_as_float(r.y & 0xffff0000u);
      }
    } else {
      const float4* q =
          reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 r = q[k];
        out[4 * k] = r.x;
        out[4 * k + 1] = r.y;
        out[4 * k + 2] = r.z;
        out[4 * k + 3] = r.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = load_param<P>(p, w_half, i + k, n);
  }
}

template <typename T, int C, int kAff>
__global__ void __launch_bounds__(fwd_max_threads(C), 2)
    ln_fwd_kernel(const T* __restrict__ x, const void* __restrict__ w,
                  const void* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  int rows, int n, int warps, float eps, bool rms, bool vec,
                  bool pvec, bool w_half) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int E = C * V;
  constexpr int D = fwd_depth(C);
  extern __shared__ float red[];  // [groups][2][warps]: the warps' sums
  const int G = 32 * warps;
  const int grp = threadIdx.x / G;
  const int j = threadIdx.x - grp * G;
  const int warp = j >> 5, lane = j & 31;
  const int groups = blockDim.x / G;
  const int first = blockIdx.x * groups + grp;
  const int step = gridDim.x * groups;
  const int count = first < rows ? (rows - first + step - 1) / step : 0;
  float* slots = red + grp * 2 * warps;
  const float nf = static_cast<float>(n);

  // the chunks of the group's row `it` (vec), zeros past the row
  uint4 raw[D][C];
  auto fetch = [&](uint4(&dst)[C], int it) {
    const T* xr = x + static_cast<size_t>(first + it * step) * n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (j + G * c) * V;
      dst[c] = i0 < n ? *reinterpret_cast<const uint4*>(xr + i0)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // the first D rows' loads, then the parameters': one batch
  if (vec) {
#pragma unroll
    for (int s = 0; s < D; ++s)
      if (s < count) fetch(raw[s], s);
  }
  float g[kAff >= kWeight ? E : 1];
  float be[kAff == kWeightBias ? E : 1];
  if constexpr (kAff >= kWeight) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (j + G * c) * V;
      load_param_chunk<V, HalfParam<T>>(w, w_half, i0, n, pvec, g + c * V);
      if constexpr (kAff == kWeightBias)
        load_param_chunk<V, HalfParam<T>>(b, w_half, i0, n, pvec,
                                          be + c * V);
    }
  }

  // the group's sum of every thread's t: its warp's by shuffles, then the
  // group's warps' in warp order; two slots by barrier parity, so a warp
  // that runs ahead never overwrites a slot another still reads
  int phase = 0;
  auto group_total = [&](float t) {
    t = apex::warp_sum(t);
    if (warps > 1) {
      float* slot = slots + (phase & 1) * warps;
      if (lane == 0) slot[warp] = t;
      group_sync(1 + grp, G);
      t = 0.f;
      for (int wi = 0; wi < warps; ++wi) t += slot[wi];
      ++phase;
    }
    return t;
  };

  for (int base = 0; base < count; base += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      const int it = base + s;
      if (it >= count) break;
      const int row = first + it * step;
      const size_t off = static_cast<size_t>(row) * n;
      float v[E];
      if (vec) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          apex::unpack_chunk<T>(raw[s][c], v + c * V);
        if (it + D < count) fetch(raw[s], it + D);  // in flight meanwhile
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
          apex::load_chunk(x + off, (j + G * c) * V, n, false, 0.f,
                           v + c * V);
      }
      float mu = 0.f;
      if (!rms) {
        float t = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) t += v[e];
        mu = group_total(t) / nf;
      }
      float ss = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int e = c * V + k;
          v[e] = (j + G * c) * V + k < n ? v[e] - mu : 0.f;
          ss = fmaf(v[e], v[e], ss);
        }
      const float rstd = rsqrtf(group_total(ss) / nf + eps);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float o = v[e] * rstd;
        if constexpr (kAff >= kWeight) o *= g[e];
        if constexpr (kAff == kWeightBias) o += be[e];
        v[e] = o;
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        apex::store_chunk(y + off, (j + G * c) * V, n, vec, v + c * V);
      if (j == 0) {
        mean_out[row] = mu;
        rstd_out[row] = rstd;
      }
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int C>
cudaError_t fwd_launch(const void* x, const void* w, const void* b, void* y,
                       void* mean, void* rstd, int affine, bool rms, int rows,
                       int n, float eps, int warps, int groups, int ctas,
                       int smem, bool w_half, cudaStream_t st) {
  const bool vec = n % apex::Chunk<T>::kVec == 0 && aligned(x) && aligned(y);
  const bool pvec = n % apex::Chunk<T>::kVec == 0 &&
                    (w == nullptr || aligned(w)) &&
                    (b == nullptr || aligned(b));
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  const int threads = groups * warps * 32;
  if (affine == kWeightBias)
    ln_fwd_kernel<T, C, kWeightBias><<<ctas, threads, smem, st>>>(
        xp, w, b, yp, mp, rp, rows, n, warps, eps, rms, vec, pvec, w_half);
  else if (affine == kWeight)
    ln_fwd_kernel<T, C, kWeight><<<ctas, threads, smem, st>>>(
        xp, w, b, yp, mp, rp, rows, n, warps, eps, rms, vec, pvec, w_half);
  else
    ln_fwd_kernel<T, C, kNone><<<ctas, threads, smem, st>>>(
        xp, w, b, yp, mp, rp, rows, n, warps, eps, rms, vec, pvec, w_half);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_t(const void* x, const void* w, const void* b, void* y,
                  void* mean, void* rstd, int affine, bool rms, int rows,
                  int n, float eps, int chunks, int warps, int groups,
                  int ctas, int smem, bool w_half, cudaStream_t st) {
  switch (chunks) {
    case 1:
      return fwd_launch<T, 1>(x, w, b, y, mean, rstd, affine, rms, rows, n,
                              eps, warps, groups, ctas, smem, w_half, st);
    case 2:
      return fwd_launch<T, 2>(x, w, b, y, mean, rstd, affine, rms, rows, n,
                              eps, warps, groups, ctas, smem, w_half, st);
    case 4:
      if constexpr (apex::Chunk<T>::kVec * 4 <= 16)
        return fwd_launch<T, 4>(x, w, b, y, mean, rstd, affine, rms, rows,
                                n, eps, warps, groups, ctas, smem, w_half,
                                st);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// whether the host's plan covers a row of n and fits the kernel: chunks
// of 1, 2 (4 in fp32), whole warps a row, at most fwd_max_threads a CTA,
// a named barrier for each group of more than one warp, and room for the
// groups' sums
template <typename T>
bool fwd_plan_ok(int n, int chunks, int warps, int groups, int ctas,
                 int smem) {
  constexpr int V = apex::Chunk<T>::kVec;
  if (chunks != 1 && chunks != 2 && !(chunks == 4 && V == 4)) return false;
  if (warps < 1 || groups < 1 || ctas < 1 ||
      groups * warps * 32 > fwd_max_threads(chunks) ||
      (warps > 1 && groups > 15))
    return false;
  return chunks * warps * 32 * V >= n &&
         smem >= groups * 2 * warps * static_cast<int>(sizeof(float));
}

template <typename T, int C, int W, bool kW>
cudaError_t bwd_launch(const T* dy, const T* x, const float* mean,
                       const float* rstd, const void* w, T* dx, float* part,
                       bool rms, int rows, int n, int rows_per_cta, bool vec,
                       bool w_half, cudaStream_t st) {
  const int blocks = (rows + rows_per_cta - 1) / rows_per_cta;
  const size_t smem = bwd_smem<C, W>(n);
  auto kernel = ln_bwd_kernel<T, C, W, kW>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, bwd_threads(C, W), smem, st>>>(dy, x, mean, rstd, w, dx,
                                                  part,
                                               rows, n, rows_per_cta, rms,
                                               vec, w_half);
  return cudaGetLastError();
}

template <typename T, int C, int W>
cudaError_t bwd_cw(const void* dy, const void* x, const void* mean,
                   const void* rstd, const void* w, void* dx, void* part,
                   void* dw, void* db, bool rms, int rows, int n,
                   int rows_per_cta, bool vec, bool w_half, cudaStream_t st) {
  const T* dyp = static_cast<const T*>(dy);
  const T* xp = static_cast<const T*>(x);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  if (w == nullptr)
    return bwd_launch<T, C, W, false>(dyp, xp, mp, rp, w, dxp, pp, rms, rows,
                                      n, rows_per_cta, vec, w_half, st);
  const cudaError_t err = bwd_launch<T, C, W, true>(
      dyp, xp, mp, rp, w, dxp, pp, rms, rows, n, rows_per_cta, vec, w_half,
      st);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + rows_per_cta - 1) / rows_per_cta;
  ln_bwd_reduce_kernel<HalfParam<T>><<<dim3((n + 31) / 32, db != nullptr ? 2 : 1),
                         32 * kRedRows, 0, st>>>(pp, dw, db, blocks, n,
                                                 w_half);
  return cudaGetLastError();
}

// the backward's launch shape for a row of n: C chunks a thread (at most
// 16 elements), then the fewest warps W of {1, 2, 3, 4, 6, 8} that cover
// the row's chunks (hidden 768 in bf16: 96 chunks, 3 warps of one chunk a
// lane, no idle lane; 1024: 4 warps; 4096: 8 warps of two chunks)
template <typename T>
void bwd_shape(int n, int* c, int* w) {
  constexpr int V = apex::Chunk<T>::kVec;
  const int nc = (n + V - 1) / V;
  *c = nc <= 256 ? 1 : nc <= 512 ? 2 : 4;
  const int need = (nc + 32 * *c - 1) / (32 * *c);
  *w = need <= 4 ? need : need <= 6 ? 6 : 8;
}

template <typename T>
cudaError_t bwd_t(const void* dy, const void* x, const void* mean,
                  const void* rstd, const void* w, void* dx, void* part,
                  void* dw, void* db, bool rms, int rows, int n,
                  int rows_per_cta, bool w_half, cudaStream_t st) {
  constexpr int V = apex::Chunk<T>::kVec;
  const bool vec = n % V == 0 && aligned(dy) && aligned(x) && aligned(dx);
  int c, wr;
  bwd_shape<T>(n, &c, &wr);
#define APEX_LN_BWD(C_, W_)                                                  \
  if (c == C_ && wr == W_)                                                   \
    return bwd_cw<T, C_, W_>(dy, x, mean, rstd, w, dx, part, dw, db, rms,    \
                             rows, n, rows_per_cta, vec, w_half, st);
  APEX_LN_BWD(1, 1)
  APEX_LN_BWD(1, 2)
  APEX_LN_BWD(1, 3)
  APEX_LN_BWD(1, 4)
  APEX_LN_BWD(1, 6)
  APEX_LN_BWD(1, 8)
  APEX_LN_BWD(2, 6)
  APEX_LN_BWD(2, 8)
  if constexpr (V * 4 <= 16) {
    APEX_LN_BWD(4, 6)
    APEX_LN_BWD(4, 8)
  }
#undef APEX_LN_BWD
  return cudaErrorInvalidValue;
}

bool dtype_ok(int dtype) {
  return dtype == apex::kFloat32 || dtype == apex::kBFloat16 ||
         dtype == apex::kFloat16;
}

// the parameters' dtype code beside x's: fp32, or the 16-bit type
// HalfParam gives x's (fp16 for fp16 x, bf16 for bf16 and fp32 x)
bool param_ok(int dtype, int w_dtype) {
  return w_dtype == apex::kFloat32 ||
         w_dtype == (dtype == apex::kFloat16 ? apex::kFloat16
                                             : apex::kBFloat16);
}

}  // namespace

// x, y (rows, n) of dtype; w, b (n,) of w_dtype (param_ok) or null by
// `affine` (0 none, 1 weight, 2 weight and bias); mean, rstd (rows,) fp32.
// chunks, warps, groups, ctas, smem: the host's plan (_fwd_plan)
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* y, void* mean, void* rstd, int dtype,
                           int w_dtype, int affine, int rms, int rows, int n,
                           float eps, int chunks, int warps, int groups,
                           int ctas, int smem, void* stream) {
  if (!dtype_ok(dtype) || !param_ok(dtype, w_dtype) || rows < 1 || n < 1 ||
      n > kMaxHidden || affine < kNone || affine > kWeightBias ||
      (affine >= kWeight && w == nullptr) ||
      (affine == kWeightBias && b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok =
      dtype == apex::kBFloat16
          ? fwd_plan_ok<__nv_bfloat16>(n, chunks, warps, groups, ctas, smem)
      : dtype == apex::kFloat16
          ? fwd_plan_ok<__half>(n, chunks, warps, groups, ctas, smem)
          : fwd_plan_ok<float>(n, chunks, warps, groups, ctas, smem);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_half = w_dtype != apex::kFloat32;
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? fwd_t<__nv_bfloat16>(x, w, b, y, mean, rstd, affine, rms != 0,
                                 rows, n, eps, chunks, warps, groups, ctas,
                                 smem, w_half, st)
      : dtype == apex::kFloat16
          ? fwd_t<__half>(x, w, b, y, mean, rstd, affine, rms != 0, rows, n,
                          eps, chunks, warps, groups, ctas, smem, w_half, st)
          : fwd_t<float>(x, w, b, y, mean, rstd, affine, rms != 0, rows, n,
                         eps, chunks, warps, groups, ctas, smem, w_half, st);
  return static_cast<int>(err);
}

// the backward row kernel's launch shape for a row of n of dtype: out =
// (chunks a thread, warps a row, threads a CTA)
extern "C" int apex_ln_bwd_shape(int dtype, int n, int* out) {
  if (!dtype_ok(dtype) || n < 1 || n > kMaxHidden || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == apex::kFloat32)
    bwd_shape<float>(n, out, out + 1);
  else  // the 16-bit types' chunks are alike
    bwd_shape<__nv_bfloat16>(n, out, out + 1);
  out[2] = bwd_threads(out[0], out[1]);
  return 0;
}

// dy, x, dx (rows, n) of dtype; mean, rstd (rows,) fp32; w (n,) or null.
// With w: part (ceil(rows / rows_per_cta), 2, n) fp32 scratch, dw (n,) and
// db (n,) or null in w's dtype.
extern "C" int apex_ln_bwd(const void* dy, const void* x, const void* mean,
                           const void* rstd, const void* w, void* dx,
                           void* part, void* dw, void* db, int dtype,
                           int w_dtype, int rms, int rows, int n,
                           int rows_per_cta, void* stream) {
  if (!dtype_ok(dtype) || !param_ok(dtype, w_dtype) || rows < 1 || n < 1 ||
      n > kMaxHidden || rows_per_cta < 1 ||
      (w != nullptr && (part == nullptr || dw == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_half = w_dtype != apex::kFloat32;
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? bwd_t<__nv_bfloat16>(dy, x, mean, rstd, w, dx, part, dw, db,
                                 rms != 0, rows, n, rows_per_cta, w_half, st)
      : dtype == apex::kFloat16
          ? bwd_t<__half>(dy, x, mean, rstd, w, dx, part, dw, db, rms != 0,
                          rows, n, rows_per_cta, w_half, st)
          : bwd_t<float>(dy, x, mean, rstd, w, dx, part, dw, db, rms != 0,
                         rows, n, rows_per_cta, w_half, st);
  return static_cast<int>(err);
}
