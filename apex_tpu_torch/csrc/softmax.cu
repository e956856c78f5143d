// The scaled masked softmax, forward and backward, for Hopper (sm_90a).
//
// Replaces apex_tpu/ops/pallas/softmax.py::softmax_fwd (:83; body
// _softmax_fwd_kernel :43) and ::softmax_bwd (:108; body
// _softmax_bwd_kernel :96). Same contract, per row of (rows, sk) scores in
// fp32 arithmetic: the forward computes y = softmax(scale * x) with
// MASK_FILL = -10000 put in place of every masked entry AFTER the scale
// (so a fully masked row comes out uniform), y in x's dtype; the backward
// computes dx = scale * y * (dy - sum(dy * y)) from the saved y alone.
//
// Masks: none; causal (key k kept where k <= q, q = row mod sq, built in
// the kernel); or a bool mask read through its four strides (b, h, q, k)
// in bytes, 0 on every broadcast dimension. The reference materialises
// broadcast_to(mask, x.shape) as int8 before its kernel (ops/softmax.py:
// 90-91): at BERT-large that is 32*16*512*512 B = 134 MB a call against
// the 16 KB (b, 1, 1, s) key mask this kernel reads.
//
// Entries: apex_softmax_fwd and apex_softmax_bwd.
//
// Bound on this card at GPT's causal call (163840 rows x 1024, bf16):
// bytes, counting only the entries the function must read (a masked
// entry's score is MASK_FILL whatever x holds, and its dx is 0). The
// forward reads x on and below the diagonal and writes y whole (503 MB,
// 0.150 ms at 3.35 TB/s), the backward reads dy and y there and writes dx
// (671 MB, 0.200 ms). About five fp32 operations an entry are far below
// the card's rate.
//
// Forward (sk <= 2048): L lanes a row (a warp; half a warp for rows of at
// most 16 chunks, two rows a warp); lane l holds the 16-byte chunks l,
// l + L, ... of the row (E = 8, 16, 32 or 64 elements a lane). What it does
// about the bound:
// * it reads only what the function needs: a row's masked entries are
//   known before its x is read (causal: from the query index; a mask:
//   from the row's mask bytes, 8 or 4 at a time when the key stride is 1),
//   and a chunk whose every entry is masked is not loaded; its entries
//   take MASK_FILL and its exp is taken once a row. The output is written
//   whole, so a fully masked row is still uniform;
// * it keeps loads in flight without registers: as many CTAs as the card
//   holds at once, each warp walking rows grid-stride; every lane copies
//   its own chunks of the row S - 1 steps ahead into its own slots of the
//   warp's shared-memory ring with cp.async (in 16-, 8- or 4-byte pieces
//   by the row's alignment; element by element, at once, when a row
//   starts on no 4-byte boundary) and reads them back after its own wait;
// * it spends few instructions an entry, which the short rows of T5's
//   decoder are bound by: bf16 pairs unpacked and packed by shifts and one
//   conversion a pair, exp2 (ex2.approx) on scores prescaled by scale *
//   log2(e), one reciprocal a row, a row's (b, h, q) kept by additions
//   instead of divisions, masked bits from the mask bytes by word
//   arithmetic, and no per-entry bound check where a chunk is whole.
// A longer row takes a CTA of 256 threads and three passes over it (max,
// sum, write).
//
// Backward: one warp a row, the row in registers (sk <= 2048; lane l
// holds chunks l, l + 32, ... through row_io.cuh), max-free: the dot of dy
// and y by warp shuffles, one write; a longer row takes a CTA of 256
// threads and two passes.
#include <cmath>
#include <cstdint>

#include "apex_cuda.cuh"
#include "apex_mma.cuh"
#include "row_io.cuh"

namespace {

constexpr float kMaskFill = -10000.f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // 4 warps, one row each
constexpr int kWarps = kThreads / 32;
constexpr int kLongThreads = 256;

enum Mode : int { kNoMask = 0, kCausal = 1, kMask = 2 };

// the mask viewed (b, h, q, k) over x's rows: row r is (b, h, q) with
// q = r % q_rows and h = (r / q_rows) % heads; strides in bytes
struct MaskView {
  const uint8_t* p;
  long long sb, sh, sq, sk;
  int heads, q_rows;

  __device__ const uint8_t* row(int r) const {
    const int qi = r % q_rows;
    const int t = r / q_rows;
    return p + (t / heads) * sb + (t % heads) * sh + qi * sq;
  }
};

// the mask bytes of elements i0 .. i0 + V - 1 of a mask row, packed
// little-endian (0 past n): one access when the key stride is 1 and the
// bytes are aligned
template <int V>
__device__ __forceinline__ uint2 fetch_mask(const uint8_t* mr, long long sk,
                                            int i0, int n) {
  uint2 r = make_uint2(0u, 0u);
  if (i0 >= n) return r;
  const uint8_t* p = mr + i0 * sk;
  if (sk == 1 && i0 + V <= n && reinterpret_cast<uintptr_t>(p) % V == 0) {
    if constexpr (V == 8)
      r = *reinterpret_cast<const uint2*>(p);
    else
      r.x = *reinterpret_cast<const uint32_t*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (i0 + k < n) {
        const uint32_t b = p[k * sk] != 0;
        if (k < 4)
          r.x |= b << (8 * (k & 3));
        else
          r.y |= b << (8 * (k & 3));
      }
  }
  return r;
}

// the scaled, masked score of element i of a row
template <int kMode>
__device__ __forceinline__ float score(float x, int i, int q,
                                       const uint8_t* mr,
                                       const MaskView& m, float scale) {
  float s = x * scale;
  if constexpr (kMode == kCausal) s = i <= q ? s : kMaskFill;
  if constexpr (kMode == kMask) s = mr[i * m.sk] ? kMaskFill : s;
  return s;
}

// stages of a warp's cp.async ring: S - 1 rows in flight ahead of the row
// it reduces
__host__ __device__ constexpr int fwd_stages(int c) {
  return c <= 2 ? 4 : c == 4 ? 3 : 2;
}

// shared memory of a CTA: each warp's ring of [S][C][32] 16-byte chunk
// slots, then its [S][C][32] masked bits
__host__ __device__ constexpr int fwd_smem(int c) {
  return kWarps * fwd_stages(c) * c * 32 * (16 + 4);
}

// a reduction over the L lanes of a row (xor partners stay in the group)
template <int L, bool kMax>
__device__ __forceinline__ float group_reduce(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, t) : v + t;
  }
  return v;
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x, 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bit k set where byte k of w is nonzero (k < 4)
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t hi = ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w;  // byte MSBs
  return (((hi >> 7) & 0x01010101u) * 0x01020408u) >> 24;
}

template <typename T>
__device__ __forceinline__ uint4 pack_chunk(const float* v, float scale) {
  uint4 raw;
  if constexpr (sizeof(T) == 2) {
    uint32_t* u = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(v[2 * k] * scale, v[2 * k + 1] * scale);
      u[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
  } else {
    raw = make_uint4(__float_as_uint(v[0] * scale),
                     __float_as_uint(v[1] * scale),
                     __float_as_uint(v[2] * scale),
                     __float_as_uint(v[3] * scale));
  }
  return raw;
}

// the (b, h, q) of the rows a lane visits, r, r + stride, ..., kept by
// additions: one division per quantity at the start, none per row
struct RowWalk {
  int q, h, b;     // the current row
  int dq, dh, db;  // the stride's
  int q_rows, heads;

  __device__ RowWalk(int r, int stride, int q_rows_, int heads_)
      : q_rows(q_rows_), heads(heads_) {
    int t = r / q_rows;
    q = r - t * q_rows;
    b = t / heads;
    h = t - b * heads;
    t = stride / q_rows;
    dq = stride - t * q_rows;
    db = t / heads;
    dh = t - db * heads;
  }
  __device__ void next() {
    q += dq;
    int carry = q >= q_rows;
    q -= carry ? q_rows : 0;
    h += dh + carry;
    carry = h >= heads;
    h -= carry ? heads : 0;
    b += db + carry;
  }
};

// y = softmax(scale * x) over rows walked by persistent warps, G rows a
// warp at a time (two for rows of at most 16 chunks, L = 32 / G lanes a
// row). A row's masked bits are known before its x is read (causal: from
// its query index; mask: from its mask bytes), so a chunk whose every
// entry is masked is never loaded. Each lane copies its own chunks of the
// row S - 1 steps ahead into its own slots of the warp's ring with
// cp.async, in pieces of w bytes (16, 8, 4; 0: element by element, at
// once), and reads them back after its own wait: no barrier guards the
// ring.
template <typename T, int E, int G, int kMode>
__global__ void __launch_bounds__(kThreads)
    softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                       MaskView m, int rows, int n, int sq, float scale2,
                       int w) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = E / V;
  constexpr int L = 32 / G;
  constexpr int S = fwd_stages(C);
  constexpr uint32_t kAll = (1u << V) - 1;
  constexpr float kFill2 = kMaskFill * kLog2e;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sl = lane % L;
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * S * C * 32;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + kWarps * S * C * 32 *
                                                           16) +
                   warp * S * C * 32;
  const int stride = gridDim.x * kWarps * G;
  const int base = (blockIdx.x * kWarps + warp) * G;
  if (base >= rows) return;
  const int first = base + lane / L;
  const int count = (rows - base + stride - 1) / stride;
  // the rows prefetch() visits, in order
  RowWalk walk(first, stride, kMode == kMask ? m.q_rows : sq,
               kMode == kMask ? m.heads : 1);

  auto prefetch = [&](int it) {
    const int r = first + it * stride;
    const int st = it % S;
    const bool active = r < rows;
    const T* xr = x + static_cast<size_t>(r) * n;
    uint32_t mb[C];
    if constexpr (kMode == kMask) {
      const uint8_t* mr = m.p + walk.b * m.sb + walk.h * m.sh + walk.q * m.sq;
      uint2 raw[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        raw[c] = active ? fetch_mask<V>(mr, m.sk, (sl + L * c) * V, n)
                        : make_uint2(0u, 0u);
#pragma unroll
      for (int c = 0; c < C; ++c)
        mb[c] = nonzero_bytes(raw[c].x) | (nonzero_bytes(raw[c].y) << 4);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = walk.q - (sl + L * c) * V;  // k masked where k > d
        mb[c] = kMode != kCausal ? 0u
                : d < 0          ? kAll
                : d >= V - 1     ? 0u
                                 : kAll & ~((2u << d) - 1);
      }
    }
    walk.next();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (sl + L * c) * V;
      const int left = n - i0;  // elements of the chunk inside the row
      const uint32_t dead =
          left <= 0 ? kAll : left >= V ? 0u : kAll & ~((1u << left) - 1);
      const uint32_t b = active ? mb[c] & kAll : kAll;
      const int at = (st * C + c) * 32 + lane;
      bits[at] = b;
      if ((b | dead) == kAll) continue;  // nothing of it is read
      const T* src = xr + i0;
      if (w == 16) {
        apex::cp_async_16_bytes(ring + at, src, 16);
      } else if (w != 0) {
        const int ep = w / static_cast<int>(sizeof(T));  // elements a piece
        for (int p = 0; p * ep < left && p * w < 16; ++p)
          apex::cp_async_small(reinterpret_cast<char*>(ring + at) + p * w,
                               src + p * ep, w);
      } else {
        uint4 tmp = make_uint4(0u, 0u, 0u, 0u);
        T* e = reinterpret_cast<T*>(&tmp);
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (k < left) e[k] = src[k];
        ring[at] = tmp;
      }
    }
  };

  auto finish = [&](int it) {
    const int r = first + it * stride;
    const int st = it % S;
    float v[E];
    uint32_t b[C];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (sl + L * c) * V;
      const int at = (st * C + c) * 32 + lane;
      b[c] = bits[at];
      if (i0 >= n) continue;
      if (b[c] == kAll) {  // never loaded: every element is the fill
        mx = fmaxf(mx, kFill2);
        continue;
      }
      apex::unpack_chunk<T>(ring[at], v + c * V);
#pragma unroll
      for (int k = 0; k < V; ++k) v[c * V + k] *= scale2;
      if (b[c] != 0 || i0 + V > n) {  // masked entries: the fill; dead: 0
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if ((b[c] >> k) & 1u) v[c * V + k] = kFill2;
          if (i0 + k >= n) v[c * V + k] = -INFINITY;
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) mx = fmaxf(mx, v[c * V + k]);
    }
    mx = group_reduce<L, true>(mx);
    const float pf = fast_exp2(kFill2 - mx);  // a filled entry's numerator
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (sl + L * c) * V;
      if (i0 >= n) continue;
      if (b[c] == kAll) {
        sum += pf * static_cast<float>(min(V, n - i0));
        continue;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[c * V + k] = fast_exp2(v[c * V + k] - mx);
        sum += v[c * V + k];
      }
    }
    const float inv = fast_rcp(group_reduce<L, false>(sum));
    if (r >= rows) return;
    T* yr = y + static_cast<size_t>(r) * n;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (sl + L * c) * V;
      if (i0 >= n) continue;
      if (b[c] == kAll) {
#pragma unroll
        for (int k = 0; k < V; ++k) v[c * V + k] = pf;
      }
      const uint4 out = pack_chunk<T>(v + c * V, inv);
      if (w == 16) {
        *reinterpret_cast<uint4*>(yr + i0) = out;
      } else if (w == 8) {
        const int ep = 8 / static_cast<int>(sizeof(T));
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (p * ep < n - i0)
            reinterpret_cast<uint2*>(yr + i0)[p] =
                reinterpret_cast<const uint2*>(&out)[p];
      } else if (w == 4) {
        const int ep = 4 / static_cast<int>(sizeof(T));
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (p * ep < n - i0)
            reinterpret_cast<uint32_t*>(yr + i0)[p] =
                reinterpret_cast<const uint32_t*>(&out)[p];
      } else {
        const T* e = reinterpret_cast<const T*>(&out);
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (i0 + k < n) yr[i0 + k] = e[k];
      }
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < count) prefetch(s);
    apex::cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    if (it + S - 1 < count) prefetch(it + S - 1);
    apex::cp_async_commit();
    apex::cp_async_wait<S - 1>();
    finish(it);
  }
}

template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                       T* __restrict__ dx, int rows, int n, float scale,
                       bool vec) {
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = E / V;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(row) * n;
  float g[E], p[E];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    apex::load_chunk(dy + off, (lane + 32 * c) * V, n, vec, 0.f, g + c * V);
    apex::load_chunk(y + off, (lane + 32 * c) * V, n, vec, 0.f, p + c * V);
  }
  float dot = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) dot += g[e] * p[e];
  dot = apex::warp_sum(dot);
#pragma unroll
  for (int e = 0; e < E; ++e) g[e] = scale * p[e] * (g[e] - dot);
#pragma unroll
  for (int c = 0; c < C; ++c)
    apex::store_chunk(dx + off, (lane + 32 * c) * V, n, vec, g + c * V);
}

// a CTA-wide sum (is_max false) or max over kLongThreads threads
__device__ float block_reduce(float v, bool is_max, float* red) {
  v = is_max ? apex::warp_max(v) : apex::warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < kLongThreads / 32; ++w)
    t = is_max ? fmaxf(t, red[w]) : t + red[w];
  return t;
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kLongThreads)
    softmax_fwd_long_kernel(const T* __restrict__ x, T* __restrict__ y,
                            MaskView m, int n, int sq, float scale) {
  __shared__ float red[kLongThreads / 32];
  const int row = blockIdx.x;
  const size_t off = static_cast<size_t>(row) * n;
  const int q = kMode == kCausal ? row % sq : 0;
  const uint8_t* mr = kMode == kMask ? m.row(row) : nullptr;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kLongThreads)
    mx = fmaxf(mx, score<kMode>(apex::to_float(x[off + i]), i, q, mr, m,
                                scale));
  mx = block_reduce(mx, true, red);
  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += kLongThreads)
    sum += expf(score<kMode>(apex::to_float(x[off + i]), i, q, mr, m,
                             scale) - mx);
  const float inv = 1.f / block_reduce(sum, false, red);
  for (int i = threadIdx.x; i < n; i += kLongThreads)
    y[off + i] = apex::from_float<T>(
        expf(score<kMode>(apex::to_float(x[off + i]), i, q, mr, m, scale) -
             mx) * inv);
}

template <typename T>
__global__ void __launch_bounds__(kLongThreads)
    softmax_bwd_long_kernel(const T* __restrict__ dy,
                            const T* __restrict__ y, T* __restrict__ dx,
                            int n, float scale) {
  __shared__ float red[kLongThreads / 32];
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  float dot = 0.f;
  for (int i = threadIdx.x; i < n; i += kLongThreads)
    dot += apex::to_float(dy[off + i]) * apex::to_float(y[off + i]);
  dot = block_reduce(dot, false, red);
  for (int i = threadIdx.x; i < n; i += kLongThreads) {
    const float p = apex::to_float(y[off + i]);
    dx[off + i] = apex::from_float<T>(
        scale * p * (apex::to_float(dy[off + i]) - dot));
  }
}

// elements a lane holds for a row of n: 8, 16, 32, 64 (0: a CTA per row)
template <typename T>
int lane_elems(int n) {
  constexpr int V = apex::Chunk<T>::kVec;
  const int need = ((n + V - 1) / V + 31) / 32 * V;
  return need <= 8 ? 8 : need <= 16 ? 16 : need <= 32 ? 32
                                                       : need <= 64 ? 64 : 0;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the forward's grid: every CTA resident at once (its warps walk the rows),
// or fewer when the rows run out
template <typename T, int E, int G, int kMode>
int fwd_blocks(int rows) {
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, softmax_fwd_kernel<T, E, G, kMode>, kThreads,
        fwd_smem(E / apex::Chunk<T>::kVec));
    return sms * per_sm > 0 ? sms * per_sm : 1;
  }();
  return min((rows + kWarps * G - 1) / (kWarps * G), resident);
}

template <typename T, int E, int G, int kMode>
void fwd_launch(const T* x, T* y, const MaskView& m, int rows, int n, int sq,
                float scale2, int w, cudaStream_t st) {
  constexpr int kSmem = fwd_smem(E / apex::Chunk<T>::kVec);
  if constexpr (kSmem > 48 * 1024)  // fp32 rows of 2048: 80 KB
    cudaFuncSetAttribute(softmax_fwd_kernel<T, E, G, kMode>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  softmax_fwd_kernel<T, E, G, kMode>
      <<<fwd_blocks<T, E, G, kMode>(rows), kThreads, kSmem, st>>>(
          x, y, m, rows, n, sq, scale2, w);
}

// the widest piece (16, 8 or 4 bytes; 0: none) that every row of x and y
// starts on and ends on
int piece_bytes(const void* x, const void* y, int n, int es) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y) |
                      static_cast<uintptr_t>(n) * es;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

template <typename T, int kMode>
cudaError_t fwd_mode(const void* x, void* y, const MaskView& m, int rows,
                     int n, int sq, float scale, cudaStream_t st) {
  constexpr int V = apex::Chunk<T>::kVec;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int w = piece_bytes(x, y, n, sizeof(T));
  const float scale2 = scale * kLog2e;
  switch (lane_elems<T>(n)) {
    case 8:
      if ((n + V - 1) / V <= 16)
        fwd_launch<T, 8, 2, kMode>(xp, yp, m, rows, n, sq, scale2, w, st);
      else
        fwd_launch<T, 8, 1, kMode>(xp, yp, m, rows, n, sq, scale2, w, st);
      break;
    case 16:
      fwd_launch<T, 16, 1, kMode>(xp, yp, m, rows, n, sq, scale2, w, st);
      break;
    case 32:
      fwd_launch<T, 32, 1, kMode>(xp, yp, m, rows, n, sq, scale2, w, st);
      break;
    case 64:
      fwd_launch<T, 64, 1, kMode>(xp, yp, m, rows, n, sq, scale2, w, st);
      break;
    default:
      softmax_fwd_long_kernel<T, kMode><<<rows, kLongThreads, 0, st>>>(
          xp, yp, m, n, sq, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_t(const void* x, void* y, const MaskView& m, int mode,
                  int rows, int n, int sq, float scale, cudaStream_t st) {
  if (mode == kCausal) return fwd_mode<T, kCausal>(x, y, m, rows, n, sq,
                                                   scale, st);
  if (mode == kMask) return fwd_mode<T, kMask>(x, y, m, rows, n, sq, scale,
                                               st);
  return fwd_mode<T, kNoMask>(x, y, m, rows, n, sq, scale, st);
}

template <typename T>
cudaError_t bwd_t(const void* dy, const void* y, void* dx, int rows, int n,
                  float scale, cudaStream_t st) {
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  T* dxp = static_cast<T*>(dx);
  const bool vec = n % apex::Chunk<T>::kVec == 0 && aligned(dy) &&
                   aligned(y) && aligned(dx);
  const int blocks = (rows + kWarps - 1) / kWarps;
  switch (lane_elems<T>(n)) {
    case 8:
      softmax_bwd_kernel<T, 8><<<blocks, kThreads, 0, st>>>(
          dyp, yp, dxp, rows, n, scale, vec);
      break;
    case 16:
      softmax_bwd_kernel<T, 16><<<blocks, kThreads, 0, st>>>(
          dyp, yp, dxp, rows, n, scale, vec);
      break;
    case 32:
      softmax_bwd_kernel<T, 32><<<blocks, kThreads, 0, st>>>(
          dyp, yp, dxp, rows, n, scale, vec);
      break;
    case 64:
      softmax_bwd_kernel<T, 64><<<blocks, kThreads, 0, st>>>(
          dyp, yp, dxp, rows, n, scale, vec);
      break;
    default:
      softmax_bwd_long_kernel<T><<<rows, kLongThreads, 0, st>>>(
          dyp, yp, dxp, n, scale);
  }
  return cudaGetLastError();
}

bool dtype_ok(int dtype) {
  return dtype == apex::kFloat32 || dtype == apex::kBFloat16;
}

}  // namespace

// x, y (rows, n) of dtype. mode 0: no mask; 1: causal, q = row % sq;
// 2: mask (bool bytes) at strides mstrides = (b, h, q, k) in bytes over
// x's rows seen as (b, heads, q_rows).
extern "C" int apex_softmax_fwd(const void* x, void* y, const void* mask,
                                const long long* mstrides, int heads,
                                int q_rows, int dtype, int mode, int rows,
                                int n, int sq, float scale, void* stream) {
  if (!dtype_ok(dtype) || rows < 1 || n < 1 || mode < kNoMask ||
      mode > kMask || (mode == kCausal && sq < 1) ||
      (mode == kMask && (mask == nullptr || mstrides == nullptr ||
                         heads < 1 || q_rows < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  MaskView m{static_cast<const uint8_t*>(mask), 0, 0, 0, 0, 1, 1};
  if (mode == kMask) {
    for (int i = 0; i < 4; ++i)
      if (mstrides[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
    m.sb = mstrides[0];
    m.sh = mstrides[1];
    m.sq = mstrides[2];
    m.sk = mstrides[3];
    m.heads = heads;
    m.q_rows = q_rows;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? fwd_t<__nv_bfloat16>(x, y, m, mode, rows, n, sq, scale, st)
          : fwd_t<float>(x, y, m, mode, rows, n, sq, scale, st);
  return static_cast<int>(err);
}

// dy, y, dx (rows, n) of dtype
extern "C" int apex_softmax_bwd(const void* dy, const void* y, void* dx,
                                int dtype, int rows, int n, float scale,
                                void* stream) {
  if (!dtype_ok(dtype) || rows < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? bwd_t<__nv_bfloat16>(dy, y, dx, rows, n, scale, st)
          : bwd_t<float>(dy, y, dx, rows, n, scale, st);
  return static_cast<int>(err);
}
