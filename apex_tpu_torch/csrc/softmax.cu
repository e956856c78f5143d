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
// Backward (sk <= 2048), told the forward's mode and mask. A masked
// entry's y is the same all along its row (one exp a row), and on a row
// with a live entry that y is 0 in practice, so its dx is 0 and it adds
// nothing to sum(dy * y). The kernel reads dy and y only in 16-byte chunks
// with a live entry, zeroes a partly masked chunk's masked lanes from the
// mask bits (never from dy * y: a NaN in dy there never reaches the row),
// and writes 0 for every fully masked chunk. It trusts that only after
// reading ONE masked y of the row, the guard (the first masked entry of the
// first lane that has one; its chunk's y is loaded even when all of it is
// masked). A row whose guard is not 0 (a fully masked row, uniform at
// 1/sk; live scaled scores within about 90 of MASK_FILL) is read whole,
// its masked chunks loaded then. One divergence from the reference: a
// non-finite dy at an entry whose y is exactly 0 gives NaN there and a
// finite row here. Bound: bytes, the live entries of dy and y read and dx
// written whole (GPT's causal call: 671 MB, 0.200 ms at 3.35 TB/s). A
// lane holds its chunks of a row as raw 16-byte registers (the dot by
// group shuffles in a fixed order, then dx from the same registers). With
// a mask the warps are persistent and keep the next row's loads in
// flight; without one a warp takes one row group and the grid covers the
// rows (the card then holds as many rows in flight as warps, every byte
// of them read). Rows of at most 16 chunks (T5's decoder, 114 long) go
// four to a warp. A longer row takes a CTA of 256 threads and two passes
// over every entry, whatever the mask.
#include <cmath>
#include <cstdint>
#include <type_traits>

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

// the masked bits of a lane's C chunks of the row at `walk` (bit k of
// chunk c: element (sl + L c) V + k masked): from the row's mask bytes, or
// k > q under causal (which may set bits past n)
template <int kMode, int C, int V, int L>
__device__ __forceinline__ void row_bits(uint32_t* mb, const RowWalk& walk,
                                         const MaskView& m, int sl, int n,
                                         bool active) {
  constexpr uint32_t kAll = (1u << V) - 1;
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
}

// bit k set where element k of a chunk with `left` elements inside the
// row lies past its end
template <int V>
__device__ __forceinline__ uint32_t dead_bits(int left) {
  constexpr uint32_t kAll = (1u << V) - 1;
  return left <= 0 ? kAll : left >= V ? 0u : kAll & ~((1u << left) - 1);
}

// a chunk's packed elements into the row at i0, up to n: 16 bytes, pieces
// of w = 8 or 4 bytes, or (w 0) element by element
template <typename T>
__device__ __forceinline__ void put_chunk(T* row, int i0, int n, int w,
                                          const uint4& out) {
  constexpr int V = apex::Chunk<T>::kVec;
  if (w == 16) {
    *reinterpret_cast<uint4*>(row + i0) = out;
  } else if (w == 8) {
    const int ep = 8 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int p = 0; p < 2; ++p)
      if (p * ep < n - i0)
        reinterpret_cast<uint2*>(row + i0)[p] =
            reinterpret_cast<const uint2*>(&out)[p];
  } else if (w == 4) {
    const int ep = 4 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p * ep < n - i0)
        reinterpret_cast<uint32_t*>(row + i0)[p] =
            reinterpret_cast<const uint32_t*>(&out)[p];
  } else {
    const T* e = reinterpret_cast<const T*>(&out);
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (i0 + k < n) row[i0 + k] = e[k];
  }
}

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
    row_bits<kMode, C, V, L>(mb, walk, m, sl, n, active);
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
      put_chunk<T>(yr, i0, n, w, pack_chunk<T>(v + c * V, inv));
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

// a chunk's elements [0, left) of a row as 16 raw bytes (0 past left):
// one 16-byte load, pieces of w = 8 or 4 bytes, or (w 0) element by
// element
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* src, int left, int w) {
  constexpr int V = apex::Chunk<T>::kVec;
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (w == 16) {
    raw = *reinterpret_cast<const uint4*>(src);
  } else if (w == 8) {
    const int ep = 8 / static_cast<int>(sizeof(T));
    uint2* d = reinterpret_cast<uint2*>(&raw);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      if (p * ep < left) d[p] = reinterpret_cast<const uint2*>(src)[p];
  } else if (w == 4) {
    const int ep = 4 / static_cast<int>(sizeof(T));
    uint32_t* d = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p * ep < left) d[p] = reinterpret_cast<const uint32_t*>(src)[p];
  } else {
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k < left) e[k] = src[k];
  }
  return raw;
}

// element k of a chunk held as 16 raw bytes, in fp32 (no local memory for
// a k known only at run time)
template <typename T>
__device__ __forceinline__ float raw_elem(const uint4& raw, int k) {
  const int i = sizeof(T) == 2 ? k >> 1 : k;
  const uint32_t u = i == 0 ? raw.x : i == 1 ? raw.y : i == 2 ? raw.z : raw.w;
  if constexpr (sizeof(T) == 2)
    return __uint_as_float(k & 1 ? u & 0xffff0000u : u << 16);
  return __uint_as_float(u);
}

// the mask bytes of elements i0 .. i0 + V - 1 of a mask row (i0 >= 0),
// 0 past n, with a key stride of 1 where the rows start on no V-byte
// boundary (T5's (1, 1, 114, 114) triangle): the (at most 3) 4-byte
// words that hold them, each with a byte of the row, shifted into place,
// in place of fetch_mask's V byte loads
template <int V>
__device__ __forceinline__ uint2 mask_words(const uint8_t* mr, int i0,
                                            int n) {
  const int hi = min(i0 + V, n);
  uint2 r = make_uint2(0u, 0u);
  if (i0 >= hi) return r;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(mr + i0);
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(pa & ~uintptr_t{3});
  const int s = static_cast<int>(pa & 3) * 8;
  const int words = (static_cast<int>(pa & 3) + hi - i0 + 3) >> 2;
  const uint32_t w0 = wp[0];
  const uint32_t w1 = words > 1 ? wp[1] : 0u;
  const uint32_t w2 = words > 2 ? wp[2] : 0u;
  uint64_t b = (static_cast<uint64_t>(__funnelshift_r(w1, w2, s)) << 32) |
               __funnelshift_r(w0, w1, s);
  const int keep = hi - i0;
  if (keep < 8) b &= (uint64_t{1} << (8 * keep)) - 1;
  r.x = static_cast<uint32_t>(b);
  r.y = static_cast<uint32_t>(b >> 32);
  return r;
}

// row_bits for the backward: with `words`, a mask is read by mask_words
template <int kMode, int C, int V, int L>
__device__ __forceinline__ void bwd_bits(uint32_t* mb, const RowWalk& walk,
                                         const MaskView& m, int sl, int n,
                                         bool active, bool words) {
  if (kMode == kMask && words) {
    const uint8_t* mr = m.p + walk.b * m.sb + walk.h * m.sh + walk.q * m.sq;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint2 raw = active ? mask_words<V>(mr, (sl + L * c) * V, n)
                               : make_uint2(0u, 0u);
      mb[c] = nonzero_bytes(raw.x) | (nonzero_bytes(raw.y) << 4);
    }
  } else {
    row_bits<kMode, C, V, L>(mb, walk, m, sl, n, active);
  }
}

// dx = scale * y * (dy - sum(dy * y)) over rows walked by warps, G rows a
// warp at a time, as the forward walks them. With D 2 the warps are
// persistent and walk rows grid-stride, the next row's loads in flight
// while a row is reduced; with D 1 (no mask: every byte of a row is read,
// and the card holds as many rows in flight as warps) a warp takes one
// row group and the grid covers the rows. A lane holds chunks l, l + L,
// ... of a row as raw 16-byte registers. A row's masked bits are
// known before its loads are issued; a lane loads dy and y in its chunks
// with a live entry, and the y of the guard's chunk. The dot is each
// lane's chunks in order, then the group's xor shuffles, so dx is the same
// bits from run to run.
template <typename T, int E, int G, int kMode, int D, bool kFull>
__global__ void __launch_bounds__(kThreads)
    softmax_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                       T* __restrict__ dx, MaskView m, int rows, int n,
                       int sq, float scale, int piece, bool words) {
  // every row whole 16-byte chunks (kFull: no code for narrower pieces,
  // fewer registers), else pieces of `piece` bytes
  const int w = kFull ? 16 : piece;
  constexpr int V = apex::Chunk<T>::kVec;
  constexpr int C = E / V;
  constexpr int L = 32 / G;
  constexpr uint32_t kAll = (1u << V) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sl = lane % L;
  // the lanes of this lane's row
  const unsigned group =
      L == 32 ? 0xffffffffu : ((1u << L) - 1) << (lane & ~(L - 1));
  const int stride = gridDim.x * kWarps * G;
  const int base = (blockIdx.x * kWarps + warp) * G;
  if (base >= rows) return;
  const int first = base + lane / L;
  const int count = (rows - base + stride - 1) / stride;
  // the rows load() visits, in order
  RowWalk walk(first, stride, kMode == kMask ? m.q_rows : sq,
               kMode == kMask ? m.heads : 1);

  // a row as a lane holds it: its chunks of dy and y, raw, and their
  // masked bits inside the row
  struct Row {
    uint4 g[C], p[C];
    uint32_t mk[C];
  };

  // the guard's lane: the row's first lane with a masked entry inside the
  // row, -1 where the row has none
  auto guard_lane = [&](const uint32_t* mk) {
    bool has = false;
#pragma unroll
    for (int c = 0; c < C; ++c) has |= mk[c] != 0;
    const unsigned b = __ballot_sync(0xffffffffu, has) & group;
    return b ? __ffs(b) - 1 : -1;
  };

  auto load = [&](Row& row, int it) {
    const int r = first + it * stride;
    const bool active = r < rows;
    const size_t off = static_cast<size_t>(r) * n;
    bwd_bits<kMode, C, V, L>(row.mk, walk, m, sl, n, active, words);
    walk.next();
#pragma unroll
    for (int c = 0; c < C; ++c)
      row.mk[c] = active ? row.mk[c] & ~dead_bits<V>(n - (sl + L * c) * V) &
                               kAll
                         : 0u;
    bool guard = kMode != kNoMask && lane == guard_lane(row.mk);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (sl + L * c) * V;
      const int left = n - i0;  // elements of the chunk inside the row
      if (!active || left <= 0) continue;
      const bool live = (row.mk[c] | dead_bits<V>(left)) != kAll;
      if (live) row.g[c] = load_raw(dy + off + i0, left, w);
      if (live || (guard && row.mk[c] != 0))
        row.p[c] = load_raw(y + off + i0, left, w);
      guard = guard && row.mk[c] == 0;
    }
  };

  auto finish = [&](const Row& row, int it) {
    const int r = first + it * stride;
    const bool active = r < rows;
    const size_t off = static_cast<size_t>(r) * n;
    // the guard's y, shared over the row: the skip holds where it is 0
    bool whole = false;
    if constexpr (kMode != kNoMask) {
      const int gl = guard_lane(row.mk);
      bool look = lane == gl;
      float gy = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (look && row.mk[c] != 0)
          gy = raw_elem<T>(row.p[c], __ffs(row.mk[c]) - 1);
        look = look && row.mk[c] == 0;
      }
      gy = __shfl_sync(0xffffffffu, gy, gl < 0 ? lane : gl);
      whole = active && gy != 0.f;
    }
    // chunk c's dy and y in fp32 (on a whole row a chunk never loaded
    // comes from device memory); returns the bits of its entries left
    // out: past n, and masked where the skip holds (kAll: g and p unset)
    auto values = [&](int c, float* g, float* p) -> uint32_t {
      const int i0 = (sl + L * c) * V;
      const int left = n - i0;
      const uint32_t dead = dead_bits<V>(left);
      if (left > 0 && (row.mk[c] | dead) != kAll) {
        apex::unpack_chunk<T>(row.g[c], g);
        apex::unpack_chunk<T>(row.p[c], p);
        return dead | (whole ? 0u : row.mk[c]);
      }
      if (left <= 0 || !whole) return kAll;
      apex::unpack_chunk<T>(load_raw(dy + off + i0, left, w), g);
      apex::unpack_chunk<T>(load_raw(y + off + i0, left, w), p);
      return dead;
    };
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float g[V], p[V];
      const uint32_t out = values(c, g, p);
      if (out == kAll) continue;
#pragma unroll
      for (int k = 0; k < V; ++k)
        dot += ((out >> k) & 1u) ? 0.f : g[k] * p[k];
    }
    dot = group_reduce<L, false>(dot);
    if (!active) return;
    T* dxr = dx + off;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int i0 = (sl + L * c) * V;
      if (i0 >= n) continue;
      float g[V], p[V], v[V];
      const uint32_t out = values(c, g, p);
      if (out == kAll) {  // every entry masked: dx 0, nothing to pack
        put_chunk<T>(dxr, i0, n, w, make_uint4(0u, 0u, 0u, 0u));
        continue;
      }
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[k] = ((out >> k) & 1u) ? 0.f : scale * p[k] * (g[k] - dot);
      put_chunk<T>(dxr, i0, n, w, pack_chunk<T>(v, 1.f));
    }
  };

  Row cur;
  load(cur, 0);
  for (int it = 0; it < count; ++it) {
    if constexpr (D == 2) {  // the next row's loads issued first
      Row next;
      if (it + 1 < count) load(next, it + 1);
      finish(cur, it);
      cur = next;
    } else {
      if (it > 0) load(cur, it);
      finish(cur, it);
    }
  }
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

// CTAs of `kernel` (kThreads threads, `smem` bytes of dynamic shared
// memory) the card holds at once
template <typename K>
int resident_ctas(K kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// the grids: every CTA resident at once (its warps walk the rows), or
// fewer when the rows run out
template <typename T, int E, int G, int kMode>
int fwd_blocks(int rows) {
  static const int resident = resident_ctas(
      softmax_fwd_kernel<T, E, G, kMode>, fwd_smem(E / apex::Chunk<T>::kVec));
  return min((rows + kWarps * G - 1) / (kWarps * G), resident);
}

// rows a lane holds at once in the backward: the row it reduces, and with
// a mask the next one, whose loads are in flight
constexpr int bwd_depth(int mode) { return mode == kNoMask ? 1 : 2; }


template <typename T, int E, int G, int kMode, int D, bool kFull>
int bwd_blocks(int rows) {
  const int all = (rows + kWarps * G - 1) / (kWarps * G);
  if constexpr (D == 1) return all;
  static const int resident =
      resident_ctas(softmax_bwd_kernel<T, E, G, kMode, D, kFull>, 0);
  return min(all, resident);
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

template <typename T, int E, int G, int kMode>
void bwd_launch(const T* dy, const T* y, T* dx, const MaskView& m, int rows,
                int n, int sq, float scale, int w, bool words,
                cudaStream_t st) {
  constexpr int D = bwd_depth(kMode);
  if (w == 16)
    softmax_bwd_kernel<T, E, G, kMode, D, true>
        <<<bwd_blocks<T, E, G, kMode, D, true>(rows), kThreads, 0, st>>>(
            dy, y, dx, m, rows, n, sq, scale, w, words);
  else
    softmax_bwd_kernel<T, E, G, kMode, D, false>
        <<<bwd_blocks<T, E, G, kMode, D, false>(rows), kThreads, 0, st>>>(
            dy, y, dx, m, rows, n, sq, scale, w, words);
}

// the widest piece (16, 8 or 4 bytes; 0: none) that every row of x and y
// starts on and ends on
int piece_bytes(const void* x, const void* y, int n, int es) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(y) |
                      static_cast<uintptr_t>(n) * es;
  return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 0;
}

// launch(E, G) with the warp kernels' elements a lane and rows a warp for
// rows of n, as std::integral_constants; false for a row too long for a
// warp
template <typename T, typename F>
bool by_width(int n, F&& launch) {
  constexpr int V = apex::Chunk<T>::kVec;
  using I8 = std::integral_constant<int, 8>;
  using G1 = std::integral_constant<int, 1>;
  switch (lane_elems<T>(n)) {
    case 8:
      if ((n + V - 1) / V <= 16)
        launch(I8{}, std::integral_constant<int, 2>{});
      else
        launch(I8{}, G1{});
      return true;
    case 16:
      launch(std::integral_constant<int, 16>{}, G1{});
      return true;
    case 32:
      launch(std::integral_constant<int, 32>{}, G1{});
      return true;
    case 64:
      launch(std::integral_constant<int, 64>{}, G1{});
      return true;
  }
  return false;
}

template <typename T, int kMode>
cudaError_t fwd_mode(const void* x, void* y, const MaskView& m, int rows,
                     int n, int sq, float scale, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int w = piece_bytes(x, y, n, sizeof(T));
  const float scale2 = scale * kLog2e;
  if (!by_width<T>(n, [&](auto e, auto g) {
        fwd_launch<T, decltype(e)::value, decltype(g)::value, kMode>(
            xp, yp, m, rows, n, sq, scale2, w, st);
      }))
    softmax_fwd_long_kernel<T, kMode><<<rows, kLongThreads, 0, st>>>(
        xp, yp, m, n, sq, scale);
  return cudaGetLastError();
}

// by_width for the backward: rows of at most 16 blocks go 4 to a warp
// (8 lanes a row, 1 or 2 blocks a lane), so a warp has more bytes in
// flight a step
template <typename T, typename F>
bool bwd_width(int n, F&& launch) {
  constexpr int V = apex::Chunk<T>::kVec;
  const int blocks = (n + V - 1) / V;
  if (blocks <= 8) {
    launch(std::integral_constant<int, V>{}, std::integral_constant<int, 4>{});
    return true;
  }
  if (blocks <= 16) {
    launch(std::integral_constant<int, 2 * V>{},
           std::integral_constant<int, 4>{});
    return true;
  }
  return by_width<T>(n, launch);
}

template <typename T, int kMode>
cudaError_t bwd_mode(const void* dy, const void* y, void* dx,
                     const MaskView& m, int rows, int n, int sq, float scale,
                     cudaStream_t st) {
  const T* dyp = static_cast<const T*>(dy);
  const T* yp = static_cast<const T*>(y);
  T* dxp = static_cast<T*>(dx);
  const int w = min(piece_bytes(dy, y, n, sizeof(T)),
                    piece_bytes(dx, dx, n, sizeof(T)));
  // every mask row on a V-byte boundary: fetch_mask's one load a chunk;
  // else words (a per-launch choice, so no warp splits between the two)
  const bool words =
      kMode == kMask && m.sk == 1 &&
      (reinterpret_cast<uintptr_t>(m.p) | m.sb | m.sh | m.sq) %
              apex::Chunk<T>::kVec !=
          0;
  if (!bwd_width<T>(n, [&](auto e, auto g) {
        bwd_launch<T, decltype(e)::value, decltype(g)::value, kMode>(
            dyp, yp, dxp, m, rows, n, sq, scale, w, words, st);
      }))  // every entry read, whatever the mask
    softmax_bwd_long_kernel<T><<<rows, kLongThreads, 0, st>>>(
        dyp, yp, dxp, n, scale);
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
cudaError_t bwd_t(const void* dy, const void* y, void* dx, const MaskView& m,
                  int mode, int rows, int n, int sq, float scale,
                  cudaStream_t st) {
  if (mode == kCausal)
    return bwd_mode<T, kCausal>(dy, y, dx, m, rows, n, sq, scale, st);
  if (mode == kMask)
    return bwd_mode<T, kMask>(dy, y, dx, m, rows, n, sq, scale, st);
  return bwd_mode<T, kNoMask>(dy, y, dx, m, rows, n, sq, scale, st);
}

bool dtype_ok(int dtype) {
  return dtype == apex::kFloat32 || dtype == apex::kBFloat16;
}

// the mask arguments of both entries as a MaskView; false where they are
// out of range
bool mask_view(const void* mask, const long long* mstrides, int heads,
               int q_rows, int mode, int sq, MaskView* m) {
  if (mode < kNoMask || mode > kMask || (mode == kCausal && sq < 1) ||
      (mode == kMask && (mask == nullptr || mstrides == nullptr ||
                         heads < 1 || q_rows < 1)))
    return false;
  *m = MaskView{static_cast<const uint8_t*>(mask), 0, 0, 0, 0, 1, 1};
  if (mode == kMask) {
    for (int i = 0; i < 4; ++i)
      if (mstrides[i] < 0) return false;
    m->sb = mstrides[0];
    m->sh = mstrides[1];
    m->sq = mstrides[2];
    m->sk = mstrides[3];
    m->heads = heads;
    m->q_rows = q_rows;
  }
  return true;
}

}  // namespace

// x, y (rows, n) of dtype. mode 0: no mask; 1: causal, q = row % sq;
// 2: mask (bool bytes) at strides mstrides = (b, h, q, k) in bytes over
// x's rows seen as (b, heads, q_rows).
extern "C" int apex_softmax_fwd(const void* x, void* y, const void* mask,
                                const long long* mstrides, int heads,
                                int q_rows, int dtype, int mode, int rows,
                                int n, int sq, float scale, void* stream) {
  MaskView m;
  if (!dtype_ok(dtype) || rows < 1 || n < 1 ||
      !mask_view(mask, mstrides, heads, q_rows, mode, sq, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? fwd_t<__nv_bfloat16>(x, y, m, mode, rows, n, sq, scale, st)
          : fwd_t<float>(x, y, m, mode, rows, n, sq, scale, st);
  return static_cast<int>(err);
}

// dy, y, dx (rows, n) of dtype; the forward's mode and mask arguments, as
// apex_softmax_fwd takes them: the masked entries the forward filled are
// not read where the row's guard is 0
extern "C" int apex_softmax_bwd(const void* dy, const void* y, void* dx,
                                const void* mask, const long long* mstrides,
                                int heads, int q_rows, int dtype, int mode,
                                int rows, int n, int sq, float scale,
                                void* stream) {
  MaskView m;
  if (!dtype_ok(dtype) || rows < 1 || n < 1 ||
      !mask_view(mask, mstrides, heads, q_rows, mode, sq, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == apex::kBFloat16
          ? bwd_t<__nv_bfloat16>(dy, y, dx, m, mode, rows, n, sq, scale, st)
          : bwd_t<float>(dy, y, dx, m, mode, rows, n, sq, scale, st);
  return static_cast<int>(err);
}
