// Hopper (sm_90a) building blocks of the port's kernels: TMA tensor maps
// of rank 2 to 4, tile loads and bulk stores, mbarriers and named
// barriers, the wgmma shared-memory descriptor and the bf16 and fp16 wgmma
// with fp32 accumulators (m64n128k16 and m64n64k16 with both operands in shared
// memory, with and without the accumulator's input; m64n64k16 and
// m64n128k16 with A in registers), setmaxnreg, and 1-D bulk copies,
// cluster ranks and barriers and distributed shared-memory stores and
// mbarrier arrivals.
// The GEMM (matmul_bias_act.cu), the flash kernels and the decode
// attention (paged_decode_attn.cu) use them.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle and
// read by wgmma through a descriptor of the same swizzle, so neither side
// computes a swizzled address. A tile's base must be 1024-byte aligned
// (the swizzle's period: 8 rows of 128 bytes). Per operand:
//   K-major  (the operand's contiguous axis is K): rows of 64 bf16 along
//     K, 128 bytes each, one row per M (or N) index; the descriptor's
//     stride byte offset is 1024 (8 rows), its leading byte offset unused;
//     the k-th 16-deep slice starts 32 * k bytes into the tile.
//   MN-major (contiguous along M or N): rows of 64 bf16 along M (N), one
//     row per K index, in boxes of 64 K rows (8 KB); the stride byte
//     offset is 1024 (8 K rows), the leading byte offset the distance of
//     two 64-wide M (N) boxes; the k-th 16-deep slice starts 2048 * k
//     bytes in. The wgmma's transpose bit marks the operand MN-major.
// (PTX ISA, "Matrix Descriptor Format" and "Shared Memory Matrix Layout";
// CUTLASS's make_gmma_desc computes the same offsets.)
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace apex {
namespace sm90 {

// --- host: tensor maps ------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a CUDA driver API function, looked up through
// the CUDA runtime so the library links no -lcuda; null where the
// installed CUDA driver lacks it
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// cuTensorMapEncodeTiled needs the device's context current on the
// calling thread. A thread whose first CUDA call is an encode (an autograd
// worker running a backward whose first op is a kernel of this library)
// has none until a runtime call binds the primary context: make one, once
// per thread.
inline void bind_context() {
  thread_local bool bound = false;
  if (!bound) {
    cudaFree(nullptr);
    bound = true;
  }
}

// A tensor map of rank `rank` (2-4) over `base` (16-byte aligned):
// dims[0] elements along the contiguous axis, strides[i] the byte stride
// of axis i + 1 (each a multiple of 16), loaded in boxes of box[0..rank)
// (with the 128-byte swizzle, box[0] elements span at most 128 bytes).
// Elements past an extent read as zero. An axis of extent 1 is never
// stepped: its stride is replaced by one the encoder accepts, the largest
// span of the others (so an operand of one row gets a valid row stride).
inline bool make_tensor_map(CUtensorMap* map, CUtensorMapDataType dtype,
                            int rank, const void* base,
                            const long long* dims, const long long* strides,
                            const int* box, CUtensorMapSwizzle swizzle) {
  bind_context();
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr || rank < 2 || rank > 4 ||
      reinterpret_cast<uintptr_t>(base) % 16)
    return false;
  const long long elem = dtype == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], el[4];
  long long span = dims[0] * elem;  // bytes an extent-1 axis's stride takes
  for (int i = 0; i < rank - 1; ++i)
    if (dims[i + 1] > 1 && strides[i] * dims[i + 1] > span)
      span = strides[i] * dims[i + 1];
  for (int i = 0; i < rank; ++i) {
    if (dims[i] < 1 || box[i] < 1 || box[i] > 256) return false;
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    el[i] = 1;
    if (i + 1 < rank) {
      const long long s = dims[i + 1] > 1 ? strides[i] : (span + 15) / 16 * 16;
      if (s < 16 || s % 16) return false;
      st[i] = static_cast<cuuint64_t>(s);
    }
  }
  return encode(map, dtype, static_cast<cuuint32_t>(rank),
                const_cast<void*>(base), d, st, bx, el,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D bf16 tensor map with the 128-byte swizzle: `inner` elements along
// the contiguous axis, `outer` rows `ld` elements apart, boxes of
// box_inner x box_outer
inline bool make_tensor_map_bf16(CUtensorMap* map, const void* base,
                                 long long inner, long long outer,
                                 long long ld, int box_inner,
                                 int box_outer) {
  const long long dims[2] = {inner, outer};
  const long long strides[1] = {ld * 2};
  const int box[2] = {box_inner, box_outer};
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// --- device: addresses, mbarriers, TMA ------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and expect `bytes` more of transactions (the TMA loads' bytes)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// box (c_inner, c_outer) of `map` into shared memory at dst; completion
// counted on `bar` in bytes
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            int c_inner, int c_outer,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c_inner), "r"(c_outer),
      "r"(bar)
      : "memory");
}

// box (c0, c1, c2) of a rank-3 map into shared memory at dst
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// box (c0, c1, c2, c3) of a rank-4 map into shared memory at dst
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// 4-byte global -> shared copy; complete after cp_async_wait_all
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 8-byte global -> shared copy; complete after cp_async_wait_all
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// box (c_inner, c_outer) of `map` from shared memory at src, in this
// thread's bulk group; elements past the tensor's extents are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c_inner,
                                             int c_outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c_inner), "r"(c_outer)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until this thread's bulk stores have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// make this thread's shared-memory writes visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15) over `threads` threads, e.g. one warpgroup
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// --- device: 1-D bulk copies and thread-block clusters ---------------------

// `bytes` (a multiple of 16) from global memory at src into shared memory
// at dst, both 16-byte aligned, by the bulk-copy engine (no tensor map);
// completion counted on `bar` in bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// this CTA's rank in its cluster (0 without a cluster launch)
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier, split: every thread of every CTA of the cluster
// arrives, later waits (acquire) until all have arrived; every thread of a
// warp executes both. The arrive is relaxed: it orders none of the
// thread's memory operations, so it waits for none of them (an mbarrier's
// initialisation reaches the cluster by fence_barrier_init instead)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address, in the CTA of rank `rank`, of what sits at
// shared address `addr` in this CTA (distributed shared memory)
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr,
                                                uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another CTA's shared memory (an address of cluster_map)
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// arrive on another CTA's mbarrier (an address of cluster_map), releasing
// at cluster scope what this thread wrote and saw before
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// mbar_wait with an acquire at cluster scope: what the arrivals of other
// CTAs released (their writes into this CTA's shared memory) is seen after
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// --- device: wgmma --------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at shared address `addr`
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The wgmma statements, by the operands' type TY ("bf16" or "f16"; the
// accumulators fp32 either way): one text for both types' instances.
#define APEX_WGMMA_M64N128K16_SS(TY)                                \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                            \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                      \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                    \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                    \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                    \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                    \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                    \
      "%56, %57, %58, %59, %60, %61, %62, %63"                      \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                        \
      :                                                             \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),             \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),             \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),         \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),         \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),         \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),         \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),         \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])          \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));

#define APEX_WGMMA_M64N64K16_SS(TY)                                \
  asm volatile(                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                   \
      "%24, %25, %26, %27, %28, %29, %30, %31"                     \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"                       \
      :                                                            \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])         \
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));

#define APEX_WGMMA_M64N64K16_RS(TY)                                  \
  asm volatile(                                                      \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                   \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"   \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                             \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                       \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                     \
      "%24, %25, %26, %27, %28, %29, %30, %31"                       \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"             \
      :                                                              \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),              \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),              \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),            \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),          \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), \
        "n"(TB));

#define APEX_WGMMA_M64N128K16_RS(TY)                                 \
  asm volatile(                                                      \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                   \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                             \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                       \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                     \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                     \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                     \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                     \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                     \
      "%56, %57, %58, %59, %60, %61, %62, %63"                       \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"             \
      :                                                              \
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),              \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),              \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),            \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),          \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),          \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),          \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),          \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),          \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),          \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),          \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),          \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),          \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), \
        "n"(TB));

// d (64 x 128, fp32, the warpgroup's fragment) = A (64 x 16) B (16 x 128)
// [+ d when scale_d], both T (bf16 or fp16) in shared memory; TA / TB: the
// operand is MN-major. Fragment of d (any N): warp w of the warpgroup holds rows
// 16w..16w+15; lane l, with g = l / 4 and t = l % 4, holds d[4i], d[4i+1]
// at row g, columns 8i + 2t, 8i + 2t + 1, and d[4i+2], d[4i+3] at row g + 8.
template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                  uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    APEX_WGMMA_M64N128K16_SS("f16");
  } else {
    APEX_WGMMA_M64N128K16_SS("bf16");
  }
}

// d (64 x 64, fp32, the warpgroup's fragment) = A (64 x 16) B (16 x 64)
// [+ d when scale_d], both T in shared memory; TA / TB: MN-major
template <int TA, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                  uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value) {
    APEX_WGMMA_M64N64K16_SS("f16");
  } else {
    APEX_WGMMA_M64N64K16_SS("bf16");
  }
}

// d (64 x 64, fp32) += A (64 x 16, T from registers: the fragment of a
// 64 x 16 slice of an m64nN accumulator, see wgmma_a_frag) B (16 x 64, T
// in shared memory); TB: B is MN-major
template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    APEX_WGMMA_M64N64K16_RS("f16");
  } else {
    APEX_WGMMA_M64N64K16_RS("bf16");
  }
}

// d (64 x 128, fp32) += A (64 x 16, T from registers: the fragment of a
// 64 x 16 slice of an m64nN accumulator, see wgmma_a_frag) B (16 x 128, T
// in shared memory); TB: B is MN-major
template <int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  if constexpr (std::is_same<T, __half>::value) {
    APEX_WGMMA_M64N128K16_RS("f16");
  } else {
    APEX_WGMMA_M64N128K16_RS("bf16");
  }
}


// The A fragment (T pairs, rounded to nearest) of the k-th 16-column slice
// of an m64nN fp32 accumulator: a warp's 16 x 16 block in mma.sync's A
// layout, which is what a register-A wgmma takes (rows g and g + 8,
// columns 2t and 2t + 8 of the slice), so a product's result feeds the
// next product without a shuffle.
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_a_frag(uint32_t (&a)[4],
                                             const float (&d)[N], int k) {
  if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 v = __floats2half2_rn(d[8 * k + 2 * i],
                                          d[8 * k + 2 * i + 1]);
      a[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    return;
  }
  const __nv_bfloat162 v0 = __floats2bfloat162_rn(d[8 * k], d[8 * k + 1]);
  const __nv_bfloat162 v1 = __floats2bfloat162_rn(d[8 * k + 2], d[8 * k + 3]);
  const __nv_bfloat162 v2 = __floats2bfloat162_rn(d[8 * k + 4], d[8 * k + 5]);
  const __nv_bfloat162 v3 = __floats2bfloat162_rn(d[8 * k + 6], d[8 * k + 7]);
  a[0] = *reinterpret_cast<const uint32_t*>(&v0);
  a[1] = *reinterpret_cast<const uint32_t*>(&v1);
  a[2] = *reinterpret_cast<const uint32_t*>(&v2);
  a[3] = *reinterpret_cast<const uint32_t*>(&v3);
}

// keep the compiler from moving reads or writes of the accumulators
// across this point (else ptxas serialises the wgmma pipeline)
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}


// hand registers back to (dec) or take them from (inc) the SM's pool;
// every warp of the warpgroup executes it
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace sm90
}  // namespace apex
