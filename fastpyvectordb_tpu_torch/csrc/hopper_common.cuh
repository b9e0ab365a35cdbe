// Hopper (sm_90a) building blocks shared by the port's kernels: mbarrier,
// TMA (tensor and bulk copies), cp.async, wgmma and tensor-map helpers as
// plain inline PTX.  hopper_scan.cuh (B1, B4, B5, B6),
// grouped_cell_scores.cu (B2, B3) and grouped_cell_scores_pq.cu (B7) are
// built on them.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fpv {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// arrive once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// a barrier among `count` threads of the block (ids 1.. ; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
      "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// all but the issuing thread's last N groups of TMA stores have read their
// shared-memory source
template <int N = 0>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// 16 bytes global -> shared, asynchronously (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

// 4 bytes global -> shared, asynchronously; `bytes` (0 or 4) are read and
// the rest of the word is zero-filled
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// generic-proxy shared-memory writes made visible to TMA (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator or fragment accesses across a
// wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the 128 accumulator operands of an m64n256 wgmma, as PTX text and as asm
// operands of d[0..127] with constraint C ("+f" or "+r")
#define FPV_D128 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127" "}"
#define FPV_ACC8(C, i)                                                     \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define FPV_ACC64(C, i)                                                    \
  FPV_ACC8(C, i), FPV_ACC8(C, i + 8), FPV_ACC8(C, i + 16),                 \
      FPV_ACC8(C, i + 24), FPV_ACC8(C, i + 32), FPV_ACC8(C, i + 40),       \
      FPV_ACC8(C, i + 48), FPV_ACC8(C, i + 56)
#define FPV_ACC128(C) FPV_ACC64(C, 0), FPV_ACC64(C, 64)
// the same for the narrower m64nN shapes (N / 2 accumulators a thread)
#define FPV_D8 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7" \
  "}"
#define FPV_D16 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}"
#define FPV_D32 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}"
#define FPV_D64 "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define FPV_ACC16(C, i) FPV_ACC8(C, i), FPV_ACC8(C, i + 8)
#define FPV_ACC32(C, i) FPV_ACC16(C, i), FPV_ACC16(C, i + 16)
#define FPV_F(x) "+f"(x)
#define FPV_R(x) "+r"(x)

// wgmma matrix descriptor of a K-major tile in 128-byte-swizzled rows of
// 128 bytes: 8-row groups 1024 bytes apart (SBO); LBO unused for this
// layout.  Advancing 32 bytes along K adds 2 to the address field.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFu) >> 4) | (uint64_t(1) << 16) | (uint64_t(64) << 32) |
         (uint64_t(1) << 62);
}

// byte offset of the 16-byte chunk `c` of row `r` in a 128B-swizzled tile
// (the layout TMA's CU_TENSOR_MAP_SWIZZLE_128B reads and writes)
__device__ __forceinline__ int sw128_chunk(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// exact float of an integer in [0, 2^23): one OR and one subtraction
__device__ __forceinline__ float small_uint_to_float(uint32_t x) {
  return __uint_as_float(0x4B000000u | x) - 8388608.0f;
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// a 2-D row-major (rows, cols) tensor map with 128-byte swizzled boxes
inline bool encode_2d(CUtensorMap* map, CUtensorMapDataType type,
                      int elem_bytes, const void* ptr, int rows, int cols,
                      int box_rows, int box_cols) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * elem_bytes};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 3-D row-major (blocks, rows, cols) tensor map with 128-byte swizzled
// boxes of (1, box_rows, box_cols): a box never runs into the next block,
// and what lies past `rows` or `cols` is zero-filled (loads) or clipped
// (stores)
inline bool encode_3d(CUtensorMap* map, CUtensorMapDataType type,
                      int elem_bytes, const void* ptr, int blocks, int rows,
                      int cols, int box_rows, int box_cols) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(blocks)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * elem_bytes,
                                 cuuint64_t(rows) * cols * elem_bytes};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace fpv
