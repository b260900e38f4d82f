// Hopper (sm_90a) building blocks shared by the kernel routes of csrc/flat_scan.cu,
// csrc/rerank.cu and csrc/sq_probe.cu: mbarriers, 2-D tensor-map TMA loads,
// wgmma shared-memory descriptors and fences, 16-byte cp.async copies, the
// m16n8k16 bf16 mma.sync, the exact int8 -> bf16 widening of a word, and the
// host-side tensor-map encoder.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int BOX_COLS = 64;  // elements a box row: one 128-byte swizzle row of bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

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

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One box of a 2-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written with the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma
// fence, commit or wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 16 bytes from global into shared memory, asynchronously; the bytes past
// `src_bytes` (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a * b for one m16n8k16 tile, bf16 operands, fp32 accumulation.  With
// g = lane / 4, q = lane % 4: a[0] holds (row g, k 2q, 2q+1), a[1] row g+8,
// a[2] (row g, k 2q+8, 2q+9), a[3] row g+8; b0 (k 2q, 2q+1; n g), b1 k+8;
// d (row g, n 2q, 2q+1), then row g+8.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (one word) -> four exact bf16 (two words).  |x| <= 128 goes into
// the mantissa of +-128 (bf16 bits 0x4300 + |x|, which is 128 + |x| for |x|
// up to 128), and +-128 is subtracted: both steps exact.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t sign = w & 0x80808080u;
  const uint32_t one = sign >> 7;                      // 1 in each negative byte
  const uint32_t mag = (w ^ (one * 0xFFu)) + one;      // |x| a byte, no carries
  const uint32_t top = sign | 0x43434343u;             // bf16 high byte of +-128
  const uint32_t v[2] = {__byte_perm(mag, top, 0x5140), __byte_perm(mag, top, 0x7362)};
  const uint32_t b[2] = {__byte_perm(0u, top, 0x5140), __byte_perm(0u, top, 0x7362)};
  uint32_t r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&v[i]);
    __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&b[i]);
    __nv_bfloat162 z = __hsub2(x, y);
    r[i] = *reinterpret_cast<uint32_t*>(&z);
  }
  lo = r[0];
  hi = r[1];
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query, so
// a library links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (rows, cols) row-major map cut into (box_rows, 64) boxes; zero fill out of
// bounds.  bf16 boxes carry the 128-byte swizzle, int8 boxes none.
inline bool make_map(CUtensorMap* map, const void* ptr, bool int8, uint64_t rows, uint64_t cols,
                     uint32_t box_rows) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (int8 ? 1 : 2)};
  const cuuint32_t box[2] = {uint32_t(BOX_COLS), box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
