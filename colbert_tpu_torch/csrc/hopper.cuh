// Hopper (sm_90a) building blocks shared by the kernel routes of csrc/flat_scan.cu,
// csrc/rerank.cu and csrc/sq_probe.cu: mbarriers, 2-D tensor-map TMA loads,
// wgmma shared-memory descriptors and fences, 16-byte cp.async copies, a
// producer's own tile copies where no tensor map describes a tile, the
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

// ---- a producer's own copies, where no tensor map describes a tile: rows
// whose pitch is not a multiple of 16 bytes, or a last column chunk that a
// map's box would read past its row (into the next row, and past the table
// at its last row) ----

// The widest piece (16, 8, 4, 2 or 1 bytes) to which every row of
// `row_bytes` bytes from a 16-byte aligned base is aligned.
__host__ __device__ inline int copy_width(long long row_bytes) {
  int w = 16;
  while (w > 1 && row_bytes % w) w >>= 1;
  return w;
}

// A piece of W bytes at shared `dst`: its first n (0..W) bytes from global
// `src`, the rest zero.  cp.async (zero-filled past n) for W >= 4; a load and
// a store below, where cp.async has no size.  n = 0 reads nothing.
template <int W>
__device__ __forceinline__ void copy_piece(uint32_t dst, const unsigned char* src, int n) {
  if constexpr (W == 1) {
    const unsigned short x = n ? *src : (unsigned short)0;
    asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
  } else if constexpr (W == 2) {
    const unsigned short x = n ? *reinterpret_cast<const unsigned short*>(src) : (unsigned short)0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
  } else if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(W), "r"(n) : "memory");
  }
}

// Rows 0..ROWS-1 of a tile, UNITS 16-byte units each, by thread t of nt:
// row r's data are the first `nb` bytes at src + r * pitch (none for r >=
// valid_rows), unit u lands at dst + off(r, u), every byte past the data is
// zero.  Issues the copies in pieces of W bytes; the caller commits, waits
// and fences.  `src` itself must be readable (a row and column the tile
// starts at): a unit with nothing to read passes it and reads nothing.
template <int W, int ROWS, int UNITS, typename OFF>
__device__ __forceinline__ void copy_tile_w(uint32_t dst, const unsigned char* src, long long pitch,
                                            int valid_rows, int nb, int t, int nt, OFF off) {
#pragma unroll 1
  for (int i = t; i < ROWS * UNITS; i += nt) {
    const int r = i / UNITS, u = i % UNITS;
    const int b = r < valid_rows ? min(max(nb - 16 * u, 0), 16) : 0;
    const unsigned char* s = b ? src + r * pitch + 16 * u : src;
    const uint32_t d = dst + off(r, u);
#pragma unroll
    for (int p = 0; p < 16; p += W) {
      const int n = min(max(b - p, 0), W);
      copy_piece<W>(d + p, n ? s + p : src, n);
    }
  }
}

// copy_tile_w at the piece width `w` (copy_width of the rows' pitch).
template <int ROWS, int UNITS, typename OFF>
__device__ __forceinline__ void copy_tile(int w, uint32_t dst, const unsigned char* src, long long pitch,
                                          int valid_rows, int nb, int t, int nt, OFF off) {
  switch (w) {
    case 16: copy_tile_w<16, ROWS, UNITS>(dst, src, pitch, valid_rows, nb, t, nt, off); break;
    case 8: copy_tile_w<8, ROWS, UNITS>(dst, src, pitch, valid_rows, nb, t, nt, off); break;
    case 4: copy_tile_w<4, ROWS, UNITS>(dst, src, pitch, valid_rows, nb, t, nt, off); break;
    case 2: copy_tile_w<2, ROWS, UNITS>(dst, src, pitch, valid_rows, nb, t, nt, off); break;
    default: copy_tile_w<1, ROWS, UNITS>(dst, src, pitch, valid_rows, nb, t, nt, off); break;
  }
}

// A copying thread's hand-off of its stages of a ring of `stages`: after
// issuing the copies of a stage, commit them; once more than LAG stages are
// pending, wait for the oldest, make it visible to the tensor cores
// (fence.proxy.async: wgmma reads shared memory through the async proxy)
// and arrive on its barrier.  `pending` counts the stages issued and not yet
// handed over, `oldest` is the ring slot of the first of them.  LAG stages
// stay in flight, so the copies overlap the products; LAG must stay below
// the ring's depth, or the thread would wait for a stage it holds itself.
// Before a wait on another barrier that the consumers release only after
// the pending stages, drain.
template <int LAG>
__device__ __forceinline__ void copies_issued(int& pending, int& oldest, uint64_t* full, int stages) {
  cp_async_commit();
  if (++pending > LAG) {
    cp_async_wait<LAG>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&full[oldest]);
    if (++oldest == stages) oldest = 0;
    --pending;
  }
}

// The hand-off of every pending stage.
__device__ __forceinline__ void copies_drained(int& pending, int& oldest, uint64_t* full, int stages) {
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  for (; pending > 0; --pending) {
    mbar_arrive(&full[oldest]);
    if (++oldest == stages) oldest = 0;
  }
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
