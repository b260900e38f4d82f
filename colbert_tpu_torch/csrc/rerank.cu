// Fused candidate gather + exact MaxSim rerank for Hopper (sm_90a), bound with ctypes.
//
// Replaces two TPU kernels of colbert_tpu/ops/rerank_pallas.py:
//   K4  _kernel         (rerank_pallas.py:26, pallas_call :294, reached through
//       maxsim_rerank_uniform): bf16 table, queries rounded to bf16;
//   K5  _kernel_packed  (rerank_pallas.py:65, pallas_call :157, reached through
//       maxsim_rerank_uniform_packed): int8 table, fp32 queries with the
//       per-dim descale folded in by the caller.
// Each route below serves both, templated on the table type.
//
// What it computes, for candidates cand (B, C) int32 (-1 = none), queries
// Q (B, qv, dim) fp32 and a doc-major table (num_docs * dv, dim) whose doc p
// occupies rows [p*dv, (p+1)*dv):
//   out[b, c] = sum over the qv query rows of max over the dv doc rows of
//               table[row] . Q[b, view]                   fp32 accumulation,
// and -inf where cand[b, c] < 0; such a candidate moves no bytes.  Any C.
// Numerics: K4 multiplies bf16(Q) by the bf16 table (the TPU kernel casts Q
// to bf16); the products are exact in fp32.  K5 keeps Q in fp32, as the TPU
// kernel does: Q is split into three bf16 terms whose sum is Q to fp32
// precision, and each int8 value is an exact bf16 integer, so three bf16
// products accumulated in fp32 give the fp32 dot.
//
// What bounds it: at the serving point (144 queries x 4,096 candidates, 16 x
// 768) the pairs name ~20,000 distinct docs, each ~19 times: 0.49 GB of
// distinct bf16 doc blocks against 9.26 GB if every (query, candidate) pair
// fetched its block from device memory.  The operations (16 FLOP a byte of
// pair blocks, 3x that for K5's three terms) sit below the ridge, so bytes
// bound it: the distinct docs from device memory once, and the pair blocks
// streamed from L2 into the SMs.
//
// Route "wgmma" (dv = 16 rows a doc, qv = 16 views: the serving shape; any
// dim up to 1,024 over a bf16 table, a multiple of 64 over int8),
// query-stationary blocks over pid-windowed candidates:
// * The wrapper (ops/rerank.py) sorts each query's candidates by pid (-1
//   last, the permutation kept), cuts the pid space into windows of W docs
//   and finds each query's first sorted candidate in each window: all on the
//   device, no host synchronisation.  A work item is (window w, query b).
// * A persistent grid walks the items window-major, so the ~144 queries'
//   candidates in one window are in flight together and each doc block of
//   the window comes from device memory about once a batch; W is chosen so
//   that about two windows of blocks fit in half the L2.  Empty items exit
//   at once.
// * The item's query sits in shared memory as the wgmma B operand (n = 16:
//   bf16(Q); n = 48 for K5: its three bf16 terms side by side), loaded once
//   an item by TMA (two buffers for K4, so the next item's query loads while
//   this one's docs stream); the wrapper pads its dims with zeros to whole
//   64-dim chunks.
// * The item's candidates stream in groups of 8 docs through a ring of
//   stages fed by TMA from a 3-D tensor map over the table (128-byte column
//   chunk x row x chunk index, the chunk index outermost): one box a doc a
//   stage, its 16 rows x 3 chunks (192 dims) of bf16 or 2 chunks (256 dims)
//   of int8, landing chunk-major in the 128-byte swizzle.  The TMA path
//   takes about the same time a box whatever its bytes, so boxes are large:
//   with one 16 x 64 box a doc a 64-dim stage K4 took 1.8-2.3 ms, with these
//   1.4 (NVIDIA H100 80GB HBM3, 700.00 W).  Four producer threads, one a
//   warp, issue the boxes.
// * A bf16 dim that is not whole 64-dim chunks (312: 4 chunks and 56 dims)
//   has a last chunk the map cannot describe: its box would read the next
//   row's first dims (past the table at its last row), and a NaN there times
//   a zero query dim is NaN.  There the four producer warps copy the boxes
//   themselves (hopper.cuh::copy_tile), doc d by warp d % 4, in cp.async
//   pieces as wide as the rows' alignment allows, into the same swizzled
//   chunk-major layout, with zeros past dim; two stages stay in flight, and
//   each item's are handed over before the next item's wait on its query
//   buffer.
// * A doc a consumer warp: with m64 a warp owns 16 accumulator rows, so each
//   warp loads its own doc's A fragments from its box into registers
//   (ldmatrix on the swizzled bf16 rows; for int8, 32-bit loads widened
//   exactly to bf16 in registers: no widened copy in shared memory), frees
//   the stage, and the two consumer warpgroups issue wgmma m64n16k16 (K4) or
//   m64n48k16 (K5) with A from registers; setmaxnreg moves registers from
//   the producers to them.  The int8 widening puts bytes 4q..4q+3 of a
//   k16 step in fragment columns 2q, 2q+1, 2q+8, 2q+9; the wrapper permutes
//   the query's dims the same way.
// * The epilogue in registers: the doc never leaves its warp, so K5's three
//   term columns (j, j+16, j+32) are added, the max over the doc's rows is a
//   shuffle over lane bits 2-4 and the sum over views one over bits 0-1;
//   lane 0 writes out[b, perm[b, j]].  Each pair is written once, no
//   atomics; the wrapper fills out with -inf, which -1 pairs keep.
//
// Route "wgmma_rows" (any other dv >= 1, up to 32 query rows, dim as
// "wgmma": a ragged corpus's stride buckets, dv 16-384, and the host
// table's blocks, dv = the longest doc), "wgmma" generalised (the same
// copies where a bf16 dim is not whole chunks, rows past dv zeros):
// * What bounds it: at phase 9a's ragged batch (144 queries x 4,096
//   candidates over 10,000 docs of 40-124 rows, four buckets) a doc is a
//   candidate of ~59 queries: 1.45 GB of distinct bf16 blocks (0.43 ms from
//   device memory) against 71.1 GB of pair blocks, and 2.3 ms of bf16
//   operations (6.9 for K5's three terms).  So the stream of pair blocks
//   from L2 into the SMs bounds K4, the operations K5; the host table's
//   blocks (each pair its own doc) are read once from device memory.
// * Query-stationary, as "wgmma": the same pid windows (sized by the doc's
//   bytes), and each (window, query) run cut into parts of at most 64 docs
//   (K4; 32 for K5) by the wrapper (ops/rerank.py::rerank_items, on the device): a
//   work list with no empty item, window-major, that balances the
//   persistent grid when runs are long (the host table's 256 docs a query)
//   and spends nothing on another bucket's -1 candidates.
// * The query sits in shared memory as the wgmma B operand, 32 rows (fewer
//   are zero rows, which add 0): n = 32 for bf16(Q), n = 96 for K5's three
//   bf16 terms; one or two query buffers and a 1-4 stage ring, as many as
//   fit beside it (K5 at dim 768: its 144 KB query and two 32 KB stages).
// * A doc a consumer warp, its 16-row tiles in turn: a stage is one tile
//   of each of 8 docs, one TMA box a doc (16 rows x 3 chunks bf16, x 2
//   int8) from a 4-D tensor map (128-byte column chunk, row of the doc, doc,
//   chunk index), so the rows of a last tile past dv come in as zeros, never
//   as the next doc's rows; the epilogue leaves them out of the max, so a
//   doc's score is the max over its dv rows, as in the plain version.
// * A fragments in registers as "wgmma" (ldmatrix; int8 widened exactly),
//   wgmma m64n32k16 / m64n96k16 with no branch between them (the query
//   padded with zeros to whole stages), and after each tile the max over its rows
//   folded into 8 running maxima a thread; after the last tile the max over
//   the warp's rows (lane bits 2-4) and the sum over the 32 views (bits
//   0-1); lane 0 writes out[b, perm[b, j]] once, no atomics.
//
// Route "staged" (every other shape: dims past 1,024, int8 dims that are
// not whole 64-dim chunks, more than 32 query rows; and on request, as the
// first design): the first design, one warp per candidate at a time, 16 doc
// rows x 128 dims staged synchronously in shared memory (the last step's
// dims past dim zeros; rows that are not 16-byte aligned read element by
// element), bf16 16x16x16 wmma, every pair's block read from device memory;
// a launch covers every candidate of the call, -1s included.
// ops/rerank.py::rerank_plan picks the route.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"  // TMA, mbarriers, wgmma descriptors, int8 widening, tensor maps

using namespace nvcuda;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int CAND_PER_BLOCK = 64;  // candidates per block, one warp each at a time
constexpr int KC = 128;             // hidden dims staged per step
constexpr int LDD = KC + 16;        // bf16 pitch of the staged doc tile: 288 B rows
constexpr int MAX_QV = 32;          // query rows: one per lane in the epilogue
constexpr int Q_TILES = MAX_QV / 16;
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// One 16-byte load of table elements, stored to shared memory as bf16.
template <typename T> struct Rows;

template <> struct Rows<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int TERMS = 1;  // Q rounded to bf16
  __device__ static void load(const __nv_bfloat16* src, __nv_bfloat16* dst) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  }
  __device__ static void zero(__nv_bfloat16* dst) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  // the first n (1..VEC) elements, one at a time (any alignment), zeros after
  __device__ static void load_part(const __nv_bfloat16* src, __nv_bfloat16* dst, int n) {
    zero(dst);
    for (int i = 0; i < n; ++i) dst[i] = src[i];
  }
};

template <> struct Rows<int8_t> {
  static constexpr int VEC = 16;
  static constexpr int TERMS = 3;  // Q kept in fp32 as three bf16 terms
  __device__ static void load(const int8_t* src, __nv_bfloat16* dst) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(src));
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) __nv_bfloat16 w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = __float2bfloat16_rn(float(v[i]));  // |v| <= 127: exact
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(w)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(w)[1];
  }
  __device__ static void zero(__nv_bfloat16* dst) {
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(0, 0, 0, 0);
  }
  __device__ static void load_part(const int8_t* src, __nv_bfloat16* dst, int n) {
    zero(dst);
    for (int i = 0; i < n; ++i) dst[i] = __float2bfloat16_rn(float(src[i]));
  }
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// The staged query's bf16 terms: rows of the dim rounded up to whole 16-dim
// steps (zeros past dim) and 16 more, the fragments' pitch.
__host__ __device__ inline size_t q_bytes(int terms, int qv, int dim) {
  return align128(size_t(terms) * ((qv + 15) / 16 * 16) * ((dim + 15) / 16 * 16 + 16) * 2);
}

constexpr size_t D_BYTES = size_t(WARPS) * 16 * LDD * 2;
constexpr size_t C_BYTES = size_t(WARPS) * Q_TILES * 256 * 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rerank_kernel(const int* __restrict__ cand, const float* __restrict__ Q,
              const T* __restrict__ table, float* __restrict__ out,
              int C, int qv, int dim, int dv) {
  constexpr int TERMS = Rows<T>::TERMS;
  constexpr int VEC = Rows<T>::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qv_pad = (qv + 15) / 16 * 16;
  const int dim_p = (dim + 15) / 16 * 16;  // whole 16-dim steps: the columns past dim are zeros
  const int ldq = dim_p + 16;
  const bool aligned = dim % VEC == 0;     // every doc row 16-byte aligned (the table is)
  const size_t qb = q_bytes(TERMS, qv, dim);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem + qb) + warp * 16 * LDD;
  float* Cs = reinterpret_cast<float*>(smem + qb + D_BYTES) + warp * Q_TILES * 256;
  const int b = blockIdx.y;

  // the block's query, split into TERMS bf16 parts (term t: rows t*qv_pad..)
  for (int i = tid; i < qv_pad * dim_p; i += THREADS) {
    const int row = i / dim_p, k = i % dim_p;
    float x = row < qv && k < dim ? Q[(int64_t(b) * qv + row) * dim + k] : 0.0f;
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      Qs[(size_t(t) * qv_pad + row) * ldq + k] = h;
      x -= __bfloat162float(h);
    }
  }
  __syncthreads();

  const int q_tiles = qv_pad / 16;
  for (int ci = warp; ci < CAND_PER_BLOCK; ci += WARPS) {
    const int c = blockIdx.x * CAND_PER_BLOCK + ci;
    if (c >= C) break;
    const int pid = cand[int64_t(b) * C + c];
    if (pid < 0) {
      if (lane == 0) out[int64_t(b) * C + c] = neg_inf();
      continue;
    }
    const T* doc = table + int64_t(pid) * dv * dim;
    float rmax = neg_inf();  // lane i: running max of query row i over doc rows
    for (int d0 = 0; d0 < dv; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[Q_TILES];
#pragma unroll
      for (int qt = 0; qt < Q_TILES; ++qt) wmma::fill_fragment(acc[qt], 0.0f);
      for (int k0 = 0; k0 < dim; k0 += KC) {
        const int kc = min(KC, dim - k0);
        const int kp = (kc + 15) / 16 * 16;  // whole 16-dim steps: columns kc .. kp - 1 are zeros
        const int vecs = kp / VEC;
        __syncwarp();  // the previous tile is consumed
        for (int i = lane; i < 16 * vecs; i += 32) {
          const int rr = i / vecs, cc = (i % vecs) * VEC;
          __nv_bfloat16* dst = Ds + rr * LDD + cc;
          const T* src = doc + int64_t(d0 + rr) * dim + k0 + cc;
          if (d0 + rr >= dv || cc >= kc)
            Rows<T>::zero(dst);
          else if (aligned)  // then kc is a multiple of VEC
            Rows<T>::load(src, dst);
          else
            Rows<T>::load_part(src, dst, min(VEC, kc - cc));
        }
        __syncwarp();
        for (int kk = 0; kk < kp; kk += 16) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Ds + kk, LDD);
#pragma unroll
          for (int qt = 0; qt < Q_TILES; ++qt) {
            if (qt >= q_tiles) break;
#pragma unroll
            for (int t = 0; t < TERMS; ++t) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
              wmma::load_matrix_sync(fa, Qs + (size_t(t) * qv_pad + qt * 16) * ldq + k0 + kk, ldq);
              wmma::mma_sync(acc[qt], fa, fb, acc[qt]);
            }
          }
        }
      }
#pragma unroll
      for (int qt = 0; qt < Q_TILES; ++qt)
        if (qt < q_tiles) wmma::store_matrix_sync(Cs + qt * 256, acc[qt], 16, wmma::mem_row_major);
      __syncwarp();
      if (lane < qv) {
        const float* row = Cs + (lane / 16) * 256 + (lane % 16) * 16;
        const int nj = min(16, dv - d0);
        for (int j = 0; j < nj; ++j) rmax = fmaxf(rmax, row[j]);
      }
      __syncwarp();
    }
    float s = lane < qv ? rmax : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[int64_t(b) * C + c] = s;
  }
}

template <typename T>
cudaError_t launch(const int* cand, const float* q, const T* table, float* out, int B, int C,
                   int qv, int dim, int dv, cudaStream_t stream) {
  const size_t smem = q_bytes(Rows<T>::TERMS, qv, dim) + D_BYTES + C_BYTES;
  if (smem > size_t(SMEM_LIMIT)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rerank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((C + CAND_PER_BLOCK - 1) / CAND_PER_BLOCK, B);
  rerank_kernel<T><<<grid, THREADS, smem, stream>>>(cand, q, table, out, C, qv, dim, dv);
  return cudaGetLastError();
}

// ---- route "wgmma": query-stationary items over pid windows ----

namespace wg {

using namespace hopper;

constexpr int DV = 16;          // rows a doc: one warp's 16 accumulator rows
constexpr int QV = 16;          // views a query
constexpr int CONS = 2;         // consumer warpgroups
constexpr int GD = 4 * CONS;    // docs a stage: one a consumer warp
constexpr int PROD = 4;         // producer threads: lane 0 of each producer warp
constexpr int THREADS = 128 * (CONS + 1);  // warpgroups 0..CONS-1 consume; the last produces
constexpr int MAX_DIM = 1024;
constexpr int ROW = 128;        // bytes a box row: one 128-byte swizzle row
constexpr uint32_t CHUNK = DV * ROW;  // a doc's 16 rows of one 128-byte column chunk
constexpr int LAG = 2;          // ring stages a copying producer keeps in flight (< the ring's depth)

// A doc's box of a stage (16 rows x `chunks` 128-byte column chunks,
// chunk-major, each chunk 16 rows of 128 swizzled bytes) copied by a
// producer warp itself, where no tensor map describes the bf16 rows (a dim
// that is not whole 64-dim chunks): rows of `dim` elements at `src` (the
// doc's row of the tile, the stage's first column), `valid` of them (rows
// past are zeros), the columns past dim zeros, 16-byte unit u of row r in
// chunk u / 8 at (u % 8) ^ (r % 8), as TMA's 128-byte swizzle lands it.
template <int CHUNKS>
__device__ __forceinline__ void copy_box(int w, uint32_t dst, const unsigned char* src, int dim, int col0,
                                         int valid, int lane) {
  const int nb = min(dim - col0, CHUNKS * 64) * 2;
  copy_tile<16, CHUNKS * 8>(w, dst, src, (long long)dim * 2, valid, nb, lane, 32, [](int r, int u) {
    return uint32_t((u / 8) * CHUNK + r * ROW + (((u % 8) ^ (r & 7)) * 16));
  });
}

// A doc's TMA box a stage is 16 rows x `chunks` 128-byte column chunks (3-D:
// chunk-major, each chunk 16 swizzled rows): 192 dims of bf16, 256 of int8.
// The boxes, not their bytes, set the streaming rate, so they are large.
template <bool I8> struct Cfg {
  static constexpr int NQ = I8 ? 3 * QV : QV;   // B operand rows (wgmma n): bf16 terms x views
  static constexpr int QBUF = I8 ? 1 : 2;       // query buffers
  static constexpr int chunks = I8 ? 2 : 3;     // 128-byte column chunks a box
  static constexpr int ks = chunks * ROW / (I8 ? 1 : 2);  // dims a stage
  static constexpr int steps = ks / 16;         // k16 steps a stage
  static constexpr int stages = I8 ? 4 : 3;
  static constexpr uint32_t box = chunks * CHUNK;
  static constexpr uint32_t stage = GD * box;
  static constexpr uint32_t ring = stages * stage;
  static constexpr uint32_t q_chunk = NQ * 128; // 64 dims of the B operand
  static constexpr size_t smem(int nq) { return ring + size_t(QBUF) * nq * q_chunk + 1024; }  // + alignment
};
static_assert(Cfg<false>::smem(MAX_DIM / 64) <= 232448 - 1024 && Cfg<true>::smem(MAX_DIM / 64) <= 232448 - 1024,
              "the ring and the query buffers must fit a block's shared memory");
static_assert(CHUNK % 1024 == 0 && Cfg<true>::q_chunk % 1024 == 0 && Cfg<false>::q_chunk % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");
static_assert(PROD <= 4 && GD % PROD == 0, "the producer warpgroup has 4 warps");

// One box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// d (+)= A[64 x 16] . B[16 x 16]^T: A from registers (each warp its 16 rows),
// B K-major in shared memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[48 x 16]^T.
__device__ __forceinline__ void wgmma_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// This warp's A fragment of k16 step `st` of a stage, from its doc's box at
// `doc` (chunk-major, 16 rows of 128 swizzled bytes a chunk): registers a0..a3
// hold rows g, g + 8 (g = lane/4) at fragment columns 2q + {0, 1} and
// 2q + 8 + {0, 1} (q = lane%4), the m16n8k16 layout.
//   bf16: one ldmatrix.x4 (lane l addresses row l%8 + 8*((l/8)%2), columns
//   8*(l/16) + {0..7} of the step), the fragment columns are the step's dims.
//   int8: rows g and g + 8, bytes 4q..4q+3 of the step's 16, widened exactly;
//   fragment columns 2q + {0, 1} hold dims 4q + {0, 1} and 2q + 8 + {0, 1} dims
//   4q + {2, 3}: the wrapper permutes the query's dims to match
//   (ops/rerank.py::query_operand).
template <bool I8>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t doc, int st, int lane) {
  if constexpr (I8) {
    const uint32_t tile = doc + (st / 8) * CHUNK;
    const int g = lane / 4, q = lane % 4, unit = ((st % 8) ^ g) * 16 + 4 * q;  // rows g, g + 8: same swizzle
    widen4(lds32(tile + g * ROW + unit), a[0], a[2]);
    widen4(lds32(tile + (g + 8) * ROW + unit), a[1], a[3]);
  } else {
    const int r = lane % 8 + 8 * ((lane / 8) % 2), u = (st % 4) * 2 + lane / 16;
    ldmatrix_x4(a, doc + (st / 4) * CHUNK + r * ROW + ((u ^ (r & 7)) * 16));
  }
}

// The doc score of this warp's 16 accumulator rows, in every lane.  A thread
// holds rows lane/4 and lane/4 + 8 at columns 8j + 2*(lane%4) + {0, 1} in
// d[4j + {0, 1}] and d[4j + {2, 3}], R / 8 column blocks of 8 in its R
// registers; for K5 (R = 24) the term t of view column c is column c + 16t,
// so d[4(j + 2t) + e] are added first.
template <int R>
__device__ __forceinline__ float doc_score(const float (&d)[R]) {
  constexpr int TERMS = R / 8;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = d[4 * j + e];
#pragma unroll
      for (int t = 1; t < TERMS; ++t) v[e] += d[4 * (j + 2 * t) + e];
    }
    // max over the doc's 16 rows: rows lane/4 and lane/4 + 8 here, the rest over lane bits 2-4
    float x = fmaxf(v[0], v[2]), y = fmaxf(v[1], v[3]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
      y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, o));
    }
    s += x + y;
  }
  // the 16 views: 4 in the thread, the rest over lane bits 0-1
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

}  // namespace wg

// COPIES (bf16 only): the doc boxes come by the producer warps' own copies
// of `table` (rows of dim elements, pieces of w bytes), not by tmap_table.
template <bool I8, bool COPIES>
__global__ void __launch_bounds__(wg::THREADS, 1)
rerank_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_table,  // 3-D over the table, box 16 rows x chunks
                    const __grid_constant__ CUtensorMap tmap_q,      // (B*NQ, qdim) bf16, box 64 x NQ
                    const unsigned char* __restrict__ table,  // (num_docs * 16, dim): COPIES
                    const int* __restrict__ spid,      // (B, C) pids sorted ascending, -1 last
                    const int64_t* __restrict__ perm,  // (B, C) column of each sorted pid
                    const int* __restrict__ wstart,    // (B, n_win + 1) first sorted index of each window
                    float* __restrict__ out,           // (B, C), filled with -inf
                    int B, int C, int n_win, int dim, int w) {
  using namespace wg;
  using K = Cfg<I8>;
  constexpr int N = K::NQ, STAGES = K::stages;
  static_assert(!(I8 && COPIES), "an int8 table comes by its tensor map");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qfull[K::QBUF], qempty[K::QBUF];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the ring, then the query buffers
  const uint32_t qbase = base + K::ring;
  const int nq = (dim + 63) / 64;                 // 64-dim chunks of the query (zeros past dim)
  const int nks = (dim + K::ks - 1) / K::ks;      // stages a group (a last partial one: zero fill)
  const uint32_t qsize = uint32_t(nq) * K::q_chunk;  // one query's B operand

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], COPIES ? PROD * 32 : PROD);  // each producer thread's expect_tx (each copier's hand-off)
      mbar_init(&empty[s], CONS * 4);                  // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < K::QBUF; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], CONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_items = n_win * B;
  const int wgi = threadIdx.x / 128;
  if (wgi == CONS) {
    // ---- producers: PROD threads load each item's docs (doc d by thread d % PROD: one
    // thread's TMA issue alone holds the stream back), the first also its query; with
    // COPIES doc d's box is copied by producer warp d % PROD ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pi = (threadIdx.x - CONS * 128) / 32, lane = threadIdx.x % 32;
    if (pi < PROD && (COPIES || lane == 0)) {
      int stage = 0, it = 0, pending = 0, oldest = 0;  // the ring slot, items; stages not handed over (COPIES)
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const int wi = i / B, b = i % B;
        const int* ws = wstart + int64_t(b) * (n_win + 1) + wi;
        const int lo = ws[0], hi = ws[1];
        if (lo >= hi) continue;
        const int qb = it % K::QBUF;
        const uint32_t qph = (it / K::QBUF) & 1;
        ++it;
        if (pi == 0 && lane == 0) {
          mbar_wait(&qempty[qb], qph ^ 1);
          mbar_expect_tx(&qfull[qb], qsize);
          for (int c = 0; c < nq; ++c)
            tma_load(qbase + qb * qsize + c * K::q_chunk, &tmap_q, c * 64, b * N, &qfull[qb]);
        }
        const int* row = spid + int64_t(b) * C;
        for (int g0 = lo; g0 < hi; g0 += GD) {
          const int nd = min(GD, hi - g0);
          int pid[GD];
#pragma unroll
          for (int d = 0; d < GD; ++d) pid[d] = d < nd ? row[g0 + d] : 0;
          for (int kb = 0; kb < nks; ++kb) {
            mbar_wait(&empty[stage], phase ^ 1);
            const uint32_t st = base + stage * K::stage;
            if constexpr (COPIES) {
#pragma unroll
              for (int d = 0; d < GD; ++d)
                if (d < nd && d % PROD == pi)
                  copy_box<K::chunks>(w, st + d * K::box, table + (int64_t(pid[d]) * DV * dim + kb * K::ks) * 2,
                                      dim, kb * K::ks, DV, lane);
              copies_issued<LAG>(pending, oldest, full, STAGES);
            } else {
              mbar_expect_tx(&full[stage], ((nd - pi + PROD - 1) / PROD) * K::box);
#pragma unroll
              for (int d = 0; d < GD; ++d)
                if (d < nd && d % PROD == pi)
                  tma_load_3d(st + d * K::box, &tmap_table, 0, pid[d] * DV, kb * K::chunks, &full[stage]);
            }
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
        // the item's stages all handed over before the next item's wait on its query buffer
        if constexpr (COPIES) copies_drained(pending, oldest, full, STAGES);
      }
    }
  } else {
    // ---- consumers: a doc a warp of every group, the MaxSim epilogue, the write ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
    int stage = 0, it = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const int wi = i / B, b = i % B;
      const int* ws = wstart + int64_t(b) * (n_win + 1) + wi;
      const int lo = ws[0], hi = ws[1];
      if (lo >= hi) continue;
      const int qb = it % K::QBUF;
      const uint32_t qph = (it / K::QBUF) & 1;
      ++it;
      mbar_wait(&qfull[qb], qph);
      const uint32_t q0 = qbase + qb * qsize;
      const int64_t row0 = int64_t(b) * C;
      for (int g0 = lo; g0 < hi; g0 += GD) {
        for (int kb = 0; kb < nks; ++kb) {
          mbar_wait(&full[stage], phase);
          // the whole stage of this warp's doc into registers, then the stage is free
          uint32_t a[K::steps][4];
          const uint32_t doc = base + stage * K::stage + (wgi * 4 + warp) * K::box;
#pragma unroll
          for (int st = 0; st < K::steps; ++st) load_a<I8>(a[st], doc, st, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[stage]);
          fence_acc(d);
          wgmma_fence();
#pragma unroll
          for (int st = 0; st < K::steps; ++st) {
            const int k = kb * K::ks + st * 16;
            if (k < dim)  // a last partial stage: the box's zero fill past dim has no query
              wgmma_rs(d, a[st], sw128_desc(q0 + (k / 64) * K::q_chunk + ((k % 64) / 16) * 32), k != 0);
          }
          wgmma_commit();
          fence_acc(d);
          wgmma_wait<0>();  // the registers of a[] are read
          fence_acc(d);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        const float s = doc_score(d);
        const int j = g0 + wgi * 4 + warp;  // this warp's doc in the sorted row
        if (lane == 0 && j < hi) out[row0 + perm[row0 + j]] = s;
      }
      if (lane == 0) mbar_arrive(&qempty[qb]);  // every product on this query is done
    }
  }
}

// The table as a 3-D map for one box a doc a stage: dims (128-byte column
// chunk, row, chunk index), box (128 bytes, 16 rows, chunks), 128-byte swizzle;
// column chunks past dim fill with zeros.
template <bool I8>
bool make_table_map(CUtensorMap* map, const void* table, int num_docs, int dim) {
  hopper::EncodeTiledFn enc = hopper::encode_tiled();
  if (enc == nullptr) return false;
  constexpr int esz = I8 ? 1 : 2, inner = wg::ROW / esz;
  const cuuint64_t dims[3] = {cuuint64_t(inner), cuuint64_t(num_docs) * wg::DV, cuuint64_t((dim + inner - 1) / inner)};
  const cuuint64_t strides[2] = {cuuint64_t(dim) * esz, cuuint64_t(wg::ROW)};
  const cuuint32_t box[3] = {uint32_t(inner), uint32_t(wg::DV), uint32_t(wg::Cfg<I8>::chunks)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(table), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The table by its 3-D tensor map where dim is whole 64-dim chunks, else by
// the producers' copies (bf16 only); q is (B * NQ, qdim), qdim = dim rounded
// up to a multiple of 64, zeros past dim.
template <bool I8, bool COPIES>
cudaError_t launch_wgmma(const void* q, const void* table, const int* spid, const int64_t* perm,
                         const int* wstart, float* out, int B, int C, int dim, int num_docs, int n_win,
                         cudaStream_t stream) {
  using K = wg::Cfg<I8>;
  const int nq = (dim + 63) / 64;
  CUtensorMap map_table = {}, map_q;
  if ((!COPIES && !make_table_map<I8>(&map_table, table, num_docs, dim)) ||
      !hopper::make_map(&map_q, q, false, uint64_t(B) * K::NQ, uint64_t(nq) * 64, K::NQ))
    return cudaErrorInvalidValue;
  const int64_t n_items = int64_t(n_win) * B;
  if (n_items > INT32_MAX) return cudaErrorInvalidValue;
  const size_t smem = K::smem(nq);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rerank_wgmma_kernel<I8, COPIES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  if (err != cudaSuccess) return err;
  const int grid = int(n_items < sms ? n_items : sms);
  rerank_wgmma_kernel<I8, COPIES><<<grid, wg::THREADS, smem, stream>>>(
      map_table, map_q, static_cast<const unsigned char*>(table), spid, perm, wstart, out, B, C, n_win, dim,
      hopper::copy_width((long long)dim * 2));
  return cudaGetLastError();
}

// ---- route "wgmma_rows": any rows a doc, up to 32 query rows ----

namespace wr {

using namespace hopper;
using wg::CHUNK;
using wg::CONS;
using wg::GD;
using wg::PROD;
using wg::ROW;
using wg::THREADS;

constexpr int QV = 32;          // query rows a launch (fewer: zero rows, which add 0)
constexpr int MAX_STAGES = 4;
constexpr int MAX_QBUF = 2;
constexpr size_t SMEM = 232448 - 1024 - 256;  // a block's shared memory less the alignment and the barriers

// As wg::Cfg, at 32 views: the B operand is bf16(Q) (n = 32) or K5's three
// terms (n = 96); a box is 16 rows of one doc x `chunks` 128-byte chunks.
// PART: docs an item at most (the wrapper cuts each (window, query) run into
// parts).  K4, bound by the box stream (no faster without its products),
// took 12.264 ms on phase 9a's shapes with parts of 64, 15.445 with 32 (each
// item switch a query load and a drained ring), 12.331 with 128; K5, bound
// by its products, 19.468 with 32 and 21.011 with 64, and its host blocks
// balance worse over the SMs with 64 (1.914 against 1.754 ms).
// SPLIT: wgmma groups a stage, a group's products running while the next
// part's A fragments load.  K4's buckets took 12.264 ms with two, 12.637
// with one; K5's 18.367 with one, 19.468 with two, bound by its products
// (9.057 without them; scripts/rerank_rows_variants.py, NVIDIA H100 80GB
// HBM3, 700.00 W).
template <bool I8> struct Cfg {
  static constexpr int PART = I8 ? 32 : 64;
  static constexpr int SPLIT = I8 ? 1 : 2;
  static constexpr int NQ = I8 ? 3 * QV : QV;
  static constexpr int chunks = I8 ? 2 : 3;
  static constexpr int ks = chunks * ROW / (I8 ? 1 : 2);
  static constexpr int steps = ks / 16;
  static constexpr uint32_t box = chunks * CHUNK;
  static constexpr uint32_t stage = GD * box;
  static constexpr uint32_t q_chunk = NQ * 128;
};
static_assert(Cfg<true>::q_chunk % 1024 == 0 && Cfg<false>::q_chunk % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");
static_assert(Cfg<true>::steps % Cfg<true>::SPLIT == 0 && Cfg<false>::steps % Cfg<false>::SPLIT == 0,
              "a stage's k-steps split evenly");
// The query's 64-dim chunks in shared memory: whole stages of dims, those
// past dim zero-filled by TMA, so a last partial stage's products add 0 and
// no k-step needs a branch (a branch there made ptxas fence every wgmma:
// K5's buckets 20.937 ms with it against 19.468 without, in turns).
template <bool I8>
__host__ __device__ constexpr int q_chunks(int dim) {
  return (dim + Cfg<I8>::ks - 1) / Cfg<I8>::ks * (Cfg<I8>::ks / 64);
}
static_assert(size_t(q_chunks<true>(wg::MAX_DIM)) * Cfg<true>::q_chunk + Cfg<true>::stage <= SMEM &&
              size_t(q_chunks<false>(wg::MAX_DIM)) * Cfg<false>::q_chunk + Cfg<false>::stage <= SMEM,
              "one query and one stage must fit a block's shared memory at the widest dim");

// The ring's depth and the query buffers for `dim`: two query buffers where
// three stages still fit beside them, else one; as many stages as fit, up
// to MAX_STAGES.  K5 at dim 768 holds its 144 KB query and two stages.
struct Plan {
  uint32_t qsize;
  int qbuf, stages;
};
template <bool I8>
Plan plan(int dim) {
  using K = Cfg<I8>;
  Plan p;
  p.qsize = uint32_t(q_chunks<I8>(dim)) * K::q_chunk;
  p.qbuf = size_t(MAX_QBUF) * p.qsize + 3 * size_t(K::stage) <= SMEM ? MAX_QBUF : 1;
  const size_t left = SMEM - size_t(p.qbuf) * p.qsize;
  p.stages = int(left / K::stage < size_t(MAX_STAGES) ? left / K::stage : MAX_STAGES);
  return p;
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// d (+)= A[64 x 16] . B[32 x 16]^T, A from registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[96 x 16]^T.
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Folds one 16-row tile of this warp's doc into the running maxima `mx`: a
// thread holds rows `row` and `row` + 8 at view columns 8j + 2*(lane%4) + {0,
// 1} (j = 0..3) in d[4j + {0, 1}] and d[4j + {2, 3}]; for K5 (R = 48) term t
// of view column c is column c + 32t, so d[4(j + 4t) + e] are added first.
// Rows at or past dv (the zeros TMA fills in past a doc's end) take no part.
template <int R>
__device__ __forceinline__ void tile_max(const float (&d)[R], float (&mx)[8], int row, int dv) {
  constexpr int TERMS = R / 16;
  const float ninf = __int_as_float(0xff800000);
  const bool v0 = row < dv, v1 = row + 8 < dv;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = d[4 * j + e], y = d[4 * j + 2 + e];
#pragma unroll
      for (int t = 1; t < TERMS; ++t) {
        x += d[4 * (j + 4 * t) + e];
        y += d[4 * (j + 4 * t) + 2 + e];
      }
      mx[2 * j + e] = fmaxf(mx[2 * j + e], fmaxf(v0 ? x : ninf, v1 ? y : ninf));
    }
  }
}

// The doc score in every lane: the max over the doc's rows (the thread's two
// rows are in mx; the rest over lane bits 2-4), summed over the 32 views (8
// in the thread, the rest over lane bits 0-1).
__device__ __forceinline__ float doc_score(const float (&mx)[8]) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float x = mx[i];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    s += x;
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

}  // namespace wr

// COPIES (bf16 only): the doc tiles come by the producer warps' own copies
// of `table` (rows of dim elements, pieces of w bytes), not by tmap_table.
template <bool I8, bool COPIES>
__global__ void __launch_bounds__(wr::THREADS, 1)
rerank_rows_kernel(const __grid_constant__ CUtensorMap tmap_table,  // 4-D over the table, box 16 rows x chunks
                   const __grid_constant__ CUtensorMap tmap_q,      // (B*NQ, qdim) bf16, box 64 x NQ
                   const unsigned char* __restrict__ table,  // (num_docs * dv, dim): COPIES
                   const int* __restrict__ spid,      // (B, C) pids sorted ascending, -1 last
                   const int64_t* __restrict__ perm,  // (B, C) column of each sorted pid
                   const int* __restrict__ items,     // (n_items, 3): query, first, end; query -1 past the last
                   float* __restrict__ out,           // (B, C), filled with -inf
                   int C, int n_items, int dim, int dv, int stages, int qbuf, int w) {
  using namespace wr;
  using K = Cfg<I8>;
  constexpr int N = K::NQ;
  static_assert(!(I8 && COPIES), "an int8 table comes by its tensor map");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES], qfull[MAX_QBUF], qempty[MAX_QBUF];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the ring, then the query buffers
  const uint32_t qbase = base + uint32_t(stages) * K::stage;
  const int nq = q_chunks<I8>(dim);           // 64-dim chunks of the query (past dim: zero fill)
  const int nks = (dim + K::ks - 1) / K::ks;  // stages a row tile (a last partial one: zero fill)
  const int tiles = (dv + 15) / 16;           // 16-row tiles a doc (the last: zero fill past dv)
  const uint32_t qsize = uint32_t(nq) * K::q_chunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], COPIES ? PROD * 32 : PROD);
      mbar_init(&empty[s], CONS * 4);
    }
    for (int s = 0; s < qbuf; ++s) {
      mbar_init(&qfull[s], 1);
      mbar_init(&qempty[s], CONS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == CONS) {
    // ---- producers: each item's query (the first thread), then its docs' boxes, (row tile,
    // 128-byte chunks) a stage, doc d by thread d % PROD (with COPIES, by warp d % PROD) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pi = (threadIdx.x - CONS * 128) / 32, lane = threadIdx.x % 32;
    if (pi < PROD && (COPIES || lane == 0)) {
      int stage = 0, it = 0, pending = 0, oldest = 0;  // the ring slot, items; stages not handed over (COPIES)
      uint32_t phase = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const int b = items[3 * i], lo = items[3 * i + 1], hi = items[3 * i + 2];
        if (b < 0) break;  // the items past the last are all -1
        const int qb = it % qbuf;
        const uint32_t qph = (it / qbuf) & 1;
        ++it;
        if (pi == 0 && lane == 0) {
          mbar_wait(&qempty[qb], qph ^ 1);
          mbar_expect_tx(&qfull[qb], qsize);
          for (int c = 0; c < nq; ++c)
            tma_load(qbase + qb * qsize + c * K::q_chunk, &tmap_q, c * 64, b * N, &qfull[qb]);
        }
        const int* row = spid + int64_t(b) * C;
        for (int g0 = lo; g0 < hi; g0 += GD) {
          const int nd = min(GD, hi - g0);
          int pid[GD];
#pragma unroll
          for (int d = 0; d < GD; ++d) pid[d] = d < nd ? row[g0 + d] : 0;
          for (int t = 0; t < tiles; ++t) {
            for (int kb = 0; kb < nks; ++kb) {
              mbar_wait(&empty[stage], phase ^ 1);
              const uint32_t st = base + stage * K::stage;
              if constexpr (COPIES) {
#pragma unroll
                for (int d = 0; d < GD; ++d)
                  if (d < nd && d % PROD == pi)
                    wg::copy_box<K::chunks>(w, st + d * K::box,
                                            table + ((int64_t(pid[d]) * dv + t * 16) * dim + kb * K::ks) * 2, dim,
                                            kb * K::ks, min(16, dv - t * 16), lane);
                copies_issued<wg::LAG>(pending, oldest, full, stages);
              } else {
                mbar_expect_tx(&full[stage], ((nd - pi + PROD - 1) / PROD) * K::box);
#pragma unroll
                for (int d = 0; d < GD; ++d)
                  if (d < nd && d % PROD == pi)
                    tma_load_4d(st + d * K::box, &tmap_table, 0, t * 16, pid[d], kb * K::chunks, &full[stage]);
              }
              if (++stage == stages) {
                stage = 0;
                phase ^= 1;
              }
            }
          }
        }
        // the item's stages all handed over before the next item's wait on its query buffer
        if constexpr (COPIES) copies_drained(pending, oldest, full, stages);
      }
    }
  } else {
    // ---- consumers: a doc a warp of every group, its row tiles in turn, the max over
    // rows carried in registers, the MaxSim epilogue, the write ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
    int stage = 0, it = 0;
    uint32_t phase = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const int b = items[3 * i], lo = items[3 * i + 1], hi = items[3 * i + 2];
      if (b < 0) break;
      const int qb = it % qbuf;
      const uint32_t qph = (it / qbuf) & 1;
      ++it;
      mbar_wait(&qfull[qb], qph);
      const uint32_t q0 = qbase + qb * qsize;
      const int64_t row0 = int64_t(b) * C;
      for (int g0 = lo; g0 < hi; g0 += GD) {
        float mx[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) mx[v] = __int_as_float(0xff800000);
        for (int t = 0; t < tiles; ++t) {
          for (int kb = 0; kb < nks; ++kb) {
            mbar_wait(&full[stage], phase);
            // this warp's doc tile into registers in K::SPLIT parts, each part's products issued
            // as one group while the next part loads; then the stage is free
            uint32_t a[K::steps][4];
            const uint32_t doc = base + stage * K::stage + (wgi * 4 + warp) * K::box;
            fence_acc(d);
#pragma unroll
            for (int h = 0; h < K::SPLIT; ++h) {
              constexpr int per = K::steps / K::SPLIT;
#pragma unroll
              for (int st = h * per; st < (h + 1) * per; ++st) wg::load_a<I8>(a[st], doc, st, lane);
              if (h == K::SPLIT - 1) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[stage]);
              }
              wgmma_fence();
#pragma unroll
              for (int st = h * per; st < (h + 1) * per; ++st) {
                const int k = kb * K::ks + st * 16;  // past dim the query's chunks are zeros
                wgmma_rs(d, a[st], sw128_desc(q0 + (k / 64) * K::q_chunk + ((k % 64) / 16) * 32), k != 0);
              }
              wgmma_commit();
            }
            fence_acc(d);
            wgmma_wait<0>();  // the registers of a[] are read
            fence_acc(d);
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
          tile_max(d, mx, t * 16 + lane / 4, dv);
        }
        const float s = doc_score(mx);
        const int j = g0 + wgi * 4 + warp;  // this warp's doc in the sorted row
        if (lane == 0 && j < hi) out[row0 + perm[row0 + j]] = s;
      }
      if (lane == 0) mbar_arrive(&qempty[qb]);  // every product on this query is done
    }
  }
}

// The table as a 4-D map for one box a doc's 16-row tile a stage: dims
// (128-byte column chunk, row of the doc, doc, chunk index), box (128 bytes,
// 16 rows, 1 doc, chunks), 128-byte swizzle.  Rows past dv and column chunks
// past dim are out of bounds, so TMA fills them with zeros: a doc's last tile
// never reads the next doc's rows.
template <bool I8>
bool make_rows_map(CUtensorMap* map, const void* table, int num_docs, int dv, int dim) {
  hopper::EncodeTiledFn enc = hopper::encode_tiled();
  if (enc == nullptr) return false;
  constexpr int esz = I8 ? 1 : 2, inner = wg::ROW / esz;
  const cuuint64_t dims[4] = {cuuint64_t(dim < inner ? dim : inner), cuuint64_t(dv), cuuint64_t(num_docs),
                              cuuint64_t((dim + inner - 1) / inner)};
  const cuuint64_t strides[3] = {cuuint64_t(dim) * esz, cuuint64_t(dv) * dim * esz, cuuint64_t(wg::ROW)};
  const cuuint32_t box[4] = {uint32_t(inner), 16u, 1u, uint32_t(wr::Cfg<I8>::chunks)};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(table), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The table by its 4-D tensor map where dim is whole 64-dim chunks, else by
// the producers' copies (bf16 only); q is (B * NQ, qdim), qdim = dim rounded
// up to a multiple of 64, zeros past dim.
template <bool I8, bool COPIES>
cudaError_t launch_rows(const void* q, const void* table, const int* spid, const int64_t* perm, const int* items,
                        float* out, int B, int C, int dim, int dv, int num_docs, int n_items, cudaStream_t stream) {
  using K = wr::Cfg<I8>;
  const wr::Plan p = wr::plan<I8>(dim);
  CUtensorMap map_table = {}, map_q;
  if (p.stages < 1 || (COPIES && p.stages <= wg::LAG) ||
      (!COPIES && !make_rows_map<I8>(&map_table, table, num_docs, dv, dim)) ||
      !hopper::make_map(&map_q, q, false, uint64_t(B) * K::NQ, uint64_t(dim + 63) / 64 * 64, K::NQ))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + size_t(p.stages) * K::stage + size_t(p.qbuf) * p.qsize;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rerank_rows_kernel<I8, COPIES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  if (err != cudaSuccess) return err;
  const int grid = n_items < sms ? n_items : sms;
  rerank_rows_kernel<I8, COPIES><<<grid, wr::THREADS, smem, stream>>>(
      map_table, map_q, static_cast<const unsigned char*>(table), spid, perm, items, out, C, n_items, dim, dv,
      p.stages, p.qbuf, hopper::copy_width((long long)dim * 2));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape limits the kernels take; the Python wrapper checks them first.
int rerank_max_views() { return MAX_QV; }            // route "staged": query rows
int rerank_wgmma_dv() { return wg::DV; }             // route "wgmma": rows a doc
int rerank_wgmma_views() { return wg::QV; }          // route "wgmma": views a query
int rerank_wgmma_max_dim() { return wg::MAX_DIM; }   // both wgmma routes: largest dim
int rerank_wgmma_group() { return wg::GD; }          // route "wgmma": docs a stage
int rerank_rows_views() { return wr::QV; }           // route "wgmma_rows": query rows a launch
int rerank_rows_part(int table_int8) {               // route "wgmma_rows": docs an item at most
  return table_int8 ? wr::Cfg<true>::PART : wr::Cfg<false>::PART;
}

// Route "staged": any dim >= 1 over a bf16 table, a multiple of 16 over int8
// (K5's; the JAX package reaches K5 at multiples of 128 only); a 16-byte
// aligned table.  Returns a cudaError_t: 0 when the launch was accepted.
int rerank_launch(const void* cand, const void* q, const void* table, int table_int8,
                  void* out, int B, int C, int qv, int dim, int dv, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || qv < 1 || qv > MAX_QV || dim < 1 || dv < 1 ||
      (table_int8 && dim % 16 != 0) || reinterpret_cast<uintptr_t>(table) % 16)
    return int(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(cand);
  const float* qq = static_cast<const float*>(q);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = table_int8
      ? launch<int8_t>(c, qq, static_cast<const int8_t*>(table), o, B, C, qv, dim, dv, s)
      : launch<__nv_bfloat16>(c, qq, static_cast<const __nv_bfloat16*>(table), o, B, C, qv, dim, dv, s);
  return int(err);
}

// Route "wgmma".  q: the bf16 B operand, (B*16, qdim) for a bf16 table or
// (B*48, qdim) (three terms a query) for int8, qdim = dim rounded up to a
// multiple of 64, zeros past dim; spid/perm/wstart: the pid-window schedule
// (ops/rerank.py::rerank_schedule); out (B, C) filled with -inf.  Any dim up
// to MAX_DIM over a bf16 table (by the producers' copies where dim is not
// whole 64-dim chunks), a multiple of 64 over int8.  Returns a cudaError_t:
// 0 when the launch was accepted.
int rerank_wgmma_launch(const void* q, const void* table, int table_int8, const void* spid,
                        const void* perm, const void* wstart, void* out, int B, int C, int dim,
                        int num_docs, int n_win, void* stream) {
  if (B < 1 || C < 1 || dim < 1 || dim > wg::MAX_DIM || (table_int8 && dim % 64 != 0) || num_docs < 1 ||
      n_win < 1 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(table)) % 16)
    return int(cudaErrorInvalidValue);
  const int* sp = static_cast<const int*>(spid);
  const int64_t* pm = static_cast<const int64_t*>(perm);
  const int* ws = static_cast<const int*>(wstart);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = table_int8 ? launch_wgmma<true, false>(q, table, sp, pm, ws, o, B, C, dim, num_docs, n_win, s)
                    : dim % 64 ? launch_wgmma<false, true>(q, table, sp, pm, ws, o, B, C, dim, num_docs, n_win, s)
                               : launch_wgmma<false, false>(q, table, sp, pm, ws, o, B, C, dim, num_docs, n_win, s);
  return int(err);
}

// Route "wgmma_rows".  q: the bf16 B operand, (B*32, qdim) for a bf16 table
// or (B*96, qdim) for int8, qdim as route "wgmma"'s; spid/perm: the sorted
// candidates of the pid-window schedule, items (n_items, 3) int32 its
// (query, first, end) parts (ops/rerank.py::rerank_items); out (B, C) filled
// with -inf; a doc is dv rows; dims as route "wgmma".  Returns a
// cudaError_t: 0 when the launch was accepted.
int rerank_rows_launch(const void* q, const void* table, int table_int8, const void* spid, const void* perm,
                       const void* items, void* out, int B, int C, int dim, int dv, int num_docs, int n_items,
                       void* stream) {
  if (B < 1 || C < 1 || dim < 1 || dim > wg::MAX_DIM || (table_int8 && dim % 64 != 0) || dv < 1 ||
      num_docs < 1 || n_items < 1 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(table)) % 16)
    return int(cudaErrorInvalidValue);
  const int* sp = static_cast<const int*>(spid);
  const int64_t* pm = static_cast<const int64_t*>(perm);
  const int* it = static_cast<const int*>(items);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = table_int8 ? launch_rows<true, false>(q, table, sp, pm, it, o, B, C, dim, dv, num_docs, n_items, s)
                    : dim % 64 ? launch_rows<false, true>(q, table, sp, pm, it, o, B, C, dim, dv, num_docs, n_items, s)
                               : launch_rows<false, false>(q, table, sp, pm, it, o, B, C, dim, dv, num_docs, n_items, s);
  return int(err);
}

}  // extern "C"
