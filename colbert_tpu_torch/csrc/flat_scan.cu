// Exact flat MaxSim scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces the two TPU kernels of colbert_tpu/ops/flat_scan.py:
//   K2  _flat_kernel        (flat_scan.py:59, pallas_call :133, reached through flat_maxsim_scan)
//   K1  _flat_kernel_fused  (flat_scan.py:157, pallas_call :252, reached through flat_scan_topk)
// Each route below serves both; its epilogue switches between them (`mode`).
//
// What it computes, for queries Qm (B, m, h) rounded to bf16 by the caller
// and a doc-major table (docs_pad * dv, h) in bf16 or int8 (int8 rows enter
// the product as exact integers), at any h >= 1:
//   S[row, tok] = table[row] . q[tok]           fp32 accumulation
//   M[doc, tok] = max over the doc's dv rows     (zero rows score 0: no -inf)
//   score[doc, b] = sum over query b's m views of M[doc, b*m + v]
// K2 (mode 0) writes score (docs_pad, B) fp32.  K1 (modes 1 and 2) rounds the
// score to the stored dtype (fp32 or bf16, round-to-nearest-even), sets docs
// >= num_docs to -inf, writes it, and writes one fp32 max per (group of
// `group` docs, query) over the rounded values: the exact two-stage top-k
// reads only the winning groups (colbert_tpu_torch/ops/flat_scan.py).
//
// What bounds it: at B=144, m=16, h=768 every 1,536-byte bf16 table row is
// multiplied against 2,304 query tokens, 2*2304*768 FLOP per row, about
// 2,300 FLOP per byte read -- far above the H100's ~295 FLOP/B ridge.  The
// scan is bound by operations: 989 TFLOP/s on the bf16 tensor cores.
//
// Route "wgmma" (dv = 16 rows a doc, m = 16 views a query: the multiview
// main path), one persistent block per SM:
// * TMA into a 4-stage ring.  Two 2-D tensor maps, over the table
//   (docs_pad*dv, h) and the bf16 queries (B*m, hq; hq = h rounded up to a
//   multiple of 64 by the wrapper, zeros past h), cut 64-dim (128-byte)
//   boxes with the 128-byte swizzle: a 128-row table tile and a 256-token
//   (16-query) query tile a stage.  Out-of-bounds boxes fill with zeros, so
//   the last row tile, the last query tile and an h that is not a multiple
//   of 64 need no code.  One producer thread keeps the ring full on
//   mbarriers; loads overlap the products and the epilogue of the last tile
//   (the staged route loads synchronously, then waits at a barrier).
// * A table whose rows no tensor map describes (a pitch, h bytes for int8
//   or 2h for bf16, that is not a multiple of 16: int8 at h 312, bf16 at h
//   100) is copied by the producer's whole warpgroup instead: each thread
//   cp.asyncs its share of the tile in the widest pieces the rows'
//   alignment allows (1-byte loads and stores for an odd int8 pitch),
//   columns past h and rows past the table written as zeros, so that no
//   NaN of a neighbouring row meets a zero query column; two stages stay in
//   flight, each made visible to the tensor cores (fence.proxy.async) and
//   handed over on its barrier once it has landed (hopper.cuh::copy_tile).
//   The query tile still comes by TMA.
// * Two consumer warpgroups, each a 64-row slice x the 256 tokens, issue
//   wgmma m64n256k16 from shared memory with 128 fp32 accumulators a thread
//   (the staged route uses 16x16x16 wmma, mma.sync, on 64x128 tiles);
//   setmaxnreg moves registers from the producer to them.
// * The MaxSim epilogue in registers: in the m64nN accumulator layout each
//   warp holds 16 consecutive rows, one doc; a thread holds rows lane/4 and
//   lane/4+8 at columns 2*(lane%4)+{0,1}+8j.  Max over the doc's rows is an
//   fmaxf plus shuffles over lane bits 2-4; a query's 16 views are column
//   blocks 2q, 2q+1, summed in the thread and over lane bits 0-1.  No
//   shared-memory C tile, no running-max buffer, no barrier between tiles
//   (the staged route stages 94 KB a block through shared memory).
// * The tile walk puts the query tile fastest: the ~15 row bands in flight
//   on 132 SMs read each table tile from HBM about once (491 MB at 20k docs,
//   where the staged grid re-reads the table per query tile and the query tile
//   per row tile); the 3.5 MB query set stays in L2.
// * The stage-2 group stays 64 docs (ops/flat_scan.py::group_docs), 8 tiles
//   of 8 docs: each warp folds its doc's rounded scores into the group max
//   with an atomic max on the float's bits (atomicMax of the int for a
//   value >= +0, atomicMin of the unsigned below), over a buffer the wrapper
//   fills with -inf.
// * An int8 table goes through the same ring: TMA brings the raw int8 tile,
//   each consumer warpgroup widens its 64 rows exactly to bf16 (sign and
//   magnitude into +-(128 + |x|), minus +-128) into the swizzled stage, then
//   issues the same wgmma.
//
// Route "staged" (any other dv or m <= 128: ragged corpora padded to their
// longest doc, m = 32): the first design, one block per (64-doc group,
// 128-token tile), bf16 wmma fragments on synchronously staged 64-row tiles,
// the accumulator tile folded into a running max in shared memory.  Its last
// 64-dim chunk is padded with zeros to whole 16-dim steps; rows that are not
// 16-byte aligned are read element by element.
// ops/flat_scan.py::flat_scan_plan picks the route by shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"  // TMA, mbarriers, wgmma descriptors, int8 widening, tensor maps

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;   // 8 warps: 2 (rows) x 4 (tokens), 32x32 each
constexpr int M_TILE = 64;     // table rows per tile
constexpr int N_TILE = 128;    // query tokens per block (whole queries)
constexpr int K_CHUNK = 64;    // hidden dims per shared-memory stage
constexpr int MAX_GROUP = 64;  // docs per block
constexpr int LDA = K_CHUNK + 8;  // bf16 row pitch: 144 B, 16-B aligned
constexpr int LDB = K_CHUNK + 8;
constexpr int LDC = N_TILE + 4;   // fp32 row pitch

constexpr size_t SMEM_A = size_t(M_TILE) * LDA * 2;
constexpr size_t SMEM_B = size_t(N_TILE) * LDB * 2;
constexpr size_t SMEM_C = size_t(M_TILE) * LDC * 4;
constexpr size_t SMEM_R = size_t(MAX_GROUP) * N_TILE * 4;
constexpr size_t SMEM_BYTES = SMEM_A + SMEM_B + SMEM_C + SMEM_R;
static_assert(SMEM_A % 128 == 0 && SMEM_B % 128 == 0 && SMEM_C % 128 == 0,
              "wmma needs 32-byte aligned tiles");
static_assert(size_t(MAX_GROUP) * N_TILE <= size_t(M_TILE) * LDC,
              "the group-max staging reuses the C tile");

enum Mode { SCORES_F32 = 0, FUSED_F32 = 1, FUSED_BF16 = 2 };

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// One 16-byte load of table elements, stored to shared memory as bf16.
template <typename T> struct TableLoad;

template <> struct TableLoad<__nv_bfloat16> {
  static constexpr int VEC = 8;
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

template <> struct TableLoad<int8_t> {
  static constexpr int VEC = 16;
  __device__ static void load(const int8_t* src, __nv_bfloat16* dst) {
    int4 raw = __ldg(reinterpret_cast<const int4*>(src));
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) __nv_bfloat16 v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = __float2bfloat16_rn(float(b[i]));  // |b| <= 127: exact
    reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(v)[0];
    reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(v)[1];
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
flat_scan_kernel(const __nv_bfloat16* __restrict__ q,  // (B*m, hq) bf16, zeros past h
                 const T* __restrict__ table,           // (docs_pad*dv, h)
                 void* __restrict__ scores,             // (docs_pad, B) fp32 or bf16
                 float* __restrict__ gmax,              // (n_groups, B), fused modes
                 int B, int m, int h, int hq, int dv, int docs_pad, int num_docs,
                 int group, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_A);
  float* Cs = reinterpret_cast<float*>(smem + SMEM_A + SMEM_B);
  float* Rm = reinterpret_cast<float*>(smem + SMEM_A + SMEM_B + SMEM_C);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 4, warp_n = warp % 4;

  const int g = blockIdx.x;
  const int64_t doc0 = int64_t(g) * group;
  const int64_t docs_left = int64_t(docs_pad) - doc0;
  const int ndocs = docs_left < group ? int(docs_left) : group;
  const int64_t row0 = doc0 * dv;
  const int nrows = ndocs * dv;
  const int qpt = N_TILE / m;  // whole queries per block
  const int q0 = blockIdx.y * qpt;
  const int nq = min(qpt, B - q0);
  const int ntok = nq * m;
  const int64_t tok0 = int64_t(q0) * m;

  // running max over each doc's rows, per token column
  for (int i = tid; i < ndocs * N_TILE; i += THREADS) Rm[i] = neg_inf();

  constexpr int VA = TableLoad<T>::VEC;
  const bool aligned = h % VA == 0;  // every row 16-byte aligned (the base is)
  for (int rt = 0; rt < nrows; rt += M_TILE) {
    const int mrows = min(M_TILE, nrows - rt);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < h; k0 += K_CHUNK) {
      const int kc = min(K_CHUNK, h - k0);
      const int kp = (kc + 15) & ~15;  // whole 16-dim steps: columns kc .. kp - 1 are zeros
      const int a_vecs = kp / VA;
      for (int i = tid; i < M_TILE * a_vecs; i += THREADS) {
        const int r = i / a_vecs, c = (i % a_vecs) * VA;
        __nv_bfloat16* dst = As + r * LDA + c;
        const T* src = table + (row0 + rt + r) * h + k0 + c;
        if (r >= mrows || c >= kc)
          TableLoad<T>::zero(dst);
        else if (aligned)  // then kc is a multiple of VA
          TableLoad<T>::load(src, dst);
        else
          TableLoad<T>::load_part(src, dst, min(VA, kc - c));
      }
      const int b_vecs = kp / 8;  // hq is a multiple of 64: whole vectors, zeros past h
      for (int i = tid; i < N_TILE * b_vecs; i += THREADS) {
        const int n = i / b_vecs, c = (i % b_vecs) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < ntok) v = __ldg(reinterpret_cast<const uint4*>(q + (tok0 + n) * hq + k0 + c));
        *reinterpret_cast<uint4*>(Bs + n * LDB + c) = v;
      }
      __syncthreads();
      for (int kk = 0; kk < kp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + (warp_m * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + (warp_n * 32 + j * 16) * LDB + kk, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (warp_m * 32 + i * 16) * LDC + warp_n * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();

    // fold this tile's rows into their docs' running max
    const int d_lo = rt / dv, d_hi = (rt + mrows - 1) / dv;
    const int c = tid % N_TILE;
    for (int d = d_lo + tid / N_TILE; d <= d_hi; d += THREADS / N_TILE) {
      const int r_beg = max(d * dv, rt) - rt;
      const int r_end = min((d + 1) * dv, rt + mrows) - rt;
      float mx = Rm[d * N_TILE + c];
      for (int r = r_beg; r < r_end; ++r) mx = fmaxf(mx, Cs[r * LDC + c]);
      Rm[d * N_TILE + c] = mx;
    }
    __syncthreads();
  }

  // sum over each query's views; fused modes round, mask and stage the group max
  float* Sc = Cs;  // (ndocs, qpt) rounded scores
  for (int i = tid; i < ndocs * qpt; i += THREADS) {
    const int d = i / qpt, qq = i % qpt;
    if (qq >= nq) continue;
    const float* rm = Rm + d * N_TILE + qq * m;
    float s = 0.0f;
    for (int v = 0; v < m; ++v) s += rm[v];
    const int64_t doc = doc0 + d;
    const size_t o = size_t(doc) * B + q0 + qq;
    if (mode == SCORES_F32) {
      static_cast<float*>(scores)[o] = s;
      continue;
    }
    float r;
    if (mode == FUSED_BF16) {
      __nv_bfloat16 sb = __float2bfloat16_rn(doc < num_docs ? s : neg_inf());
      static_cast<__nv_bfloat16*>(scores)[o] = sb;
      r = __bfloat162float(sb);
    } else {
      r = doc < num_docs ? s : neg_inf();
      static_cast<float*>(scores)[o] = r;
    }
    Sc[d * qpt + qq] = r;
  }
  if (mode != SCORES_F32) {
    __syncthreads();
    for (int qq = tid; qq < nq; qq += THREADS) {
      float mx = neg_inf();
      for (int d = 0; d < ndocs; ++d) mx = fmaxf(mx, Sc[d * qpt + qq]);
      gmax[size_t(g) * B + q0 + qq] = mx;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* table, void* scores, void* gmax,
                   int B, int m, int h, int hq, int dv, int docs_pad, int num_docs,
                   int group, int mode, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flat_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int qpt = N_TILE / m;
  dim3 grid((docs_pad + group - 1) / group, (B + qpt - 1) / qpt);
  flat_scan_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(table), scores,
      static_cast<float*>(gmax), B, m, h, hq, dv, docs_pad, num_docs, group, mode);
  return cudaGetLastError();
}


// ---- route "wgmma": TMA ring, warp-specialised wgmma, MaxSim in registers ----

namespace wg {

using namespace hopper;

constexpr int DV = 16;             // table rows a doc: one warp's 16 accumulator rows
constexpr int M = 16;              // views a query: two 8-column accumulator blocks
constexpr int ROWS = 128;          // table rows a tile: 2 consumer warpgroups x 64
constexpr int TOKS = 256;          // query tokens a tile (wgmma N)
constexpr int QPT = TOKS / M;      // 16 whole queries a tile
constexpr int DOCS = ROWS / DV;    // 8 docs a tile
constexpr int KS = 64;             // dims a stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;
constexpr int THREADS = 384;       // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr uint32_t A_BYTES = ROWS * KS * 2;   // bf16 table tile (the wgmma A operand)
constexpr uint32_t B_BYTES = TOKS * KS * 2;   // bf16 query tile (the wgmma B operand)
constexpr uint32_t A8_BYTES = ROWS * KS;      // raw int8 table tile, widened into A
constexpr int COPIERS = 128;       // the producer warpgroup, where it copies the table tile itself
constexpr int LAG = 2;             // stages a copying thread keeps in flight (< STAGES)

template <bool I8> struct Stage {
  static constexpr uint32_t bytes = A_BYTES + B_BYTES + (I8 ? A8_BYTES : 0);
  static constexpr uint32_t tx = (I8 ? A8_BYTES : A_BYTES) + B_BYTES;  // what TMA writes
  static constexpr size_t smem = size_t(STAGES) * bytes + 1024;          // + 1024-byte alignment
};
static_assert(Stage<true>::smem <= 232448 - 64, "the ring must fit a block's shared memory");
static_assert(A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0 && Stage<true>::bytes % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");
static_assert(KS == BOX_COLS, "a stage is one tensor-map box wide");

// d (+)= A[64 x 16] . B[256 x 16]^T, both K-major in shared memory, fp32 accumulation;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Max over the float bits: atomicMax of the int for values >= +0, atomicMin of
// the unsigned for negative ones (no NaN reaches here).  The buffer starts at -inf.
__device__ __forceinline__ void atomic_max_float(float* p, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(p), __float_as_uint(v));
}

}  // namespace wg

// COPIES: the table tiles come by the producer warpgroup's own copies of
// `table` (rows of h elements, pieces of w bytes), not by tmap_table.
template <bool I8, bool COPIES>
__global__ void __launch_bounds__(wg::THREADS, 1)
flat_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_table,  // (docs_pad*16, h) box 64 x 128
                       const __grid_constant__ CUtensorMap tmap_q,      // (B*16, hq) bf16, box 64 x 256
                       const unsigned char* __restrict__ table,         // (docs_pad*16, h): COPIES
                       void* __restrict__ scores,                       // (docs_pad, B) fp32 or bf16
                       float* __restrict__ gmax,                        // (n_groups, B), at -inf
                       int B, int h, int w, int docs_pad, int num_docs, int group, int mode,
                       int n_qtiles, int n_tiles, int nk) {
  using namespace wg;
  constexpr uint32_t SB = Stage<I8>::bytes;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // stage 0, shared window address
  unsigned char* const gbase = smem_raw + (base - raw);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], COPIES ? 1 + COPIERS : 1);  // the expect_tx (+ each copier's hand-off)
      mbar_init(&empty[s], 2 * 4);            // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    // ---- producer: one thread keeps the ring full, tile after tile (with
    // COPIES the warpgroup copies each table tile, the thread loads its query tile) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = threadIdx.x - 256;
    if (COPIES || pt == 0) {
      constexpr int ESZ = I8 ? 1 : 2;
      const long long pitch = (long long)h * ESZ, n_rows = (long long)docs_pad * DV;
      int stage = 0, pending = 0, oldest = 0;  // the ring slot; stages not yet handed over (COPIES)
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int row0 = (t / n_qtiles) * ROWS, tok0 = (t % n_qtiles) * TOKS;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          const uint32_t st = base + stage * SB;
          if (pt == 0) {
            mbar_expect_tx(&full[stage], COPIES ? B_BYTES : Stage<I8>::tx);
            if (!COPIES) tma_load(I8 ? st + A_BYTES + B_BYTES : st, &tmap_table, kb * KS, row0, &full[stage]);
            tma_load(st + A_BYTES, &tmap_q, kb * KS, tok0, &full[stage]);
          }
          if constexpr (COPIES) {
            const int valid = int(min(n_rows - row0, (long long)ROWS));
            const int nb = min(h - kb * KS, KS) * ESZ;
            const unsigned char* src = table + row0 * pitch + kb * KS * ESZ;
            if constexpr (I8)  // the raw tile, as TMA lands it: 64-byte rows, no swizzle
              copy_tile<ROWS, KS / 16>(w, st + A_BYTES + B_BYTES, src, pitch, valid, nb, pt, COPIERS,
                                       [](int r, int u) { return uint32_t(r * KS + u * 16); });
            else  // the swizzled bf16 A tile: 16-byte unit u of row r at (u ^ r % 8) in its 128-byte row
              copy_tile<ROWS, KS / 8>(w, st, src, pitch, valid, nb, pt, COPIERS,
                                      [](int r, int u) { return uint32_t(r * 128 + ((u ^ (r & 7)) * 16)); });
            copies_issued<LAG>(pending, oldest, full, STAGES);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      if constexpr (COPIES) copies_drained(pending, oldest, full, STAGES);
    }
  } else {
    // ---- consumers: 64 table rows x 256 tokens each, then the MaxSim epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    float d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int rtile = t / n_qtiles, qtile = t % n_qtiles;
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t st = base + stage * SB;
        if constexpr (I8) {
          // widen this warpgroup's 64 raw int8 rows into the swizzled bf16 tile
          unsigned char* const g = gbase + stage * SB;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int c = tid + 128 * j;  // 64 rows x 4 chunks of 16 int8
            const int r = wgi * 64 + c / 4, ch = c % 4;
            const uint4 w = *reinterpret_cast<const uint4*>(g + A_BYTES + B_BYTES + r * KS + ch * 16);
            uint4 lo, hi;
            widen4(w.x, lo.x, lo.y);
            widen4(w.y, lo.z, lo.w);
            widen4(w.z, hi.x, hi.y);
            widen4(w.w, hi.z, hi.w);
            *reinterpret_cast<uint4*>(g + r * 128 + (((2 * ch) ^ (r & 7)) * 16)) = lo;
            *reinterpret_cast<uint4*>(g + r * 128 + (((2 * ch + 1) ^ (r & 7)) * 16)) = hi;
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes -> wgmma
          asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wgi) : "memory");
        }
        const uint32_t a = st + wgi * (A_BYTES / 2), b = st + A_BYTES;
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
          wgmma_256(d, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32), (kb | kk) != 0);
        wgmma_commit();
        fence_acc(d);
        wgmma_wait<1>();  // the previous stage's products are done: release it
        fence_acc(d);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(&empty[prev]);

      // max over this warp's doc (its 16 rows): rows lane/4 and lane/4 + 8 in
      // the thread, the other 14 over lane bits 2-4; d[2j], d[2j+1] then hold
      // columns 8j + 2*(lane%4) + {0, 1}
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float x = fmaxf(d[4 * j], d[4 * j + 2]), y = fmaxf(d[4 * j + 1], d[4 * j + 3]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
          y = fmaxf(y, __shfl_xor_sync(0xffffffffu, y, o));
        }
        d[2 * j] = x;
        d[2 * j + 1] = y;
      }
      // sum over each query's 16 views (column blocks 2q, 2q+1): 4 in the
      // thread, the rest over lane bits 0-1; lane q keeps query q
      float mine = 0.0f;
#pragma unroll
      for (int q = 0; q < QPT; ++q) {
        float s = (d[4 * q] + d[4 * q + 1]) + (d[4 * q + 2] + d[4 * q + 3]);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (lane == q) mine = s;
      }
      const int64_t doc = int64_t(rtile) * DOCS + wgi * 4 + warp;
      const int qi = qtile * QPT + lane;
      if (lane < QPT && qi < B && doc < docs_pad) {
        const size_t o = size_t(doc) * B + qi;
        if (mode == SCORES_F32) {
          static_cast<float*>(scores)[o] = mine;
        } else {
          float r;
          if (mode == FUSED_BF16) {
            const __nv_bfloat16 sb = __float2bfloat16_rn(doc < num_docs ? mine : neg_inf());
            static_cast<__nv_bfloat16*>(scores)[o] = sb;
            r = __bfloat162float(sb);
          } else {
            r = doc < num_docs ? mine : neg_inf();
            static_cast<float*>(scores)[o] = r;
          }
          atomic_max_float(gmax + size_t(doc / group) * B + qi, r);
        }
      }
    }
  }
}

// The table by tensor map where its rows' pitch is a multiple of 16 bytes,
// else by the producer's copies.
template <bool I8, bool COPIES>
cudaError_t launch_wgmma(const void* q, const void* table, void* scores, void* gmax, int B, int h, int hq,
                         int docs_pad, int num_docs, int group, int mode, cudaStream_t stream) {
  using namespace wg;
  CUtensorMap map_table = {}, map_q;
  if ((!COPIES && !make_map(&map_table, table, I8, uint64_t(docs_pad) * DV, h, ROWS)) ||
      !make_map(&map_q, q, false, uint64_t(B) * M, hq, TOKS))
    return cudaErrorInvalidValue;
  const int n_qtiles = (B + QPT - 1) / QPT;
  const int64_t n_tiles = (int64_t(docs_pad) + DOCS - 1) / DOCS * n_qtiles;
  if (n_tiles > INT32_MAX) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flat_scan_wgmma_kernel<I8, COPIES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(Stage<I8>::smem));
  if (err != cudaSuccess) return err;
  const int grid = int(n_tiles < sms ? n_tiles : sms);
  flat_scan_wgmma_kernel<I8, COPIES><<<grid, wg::THREADS, Stage<I8>::smem, stream>>>(
      map_table, map_q, static_cast<const unsigned char*>(table), scores, static_cast<float*>(gmax), B, h,
      copy_width((long long)h * (I8 ? 1 : 2)), docs_pad, num_docs, group, mode, n_qtiles, int(n_tiles),
      (h + KS - 1) / KS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape limits the kernels take; the Python wrapper checks them first.
int flat_scan_max_tokens() { return N_TILE; }   // route "staged": views a query
int flat_scan_max_group() { return MAX_GROUP; } // route "staged": docs a block
int flat_scan_wgmma_dv() { return wg::DV; }     // route "wgmma": rows a doc
int flat_scan_wgmma_m() { return wg::M; }       // route "wgmma": views a query

// route 0 = "staged", 1 = "wgmma".  q: (B*m, hq) bf16, hq = h rounded up to
// a multiple of 64, zeros past h; any h >= 1.  Returns a cudaError_t: 0 when
// the launch was accepted.  The "wgmma" route needs gmax filled with -inf
// (modes 1, 2); both need 16-byte aligned q and table.
int flat_scan_launch(const void* q, const void* table, int table_int8, void* scores,
                     void* gmax, int B, int m, int h, int dv, int docs_pad,
                     int num_docs, int group, int mode, int route, void* stream) {
  const int hq = (h + 63) / 64 * 64;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(table)) % 16) return int(cudaErrorInvalidValue);
  if (B < 1 || m < 1 || m > N_TILE || h < 1 || dv < 1 ||
      docs_pad < 1 || group < 1 || group > MAX_GROUP || mode < 0 || mode > 2 ||
      int64_t(group) * dv > INT32_MAX || (mode != SCORES_F32 && gmax == nullptr) ||
      route < 0 || route > 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1) {
    if (dv != wg::DV || m != wg::M) return int(cudaErrorInvalidValue);
    const bool mapped = (table_int8 ? h : 2 * h) % 16 == 0;  // a row pitch a tensor map can describe
    if (table_int8)
      err = mapped ? launch_wgmma<true, false>(q, table, scores, gmax, B, h, hq, docs_pad, num_docs, group, mode, s)
                   : launch_wgmma<true, true>(q, table, scores, gmax, B, h, hq, docs_pad, num_docs, group, mode, s);
    else
      err = mapped ? launch_wgmma<false, false>(q, table, scores, gmax, B, h, hq, docs_pad, num_docs, group, mode, s)
                   : launch_wgmma<false, true>(q, table, scores, gmax, B, h, hq, docs_pad, num_docs, group, mode, s);
  } else {
    if ((B + N_TILE / m - 1) / (N_TILE / m) > 65535) return int(cudaErrorInvalidValue);
    err = table_int8
        ? launch<int8_t>(q, table, scores, gmax, B, m, h, hq, dv, docs_pad, num_docs, group, mode, s)
        : launch<__nv_bfloat16>(q, table, scores, gmax, B, m, h, hq, dv, docs_pad, num_docs, group, mode, s);
  }
  return int(err);
}

}  // extern "C"
