// Exact flat MaxSim scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces the two TPU kernels of colbert_tpu/ops/flat_scan.py:
//   K2  _flat_kernel        (flat_scan.py:59, reached through flat_maxsim_scan)
//   K1  _flat_kernel_fused  (flat_scan.py:157, reached through flat_scan_topk)
// One kernel; its epilogue switches between them (`mode`).
//
// What it computes, for queries Qm (B, m, h) rounded to bf16 by the caller
// and a doc-major table (docs_pad * dv, h) in bf16 or int8 (int8 rows enter
// the product as exact integers):
//   S[row, tok] = table[row] . q[tok]           fp32 accumulation
//   M[doc, tok] = max over the doc's dv rows     (zero rows score 0: no -inf)
//   score[doc, b] = sum over query b's m views of M[doc, b*m + v]
// K2 (mode 0) writes score (docs_pad, B) fp32.  K1 (modes 1 and 2) rounds the
// score to the stored dtype (fp32 or bf16, round-to-nearest-even), sets docs
// >= num_docs to -inf, writes it, and writes one fp32 max per (doc group,
// query) over the rounded values: the exact two-stage top-k reads only the
// winning groups (colbert_tpu_torch/ops/flat_scan.py).
//
// What bounds it: at B=144, m=16, h=768 every 1,536-byte bf16 table row is
// multiplied against 2,304 query tokens, 2*2304*768 FLOP per row, about
// 2,300 FLOP per byte read -- far above the H100's ~295 FLOP/B ridge.  The
// scan is compute-bound, so the design feeds the tensor cores: each block
// holds a 64-row table tile and a 128-token query tile in shared memory and
// multiplies them with bf16 16x16x16 wmma fragments (fp32 accumulators),
// then folds max-over-rows and sum-over-views in shared memory, so the
// (rows, tokens) similarity never reaches device memory.  One block covers
// one group of whole docs x one tile of whole queries.  wgmma, TMA, a
// multi-stage pipeline and a persistent grid are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flat_scan_kernel(const __nv_bfloat16* __restrict__ q,  // (B*m, h) bf16
                 const T* __restrict__ table,           // (docs_pad*dv, h)
                 void* __restrict__ scores,             // (docs_pad, B) fp32 or bf16
                 float* __restrict__ gmax,              // (n_groups, B), fused modes
                 int B, int m, int h, int dv, int docs_pad, int num_docs,
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
  for (int rt = 0; rt < nrows; rt += M_TILE) {
    const int mrows = min(M_TILE, nrows - rt);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < h; k0 += K_CHUNK) {
      const int kc = min(K_CHUNK, h - k0);  // a multiple of 16
      const int a_vecs = kc / VA;
      for (int i = tid; i < M_TILE * a_vecs; i += THREADS) {
        const int r = i / a_vecs, c = (i % a_vecs) * VA;
        __nv_bfloat16* dst = As + r * LDA + c;
        if (r < mrows)
          TableLoad<T>::load(table + (row0 + rt + r) * h + k0 + c, dst);
        else
          TableLoad<T>::zero(dst);
      }
      const int b_vecs = kc / 8;
      for (int i = tid; i < N_TILE * b_vecs; i += THREADS) {
        const int n = i / b_vecs, c = (i % b_vecs) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < ntok) v = __ldg(reinterpret_cast<const uint4*>(q + (tok0 + n) * h + k0 + c));
        *reinterpret_cast<uint4*>(Bs + n * LDB + c) = v;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 16) {
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
                   int B, int m, int h, int dv, int docs_pad, int num_docs,
                   int group, int mode, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flat_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const int qpt = N_TILE / m;
  dim3 grid((docs_pad + group - 1) / group, (B + qpt - 1) / qpt);
  flat_scan_kernel<T><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(table), scores,
      static_cast<float*>(gmax), B, m, h, dv, docs_pad, num_docs, group, mode);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shape limits the kernel takes; the Python wrapper checks them first.
int flat_scan_max_tokens() { return N_TILE; }
int flat_scan_max_group() { return MAX_GROUP; }

// Returns a cudaError_t: 0 when the launch was accepted.
int flat_scan_launch(const void* q, const void* table, int table_int8, void* scores,
                     void* gmax, int B, int m, int h, int dv, int docs_pad,
                     int num_docs, int group, int mode, void* stream) {
  if (B < 1 || m < 1 || m > N_TILE || h < 16 || h % 16 != 0 || dv < 1 ||
      docs_pad < 1 || group < 1 || group > MAX_GROUP || mode < 0 || mode > 2 ||
      int64_t(group) * dv > INT32_MAX || (B + N_TILE / m - 1) / (N_TILE / m) > 65535 ||
      (mode != SCORES_F32 && gmax == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = table_int8
      ? launch<int8_t>(q, table, scores, gmax, B, m, h, dv, docs_pad, num_docs, group, mode, s)
      : launch<__nv_bfloat16>(q, table, scores, gmax, B, m, h, dv, docs_pad, num_docs, group, mode, s);
  return int(err);
}

}  // extern "C"
