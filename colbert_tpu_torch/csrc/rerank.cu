// Fused candidate gather + exact MaxSim rerank for Hopper (sm_90a), bound with ctypes.
//
// Replaces two TPU kernels of colbert_tpu/ops/rerank_pallas.py:
//   K4  _kernel         (rerank_pallas.py:26, reached through maxsim_rerank_uniform):
//       bf16 table, queries rounded to bf16;
//   K5  _kernel_packed  (rerank_pallas.py:65, reached through
//       maxsim_rerank_uniform_packed): int8 table, fp32 queries with the
//       per-dim descale folded in by the caller.
// One kernel, templated on the table type.
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
// What bounds it: every candidate's dv x dim block is read once per
// (query, candidate) -- at the serving point (144 x 4,096 candidates x 16 x
// 768 bf16) 14.5 GB per batch, against 232 GFLOP, i.e. 16 FLOP per byte:
// far below the card's ~295 FLOP/B ridge, so the bytes bound it.  The design
// keeps the similarity tile out of device memory: one warp owns one
// candidate at a time, stages 16 doc rows x 128 dims in shared memory
// (16-byte loads; int8 widened to bf16 there), multiplies them against the
// query, held in shared memory for the whole block, with bf16 16x16x16 wmma
// fragments, and folds max-over-rows and sum-over-views in registers.
// cp.async/TMA pipelining, wgmma and candidate sorting are left for later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__host__ __device__ inline size_t q_bytes(int terms, int qv, int dim) {
  return align128(size_t(terms) * ((qv + 15) / 16 * 16) * (dim + 16) * 2);
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
  const int ldq = dim + 16;
  const size_t qb = q_bytes(TERMS, qv, dim);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem + qb) + warp * 16 * LDD;
  float* Cs = reinterpret_cast<float*>(smem + qb + D_BYTES) + warp * Q_TILES * 256;
  const int b = blockIdx.y;

  // the block's query, split into TERMS bf16 parts (term t: rows t*qv_pad..)
  for (int i = tid; i < qv_pad * dim; i += THREADS) {
    const int row = i / dim, k = i % dim;
    float x = row < qv ? Q[(int64_t(b) * qv + row) * dim + k] : 0.0f;
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
        const int kc = min(KC, dim - k0);  // a multiple of 16
        const int vecs = kc / VEC;
        __syncwarp();  // the previous tile is consumed
        for (int i = lane; i < 16 * vecs; i += 32) {
          const int rr = i / vecs, cc = (i % vecs) * VEC;
          __nv_bfloat16* dst = Ds + rr * LDD + cc;
          if (d0 + rr < dv)
            Rows<T>::load(doc + int64_t(d0 + rr) * dim + k0 + cc, dst);
          else
            Rows<T>::zero(dst);
        }
        __syncwarp();
        for (int kk = 0; kk < kc; kk += 16) {
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

}  // namespace

extern "C" {

// Shape limits the kernel takes; the Python wrapper checks them first.
int rerank_max_views() { return MAX_QV; }

// Returns a cudaError_t: 0 when the launch was accepted.
int rerank_launch(const void* cand, const void* q, const void* table, int table_int8,
                  void* out, int B, int C, int qv, int dim, int dv, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || qv < 1 || qv > MAX_QV || dim < 16 || dim % 16 != 0 || dv < 1)
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

}  // extern "C"
