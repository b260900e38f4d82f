// K3: all-pairs MaxSim in fp32.
//
// Replaces the TPU kernel of colbert_tpu/ops/maxsim.py (`_maxsim_kernel`,
// called by `maxsim_pallas`):
//
//     out[q, d] = sum over m of  max over n of  <Q[q, m], D[d, n]>
//
// with Q (nq, m, h) and D (nd, n, h) fp32, masks already applied (masked
// rows are zero vectors, so they score 0 inside the max, as the reference
// does), out (nq, nd) fp32.  Products and sums stay in fp32 (FMA on the
// CUDA cores, no TF32): the kernel agrees with the fp32 plain version to
// summation order.
//
// Bound: operations at the trainer's eval shape (34 x 16 query rows
// against 340 x 16 doc rows x 768: 4.5 GFLOP over 18 MB of inputs, 0.07 ms
// at the card's 67 TFLOP/s fp32 rate, 0.006 ms at 3.35 TB/s).
//
// Design: each block owns `tq` whole queries (their tq*m rows of Q) and
// `td` whole docs (their td*n rows of D), so the max over a doc's rows and
// the sum over a query's rows both finish inside the block; nothing is
// carried between blocks.  The block walks its Q rows in chunks of 64 and
// its D rows in chunks of 64; each 64 x 64 chunk of similarities is an
// SGEMM tile (k-steps of 32 through shared memory, 4 x 4 outputs per
// thread), written to shared memory and folded into a running max per
// (Q row, doc) held in shared memory.  A doc's rows may straddle two
// chunks (any n), and the last block may hold fewer docs (any nd).  The
// TPU kernel's (8, 128) tiling and its (n, td, h) doc-row transpose are
// not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 32, kThreads = 256;
constexpr int LD = BM + 1;  // padded row stride of the shared tiles (BM == BN)

__global__ void __launch_bounds__(kThreads)
maxsim_kernel(const float* __restrict__ Q, const float* __restrict__ D, float* __restrict__ out,
              int nq, int m, int nd, int n, int h, int tq, int td, int r_pad) {
  extern __shared__ float smem[];
  float* As = smem;               // [BK][LD]  Q chunk, k-major
  float* Bs = As + BK * LD;       // [BK][LD]  D chunk, k-major
  float* Cs = Bs + BK * LD;       // [BM][LD]  similarities of one chunk pair
  float* Smax = Cs + BM * LD;     // [r_pad][td] running max per (Q row, doc)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, cols tx + 16 j
  const int q0 = blockIdx.x * tq;
  const int d0 = blockIdx.y * td;
  const int rows = tq * m;
  const long long q_row0 = (long long)q0 * m, q_rows_total = (long long)nq * m;
  const int docs = min(td, nd - d0);
  const int cols = docs * n;
  const long long d_row0 = (long long)d0 * n;

  for (int i = tid; i < r_pad * td; i += kThreads) Smax[i] = -INFINITY;

  for (int rc = 0; rc < rows; rc += BM) {
    for (int cc = 0; cc < cols; cc += BN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

      for (int k0 = 0; k0 < h; k0 += BK) {
        for (int i = tid; i < BM * BK; i += kThreads) {
          const int r = i / BK, k = i % BK;
          const long long g = q_row0 + rc + r;
          As[k * LD + r] = (rc + r < rows && g < q_rows_total && k0 + k < h) ? Q[g * h + k0 + k] : 0.0f;
        }
        for (int i = tid; i < BN * BK; i += kThreads) {
          const int c = i / BK, k = i % BK;
          Bs[k * LD + c] = (cc + c < cols && k0 + k < h) ? D[(d_row0 + cc + c) * h + k0 + k] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k * LD + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Bs[k * LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Cs[(ty + 16 * i) * LD + tx + 16 * j] = acc[i][j];
      __syncthreads();

      // fold the chunk into the running max of every (Q row, doc) it touches
      const int c_end = min(cc + BN, cols);
      const int dlo = cc / n, dhi = (c_end - 1) / n;
      const int ndt = dhi - dlo + 1;
      const int r_end = min(BM, rows - rc);
      for (int p = tid; p < r_end * ndt; p += kThreads) {
        const int r = p / ndt, d = dlo + p % ndt;
        const int a = max(d * n, cc) - cc, b = min((d + 1) * n, c_end) - cc;
        float mx = -INFINITY;
        for (int c = a; c < b; ++c) mx = fmaxf(mx, Cs[r * LD + c]);
        float* s = Smax + (rc + r) * td + d;
        *s = fmaxf(*s, mx);
      }
      __syncthreads();
    }
  }

  for (int p = tid; p < tq * docs; p += kThreads) {
    const int ql = p / docs, d = p % docs;
    if (q0 + ql >= nq) continue;
    float s = 0.0f;
    for (int v = 0; v < m; ++v) s += Smax[(ql * m + v) * td + d];
    out[(long long)(q0 + ql) * nd + d0 + d] = s;
  }
}

constexpr long long kSmemFixed = 2 * BK * LD + BM * LD;  // floats: two k-tiles, one similarity tile
constexpr long long kSmemMax = 227 * 1024 / 4;  // floats a block may hold on sm_90

}  // namespace

// Q (nq*m, h), D (nd*n, h), out (nq, nd), all fp32 and contiguous.  Each
// block takes tq whole queries filling 64 Q rows (one query when m > 64)
// and td whole docs filling about 256 D rows (at most 64 docs), as far as
// its shared memory holds their running maxima.  Returns a cudaError_t (0
// on success); cudaErrorInvalidValue when one query's rows do not fit a
// block or the docs exceed the grid.
extern "C" int maxsim_launch(const float* Q, const float* D, float* out, int nq, int m, int nd, int n,
                             int h, void* stream) {
  if (nq <= 0 || nd <= 0) return 0;
  if (m < 1 || n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  const int tq = m < BM ? BM / m : 1;
  const long long r_pad = ((long long)tq * m + BM - 1) / BM * BM;
  const long long td_fit = (kSmemMax - kSmemFixed) / r_pad, td_want = n < 4 ? 64 : (256 + n - 1) / n;
  const int td = (int)(td_want < td_fit ? td_want : td_fit);
  if (td < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kSmemFixed + r_pad * td) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(maxsim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long gx = (nq + tq - 1) / tq, gy = (nd + td - 1) / td;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  maxsim_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      Q, D, out, nq, m, nd, n, h, tq, td, (int)r_pad);
  return (int)cudaGetLastError();
}
