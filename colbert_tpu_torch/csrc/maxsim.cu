// K3: all-pairs MaxSim in fp32.
//
// Replaces the TPU kernel of colbert_tpu/ops/maxsim.py (`_maxsim_kernel`,
// called by `maxsim_pallas`):
//
//     out[q, d] = sum over m of  max over n of  <Q[q, m], D[d, n]>
//
// with Q (nq, m, h) and D (nd, n, h) fp32, masks already applied (masked
// rows are zero vectors, so they score 0 inside the max, as the reference
// does), out (nq, nd) fp32.  Two routes (ops/maxsim.py::maxsim_plan):
//
// Route "tf32" (m = n = 16, h a multiple of 4: the trainer's multiview eval
// shape, 34 x 16 against 340 x 16 x 768).  Bound: the tensor cores' TF32
// rate.  fp32 agreement from TF32 products: each fp32 x splits at the
// fragment into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna: round to
// nearest, ties away), and a dot is hi.hi + hi.lo + lo.hi on
// mma.sync.m16n8k8 TF32 with fp32 accumulation, each 32-wide k-tile's sum
// in a fresh accumulator added to the running sum with round-to-nearest
// (the tensor cores truncate each mma's sum: one accumulator over a 768-dim
// dot put scores ~7e-6 off); the dropped lo.lo and lo's own rounding are
// ~2^-22 of a product, so a score agrees with fp32 to summation order.  13.6 GFLOP at the eval shape, 0.0275 ms at 495
// TFLOP/s.  Each block owns 12 queries x 8 docs (192 + 128 rows) and walks
// h in 32-wide k-tiles through a 4-stage cp.async ring (rows padded to 36
// floats: ldmatrix reads without bank conflicts); each of its 16 warps
// holds 3 queries x 2 docs, and a warp's 16 x 16 accumulator tile of one
// (query, doc) pair is the whole similarity block: the max over the doc's
// 16 columns and the sum over the query's 16 rows finish with shuffles
// over the quad and the groups.  No similarity reaches shared or device
// memory.
//
// Route "staged" (every other shape; the first design): products and sums in
// fp32 (FMA on the CUDA cores, no TF32), agreeing with the fp32 plain
// version to summation order.  Bound: operations (4.5 GFLOP at the eval
// shape, 0.07 ms at the card's 67 TFLOP/s fp32 rate).  Each block owns `tq`
// whole queries (their tq*m rows of Q) and `td` whole docs (their td*n rows
// of D), so the max over a doc's rows and the sum over a query's rows both
// finish inside the block; nothing is carried between blocks.  The block
// walks its Q rows in chunks of 64 and its D rows in chunks of 64; each
// 64 x 64 chunk of similarities is an SGEMM tile (k-steps of 32 through
// shared memory, 4 x 4 outputs per thread), written to shared memory and
// folded into a running max per (Q row, doc) held in shared memory.  A
// doc's rows may straddle two chunks (any n), and the last block may hold
// fewer docs (any nd).  The TPU kernel's (8, 128) tiling and its (n, td, h)
// doc-row transpose are not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // cp_async16, smem_u32

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

// ---- route "tf32" ----

constexpr int TQ = 12, TD = 8;             // queries and docs a block
constexpr int VIEWS = 16;                  // m = n: rows a query and a doc
constexpr int KT = 32, LDK = KT + 4;       // floats a k-tile row, and its padded stride
constexpr int STAGES = 4;
constexpr int Q_ROWS = TQ * VIEWS, D_ROWS = TD * VIEWS, ROWS = Q_ROWS + D_ROWS;
constexpr int TF32_THREADS = 512;          // 16 warps: 4 doc pairs x 4 quarters of the queries
constexpr int WQ = TQ / 4, WD = 2;         // queries and docs a warp
constexpr int TF32_SMEM = STAGES * ROWS * LDK * 4;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(p))
               : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x (fp32 bits) -> hi = tf32(x), lo = tf32(x - hi): x = hi + lo to ~2^-22.
__device__ __forceinline__ void split(const uint32_t (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = to_tf32(__uint_as_float(x[i]));
    lo[i] = to_tf32(__uint_as_float(x[i]) - __uint_as_float(hi[i]));
  }
}

// d += a * b for one m16n8k8 tile, TF32 operands, fp32 accumulation.  With
// g = lane / 4, q = lane % 4: a[0] (row g, k q), a[1] (row g+8, k q), a[2]
// (row g, k q+4), a[3] (row g+8, k q+4); b0 (k q, n g), b1 (k q+4, n g);
// d (row g, n 2q, 2q+1), then row g+8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
      " {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(TF32_THREADS, 1)
maxsim_tf32_kernel(const float* __restrict__ Q, const float* __restrict__ D, float* __restrict__ out, int nq,
                   int nd, int h) {
  extern __shared__ __align__(16) float tiles[];  // [STAGES][ROWS][LDK]: Q rows, then D rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * TD, q0 = blockIdx.y * TQ;
  const int wd = (warp & 3) * WD, wq = (warp >> 2) * WQ;  // this warp's first doc and query in the block
  const int n_k = (h + KT - 1) / KT;

  // k-tile kt into ring slot `slot`: 16-byte chunks, zero past h and past the last query or doc
  auto load = [&](int slot, int kt) {
    float* dst = tiles + slot * ROWS * LDK;
    for (int i = tid; i < ROWS * (KT / 4); i += TF32_THREADS) {
      const int row = i / (KT / 4), col = kt * KT + (i % (KT / 4)) * 4;
      const bool is_q = row < Q_ROWS;
      const int item = is_q ? q0 + row / VIEWS : d0 + (row - Q_ROWS) / VIEWS;
      const bool in = col < h && item < (is_q ? nq : nd);
      const float* src = is_q ? Q + (int64_t(q0) * VIEWS + row) * h : D + (int64_t(d0) * VIEWS + row - Q_ROWS) * h;
      hopper::cp_async16(hopper::smem_u32(dst + row * LDK + (i % (KT / 4)) * 4), in ? src + col : Q, in ? 16 : 0);
    }
  };

  float acc[WQ][WD][2][4];
#pragma unroll
  for (int i = 0; i < WQ; ++i)
#pragma unroll
    for (int j = 0; j < WD; ++j)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][t][e] = 0.0f;

  // ldmatrix row addresses: A (a query's 16 rows x 8 k) as matrices (rows
  // 0-7, k 0-3), (8-15, 0-3), (0-7, 4-7), (8-15, 4-7) = a[0..3]; B (a doc's
  // 16 rows x 8 k) as (0-7, 0-3), (0-7, 4-7), (8-15, 0-3), (8-15, 4-7) =
  // b0, b1 of n-tile 0, then of n-tile 1
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDK + (lane >> 4) * 4;
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * LDK + ((lane >> 3) & 1) * 4;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // k-tile kt is in; every warp is done with the slot refilled next
    if (kt + STAGES - 1 < n_k) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    hopper::cp_async_commit();
    const float* qt = tiles + (kt % STAGES) * ROWS * LDK + wq * VIEWS * LDK;
    const float* dt = tiles + (kt % STAGES) * ROWS * LDK + (Q_ROWS + wd * VIEWS) * LDK;
    // this k-tile's products sum apart and join acc with one rounded add:
    // the tensor cores truncate each mma's sum, and 288 of them into one
    // accumulator a dot cost ~7e-6 a score, 12 a k-tile ~4e-7
    float part[WQ][WD][2][4];
#pragma unroll
    for (int i = 0; i < WQ; ++i)
#pragma unroll
      for (int j = 0; j < WD; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][t][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KT / 8; ++ks) {
      uint32_t bh[WD][4], bl[WD][4];
#pragma unroll
      for (int j = 0; j < WD; ++j) {
        uint32_t x[4];
        ldmatrix_x4(x, dt + j * VIEWS * LDK + b_off + ks * 8);
        split(x, bh[j], bl[j]);
      }
      uint32_t ah[WQ][4], al[WQ][4];
#pragma unroll
      for (int i = 0; i < WQ; ++i) {
        uint32_t x[4];
        ldmatrix_x4(x, qt + i * VIEWS * LDK + a_off + ks * 8);
        split(x, ah[i], al[i]);
      }
      // the small terms first; consecutive products go to different
      // accumulators, so no product waits for the one before it
#pragma unroll
      for (int term = 0; term < 3; ++term)
#pragma unroll
        for (int i = 0; i < WQ; ++i)
#pragma unroll
          for (int j = 0; j < WD; ++j)
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const uint32_t(&a)[4] = term == 0 ? al[i] : ah[i];
              const uint32_t(&b)[4] = term == 1 ? bl[j] : bh[j];
              mma_tf32(part[i][j][t], a, b[2 * t], b[2 * t + 1]);
            }
    }
#pragma unroll
    for (int i = 0; i < WQ; ++i)
#pragma unroll
      for (int j = 0; j < WD; ++j)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][t][e] += part[i][j][t][e];
  }

  // MaxSim in registers: a thread holds rows g and g+8 of each pair's tile,
  // columns 2q, 2q+1 of both n-tiles
#pragma unroll
  for (int i = 0; i < WQ; ++i)
#pragma unroll
    for (int j = 0; j < WD; ++j) {
      const float(&c)[2][4] = acc[i][j];
      float m0 = fmaxf(fmaxf(c[0][0], c[0][1]), fmaxf(c[1][0], c[1][1]));  // row g
      float m1 = fmaxf(fmaxf(c[0][2], c[0][3]), fmaxf(c[1][2], c[1][3]));  // row g + 8
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      float sum = m0 + m1;
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const int qq = q0 + wq + i, dd = d0 + wd + j;
      if (lane == 0 && qq < nq && dd < nd) out[int64_t(qq) * nd + dd] = sum;
    }
}

}  // namespace

// Route "tf32": Q (nq*16, h), D (nd*16, h), out (nq, nd), all fp32,
// contiguous and 16-byte aligned, h a multiple of 4.  Returns a cudaError_t
// (0 on success); cudaErrorInvalidValue on another shape or when the
// queries exceed the grid.
extern "C" int maxsim_tf32_launch(const float* Q, const float* D, float* out, int nq, int nd, int h,
                                  void* stream) {
  if (nq <= 0 || nd <= 0) return 0;
  if (h < 4 || h % 4 || (reinterpret_cast<uintptr_t>(Q) | reinterpret_cast<uintptr_t>(D)) % 16)
    return (int)cudaErrorInvalidValue;
  const long long gy = (nq + TQ - 1) / TQ, gx = (nd + TD - 1) / TD;
  if (gy > 65535 || gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(maxsim_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TF32_SMEM);
  if (err != cudaSuccess) return (int)err;
  maxsim_tf32_kernel<<<dim3((unsigned)gx, (unsigned)gy), TF32_THREADS, TF32_SMEM, static_cast<cudaStream_t>(stream)>>>(
      Q, D, out, nq, nd, h);
  return (int)cudaGetLastError();
}

// The tile sizes of route "tf32", for the wrapper's checks.
extern "C" int maxsim_tf32_views() { return VIEWS; }

// Route "staged": Q (nq*m, h), D (nd*n, h), out (nq, nd), all fp32 and contiguous.  Each
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
