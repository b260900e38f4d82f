// K11-K13: flash attention with segment-id masking, forward and backward.
//
// Replaces the three TPU kernels of jax.experimental.pallas.ops.tpu.
// flash_attention (jax 0.9.0, jax/experimental/pallas/ops/tpu/
// flash_attention.py) that colbert_tpu/models/bert.py:181-200 runs under
// model.attention_impl="flash":
//
//   K11  _flash_attention_kernel (pallas_call at :758): o = softmax(q k^T *
//        scale + mask) v with a running max m and sum l over 128-key blocks;
//        saves l and m per row;
//   K12  _flash_attention_dkv_kernel (:1121): dK and dV from p recomputed
//        as exp(s - m) * (1 / l);
//   K13  _flash_attention_dq_kernel (:1456): dQ from the same ds.
//
// Arithmetic kept from the JAX kernels (ops/flash_attention.py holds the
// plain version in the same order): s = (q . k) in fp32, times scale, plus
// 0 or MASK_VALUE (-0.7 FLT_MAX, added, never -inf) by segment equality
// q_seg[i] == kv_seg[j]; the forward's max and sum run over 128-key blocks,
// the JAX block, so m and every p are the JAX kernel's but for the fp32
// summation order of q . k: p = exp(s - m_next) rounded to the input type
// before p . v, acc = acc * (l_corr / l_next) + (p . v) / l_next (with one
// block, L = 128: p / l rounded instead); the backward's p = exp(s - m) *
// (1 / l), ds = (dp - di) * p * scale, each cast to the input type before
// its product; fp32 accumulation everywhere, one rounding of each output.
// Route "wgmma" takes exp(x) as 2^(x log2 e) by the MUFU (ex2.approx, 2 ulps,
// where the first design's expf has 1), from the same x = s - m.
//
// Route "simple" (the first design, on request only): mma.sync m16n8k16
// (bf16 or fp16, fp32 accumulators) on tiles in
// shared memory with the 16-byte chunks of each 128-byte row XOR-swizzled by
// the row (ldmatrix without bank conflicts), filled by cp.async two tiles
// deep.  A block is four warps of 16 rows.  A product's accumulators become
// the next product's A operand in registers (the C fragments of two n-tiles
// are one A fragment of k 16), so no logit or probability reaches shared or
// device memory.
//   K11: a block owns 64 query rows of one (batch, head) and walks the
//        keys in 128-key tiles (K, V and their segment ids); the online
//        softmax state stays in registers (rows g and g + 8 of each warp).
//   K12: a block owns 64 keys, their K and V rows held as A fragments, and
//        walks the queries in 64-row tiles (Q, dO, m, 1 / l, di, segment
//        ids): S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q.
//   K13: a block owns 64 query rows, Q and dO held as A fragments, and
//        walks the keys in 64-key tiles: S = Q K^T, dP = dO V^T, dQ += dS K.
// di = rowsum(o * do) comes from the caller (outside the JAX kernels too).
//
// Route "wgmma" (every shape the kernels take): persistent blocks of
// consumer warpgroups and one producer warpgroup whose one thread feeds a
// ring of tiles by TMA (4-D tensor maps over the heads-major views,
// 128-byte swizzle) on mbarriers; setmaxnreg moves the producer's registers
// to the consumers; the products are wgmma with the B operand in shared
// memory (K-major, or MN-major with the transpose bit for P V, P^T dO,
// dS^T Q and dS K) and the A operand in registers; outputs leave through a
// warp's 2 KB of shared memory as whole 128-byte rows.
//   K11: 192 query rows a block where they tile Lq (three consumer
//        warpgroups), else 128; Q loaded once a tile into A fragments; K, V
//        and key segment ids 128 keys a stage, three stages.
//   K12: 128 keys a block (two consumer warpgroups), K and V in A fragments
//        once a tile; Q, dO and the rows' m, 1 / l, di and segment ids 64
//        queries a stage, eight stages; dV's and dK's products left running
//        under the next stage's S^T and dP^T.
//   K13: 128 query rows a block (two consumer warpgroups); Q and dO in A
//        fragments and the rows' m, 1 / l, di and segment ids in registers
//        once a tile; K, V and key segment ids 64 keys a stage, eight
//        stages; dQ's product left running under the next stage's S and dP.
// The rows kernel (flash_bwd_rows_launch) gives route "wgmma" its inputs
// once a row: di from o and do read once in their type, and 1 / l.
// The backward is the JAX split: dK/dV over key blocks, dQ over query
// blocks, each sum in one block's registers, no atomics, so two runs give
// the same bits.  Layouts: each of q, k, v, o, do, dq, dk, dv is (B, nh, L,
// 64) with its own (batch, head, row) strides in elements and unit stride
// along the head dim, rows 16-byte aligned; segment ids (B, L) int32 and l,
// m, di (B, nh, L) fp32 contiguous and 16-byte aligned.
//
// Bounds on the card (989 TFLOP/s bf16, 3.35 TB/s), at the retriever's doc
// pass (68, 12, 384, 64) bf16: K11 reads q, k, v and writes o, 160 MB, 0.048
// ms, against 4 L^2 hd flops a head, 3.1e10, 0.031 ms: bytes.  K12 does four
// L^2 hd products (5.2e10 flops, 0.052 ms) and moves q, k, v, do, dk, dv
// (241 MB, 0.072 ms): bytes; K13 three products (3.9e10, 0.039 ms) and q, k,
// v, do, dq (200 MB, 0.060 ms): bytes.  Route "simple" re-reads K/V (K12:
// Q/dO) once for every 64-row block of a head, from L2, issues one ldmatrix
// a B fragment and stores outputs 4 bytes a lane (half sectors).  Route
// "wgmma" re-reads them once for every 192 (K12, K13: 128) rows, feeds the tensor
// cores from shared memory without ldmatrix, and stores whole rows; what
// stays is the exponentials' and the mask's issue slots and, in K12, the
// dK/dV stores (PERF.md §6).

#include <algorithm>
#include <atomic>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async, mma.sync, mbarriers, wgmma descriptors and fences, the tensor-map encoder

namespace {

constexpr int HD = 64;            // head dim
constexpr int THREADS = 128;      // four warps of 16 rows
constexpr int ROWS = 64;          // rows a block owns (queries in K11/K13, keys in K12)
constexpr int FWD_TILE = 128;     // keys a K11 tile: the JAX kernel's block
constexpr int BWD_TILE = 64;      // keys (K13) or queries (K12) a backward tile
constexpr float MASK_VALUE = (float)(-0.7 * 3.4028234663852886e38);  // DEFAULT_MASK_VALUE
constexpr int kMaxDevices = 64;

struct View {
  long long sb, sh, sl;  // batch, head and row strides in elements
};

__device__ __forceinline__ void mma_f16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> struct Type;
template <> struct Type<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    hopper::mma_bf16_16816(d, a, b0, b1);
  }
  // (lo, hi) rounded to nearest, lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
};
template <> struct Type<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_f16_16816(d, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ float f(__half x) { return __half2float(x); }
};

// Element offset of (row, 16-byte chunk) in a tile of 64-element rows, the
// chunk XOR-swizzled by the row's low three bits.
__device__ __forceinline__ int swz(int row, int chunk) { return row * HD + ((chunk ^ (row & 7)) << 3); }

// `rows` rows of 64 elements from `g` (row stride `sl`) into a swizzled tile.
template <int R, typename T>
__device__ __forceinline__ void load_tile(T* tile, const T* g, long long sl, int tid) {
#pragma unroll
  for (int i = tid; i < R * 8; i += THREADS) {
    const int r = i >> 3, c = i & 7;
    hopper::cp_async16(hopper::smem_u32(tile + swz(r, c)), g + r * sl + c * 8, 16);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A fragment (16 rows from row0, k-step ks of 16) of a row-major tile.
template <typename T>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* tile, int row0, int ks, int lane) {
  const int row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(a, hopper::smem_u32(tile + swz(row, ks * 2 + (lane >> 4))));
}

// B fragments of n-tiles n0 and n0 + 8 (k-step ks) from a tile stored [n][k]:
// b[0], b[1] for n-tile n0, b[2], b[3] for n0 + 8.
template <typename T>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const T* tile, int n0, int ks, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  ldsm_x4(b, hopper::smem_u32(tile + swz(row, ks * 2 + ((lane >> 3) & 1))));
}

// B fragments of n-tiles 8 * c0 and 8 * (c0 + 1) (k rows k0 .. k0 + 15) from a
// tile stored [k][n]: the same order as load_b_nk.
template <typename T>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const T* tile, int k0, int c0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4_trans(b, hopper::smem_u32(tile + swz(row, c0 + (lane >> 4))));
}

// The A fragment of k-step kk from the fp32 accumulators of n-tiles 2kk and 2kk + 1.
template <typename T, int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = Type<T>::pack(c[2 * kk][0], c[2 * kk][1]);
  a[1] = Type<T>::pack(c[2 * kk][2], c[2 * kk][3]);
  a[2] = Type<T>::pack(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = Type<T>::pack(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

// Two fp32 accumulator rows (g and g + 8 of a warp's 16) rounded to T at
// `out` (row stride `sl`): columns 8 j + 2 (lane % 4) and the next.
template <typename T, int N>
__device__ __forceinline__ void store_rows(T* out, long long sl, const float (&c)[N][4], int lane) {
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    *reinterpret_cast<uint32_t*>(out + j * 8 + col) = Type<T>::pack(c[j][0], c[j][1]);
    *reinterpret_cast<uint32_t*>(out + 8 * sl + j * 8 + col) = Type<T>::pack(c[j][2], c[j][3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s * scale, then the mask added: the JAX kernels' two roundings.
__device__ __forceinline__ float masked(float s, float scale, bool visible) {
  return __fadd_rn(__fmul_rn(s, scale), visible ? 0.0f : MASK_VALUE);
}

// ---- K11: forward ----

constexpr int FWD_SMEM = (ROWS * HD + 4 * FWD_TILE * HD) * 2 + 2 * FWD_TILE * 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V, T* __restrict__ O,
                 const int* __restrict__ qseg, const int* __restrict__ kvseg, float* __restrict__ l_out,
                 float* __restrict__ m_out, View vq, View vk, View vv, View vo, int nh, int Lq, int Lk,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);       // [64][64]
  T* sK = sQ + ROWS * HD;                    // [2][128][64]
  T* sV = sK + 2 * FWD_TILE * HD;            // [2][128][64]
  int* sSeg = reinterpret_cast<int*>(sV + 2 * FWD_TILE * HD);  // [2][128]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, qd = lane & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const T* Kb = K + b * vk.sb + h * vk.sh;
  const T* Vb = V + b * vv.sb + h * vv.sh;
  const int* kvs = kvseg + (long long)b * Lk;
  const int n_tiles = Lk / FWD_TILE;

  auto load_kv = [&](int t, int buf) {
    load_tile<FWD_TILE>(sK + buf * FWD_TILE * HD, Kb + (long long)t * FWD_TILE * vk.sl, vk.sl, tid);
    load_tile<FWD_TILE>(sV + buf * FWD_TILE * HD, Vb + (long long)t * FWD_TILE * vv.sl, vv.sl, tid);
    if (tid < FWD_TILE / 4)
      hopper::cp_async16(hopper::smem_u32(sSeg + buf * FWD_TILE + tid * 4), kvs + t * FWD_TILE + tid * 4, 16);
  };
  load_tile<ROWS>(sQ, Q + b * vq.sb + h * vq.sh + (long long)q0 * vq.sl, vq.sl, tid);
  load_kv(0, 0);
  hopper::cp_async_commit();

  const int row = warp * 16 + (lane >> 2);  // this thread's rows: row and row + 8 of the block
  const int* qs = qseg + (long long)b * Lq + q0;
  const int seg0 = qs[row], seg1 = qs[row + 8];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float acc[HD / 8][4];
  zero(acc);
  uint32_t qf[HD / 16][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) load_a(qf[ks], sQ, warp * 16, ks, lane);
    }
    const T* kt = sK + buf * FWD_TILE * HD;
    const T* vt = sV + buf * FWD_TILE * HD;
    const int* st = sSeg + buf * FWD_TILE;

    float s[FWD_TILE / 8][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
      for (int np = 0; np < FWD_TILE / 16; ++np) {
        uint32_t bb[4];
        load_b_nk(bb, kt, np * 16, ks, lane);
        Type<T>::mma(s[2 * np], qf[ks], bb[0], bb[1]);
        Type<T>::mma(s[2 * np + 1], qf[ks], bb[2], bb[3]);
      }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < FWD_TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * qd + (e & 1);
        s[j][e] = masked(s[j][e], scale, (e < 2 ? seg0 : seg1) == st[key]);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float m_next[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) m_next[r] = fmaxf(m_run[r], quad_max(mx[r]));
#pragma unroll
    for (int j = 0; j < FWD_TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_next[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    float inv[2];
    if (n_tiles == 1) {
      // the JAX kernel's single-step form: p / l rounded, o = (p / l) . v
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] = quad_sum(sum[r]);
        m_run[r] = m_next[r];
      }
#pragma unroll
      for (int j = 0; j < FWD_TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = __fdiv_rn(s[j][e], l_run[e >> 1]);
      inv[0] = inv[1] = 1.0f;
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_corr = __fmul_rn(expf(m_run[r] - m_next[r]), l_run[r]);
        const float l_next = __fadd_rn(quad_sum(sum[r]), l_corr);
        inv[r] = l_next == 0.0f ? 1.0f : __fdiv_rn(1.0f, l_next);
        const float keep = __fmul_rn(l_corr, inv[r]);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          acc[j][2 * r] = __fmul_rn(acc[j][2 * r], keep);
          acc[j][2 * r + 1] = __fmul_rn(acc[j][2 * r + 1], keep);
        }
        l_run[r] = l_next;
        m_run[r] = m_next[r];
      }
    }
    float pv[HD / 8][4];
    zero(pv);
#pragma unroll
    for (int kk = 0; kk < FWD_TILE / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<T>(a, s, kk);
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        uint32_t bb[4];
        load_b_kn(bb, vt, kk * 16, 2 * c, lane);
        Type<T>::mma(pv[2 * c], a, bb[0], bb[1]);
        Type<T>::mma(pv[2 * c + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(pv[j][e], inv[e >> 1]));
    __syncthreads();  // every warp is done with `buf` before the next tile's copy refills it
  }

  store_rows(O + b * vo.sb + h * vo.sh + (long long)(q0 + row) * vo.sl, vo.sl, acc, lane);
  if (qd == 0) {
    const long long i = ((long long)b * nh + h) * Lq + q0 + row;
    l_out[i] = l_run[0];
    l_out[i + 8] = l_run[1];
    m_out[i] = m_run[0];
    m_out[i + 8] = m_run[1];
  }
}

// ---- K12: dK and dV ----

constexpr int DKV_SMEM = 4 * BWD_TILE * HD * 2 + 2 * 4 * BWD_TILE * 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                 const int* __restrict__ qseg, const int* __restrict__ kvseg, const float* __restrict__ l_in,
                 const float* __restrict__ m_in, const T* __restrict__ dO, const float* __restrict__ di_in,
                 T* __restrict__ dK, T* __restrict__ dV, View vq, View vk, View vv, View vdo, View vdk, View vdv,
                 int nh, int Lq, int Lk, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);       // [2][64][64]; first the block's K rows
  T* sO = sQ + 2 * BWD_TILE * HD;            // [2][64][64] dO; first the block's V rows
  float* sM = reinterpret_cast<float*>(sO + 2 * BWD_TILE * HD);  // [2][64]
  float* sInvL = sM + 2 * BWD_TILE;                                // [2][64]
  float* sDi = sInvL + 2 * BWD_TILE;                               // [2][64]
  int* sSeg = reinterpret_cast<int*>(sDi + 2 * BWD_TILE);          // [2][64]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, qd = lane & 3;
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const T* Qb = Q + b * vq.sb + h * vq.sh;
  const T* Ob = dO + b * vdo.sb + h * vdo.sh;
  const long long bh = ((long long)b * nh + h) * Lq;
  const int n_tiles = Lq / BWD_TILE;
  const int row = warp * 16 + (lane >> 2);  // this thread's keys: row and row + 8 of the block
  const int kseg0 = kvseg[(long long)b * Lk + k0 + row], kseg1 = kvseg[(long long)b * Lk + k0 + row + 8];

  // the block's K and V rows -> A fragments, through the tiles' second buffers
  load_tile<ROWS>(sQ + BWD_TILE * HD, K + b * vk.sb + h * vk.sh + (long long)k0 * vk.sl, vk.sl, tid);
  load_tile<ROWS>(sO + BWD_TILE * HD, V + b * vv.sb + h * vv.sh + (long long)k0 * vv.sl, vv.sl, tid);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[HD / 16][4], vf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    load_a(kf[ks], sQ + BWD_TILE * HD, warp * 16, ks, lane);
    load_a(vf[ks], sO + BWD_TILE * HD, warp * 16, ks, lane);
  }
  __syncthreads();

  auto load_q = [&](int t, int buf) {
    const long long r0 = (long long)t * BWD_TILE;
    load_tile<BWD_TILE>(sQ + buf * BWD_TILE * HD, Qb + r0 * vq.sl, vq.sl, tid);
    load_tile<BWD_TILE>(sO + buf * BWD_TILE * HD, Ob + r0 * vdo.sl, vdo.sl, tid);
    if (tid < BWD_TILE) {
      sM[buf * BWD_TILE + tid] = m_in[bh + r0 + tid];
      sInvL[buf * BWD_TILE + tid] = __fdiv_rn(1.0f, l_in[bh + r0 + tid]);
      sDi[buf * BWD_TILE + tid] = di_in[bh + r0 + tid];
      sSeg[buf * BWD_TILE + tid] = qseg[(long long)b * Lq + r0 + tid];
    }
  };
  load_q(0, 0);
  hopper::cp_async_commit();

  float dk[HD / 8][4], dv[HD / 8][4];
  zero(dk);
  zero(dv);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_q(t + 1, buf ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const T* qt = sQ + buf * BWD_TILE * HD;
    const T* ot = sO + buf * BWD_TILE * HD;
    const float* mt = sM + buf * BWD_TILE;
    const float* it = sInvL + buf * BWD_TILE;
    const float* dt = sDi + buf * BWD_TILE;
    const int* segt = sSeg + buf * BWD_TILE;

    float p[BWD_TILE / 8][4], ds[BWD_TILE / 8][4];  // S^T, then P^T; dP^T, then dS^T
    zero(p);
    zero(ds);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
      for (int np = 0; np < BWD_TILE / 16; ++np) {
        uint32_t bq[4], bo[4];
        load_b_nk(bq, qt, np * 16, ks, lane);
        load_b_nk(bo, ot, np * 16, ks, lane);
        Type<T>::mma(p[2 * np], kf[ks], bq[0], bq[1]);
        Type<T>::mma(p[2 * np + 1], kf[ks], bq[2], bq[3]);
        Type<T>::mma(ds[2 * np], vf[ks], bo[0], bo[1]);
        Type<T>::mma(ds[2 * np + 1], vf[ks], bo[2], bo[3]);
      }
#pragma unroll
    for (int j = 0; j < BWD_TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * qd + (e & 1);
        const float x = masked(p[j][e], scale, (e < 2 ? kseg0 : kseg1) == segt[qi]);
        p[j][e] = __fmul_rn(expf(x - mt[qi]), it[qi]);
        ds[j][e] = __fmul_rn(__fmul_rn(__fsub_rn(ds[j][e], dt[qi]), p[j][e]), scale);
      }
#pragma unroll
    for (int kk = 0; kk < BWD_TILE / 16; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a<T>(ap, p, kk);
      acc_to_a<T>(as, ds, kk);
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        uint32_t bo[4], bq[4];
        load_b_kn(bo, ot, kk * 16, 2 * c, lane);
        load_b_kn(bq, qt, kk * 16, 2 * c, lane);
        Type<T>::mma(dv[2 * c], ap, bo[0], bo[1]);
        Type<T>::mma(dv[2 * c + 1], ap, bo[2], bo[3]);
        Type<T>::mma(dk[2 * c], as, bq[0], bq[1]);
        Type<T>::mma(dk[2 * c + 1], as, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  store_rows(dK + b * vdk.sb + h * vdk.sh + (long long)(k0 + row) * vdk.sl, vdk.sl, dk, lane);
  store_rows(dV + b * vdv.sb + h * vdv.sh + (long long)(k0 + row) * vdv.sl, vdv.sl, dv, lane);
}

// ---- K13: dQ ----

constexpr int DQ_SMEM = 4 * BWD_TILE * HD * 2 + 2 * BWD_TILE * 4;

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                const int* __restrict__ qseg, const int* __restrict__ kvseg, const float* __restrict__ l_in,
                const float* __restrict__ m_in, const T* __restrict__ dO, const float* __restrict__ di_in,
                T* __restrict__ dQ, View vq, View vk, View vv, View vdo, View vdq, int nh, int Lq, int Lk,
                float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);       // [2][64][64]; first the block's Q rows
  T* sV = sK + 2 * BWD_TILE * HD;            // [2][64][64]; first the block's dO rows
  int* sSeg = reinterpret_cast<int*>(sV + 2 * BWD_TILE * HD);  // [2][64]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, qd = lane & 3;
  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const T* Kb = K + b * vk.sb + h * vk.sh;
  const T* Vb = V + b * vv.sb + h * vv.sh;
  const int* kvs = kvseg + (long long)b * Lk;
  const int n_tiles = Lk / BWD_TILE;
  const int row = warp * 16 + (lane >> 2);  // this thread's rows: row and row + 8 of the block
  const long long i0 = ((long long)b * nh + h) * Lq + q0 + row;
  const int seg0 = qseg[(long long)b * Lq + q0 + row], seg1 = qseg[(long long)b * Lq + q0 + row + 8];
  const float m_row[2] = {m_in[i0], m_in[i0 + 8]};
  const float inv_l[2] = {__fdiv_rn(1.0f, l_in[i0]), __fdiv_rn(1.0f, l_in[i0 + 8])};
  const float di[2] = {di_in[i0], di_in[i0 + 8]};

  load_tile<ROWS>(sK + BWD_TILE * HD, Q + b * vq.sb + h * vq.sh + (long long)q0 * vq.sl, vq.sl, tid);
  load_tile<ROWS>(sV + BWD_TILE * HD, dO + b * vdo.sb + h * vdo.sh + (long long)q0 * vdo.sl, vdo.sl, tid);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[HD / 16][4], of[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    load_a(qf[ks], sK + BWD_TILE * HD, warp * 16, ks, lane);
    load_a(of[ks], sV + BWD_TILE * HD, warp * 16, ks, lane);
  }
  __syncthreads();

  auto load_kv = [&](int t, int buf) {
    load_tile<BWD_TILE>(sK + buf * BWD_TILE * HD, Kb + (long long)t * BWD_TILE * vk.sl, vk.sl, tid);
    load_tile<BWD_TILE>(sV + buf * BWD_TILE * HD, Vb + (long long)t * BWD_TILE * vv.sl, vv.sl, tid);
    if (tid < BWD_TILE / 4)
      hopper::cp_async16(hopper::smem_u32(sSeg + buf * BWD_TILE + tid * 4), kvs + t * BWD_TILE + tid * 4, 16);
  };
  load_kv(0, 0);
  hopper::cp_async_commit();

  float dq[HD / 8][4];
  zero(dq);
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const T* kt = sK + buf * BWD_TILE * HD;
    const T* vt = sV + buf * BWD_TILE * HD;
    const int* segt = sSeg + buf * BWD_TILE;

    float s[BWD_TILE / 8][4], ds[BWD_TILE / 8][4];  // S, then dS; dP
    zero(s);
    zero(ds);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
      for (int np = 0; np < BWD_TILE / 16; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, kt, np * 16, ks, lane);
        load_b_nk(bv, vt, np * 16, ks, lane);
        Type<T>::mma(s[2 * np], qf[ks], bk[0], bk[1]);
        Type<T>::mma(s[2 * np + 1], qf[ks], bk[2], bk[3]);
        Type<T>::mma(ds[2 * np], of[ks], bv[0], bv[1]);
        Type<T>::mma(ds[2 * np + 1], of[ks], bv[2], bv[3]);
      }
#pragma unroll
    for (int j = 0; j < BWD_TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, key = j * 8 + 2 * qd + (e & 1);
        const float x = masked(s[j][e], scale, (r ? seg1 : seg0) == segt[key]);
        const float p = __fmul_rn(expf(x - m_row[r]), inv_l[r]);
        s[j][e] = __fmul_rn(__fmul_rn(__fsub_rn(ds[j][e], di[r]), p), scale);
      }
#pragma unroll
    for (int kk = 0; kk < BWD_TILE / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<T>(a, s, kk);
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        uint32_t bk[4];
        load_b_kn(bk, kt, kk * 16, 2 * c, lane);
        Type<T>::mma(dq[2 * c], a, bk[0], bk[1]);
        Type<T>::mma(dq[2 * c + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }
  store_rows(dQ + b * vdq.sb + h * vdq.sh + (long long)(q0 + row) * vdq.sl, vdq.sl, dq, lane);
}

// ---- route "wgmma": K11-K13 fed by TMA, warp-specialised wgmma ----

namespace wg {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::sw128_desc;

constexpr int KT = 128;                       // keys a K11 tile (the JAX block) and keys a K12 block
constexpr int QT = 64;                        // queries a K12 tile
constexpr int FWD_STAGES = 3;                 // K/V tiles in flight in K11
constexpr int DKV_STAGES = 8;                 // Q/dO tiles in flight in K12
constexpr int DQ_KT = 64;                     // keys a K13 tile
constexpr int DQ_STAGES = 8;                  // K/V tiles in flight in K13
constexpr uint32_t ROW = HD * 2;         // a row of 64 elements: one 128-byte swizzle row
constexpr uint32_t WG_ROWS = 64 * ROW;   // a warpgroup's 64 rows
constexpr uint32_t KV_BYTES = KT * ROW;  // a 128-row tile
constexpr uint32_t QT_BYTES = QT * ROW;  // a 64-row tile
constexpr uint32_t DQ_KV_BYTES = DQ_KT * ROW;  // a K13 key tile
static_assert(WG_ROWS % 1024 == 0 && KV_BYTES % 1024 == 0 && QT_BYTES % 1024 == 0 && DQ_KV_BYTES % 1024 == 0,
              "128-byte swizzle atoms are 1024-byte aligned");

// A tile read as an MN-major B (V in O += P V, dO in dV += P^T dO, Q in dK
// += dS^T Q: rows of 64 elements along N, one row a K index, 128-byte
// swizzle) takes sw128_desc too: there SBO is the distance between 8-row
// groups along K (1024 bytes) and LBO, the distance between 64-wide atoms
// along N, is never used at N = 64.  The instruction's transpose bit tells
// the two layouts apart; a k-step of 16 rows is 2048 bytes.

// masked() as a select: s * scale, or MASK_VALUE where the key is not
// visible.  The same bits: |s * scale| is far below half an ulp of
// MASK_VALUE (2^103), so masked()'s sum rounds to MASK_VALUE, and a visible
// -0 + 0 differs only in the sign of zero, which no later step sees.
__device__ __forceinline__ float masked_sel(float s, float scale, bool visible) {
  const float x = __fmul_rn(s, scale);
  return visible ? x : MASK_VALUE;
}

// The softmax's exponential: 2^(x log2(e)) by the MUFU's ex2.approx (2 ulps,
// subnormal results flushed to 0), x the difference s - m as the JAX kernel
// forms it.
__device__ __forceinline__ float exp_p(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// One box of a 4-D tensor map (make_rows_map) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// Rows row .. row + box - 1 of head h, batch b: the map's dims are (64, nh, L, B)
// when `heads_inner`, else (64, L, nh, B).
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, bool heads_inner, int h, int row,
                                          int b, uint64_t* bar) {
  if (heads_inner)
    tma_load4(dst, map, h, row, b, bar);
  else
    tma_load4(dst, map, row, h, b, bar);
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Keeps the compiler from moving reads or writes of a wgmma's accumulators
// (fence_acc) or register A operand (fence_a) across a wgmma fence, commit or
// wait: volatile asm stays in order, and these tie the registers to it.  No
// memory clobber: shared-memory loads stay free to move.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]));
}

template <int N>
__device__ __forceinline__ void fence_a(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e]));
}

// d (+)= A[64 x 16] . B[16 x 64]: A from registers (the m16n8k16 A layout,
// each warp its 16 rows), B MN-major in shared memory (rows of 64 along N,
// 128-byte swizzle; the transpose bit set); scale_d = 0 overwrites d.
#define WGMMA_RS64T_ASM(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <typename T> __device__ __forceinline__ void wgmma_rs64t(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db, int scale_d);
template <> __device__ __forceinline__ void wgmma_rs64t<__nv_bfloat16>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  WGMMA_RS64T_ASM("bf16");
}
template <> __device__ __forceinline__ void wgmma_rs64t<__half>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  WGMMA_RS64T_ASM("f16");
}

// d (+)= A[64 x 16] . B[128 x 16]^T: A from registers, B K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites d.
#define WGMMA_RS128_ASM(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <typename T> __device__ __forceinline__ void wgmma_rs128(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db, int scale_d);
template <> __device__ __forceinline__ void wgmma_rs128<__nv_bfloat16>(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  WGMMA_RS128_ASM("bf16");
}
template <> __device__ __forceinline__ void wgmma_rs128<__half>(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  WGMMA_RS128_ASM("f16");
}

// d (+)= A[64 x 16] . B[64 x 16]^T: A from registers, B K-major in shared
// memory (128-byte swizzle); scale_d = 0 overwrites d.
#define WGMMA_RS64_ASM(TY) \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n" \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <typename T> __device__ __forceinline__ void wgmma_rs64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db, int scale_d);
template <> __device__ __forceinline__ void wgmma_rs64<__nv_bfloat16>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  WGMMA_RS64_ASM("bf16");
}
template <> __device__ __forceinline__ void wgmma_rs64<__half>(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  WGMMA_RS64_ASM("f16");
}


// ---- K11, route "wgmma" ----
//
// A block is NWG consumer warpgroups of 64 query rows (NWG = 3 where Lq is a
// multiple of 192, else 2) and one producer warpgroup, persistent over
// (query block, head, batch) tiles, the query blocks of a head adjacent.  The
// producer's one thread loads the block's Q tile once a tile and keeps 128-key
// K and V tiles with their segment ids in a ring of FWD_STAGES on mbarriers.
// Each consumer takes its Q rows into A fragments (freeing the Q buffer for
// the next tile), then per key tile: S = Q K^T by wgmma m64n128k16 (K from
// shared memory), the mask and the online softmax on the accumulators, P
// rounded into A fragments, P V by wgmma m64n64k16 (V as an MN-major B), and
// the JAX combination; o leaves through shared memory, l and m from registers.

// acc += pv / l_next: the JAX combination's second half (acc * (l_corr / l_next) came before P V).
__device__ __forceinline__ void add_pv(float (&acc)[HD / 8][4], const float (&pv)[HD / 8][4], const float (&inv)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(pv[j][e], inv[e >> 1]));
}

// A warp's 16 accumulator rows (rows g and g + 8 of lane g * 4 + q, as
// store_rows has them) rounded to T at `out` (row stride `sl`) through the
// warp's 2 KB of shared memory `stage`: each 128-byte row leaves as 8 lanes'
// 16-byte stores, whole 32-byte sectors (store_rows' 4-byte stores leave
// half sectors, 8 rows an instruction).  The 16-byte chunks of a staged row
// are XOR-swizzled by the row, so neither side has bank conflicts.
template <typename T>
__device__ __forceinline__ void store_rows_staged(T* out, long long sl, const float (&c)[HD / 8][4], uint32_t* stage,
                                                  int lane) {
  const int g = lane >> 2, q = lane & 3;
  __syncwarp();  // the last call's reads are done
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    stage[g * 32 + ((j ^ g) << 2) + q] = Type<T>::pack(c[j][0], c[j][1]);
    stage[(g + 8) * 32 + ((j ^ g) << 2) + q] = Type<T>::pack(c[j][2], c[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int chunk = lane + 32 * i, r = chunk >> 3, ch = chunk & 7;
    *reinterpret_cast<uint4*>(out + r * sl + ch * 8) =
        *reinterpret_cast<const uint4*>(stage + r * 32 + ((ch ^ (r & 7)) << 2));
  }
}

template <int NWG> struct Fwd {
  static constexpr int ROWS_BLK = NWG * 64;
  static constexpr uint32_t smem = 1024 + NWG * WG_ROWS + FWD_STAGES * (2 * KV_BYTES + KT * 4) + NWG * 4 * 2048;
};
static_assert(Fwd<3>::smem <= 232448 - 128, "K11's ring must fit a block's shared memory");

template <typename T, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, int heads_inner, T* __restrict__ O, View vo,
                       const int* __restrict__ qseg, const int* __restrict__ kvseg, float* __restrict__ l_out,
                       float* __restrict__ m_out, int nh, int Lq, int Lk, int n_tiles, float scale) {
  constexpr int ROWS_BLK = Fwd<NWG>::ROWS_BLK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[FWD_STAGES], empty[FWD_STAGES], q_full, q_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;               // Q: NWG x 64 rows
  const uint32_t skv = sq + NWG * WG_ROWS;                  // [stage][K, V]
  const uint32_t sseg = skv + FWD_STAGES * 2 * KV_BYTES;    // [stage][128] key segment ids
  const int* const seg_base = reinterpret_cast<const int*>(smem_raw + (sseg - raw));
  // [warp][2 KB] for the output rows
  uint32_t* const out_stage = reinterpret_cast<uint32_t*>(smem_raw + (sseg + FWD_STAGES * KT * 4 - raw));
  const int n_qb = Lq / ROWS_BLK, n_kt = Lk / KT;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&full[s], 1);          // the producer's expect_tx
      mbar_init(&empty[s], NWG * 4);   // every consumer warp
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NWG * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // ---- producer: one thread keeps Q and the K/V ring full, tile after tile ----
    if constexpr (NWG == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NWG * 128) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
        mbar_wait(&q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_expect_tx(&q_full, NWG * WG_ROWS);
        load_rows(sq, &map_q, heads_inner & 1, h, qb * ROWS_BLK, b, &q_full);
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * KV_BYTES + KT * 4);
          const uint32_t st = skv + stage * 2 * KV_BYTES;
          load_rows(st, &map_k, heads_inner & 2, h, kt * KT, b, &full[stage]);
          load_rows(st + KV_BYTES, &map_v, heads_inner & 4, h, kt * KT, b, &full[stage]);
          bulk_load(sseg + stage * KT * 4, kvseg + (long long)b * Lk + kt * KT, KT * 4, &full[stage]);
          if (++stage == FWD_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    if constexpr (NWG == 3)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = threadIdx.x / 128, lane = threadIdx.x % 32, qd = lane & 3;
    const int row = wgi * 64 + (threadIdx.x % 128) / 32 * 16 + (lane >> 2);  // rows row and row + 8 of the block
    const T* const q_rows = reinterpret_cast<const T*>(smem_raw + (sq - raw)) + wgi * 64 * HD;  // its Q rows
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
      const int q0 = qb * ROWS_BLK;
      const int* qs = qseg + (long long)b * Lq + q0;
      const int seg0 = qs[row], seg1 = qs[row + 8];
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
      float acc[HD / 8][4];
      zero(acc);
      mbar_wait(&q_full, q_phase);
      q_phase ^= 1;
      float s[KT / 8][4], pv[HD / 8][4];  // S, then P; P V (the first k-step of each overwrites)
      uint32_t qf[HD / 16][4], pa[KT / 16][4] = {};  // this warp's 16 rows of Q, the A operand of every S; P
      zero(s);
      zero(pv);
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) load_a(qf[ks], q_rows, (threadIdx.x % 128) / 32 * 16, ks, lane);
      if (lane == 0) mbar_arrive(&q_empty);  // this warp is done with the Q tile
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t ka = skv + stage * 2 * KV_BYTES, va = ka + KV_BYTES;
        const int* st = seg_base + stage * KT;

        fence_acc(s);
        fence_a(qf);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs128<T>(s, qf[kk], sw128_desc(ka) + 2 * kk, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_acc(s);
        fence_a(qf);

        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          const int2 ks = *reinterpret_cast<const int2*>(st + j * 8 + 2 * qd);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = masked_sel(s[j][e], scale, (e < 2 ? seg0 : seg1) == ((e & 1) ? ks.y : ks.x));
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
        float m_next[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) m_next[r] = fmaxf(m_run[r], quad_max(mx[r]));
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = exp_p(s[j][e] - m_next[e >> 1]);
            sum[e >> 1] += s[j][e];
          }
        float inv[2];
        if (n_kt == 1) {
          // the JAX kernel's single-step form: p / l rounded, o = (p / l) . v
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l_run[r] = quad_sum(sum[r]);
            m_run[r] = m_next[r];
          }
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = __fdiv_rn(s[j][e], l_run[e >> 1]);
          inv[0] = inv[1] = 1.0f;
        } else {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float l_corr = __fmul_rn(exp_p(m_run[r] - m_next[r]), l_run[r]);
            const float l_next = __fadd_rn(quad_sum(sum[r]), l_corr);
            inv[r] = l_next == 0.0f ? 1.0f : __fdiv_rn(1.0f, l_next);
            const float keep = __fmul_rn(l_corr, inv[r]);
#pragma unroll
            for (int j = 0; j < HD / 8; ++j) {
              acc[j][2 * r] = __fmul_rn(acc[j][2 * r], keep);
              acc[j][2 * r + 1] = __fmul_rn(acc[j][2 * r + 1], keep);
            }
            l_run[r] = l_next;
            m_run[r] = m_next[r];
          }
        }

#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) acc_to_a<T>(pa[kk], s, kk);
        fence_acc(pv);
        fence_a(pa);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs64t<T>(pv, pa[kk], sw128_desc(va) + 128 * kk, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_acc(pv);
        fence_a(pa);
        if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with K and V
        add_pv(acc, pv, inv);
        if (++stage == FWD_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      const int row0 = row - (lane >> 2);  // this warp's first row
      store_rows_staged<T>(O + b * vo.sb + h * vo.sh + (long long)(q0 + row0) * vo.sl, vo.sl, acc,
                           out_stage + threadIdx.x / 32 * 512, lane);
      if (qd == 0) {
        const long long i = ((long long)b * nh + h) * Lq + q0 + row;
        l_out[i] = l_run[0];
        l_out[i + 8] = l_run[1];
        m_out[i] = m_run[0];
        m_out[i + 8] = m_run[1];
      }
    }
  }
}

// ---- K12, route "wgmma" ----
//
// A block is two consumer warpgroups of 64 keys (128, one JAX key block) and
// one producer warpgroup, persistent over (key block, head, batch) tiles.
// The producer's one thread loads each tile's K and V rows and keeps
// 64-query Q and dO tiles with m, 1 / l, di and the query segment ids in a
// ring of DKV_STAGES.  Each consumer takes its K and V rows into registers
// as A fragments (freeing their buffer for the next tile at once), then for
// each query tile: S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (Q and
// dO as K-major B), committed apart; p from S^T while dP^T runs, then dV +=
// P^T dO (P^T in registers, dO as MN-major B) issued; ds from dP^T while dV
// runs, then dK += dS^T Q issued, and left running under the next tile's
// S^T and dP^T.  dK and dV stay in registers over the queries (no atomics)
// and leave through shared memory as whole rows.

constexpr uint32_t DKV_ROWS_BYTES = 4 * QT * 4;   // a tile's m, 1 / l, di, segment ids
constexpr uint32_t DKV_SMEM = 1024 + 2 * KV_BYTES + DKV_STAGES * (2 * QT_BYTES + DKV_ROWS_BYTES) + 8 * 2048;
static_assert(DKV_SMEM <= 232448 - 128, "K12's ring must fit a block's shared memory");

template <typename T>
__global__ void __launch_bounds__(384, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                       int heads_inner, const int* __restrict__ qseg, const int* __restrict__ kvseg,
                       const float* __restrict__ inv_l, const float* __restrict__ m_in,
                       const float* __restrict__ di_in, T* __restrict__ dK, T* __restrict__ dV, View vdk, View vdv,
                       int nh, int Lq, int Lk, int n_tiles, float scale) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[DKV_STAGES], empty[DKV_STAGES], kv_full, kv_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t skv = (raw + 1023u) & ~1023u;                 // K, V: 128 rows each
  const uint32_t sqo = skv + 2 * KV_BYTES;                     // [stage][Q, dO]
  const uint32_t srows = sqo + DKV_STAGES * 2 * QT_BYTES;      // [stage][m, 1 / l, di, seg][64]
  const float* const rows_base = reinterpret_cast<const float*>(smem_raw + (srows - raw));
  uint32_t* const out_stage = reinterpret_cast<uint32_t*>(smem_raw + (srows + DKV_STAGES * DKV_ROWS_BYTES - raw));
  const int n_kb = Lk / KT, n_qt = Lq / QT;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 4);
    }
    mbar_init(&kv_full, 1);
    mbar_init(&kv_empty, 2 * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0, kv_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int kb = t % n_kb, h = (t / n_kb) % nh, b = t / (n_kb * nh);
        const long long rows0 = ((long long)b * nh + h) * Lq;
        mbar_wait(&kv_empty, kv_phase ^ 1);
        kv_phase ^= 1;
        mbar_expect_tx(&kv_full, 2 * KV_BYTES);
        load_rows(skv, &map_k, heads_inner & 2, h, kb * KT, b, &kv_full);
        load_rows(skv + KV_BYTES, &map_v, heads_inner & 4, h, kb * KT, b, &kv_full);
        for (int qt = 0; qt < n_qt; ++qt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * QT_BYTES + DKV_ROWS_BYTES);
          const uint32_t st = sqo + stage * 2 * QT_BYTES, rt = srows + stage * DKV_ROWS_BYTES;
          load_rows(st, &map_q, heads_inner & 1, h, qt * QT, b, &full[stage]);
          load_rows(st + QT_BYTES, &map_do, heads_inner & 8, h, qt * QT, b, &full[stage]);
          bulk_load(rt, m_in + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + QT * 4, inv_l + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + 2 * QT * 4, di_in + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + 3 * QT * 4, qseg + (long long)b * Lq + qt * QT, QT * 4, &full[stage]);
          if (++stage == DKV_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, qd = lane & 3;
    const int key = wgi * 64 + warp * 16 + (lane >> 2);  // keys key and key + 8 of the block
    const T* const k_rows = reinterpret_cast<const T*>(smem_raw + (skv - raw)) + wgi * 64 * HD;  // its K rows
    const T* const v_rows = k_rows + KT * HD;                                                       // its V rows
    int stage = 0;
    uint32_t phase = 0, kv_phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int kb = t % n_kb, h = (t / n_kb) % nh, b = t / (n_kb * nh);
      const int k0 = kb * KT;
      const int kseg0 = kvseg[(long long)b * Lk + k0 + key], kseg1 = kvseg[(long long)b * Lk + k0 + key + 8];
      float dk[HD / 8][4], dv[HD / 8][4], p[QT / 8][4], ds[QT / 8][4];  // p: S^T, then P^T; ds: dP^T, then dS^T
      uint32_t kf[HD / 16][4], vf[HD / 16][4], ap[QT / 16][4] = {}, as[QT / 16][4] = {};
      zero(dk);
      zero(dv);
      zero(p);
      zero(ds);
      mbar_wait(&kv_full, kv_phase);
      kv_phase ^= 1;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        load_a(kf[ks], k_rows, warp * 16, ks, lane);
        load_a(vf[ks], v_rows, warp * 16, ks, lane);
      }
      if (lane == 0) mbar_arrive(&kv_empty);  // this warp is done with the K and V buffer
      int prev = -1;
      for (int qt = 0; qt < n_qt; ++qt) {
        mbar_wait(&full[stage], phase);
        const uint32_t qa = sqo + stage * 2 * QT_BYTES, oa = qa + QT_BYTES;
        // B operands' descriptors; a k-step advances one by 32 bytes (K-major, + 2) or 16 rows (MN-major, + 128)
        const uint64_t dq = sw128_desc(qa), dout = sw128_desc(oa);
        const float* mt = rows_base + stage * (DKV_ROWS_BYTES / 4);
        const float* it = mt + QT;
        const float* dt = mt + 2 * QT;
        const int* segt = reinterpret_cast<const int*>(mt + 3 * QT);

        fence_acc(p);
        fence_acc(ds);
        fence_a(kf);
        fence_a(vf);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs64<T>(p, kf[kk], dq + 2 * kk, kk);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs64<T>(ds, vf[kk], dout + 2 * kk, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S^T, and the last tile's dV and dK
        fence_acc(p);
        fence_acc(dk);
        fence_acc(dv);
        fence_a(ap);
        fence_a(as);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);  // this warp is done with the last tile

#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          const int qi = j * 8 + 2 * qd;
          const float2 mm = *reinterpret_cast<const float2*>(mt + qi);
          const float2 il = *reinterpret_cast<const float2*>(it + qi);
          const int2 sg = *reinterpret_cast<const int2*>(segt + qi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const float x = masked_sel(p[j][e], scale, (e < 2 ? kseg0 : kseg1) == (odd ? sg.y : sg.x));
            p[j][e] = __fmul_rn(exp_p(x - (odd ? mm.y : mm.x)), odd ? il.y : il.x);
          }
        }
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) acc_to_a<T>(ap[kk], p, kk);
        fence_a(ap);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) wgmma_rs64t<T>(dv, ap[kk], dout + 128 * kk, 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // dP^T
        fence_acc(ds);
        fence_a(kf);
        fence_a(vf);

#pragma unroll
        for (int j = 0; j < QT / 8; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(dt + j * 8 + 2 * qd);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[j][e] = __fmul_rn(__fmul_rn(__fsub_rn(ds[j][e], (e & 1) ? dd.y : dd.x), p[j][e]), scale);
        }
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) acc_to_a<T>(as[kk], ds, kk);
        fence_a(as);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) wgmma_rs64t<T>(dk, as[kk], dq + 128 * kk, 1);
        hopper::wgmma_commit();
        prev = stage;
        if (++stage == DKV_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      fence_a(ap);
      fence_a(as);
      if (lane == 0) mbar_arrive(&empty[prev]);
      const int key0 = k0 + key - (lane >> 2);  // this warp's first key
      uint32_t* const own = out_stage + threadIdx.x / 32 * 512;
      store_rows_staged<T>(dK + b * vdk.sb + h * vdk.sh + (long long)key0 * vdk.sl, vdk.sl, dk, own, lane);
      store_rows_staged<T>(dV + b * vdv.sb + h * vdv.sh + (long long)key0 * vdv.sl, vdv.sl, dv, own, lane);
    }
  }
}

// ---- K13, route "wgmma" ----
//
// A block is two consumer warpgroups of 64 query rows and one producer
// warpgroup, persistent over (query block, head, batch) tiles, the query
// blocks of a head adjacent (so its K and V are read from device memory
// once and then from L2).  The
// producer's one thread loads each tile's Q and dO rows with their m, 1 / l
// (from the rows kernel), di and segment ids once, and keeps 64-key K and V
// tiles with their segment ids in a ring of DQ_STAGES.  Each consumer takes
// its Q and dO rows into A fragments and its rows' m, 1 / l, di and segment
// ids into registers (freeing the tile's buffer for the next tile at once),
// then per key tile: S = Q K^T and dP = dO V^T by wgmma m64n64k16 (K and V
// as K-major B), committed apart; p from S while dP runs; ds from dP and p,
// rounded into A fragments; dQ += dS K (K as MN-major B, the transpose bit
// set) issued and left running under the next tile's S and dP.  dQ stays in
// registers over the keys (no atomics) and leaves through shared memory as
// whole rows.  Key tiles of 64, not the JAX block's 128: at 128 keys S and
// dP hold 128 fp32 accumulators a thread and dS 32 A registers, with dQ and
// the Q and dO fragments 224 live, past the 232 setmaxnreg leaves a consumer
// once addresses and loop state are counted.  Two consumer warpgroups, not
// K11's three (192 rows where they tile Lq): at three, setmaxnreg leaves 160
// registers, ptxas serialised the wgmmas for want of them, and the kernel
// ran 6% slower (PERF.md §6).

struct Dq {
  static constexpr int NWG = 2;                             // consumer warpgroups
  static constexpr int ROWS_BLK = NWG * 64;
  static constexpr uint32_t ROWS_BYTES = 4 * ROWS_BLK * 4;  // a tile's m, 1 / l, di, segment ids
  static constexpr uint32_t smem = 1024 + 2 * NWG * WG_ROWS + DQ_STAGES * (2 * DQ_KV_BYTES + DQ_KT * 4) +
                                   ROWS_BYTES + NWG * 4 * 2048;
};
static_assert(Dq::smem <= 232448 - 128, "K13's ring must fit a block's shared memory");

template <typename T>
__global__ void __launch_bounds__((Dq::NWG + 1) * 128, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                      int heads_inner, const int* __restrict__ qseg, const int* __restrict__ kvseg,
                      const float* __restrict__ inv_l, const float* __restrict__ m_in,
                      const float* __restrict__ di_in, T* __restrict__ dQ, View vdq, int nh, int Lq, int Lk,
                      int n_tiles, float scale) {
  constexpr int NWG = Dq::NWG, ROWS_BLK = Dq::ROWS_BLK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[DQ_STAGES], empty[DQ_STAGES], q_full, q_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;                      // Q, then dO: NWG x 64 rows each
  const uint32_t skv = sq + 2 * NWG * WG_ROWS;                     // [stage][K, V]
  const uint32_t sseg = skv + DQ_STAGES * 2 * DQ_KV_BYTES;         // [stage][64] key segment ids
  const uint32_t srows = sseg + DQ_STAGES * DQ_KT * 4;             // [m, 1 / l, di, seg][ROWS_BLK]
  const int* const seg_base = reinterpret_cast<const int*>(smem_raw + (sseg - raw));
  const float* const rows_base = reinterpret_cast<const float*>(smem_raw + (srows - raw));
  uint32_t* const out_stage = reinterpret_cast<uint32_t*>(smem_raw + (srows + Dq::ROWS_BYTES - raw));
  const int n_qb = Lq / ROWS_BLK, n_kt = Lk / DQ_KT;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_init(&q_full, 1);
    mbar_init(&q_empty, NWG * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // ---- producer: one thread keeps Q, dO and their rows and the K/V ring full, tile after tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NWG * 128) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
        const long long rows0 = ((long long)b * nh + h) * Lq + qb * ROWS_BLK;
        mbar_wait(&q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_expect_tx(&q_full, 2 * NWG * WG_ROWS + Dq::ROWS_BYTES);
        load_rows(sq, &map_q, heads_inner & 1, h, qb * ROWS_BLK, b, &q_full);
        load_rows(sq + NWG * WG_ROWS, &map_do, heads_inner & 8, h, qb * ROWS_BLK, b, &q_full);
        bulk_load(srows, m_in + rows0, ROWS_BLK * 4, &q_full);
        bulk_load(srows + ROWS_BLK * 4, inv_l + rows0, ROWS_BLK * 4, &q_full);
        bulk_load(srows + 2 * ROWS_BLK * 4, di_in + rows0, ROWS_BLK * 4, &q_full);
        bulk_load(srows + 3 * ROWS_BLK * 4, qseg + (long long)b * Lq + qb * ROWS_BLK, ROWS_BLK * 4, &q_full);
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * DQ_KV_BYTES + DQ_KT * 4);
          const uint32_t st = skv + stage * 2 * DQ_KV_BYTES;
          load_rows(st, &map_k, heads_inner & 2, h, kt * DQ_KT, b, &full[stage]);
          load_rows(st + DQ_KV_BYTES, &map_v, heads_inner & 4, h, kt * DQ_KT, b, &full[stage]);
          bulk_load(sseg + stage * DQ_KT * 4, kvseg + (long long)b * Lk + kt * DQ_KT, DQ_KT * 4, &full[stage]);
          if (++stage == DQ_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, qd = lane & 3;
    const int row = wgi * 64 + warp * 16 + (lane >> 2);  // rows row and row + 8 of the block
    const T* const q_rows = reinterpret_cast<const T*>(smem_raw + (sq - raw)) + wgi * 64 * HD;  // its Q rows
    const T* const o_rows = q_rows + NWG * 64 * HD;                                               // its dO rows
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
      float dq[HD / 8][4], s[DQ_KT / 8][4], dp[DQ_KT / 8][4];  // s: S, then P; dp: dP, then dS
      uint32_t qf[HD / 16][4], of[HD / 16][4], as[DQ_KT / 16][4] = {};
      zero(dq);
      zero(s);
      zero(dp);
      mbar_wait(&q_full, q_phase);
      q_phase ^= 1;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        load_a(qf[ks], q_rows, warp * 16, ks, lane);
        load_a(of[ks], o_rows, warp * 16, ks, lane);
      }
      float m_row[2], il[2], di[2];
      int seg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_row[r] = rows_base[row + 8 * r];
        il[r] = rows_base[ROWS_BLK + row + 8 * r];
        di[r] = rows_base[2 * ROWS_BLK + row + 8 * r];
        seg[r] = reinterpret_cast<const int*>(rows_base)[3 * ROWS_BLK + row + 8 * r];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty);  // this warp is done with the Q, dO and rows buffer
      int prev = -1;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t ka = skv + stage * 2 * DQ_KV_BYTES;
        // B operands' descriptors; a k-step advances one by 32 bytes (K-major, + 2) or 16 rows (MN-major, + 128)
        const uint64_t kdesc = sw128_desc(ka), vdesc = sw128_desc(ka + DQ_KV_BYTES);
        const int* st = seg_base + stage * DQ_KT;

        fence_acc(s);
        fence_acc(dp);
        fence_a(qf);
        fence_a(of);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs64<T>(s, qf[kk], kdesc + 2 * kk, kk);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs64<T>(dp, of[kk], vdesc + 2 * kk, kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S, and the last tile's dQ
        fence_acc(s);
        fence_acc(dq);
        fence_a(as);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);  // this warp is done with the last tile

#pragma unroll
        for (int j = 0; j < DQ_KT / 8; ++j) {
          const int2 ks = *reinterpret_cast<const int2*>(st + j * 8 + 2 * qd);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float x = masked_sel(s[j][e], scale, seg[r] == ((e & 1) ? ks.y : ks.x));
            s[j][e] = __fmul_rn(exp_p(x - m_row[r]), il[r]);
          }
        }
        hopper::wgmma_wait<0>();  // dP
        fence_acc(dp);
        fence_a(qf);
        fence_a(of);
#pragma unroll
        for (int j = 0; j < DQ_KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = __fmul_rn(__fmul_rn(__fsub_rn(dp[j][e], di[e >> 1]), s[j][e]), scale);
#pragma unroll
        for (int kk = 0; kk < DQ_KT / 16; ++kk) acc_to_a<T>(as[kk], dp, kk);
        fence_a(as);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_KT / 16; ++kk) wgmma_rs64t<T>(dq, as[kk], kdesc + 128 * kk, 1);
        hopper::wgmma_commit();
        prev = stage;
        if (++stage == DQ_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      fence_acc(dq);
      fence_a(as);
      if (lane == 0) mbar_arrive(&empty[prev]);
      const int row0 = qb * ROWS_BLK + row - (lane >> 2);  // this warp's first row
      store_rows_staged<T>(dQ + b * vdq.sb + h * vdq.sh + (long long)row0 * vdq.sl, vdq.sl, dq,
                           out_stage + threadIdx.x / 32 * 512, lane);
    }
  }
}

// ---- the backward's per-row inputs: di and 1 / l ----
//
// di = sum(o * do) over the head dim in fp32, read once in the input type:
// 8 threads a row, each summing the products of its 8 elements in order,
// then the 8 partial sums pairwise by lane distance 4, 2, 1
// (ops/flash_attention.py::flash_di_card_order is this order in torch);
// 1 / l rounded once a row, for K12's p = exp(s - m) * (1 / l).

template <typename T>
__global__ void __launch_bounds__(256)
flash_rows_kernel(const T* __restrict__ O, const T* __restrict__ dO, const float* __restrict__ l, View vo,
                  View vdo, float* __restrict__ di, float* __restrict__ inv_l, int nh, int L) {
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x / 8;  // the row: ((b * nh) + h) * L + r
  const int c = threadIdx.x % 8;
  const long long bh = i / L;
  const int r = int(i - bh * L), h = int(bh % nh);
  const long long b = bh / nh;
  const uint4 a = *reinterpret_cast<const uint4*>(O + b * vo.sb + h * vo.sh + r * vo.sl + c * 8);
  const uint4 g = *reinterpret_cast<const uint4*>(dO + b * vdo.sb + h * vdo.sh + r * vdo.sl + c * 8);
  const T* x = reinterpret_cast<const T*>(&a);
  const T* y = reinterpret_cast<const T*>(&g);
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) s = __fadd_rn(s, __fmul_rn(Type<T>::f(x[e]), Type<T>::f(y[e])));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 4));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  if (c == 0) {
    di[i] = s;
    inv_l[i] = __fdiv_rn(1.0f, l[i]);
  }
}

}  // namespace wg

View view(const long long* s) { return View{s[0], s[1], s[2]}; }

bool aligned(const void* p, const long long* s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0;
}

// `kernel`'s dynamic shared memory raised to `bytes`, once per device
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int device, std::atomic<bool>* done) {
  if (done[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_relaxed);
  return err;
}

// `launch()` with `device` current: made so if it is not, the caller's restored after
template <typename F>
int on_device(int device, F launch) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  int e = launch();
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == 0) e = (int)back;
  }
  return e;
}

// 0 if the shape is one the kernels take, else cudaErrorInvalidValue.
int check_shape(int B, int nh, int Lq, int Lk, int dtype, int device) {
  if (B < 1 || nh < 1 || B > 65535 || nh > 65535 || dtype < 0 || dtype > 1 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (Lq < FWD_TILE || Lk < FWD_TILE || Lq % FWD_TILE || Lk % FWD_TILE) return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, const int* qseg, const int* kvseg, float* l, float* m,
        const long long* vq, const long long* vk, const long long* vv, const long long* vo, int B, int nh, int Lq,
        int Lk, float scale, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t err = allow_smem(flash_fwd_kernel<T>, FWD_SMEM, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<T><<<dim3(Lq / ROWS, nh, B), THREADS, FWD_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), qseg, kvseg,
      l, m, view(vq), view(vk), view(vv), view(vo), nh, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg, const float* l,
        const float* m, const void* dout, const float* di, void* dk, void* dv, const long long* vq,
        const long long* vk, const long long* vv, const long long* vdo, const long long* vdk, const long long* vdv,
        int B, int nh, int Lq, int Lk, float scale, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t err = allow_smem(flash_dkv_kernel<T>, DKV_SMEM, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<T><<<dim3(Lk / ROWS, nh, B), THREADS, DKV_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qseg, kvseg, l, m,
      static_cast<const T*>(dout), di, static_cast<T*>(dk), static_cast<T*>(dv), view(vq), view(vk), view(vv),
      view(vdo), view(vdk), view(vdv), nh, Lq, Lk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg, const float* l,
       const float* m, const void* dout, const float* di, void* dq_, const long long* vq, const long long* vk,
       const long long* vv, const long long* vdo, const long long* vdq, int B, int nh, int Lq, int Lk, float scale,
       int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t err = allow_smem(flash_dq_kernel<T>, DQ_SMEM, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<T><<<dim3(Lq / ROWS, nh, B), THREADS, DQ_SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qseg, kvseg, l, m,
      static_cast<const T*>(dout), di, static_cast<T*>(dq_), view(vq), view(vk), view(vv), view(vdo), view(vdq), nh,
      Lq, Lk, scale);
  return (int)cudaGetLastError();
}


// A (B, nh, L, 64) view with (batch, head, row) strides `s` in elements as a
// 4-D tensor map cut into boxes of 64 x `box_rows` rows with the 128-byte
// swizzle.  Its dims run (64, nh, L, B) when a head's rows lie further apart
// than its heads do (the models' layout: heads-major views of (B, L, nh, 64)),
// else (64, L, nh, B); `heads_inner` says which.  A dim of extent 1 takes the
// largest stride, so that it sorts outside.
bool make_rows_map(CUtensorMap* map, const void* ptr, int dtype, int B, int nh, int L, const long long* s,
                   uint32_t box_rows, bool* heads_inner) {
  hopper::EncodeTiledFn enc = hopper::encode_tiled();
  if (enc == nullptr) return false;
  long long sb = s[0], sh = s[1];
  const long long sl = s[2];
  const long long big = std::max(std::max(sb, sh), std::max(sl, (long long)HD));
  if (nh == 1) sh = big;
  if (B == 1) sb = big;
  const bool hi = sh < sl;
  *heads_inner = hi;
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(hi ? nh : L), cuuint64_t(hi ? L : nh), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(2 * (hi ? sh : sl)), cuuint64_t(2 * (hi ? sl : sh)), cuuint64_t(2 * sb)};
  const cuuint32_t box[4] = {cuuint32_t(HD), hi ? 1u : box_rows, hi ? box_rows : 1u, 1u};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The SMs of `device`, read once.
int sm_count(int device, int* n) {
  static std::atomic<int> sms[kMaxDevices];
  int v = sms[device].load(std::memory_order_relaxed);
  if (v == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    sms[device].store(v, std::memory_order_relaxed);
  }
  *n = v;
  return 0;
}

template <typename T, int NWG>
int fwd_wgmma(const void* q, const void* k, const void* v, void* o, const int* qseg, const int* kvseg, float* l,
              float* m, const long long* vq, const long long* vk, const long long* vv, const long long* vo, int B,
              int nh, int Lq, int Lk, float scale, int dtype, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  constexpr uint32_t smem = wg::Fwd<NWG>::smem;
  CUtensorMap mq, mk, mv;
  bool hq, hk, hv;
  if (!make_rows_map(&mq, q, dtype, B, nh, Lq, vq, wg::Fwd<NWG>::ROWS_BLK, &hq) ||
      !make_rows_map(&mk, k, dtype, B, nh, Lk, vk, wg::KT, &hk) ||
      !make_rows_map(&mv, v, dtype, B, nh, Lk, vv, wg::KT, &hv))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int e = sm_count(device, &sms)) return e;
  const cudaError_t err = allow_smem(wg::flash_fwd_wgmma_kernel<T, NWG>, (int)smem, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)(Lq / wg::Fwd<NWG>::ROWS_BLK) * nh * B;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = int(tiles < sms ? tiles : sms);
  wg::flash_fwd_wgmma_kernel<T, NWG><<<grid, (NWG + 1) * 128, smem, stream>>>(
      mq, mk, mv, int(hq) | int(hk) << 1 | int(hv) << 2, static_cast<T*>(o), view(vo), qseg, kvseg, l, m, nh, Lq,
      Lk, int(tiles), scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dkv_wgmma(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg, const float* inv_l,
              const float* m, const void* dout, const float* di, void* dk, void* dv, const long long* vq,
              const long long* vk, const long long* vv, const long long* vdo, const long long* vdk,
              const long long* vdv, int B, int nh, int Lq, int Lk, float scale, int dtype, int device,
              cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  CUtensorMap mq, mk, mv, mo;
  bool hq, hk, hv, ho;
  if (!make_rows_map(&mq, q, dtype, B, nh, Lq, vq, wg::QT, &hq) ||
      !make_rows_map(&mk, k, dtype, B, nh, Lk, vk, wg::KT, &hk) ||
      !make_rows_map(&mv, v, dtype, B, nh, Lk, vv, wg::KT, &hv) ||
      !make_rows_map(&mo, dout, dtype, B, nh, Lq, vdo, wg::QT, &ho))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int e = sm_count(device, &sms)) return e;
  const cudaError_t err = allow_smem(wg::flash_dkv_wgmma_kernel<T>, (int)wg::DKV_SMEM, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)(Lk / wg::KT) * nh * B;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = int(tiles < sms ? tiles : sms);
  wg::flash_dkv_wgmma_kernel<T><<<grid, 384, wg::DKV_SMEM, stream>>>(
      mq, mk, mv, mo, int(hq) | int(hk) << 1 | int(hv) << 2 | int(ho) << 3, qseg, kvseg, inv_l, m, di,
      static_cast<T*>(dk), static_cast<T*>(dv), view(vdk), view(vdv), nh, Lq, Lk, int(tiles), scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dq_wgmma(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg, const float* inv_l,
             const float* m, const void* dout, const float* di, void* dq_, const long long* vq, const long long* vk,
             const long long* vv, const long long* vdo, const long long* vdq, int B, int nh, int Lq, int Lk,
             float scale, int dtype, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  constexpr int rows_blk = wg::Dq::ROWS_BLK;
  CUtensorMap mq, mk, mv, mo;
  bool hq, hk, hv, ho;
  if (!make_rows_map(&mq, q, dtype, B, nh, Lq, vq, rows_blk, &hq) ||
      !make_rows_map(&mk, k, dtype, B, nh, Lk, vk, wg::DQ_KT, &hk) ||
      !make_rows_map(&mv, v, dtype, B, nh, Lk, vv, wg::DQ_KT, &hv) ||
      !make_rows_map(&mo, dout, dtype, B, nh, Lq, vdo, rows_blk, &ho))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  if (int e = sm_count(device, &sms)) return e;
  const cudaError_t err = allow_smem(wg::flash_dq_wgmma_kernel<T>, (int)wg::Dq::smem, device, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)(Lq / rows_blk) * nh * B;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int grid = int(tiles < sms ? tiles : sms);
  wg::flash_dq_wgmma_kernel<T><<<grid, (wg::Dq::NWG + 1) * 128, wg::Dq::smem, stream>>>(
      mq, mk, mv, mo, int(hq) | int(hk) << 1 | int(hv) << 2 | int(ho) << 3, qseg, kvseg, inv_l, m, di,
      static_cast<T*>(dq_), view(vdq), nh, Lq, Lk, int(tiles), scale);
  return (int)cudaGetLastError();
}

template <typename T>
int rows(const void* o, const void* dout, const float* l, float* di, float* inv_l, const long long* vo,
         const long long* vdo, int B, int nh, int L, cudaStream_t stream) {
  const long long n = (long long)B * nh * L;  // a multiple of 128: L is
  if (n / 32 > INT32_MAX) return (int)cudaErrorInvalidValue;
  wg::flash_rows_kernel<T><<<int(n / 32), 256, 0, stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                                                             l, view(vo), view(vdo), di, inv_l, nh, L);
  return (int)cudaGetLastError();
}

}  // namespace

// The head dim the kernels take, for the wrapper's check.
extern "C" int flash_head_dim() { return HD; }

// K11.  q (B, nh, Lq, 64), k and v (B, nh, Lk, 64), o like q, each with its
// (batch, head, row) strides in elements (`vq`..`vo`, three each), unit
// stride along the head dim, rows 16-byte aligned; segment ids (B, Lq) and
// (B, Lk) int32, l and m (B, nh, Lq) fp32, all contiguous and 16-byte
// aligned; Lq and Lk multiples of 128; dtype 0 bf16, 1 fp16; route 1
// "wgmma", 0 "simple" (the first design).  `device` is the tensors' card:
// made current for the launch if it is not, and the caller's restored after.
// Returns a cudaError_t (0 on success, cudaErrorInvalidValue for a shape or
// layout it does not take).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, const int* qseg,
                                const int* kvseg, float* l, float* m, const long long* vq, const long long* vk,
                                const long long* vv, const long long* vo, int B, int nh, int Lq, int Lk,
                                float scale, int dtype, int route, int device, void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, dtype, device)) return e;
  if (!aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) || !aligned(o, vo) || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (route == 0)
      return dtype == 0 ? fwd<__nv_bfloat16>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, scale,
                                             device, s)
                        : fwd<__half>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, scale, device, s);
    // 192-row blocks where they tile Lq, else 128
    if (Lq % wg::Fwd<3>::ROWS_BLK == 0)
      return dtype == 0 ? fwd_wgmma<__nv_bfloat16, 3>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk,
                                                      scale, dtype, device, s)
                        : fwd_wgmma<__half, 3>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, scale,
                                               dtype, device, s);
    return dtype == 0 ? fwd_wgmma<__nv_bfloat16, 2>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk,
                                                    scale, dtype, device, s)
                      : fwd_wgmma<__half, 2>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, scale,
                                             dtype, device, s);
  });
}

// K12: dk and dv (like k and v) from q, k, v, do (like q), m and di (B, nh,
// Lq) fp32, and l (route "simple") or 1 / l (route "wgmma", from
// flash_bwd_rows_launch) likewise; the one the route does not read may be null.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg,
                                    const float* l, const float* inv_l, const float* m, const void* dout,
                                    const float* di, void* dk, void* dv, const long long* vq, const long long* vk,
                                    const long long* vv, const long long* vdo, const long long* vdk,
                                    const long long* vdv, int B, int nh, int Lq, int Lk, float scale, int dtype,
                                    int route, int device, void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, dtype, device)) return e;
  if (!aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) || !aligned(dout, vdo) || !aligned(dk, vdk) ||
      !aligned(dv, vdv) || route < 0 || route > 1 || (route == 1 && inv_l == nullptr) ||
      (route == 0 && l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (route == 0)
      return dtype == 0 ? dkv<__nv_bfloat16>(q, k, v, qseg, kvseg, l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk,
                                             vdv, B, nh, Lq, Lk, scale, device, s)
                        : dkv<__half>(q, k, v, qseg, kvseg, l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk, vdv, B,
                                      nh, Lq, Lk, scale, device, s);
    return dtype == 0 ? dkv_wgmma<__nv_bfloat16>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dk, dv, vq, vk, vv, vdo,
                                                 vdk, vdv, B, nh, Lq, Lk, scale, dtype, device, s)
                      : dkv_wgmma<__half>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk,
                                          vdv, B, nh, Lq, Lk, scale, dtype, device, s);
  });
}

// The backward's per-row inputs on the card: di = sum(o * do) over the head
// dim and 1 / l, (B, nh, L) fp32 contiguous, from o and do (B, nh, L, 64)
// views as K11 takes them and l (B, nh, L) fp32 contiguous.
extern "C" int flash_bwd_rows_launch(const void* o, const void* dout, const float* l, float* di, float* inv_l,
                                     const long long* vo, const long long* vdo, int B, int nh, int L, int dtype,
                                     int device, void* stream) {
  if (int e = check_shape(B, nh, L, L, dtype, device)) return e;
  if (!aligned(o, vo) || !aligned(dout, vdo)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return dtype == 0 ? rows<__nv_bfloat16>(o, dout, l, di, inv_l, vo, vdo, B, nh, L, s)
                      : rows<__half>(o, dout, l, di, inv_l, vo, vdo, B, nh, L, s);
  });
}

// K13: dq (like q) from the same inputs: l (route "simple") or 1 / l (route
// "wgmma", from flash_bwd_rows_launch), as K12 takes them; the one the route
// does not read may be null.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg,
                                   const float* l, const float* inv_l, const float* m, const void* dout,
                                   const float* di, void* dq_, const long long* vq, const long long* vk,
                                   const long long* vv, const long long* vdo, const long long* vdq, int B, int nh,
                                   int Lq, int Lk, float scale, int dtype, int route, int device, void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, dtype, device)) return e;
  if (!aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) || !aligned(dout, vdo) || !aligned(dq_, vdq) ||
      route < 0 || route > 1 || (route == 1 && inv_l == nullptr) || (route == 0 && l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (route == 0)
      return dtype == 0 ? dq<__nv_bfloat16>(q, k, v, qseg, kvseg, l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B, nh,
                                            Lq, Lk, scale, device, s)
                        : dq<__half>(q, k, v, qseg, kvseg, l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B, nh, Lq, Lk,
                                     scale, device, s);
    return dtype == 0 ? dq_wgmma<__nv_bfloat16>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dq_, vq, vk, vv, vdo, vdq,
                                                B, nh, Lq, Lk, scale, dtype, device, s)
                      : dq_wgmma<__half>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B, nh, Lq,
                                         Lk, scale, dtype, device, s);
  });
}
