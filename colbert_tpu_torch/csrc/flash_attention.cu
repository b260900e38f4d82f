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
// di = rowsum(o * do) comes from the wrapper (outside the JAX kernels too).
//
// Design (the first, simple one): mma.sync m16n8k16 (bf16 or fp16, fp32
// accumulators) on tiles in shared memory with the 16-byte chunks of each
// 128-byte row XOR-swizzled by the row (ldmatrix without bank conflicts),
// filled by cp.async two tiles deep.  A block is four warps of 16 rows.
// A product's accumulators become the next product's A operand in
// registers (the C fragments of two n-tiles are one A fragment of k 16),
// so no logit or probability reaches shared or device memory.
//   K11: a block owns 64 query rows of one (batch, head) and walks the
//        keys in 128-key tiles (K, V and their segment ids); the online
//        softmax state stays in registers (rows g and g + 8 of each warp).
//   K12: a block owns 64 keys, their K and V rows held as A fragments, and
//        walks the queries in 64-row tiles (Q, dO, m, 1 / l, di, segment
//        ids): S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q.
//   K13: a block owns 64 query rows, Q and dO held as A fragments, and
//        walks the keys in 64-key tiles: S = Q K^T, dP = dO V^T, dQ += dS K.
// The backward is the JAX split: dK/dV over key blocks, dQ over query
// blocks, each sum in one block's registers, no atomics, so two runs give
// the same bits.  Layouts: each of q, k, v, o, do, dq, dk, dv is (B, nh, L,
// 64) with its own (batch, head, row) strides in elements and unit stride
// along the head dim, rows 16-byte aligned; segment ids (B, L) int32 and l,
// m, di (B, nh, L) fp32 contiguous.
//
// Bounds on the card (989 TFLOP/s bf16, 3.35 TB/s), at the retriever's doc
// pass (68, 12, 384, 64) bf16: K11 reads q, k, v and writes o, 160 MB, 0.048
// ms, against 4 L^2 hd flops a head, 3.1e10, 0.031 ms: bytes.  K12 does four
// L^2 hd products (5.2e10 flops, 0.052 ms) and moves q, k, v, do, dk, dv
// (241 MB, 0.072 ms): bytes; K13 three products (3.9e10, 0.039 ms) and q, k,
// v, do, dq (200 MB, 0.060 ms): bytes.  The K/V (K12: Q/dO) tiles are re-read
// by every block of a head, from L2.

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // cp_async16, smem_u32, mma_bf16_16816

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
};
template <> struct Type<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_f16_16816(d, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
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

}  // namespace

// The head dim the kernels take, for the wrapper's check.
extern "C" int flash_head_dim() { return HD; }

// K11.  q (B, nh, Lq, 64), k and v (B, nh, Lk, 64), o like q, each with its
// (batch, head, row) strides in elements (`vq`..`vo`, three each), unit
// stride along the head dim, rows 16-byte aligned; segment ids (B, Lq) and
// (B, Lk) int32, l and m (B, nh, Lq) fp32, all contiguous; Lq and Lk
// multiples of 128; dtype 0 bf16, 1 fp16.  `device` is the tensors' card:
// made current for the launch if it is not, and the caller's restored after.
// Returns a cudaError_t (0 on success, cudaErrorInvalidValue for a shape or
// layout it does not take).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, const int* qseg,
                                const int* kvseg, float* l, float* m, const long long* vq, const long long* vk,
                                const long long* vv, const long long* vo, int B, int nh, int Lq, int Lk,
                                float scale, int dtype, int device, void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, dtype, device)) return e;
  if (!aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) || !aligned(o, vo)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return dtype == 0 ? fwd<__nv_bfloat16>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, scale,
                                           device, s)
                      : fwd<__half>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, scale, device, s);
  });
}

// K12: dk and dv (like k and v) from q, k, v, do (like q), l, m and di (B, nh, Lq) fp32.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg,
                                    const float* l, const float* m, const void* dout, const float* di, void* dk,
                                    void* dv, const long long* vq, const long long* vk, const long long* vv,
                                    const long long* vdo, const long long* vdk, const long long* vdv, int B, int nh,
                                    int Lq, int Lk, float scale, int dtype, int device, void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, dtype, device)) return e;
  if (!aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) || !aligned(dout, vdo) || !aligned(dk, vdk) ||
      !aligned(dv, vdv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return dtype == 0 ? dkv<__nv_bfloat16>(q, k, v, qseg, kvseg, l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk, vdv,
                                           B, nh, Lq, Lk, scale, device, s)
                      : dkv<__half>(q, k, v, qseg, kvseg, l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk, vdv, B, nh,
                                    Lq, Lk, scale, device, s);
  });
}

// K13: dq (like q) from the same inputs.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg,
                                   const float* l, const float* m, const void* dout, const float* di, void* dq_,
                                   const long long* vq, const long long* vk, const long long* vv,
                                   const long long* vdo, const long long* vdq, int B, int nh, int Lq, int Lk,
                                   float scale, int dtype, int device, void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, dtype, device)) return e;
  if (!aligned(q, vq) || !aligned(k, vk) || !aligned(v, vv) || !aligned(dout, vdo) || !aligned(dq_, vdq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return dtype == 0 ? dq<__nv_bfloat16>(q, k, v, qseg, kvseg, l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B, nh,
                                          Lq, Lk, scale, device, s)
                      : dq<__half>(q, k, v, qseg, kvseg, l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B, nh, Lq, Lk,
                                   scale, device, s);
  });
}
