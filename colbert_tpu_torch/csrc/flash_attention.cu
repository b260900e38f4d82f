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
// Route "fp32" (the rows kernel on fp32 inputs, and only it): fp32
// arithmetic on the CUDA cores, described with its kernel below (namespace
// f32).
//
// Route "tf32" (K11, K12 and K13 on fp32 inputs, and only they): each fp32
// product as three TF32 products (hi hi + hi lo + lo hi, hi = tf32(x), lo =
// tf32(x - hi), rounded as cvt.rna rounds) on wgmma m64nNk8 .tf32, fp32
// accumulators; the rest of the arithmetic the plain version's but for the
// exponential, route "wgmma"'s ex2.approx, and K11's online softmax, which
// steps over 64-key stages (the same m; l and o to fp32 rounding).
// Persistent blocks of 384 threads: a
// producer warpgroup (one thread feeding a TMA ring on mbarriers, its other
// three warps splitting each landed fp32 tile in place into hi and a lo twin)
// and two consumer warpgroups.  .tf32 has no
// transpose bit, so every shared-memory operand is K-major: the head-dim
// products read the split TMA tiles as B; K11's O = P V reads V^T, which the
// split warps write transposed; the backward's row products give transposed
// outputs (dV^T = dO^T P, dK^T = Q^T dS, dQ^T = K^T dS^T) whose B is the P^T
// or dS tile the kernel writes, split, and whose A is read transposed from
// the split tiles into registers (the one transpose); outputs leave by 4-byte
// stores of whole 32-byte sectors.  In K12 and K13 one consumer warpgroup is
// the S side (S, p) and the other the dP side (dP, ds), P crossing between
// them through shared memory.  Where each operand lives:
//   K11 (128 query rows a block, one consumer warpgroup's 64 each; 64-key
//        stages, 2 deep): Q -> A registers (split there) once a tile; K ->
//        split B tile (S = Q K^T); V -> V^T split B tile (O = P V); P ->
//        A registers straight from S's accumulators.
//   K12 (64 keys a block, 32-query stages, 4 deep): K, V -> A registers
//        (split there) once a tile; Q, dO -> split B tiles (S^T, dP^T) and
//        transposed A (dK^T, dV^T); P^T, dS^T -> B tiles (64 x 32, hi, lo).
//   K13 (64 query rows a block, 64-key stages, 2 deep): Q, dO -> A registers
//        once a tile; K, V -> split B tiles (S, dP), K also transposed A
//        (dQ^T); dS -> B tile (64 x 64, hi, lo), each warpgroup's dQ^T over
//        32 of the rows.
// Details and bounds with its kernels below (namespace tf).
//
// Route "simple" (the first design, on request only, head dim 64 alone): mma.sync m16n8k16
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
// Route "wgmma" (every shape the kernels take), templated on the head dim
// (templates 32, 64 and 128, a head dim 1-128 running on the least that
// holds it, "head dims below a template's" below; namespace wg's Tile says
// how a tile of each lies in shared memory): persistent blocks of
// consumer warpgroups and one producer warpgroup whose one thread feeds a
// ring of tiles by TMA (4-D tensor maps over the heads-major views,
// 128-byte swizzle, 64-byte at head dim 32) on mbarriers (or the four
// warps' copies where no map can describe the rows); setmaxnreg moves the
// producer's registers to the
// consumers; the products are wgmma with the B operand in shared
// memory (K-major, or MN-major with the transpose bit for P V, P^T dO,
// dS^T Q and dS K) and the A operand in registers; outputs leave through a
// warp's 2 KB of shared memory as whole 128-byte rows.
//   K11: 192 query rows a block where they tile Lq (three consumer
//        warpgroups; head dims 32 and 64), else 128; Q loaded once a tile
//        into A fragments; K, V and key segment ids 128 keys a stage, three
//        stages (four at hd 32, two at 128).
//   K12: 128 keys a block (two consumer warpgroups), K and V in A fragments
//        once a tile (at hd 128 read from shared memory by each product);
//        Q, dO and the rows' m, 1 / l, di and segment ids 64 queries a
//        stage, eight stages (32 queries, six, at hd 128); dV's and dK's
//        products left running under the next stage's S^T and dP^T.
//   K13: 128 query rows a block (two consumer warpgroups); Q and dO in A
//        fragments and the rows' m, 1 / l, di and segment ids in registers
//        once a tile; K, V and key segment ids 64 keys a stage, eight
//        stages (32 keys, six, at hd 128); dQ's product left running under
//        the next stage's S and dP.
// The rows kernel (flash_bwd_rows_launch) gives route "wgmma" its inputs
// once a row: di from o and do read once in their type, and 1 / l.
// The backward is the JAX split: dK/dV over key blocks, dQ over query
// blocks, each sum in one block's registers, no atomics, so two runs give
// the same bits.  Layouts: each of q, k, v, o, do, dq, dk, dv is (B, nh, L,
// hd), hd 1-128 (the JAX kernel's multiples of 128 above 128 are refused),
// with its own (batch, head, row) strides in elements and unit stride along
// the head dim; segment ids (B, L) int32 and l, m, di (B, nh, L) fp32
// contiguous and 16-byte aligned.
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
// dK/dV stores (PERF.md §6).  At fp32 (same shape, 495 TFLOP/s TF32): route
// "tf32"'s three TF32 products in K11 0.187 ms, in K12 0.373 ms and in K13
// 0.280 ms, above fp32's bytes (K11 0.096 ms, K12 0.144 ms); as fp32 FMAs on
// the CUDA cores (67 TFLOP/s) they would take 0.46, 0.92 and 0.69 ms.  At
// TinyBERT-4L-zh's doc pass (68, 12, 384, 26) bf16, K11's q, k, v and o are
// 65 MB (0.019 ms) against 1.25e10 flops at the true head dim (0.013 ms):
// bytes; on the 32 template the products and the exponentials are hd 32's,
// and the producer's copies (4-byte cp.async: a head's row is 52 bytes) take
// the tensor maps' place.

#include <algorithm>
#include <atomic>
#include <initializer_list>
#include <type_traits>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async, mma.sync, mbarriers, wgmma descriptors and fences, the tensor-map encoder

namespace {

constexpr int HD = 64;            // route "simple"'s one head dim
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

// ---- head dims below a template's: the inputs as routes "wgmma" and "tf32" read them ----
//
// A head dim d that is not a template's (32, 64, 128) runs on the least
// template that holds it; its tiles' columns d .. HD - 1 are zeros in shared
// memory, so the products over the head dim (S = Q K^T, dP = dO V^T) sum d
// terms and the products over rows give zeros there, and nothing past column
// d is stored.  Where each input's address and (batch, head, row) strides
// are 16-byte aligned, the tensor maps describe a head's d columns and TMA's
// out-of-bounds fill writes the zeros (hd 80 and 96 in bf16, any multiple of
// 4 in fp32; route "wgmma" also asks d a multiple of 8 and the outputs'
// rows 16-byte aligned, so that its stores are whole 16-byte chunks).
// Elsewhere (hd 26 in bf16: a head's row is 52 bytes) no map can describe a
// head: the producer's warps copy the rows themselves, with cp.async of the
// widest piece every row's alignment allows (4 bytes at hd 26 bf16,
// zero-filled past d) or, at 2-byte alignment (an odd d in bf16 or fp16),
// 2-byte loads and stores, then wait for their own copies, make them
// visible to the tensor cores (fence.proxy.async) and arrive on the stage's
// barrier.  A map whose box reads into the next head would need the pad
// columns zeroed before any product: a NaN there times a zero of the other
// operand is NaN.  Each kernel has two instantiations: COPIES false, the
// tensor maps fed by the producer's one thread (or at hd 128 on route
// "tf32", warp 8's lane 0: produce()), and COPIES true, the producer's
// warps copying (produce()).  Both store the columns below d alone (whole
// rows at d = HD).
struct Heads {
  const unsigned char* p[4];  // q, k, v, do (heads_inner's bit order); unused entries null
  View v[4];                  // their (batch, head, row) strides in elements
  int d;                      // the head dim: the columns read and stored
  int w;                      // bytes a copy where the producer's warps copy the rows (2, 4, 8, 16); 0: the maps
};

template <int W>
__device__ __forceinline__ void copy_piece(uint32_t dst, const unsigned char* src, int n) {
  if constexpr (W == 2) {
    const unsigned short x = n ? *reinterpret_cast<const unsigned short*>(src) : (unsigned short)0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
  } else if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(W), "r"(n) : "memory");
  }
}

// Rows row .. row + R - 1 of input i (bytes eb an element) at head h, batch
// b into a tile at `dst` of rows CH 16-byte chunks wide, by warp `part` of
// PARTS: a warp's pass covers 32 / CH rows, the warps' passes interleaved; a
// lane keeps one chunk column c of its pass's rows (CH divides 32), copied
// as 16 / W pieces of W bytes, the bytes past the head dim's zeros; chunk c
// of row r lands at dst + off(r, c).  Few registers: the producer's are
// capped by setmaxnreg.
template <int W, int CH, int PARTS, typename OFF>
__device__ __forceinline__ void copy_rows_w(uint32_t dst, const Heads& hs, int i, int eb, int R, int h, int row,
                                            int b, int lane, int part, OFF off) {
  constexpr int RS = 32 / CH;  // rows a pass of the warp
  const View& v = hs.v[i];
  const int c = lane % CH, r0 = part * RS + lane / CH;
  const int nb = min(max(hs.d * eb - 16 * c, 0), 16);  // this lane's bytes of a row
  const long long step = PARTS * RS * v.sl * eb;
  const unsigned char* g = hs.p[i] + (b * v.sb + h * v.sh + (long long)(row + r0) * v.sl) * eb + 16 * c;
#pragma unroll 1
  for (int r = r0; r < R; r += PARTS * RS, g += step) {
    const uint32_t s = dst + off(r, c);
#pragma unroll
    for (int p = 0; p < 16; p += W) {
      const int n = min(max(nb - p, 0), W);
      copy_piece<W>(s + p, n ? g + p : g, n);
    }
  }
}

template <int CH, int PARTS, typename OFF>
__device__ __forceinline__ void copy_rows(uint32_t dst, const Heads& hs, int i, int eb, int R, int h, int row, int b,
                                          int lane, int part, OFF off) {
  static_assert(CH >= 1 && CH <= 32 && 32 % CH == 0, "a row's 16-byte chunks divide a warp");
  switch (hs.w) {
    case 2: copy_rows_w<2, CH, PARTS>(dst, hs, i, eb, R, h, row, b, lane, part, off); break;
    case 4: copy_rows_w<4, CH, PARTS>(dst, hs, i, eb, R, h, row, b, lane, part, off); break;
    case 8: copy_rows_w<8, CH, PARTS>(dst, hs, i, eb, R, h, row, b, lane, part, off); break;
    default: copy_rows_w<16, CH, PARTS>(dst, hs, i, eb, R, h, row, b, lane, part, off); break;
  }
}

// A lane's copies complete and made visible to the tensor cores, then its arrival on `bar`.
__device__ __forceinline__ void copies_done(uint64_t* bar) {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  hopper::mbar_arrive(bar);
}

// The producer's jobs, warp w of NW, in the block's order: job j is its
// tile ti = j / (1 + ring) (t = blockIdx.x + ti * gridDim.x) and, in it,
// the buffer filled once a tile (k = 0: `once(t)`, after `once_empty` frees
// it, by every warp, each its share of the rows) or ring stage k - 1
// (`stage(t, k - 1, s)` into ring slot s, after empty[s] frees it, by warp
// s % NW alone).  A warp thus waits on each barrier it waits on phase after
// phase, never skipping one: a parity wait tells apart only phases one
// apart, so a warp two phases ahead of a barrier would pass it early.  A
// warp's jobs run in the block's order, so the earliest unfilled job's warps
// are never held by a later one.  Each job's buffer, slot and phase follow
// from j alone, so a warp keeps no state from job to job: the producer's
// registers are capped by setmaxnreg (a tile and a stage count carried
// instead spilled in route "tf32"'s 40).
template <int STAGES, int NW, typename ONCE, typename STAGE>
__device__ __forceinline__ void produce(int w, int n_tiles, int ring, uint64_t* once_empty, uint64_t* empty,
                                        ONCE once, STAGE stage) {
  for (int j = 0;; ++j) {
    const int ti = j / (1 + ring), k = j - ti * (1 + ring);
    const int t = blockIdx.x + ti * gridDim.x;
    if (t >= n_tiles) return;
    if (k == 0) {
      hopper::mbar_wait(once_empty, (ti & 1) ^ 1);
      once(t);
    } else {
      const int n = ti * ring + k - 1, s = n % STAGES;
      if (s % NW == w) {
        hopper::mbar_wait(&empty[s], ((n / STAGES) & 1) ^ 1);
        stage(t, k - 1, s);
      }
    }
  }
}

// The first n (1 .. 8) 2-byte elements of a 16-byte chunk to `dst`, by the
// widest stores its alignment allows.
__device__ __forceinline__ void store_part(void* dst, uint4 v, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (n == 8 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else if ((a & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (2 * j + 1 < n) reinterpret_cast<uint32_t*>(dst)[j] = w[j];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n == 2 * j + 1) reinterpret_cast<unsigned short*>(dst)[2 * j] = (unsigned short)(w[j] & 0xFFFFu);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < n) reinterpret_cast<unsigned short*>(dst)[e] = (unsigned short)(w[e >> 1] >> (16 * (e & 1)));
  }
}

// ---- route "wgmma": K11-K13 fed by TMA, warp-specialised wgmma ----

namespace wg {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

constexpr int KT = 128;  // keys a K11 tile (the JAX block) and keys a K12 block

// A tile of R rows of HD 2-byte elements as the tensor maps write it and
// wgmma and ldmatrix read it.  A row is cut into atoms of SPAN bytes, one
// swizzle row each: 128 bytes (64 elements) at head dims 64 and 128, 64 bytes
// (the whole row) at 32; the tile is its atoms' R-row columns one after the
// other (at 128 two, each a TMA box), and the 16-byte chunks of an atom row
// are XOR-swizzled by the row as TMA's 128- or 64-byte swizzle places them
// (address bits 4-6 by bits 7-9; bits 4-5 by bits 7-8).  8-row groups are
// 8 SPAN bytes apart (the descriptors' SBO), so one descriptor form serves
// K-major operands (a k-step of 16 elements 32 bytes on, the next atom R
// SPAN bytes on) and MN-major ones (V, dO, Q, K as B with the transpose
// bit: rows along K, a k-step 16 rows on; one wgmma an atom of N).
template <int HD> struct Tile {
  static_assert(HD == 32 || HD == 64 || HD == 128, "templates 32, 64 and 128: a head dim runs on the least above it");
  static constexpr uint32_t ROW = HD * 2;                // bytes a row
  static constexpr uint32_t SPAN = HD == 32 ? 64 : 128;  // bytes an atom row: the swizzle span
  static constexpr int ATOMS = ROW / SPAN;               // 2 at head dim 128, else 1
  static constexpr int COLS = SPAN / 2;                  // elements an atom row: a TMA box's inner extent, a wgmma's N
  static constexpr int CHUNKS = SPAN / 16;               // 16-byte chunks an atom row
  static constexpr int KSTEPS = SPAN / 32;               // k-steps of 16 elements an atom row
  static constexpr uint32_t MN_STEP = SPAN;              // 16 rows, in descriptor units (16 bytes)

  // byte offset of 16-byte chunk c (0 .. HD / 8 - 1) of row r
  static __device__ __forceinline__ uint32_t off(int R, int r, int c) {
    const int key = SPAN == 128 ? (r & 7) : ((r >> 1) & 3);
    return (c / CHUNKS) * R * SPAN + r * SPAN + (((c % CHUNKS) ^ key) << 4);
  }
  // wgmma shared-memory descriptor of the atom at `addr` (1024-byte aligned): SBO 8 SPAN, LBO unused
  static __device__ __forceinline__ uint64_t desc(uint32_t addr) {
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t((8 * SPAN) >> 4) << 32) |
           (uint64_t(SPAN == 128 ? 1 : 2) << 62);
  }
  // k-step kk of a K-major R-row tile, added to its descriptor
  static __device__ __forceinline__ uint32_t kstep(int R, int kk) {
    return (kk / KSTEPS) * (R * SPAN / 16) + 2 * (kk % KSTEPS);
  }
  // atom a of an R-row tile, added to its descriptor
  static __device__ __forceinline__ uint32_t atom(int R, int a) { return a * (R * SPAN / 16); }
};

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
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// Rows row .. row + R - 1 of head h, batch b into an R-row tile, a box an
// atom: the map's dims are (HD, nh, L, B) when `heads_inner`, else (HD, L, nh, B).
template <int HD>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, bool heads_inner, int R, int h,
                                          int row, int b, uint64_t* bar) {
#pragma unroll
  for (int a = 0; a < Tile<HD>::ATOMS; ++a)
    if (heads_inner)
      tma_load4(dst + a * R * Tile<HD>::SPAN, map, a * Tile<HD>::COLS, h, row, b, bar);
    else
      tma_load4(dst + a * R * Tile<HD>::SPAN, map, a * Tile<HD>::COLS, row, h, b, bar);
}

// load_rows by the copies of producer warp `part` of PARTS (Heads::w > 0): input i of `hs`.
template <int HD, int PARTS = 1>
__device__ __forceinline__ void copy_tile(uint32_t dst, const Heads& hs, int i, int R, int h, int row, int b,
                                          int lane, int part = 0) {
  copy_rows<HD / 8, PARTS>(dst, hs, i, 2, R, h, row, b, lane, part,
                           [R](int r, int c) { return Tile<HD>::off(R, r, c); });
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// The A fragment (16 rows from row0, k-step ks of 16) of an R-row tile at `tile`.
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const unsigned char* tile, int R, int row0, int ks,
                                       int lane) {
  const int row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(a, smem_u32(tile + Tile<HD>::off(R, row, ks * 2 + (lane >> 4))));
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

// Accumulator j's registers as its own array of 8-column groups: columns
// 8 j .. of the product's N, the accumulator of one wgmma of N 8 n.
template <int n, int N>
__device__ __forceinline__ float (&cols(float (&d)[N][4], int j))[n][4] {
  return *reinterpret_cast<float(*)[n][4]>(&d[j]);
}

#define WG_ACC16                                                                                                   \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),         \
      "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),     \
      "+f"(d[3][2]), "+f"(d[3][3])
#define WG_ACC32                                                                                                   \
  WG_ACC16, "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]),              \
      "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]),     \
      "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define WG_ACC64                                                                                                   \
  WG_ACC32, "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]),              \
      "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),               \
      "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),             \
      "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),             \
      "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]),             \
      "+f"(d[15][2]), "+f"(d[15][3])
#define WG_REG16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_REG32                                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "    \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_REG64                                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "    \
  "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A[64 x 16] . B: A from registers (the m16n8k16 A layout, each warp
// its 16 rows); B in shared memory, K-major (B[N x 16]^T) or, with the
// transpose bit, MN-major (B[16 x N]); scale_d = 0 overwrites d.
#define WGMMA_RS_ASM(NS, TY, TRANS, REGS, A, D, S, ...)                                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " S ", 0;\n"                                                     \
               "wgmma.mma_async.sync.aligned.m64n" NS "k16.f32." TY "." TY " " REGS ", " A ", " D ", p, 1, 1, "  \
               TRANS ";\n}\n"                                                                                     \
               : __VA_ARGS__                                                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
#define WGMMA_RS_TYPES(NS, TRANS, REGS, A, D, S, ...)                   \
  if constexpr (std::is_same<T, __nv_bfloat16>::value)                   \
    WGMMA_RS_ASM(NS, "bf16", TRANS, REGS, A, D, S, __VA_ARGS__);         \
  else                                                                   \
    WGMMA_RS_ASM(NS, "f16", TRANS, REGS, A, D, S, __VA_ARGS__)

template <typename T, int N, int TRANS>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma N 32, 64 or 128");
  if constexpr (N == 128 && TRANS) {
    WGMMA_RS_TYPES("128", "1", WG_REG64, "{%64, %65, %66, %67}", "%68", "%69", WG_ACC64);
  } else if constexpr (N == 128) {
    WGMMA_RS_TYPES("128", "0", WG_REG64, "{%64, %65, %66, %67}", "%68", "%69", WG_ACC64);
  } else if constexpr (N == 64 && TRANS) {
    WGMMA_RS_TYPES("64", "1", WG_REG32, "{%32, %33, %34, %35}", "%36", "%37", WG_ACC32);
  } else if constexpr (N == 64) {
    WGMMA_RS_TYPES("64", "0", WG_REG32, "{%32, %33, %34, %35}", "%36", "%37", WG_ACC32);
  } else if constexpr (TRANS) {
    WGMMA_RS_TYPES("32", "1", WG_REG16, "{%16, %17, %18, %19}", "%20", "%21", WG_ACC16);
  } else {
    WGMMA_RS_TYPES("32", "0", WG_REG16, "{%16, %17, %18, %19}", "%20", "%21", WG_ACC16);
  }
}

// d (+)= A[64 x 16] . B[32 x 16]^T, A and B K-major in shared memory (K12 at
// head dim 128, whose K and V rows do not fit its registers); scale_d = 0
// overwrites d.
#define WGMMA_SS32_ASM(TY)                                                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                       \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " WG_REG16 ", %16, %17, p, 1, 1, 0, 0;\n}\n" \
               : WG_ACC16                                                                                         \
               : "l"(da), "l"(db), "r"(scale_d))

template <typename T>
__device__ __forceinline__ void wgmma_ss32(float (&d)[4][4], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    WGMMA_SS32_ASM("bf16");
  else
    WGMMA_SS32_ASM("f16");
}

// ---- K11, route "wgmma" ----
//
// A block is NWG consumer warpgroups of 64 query rows (NWG = 3 where Lq is a
// multiple of 192 and the head dim at most 64, else 2) and one producer
// warpgroup, persistent over (query block, head, batch) tiles, the query
// blocks of a head adjacent.  The producer's one thread loads the block's Q
// tile once a tile and keeps 128-key K and V tiles with their segment ids in
// a ring of STAGES on mbarriers.  Each consumer takes its Q rows into A
// fragments (freeing the Q buffer for the next tile), then per key tile: S =
// Q K^T by wgmma m64n128k16 (K from shared memory, hd / 16 k-steps), the mask
// and the online softmax on the accumulators, P rounded into A fragments, P V
// by wgmma m64nNk16 (V as an MN-major B, one wgmma an atom: N = hd at 32 and
// 64, two of 64 at 128), and the JAX combination; o leaves through shared
// memory, l and m from registers.  At head dim 128 a thread holds O and P V
// (64 fp32 registers each) beside S: three consumer warpgroups' 160
// registers cannot, so its blocks are 128 rows.

// acc += pv / l_next: the JAX combination's second half (acc * (l_corr / l_next) came before P V).
template <int N>
__device__ __forceinline__ void add_pv(float (&acc)[N][4], const float (&pv)[N][4], const float (&inv)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(pv[j][e], inv[e >> 1]));
}

// A warp's 16 accumulator rows (rows g and g + 8 of lane g * 4 + q, as
// store_rows has them) rounded to T at `out` (row stride `sl`) through the
// warp's 32 hd bytes of shared memory `stage`: each row leaves as hd / 8
// lanes' 16-byte stores, whole 32-byte sectors (store_rows' 4-byte stores
// leave half sectors, 8 rows an instruction).  The 16-byte chunks of a
// staged row are XOR-swizzled by the row, so neither side has bank conflicts.
// The chunks below d alone: whole where d is a multiple of 8 and the rows
// are 16-byte aligned (the tensor maps' launches), else (PART, the copies')
// each chunk's columns below d, stored as wide as their address allows
// (store_part).
template <typename T, int HD, bool PART>
__device__ __forceinline__ void store_rows_staged(T* out, long long sl, const float (&c)[HD / 8][4], uint32_t* stage,
                                                  int lane, int d) {
  constexpr int CH = HD / 8, W = HD / 2;  // 16-byte chunks and 4-byte words a row
  const int g = lane >> 2, q = lane & 3;
  __syncwarp();  // the last call's reads are done
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    stage[g * W + ((j ^ (g & (CH - 1))) << 2) + q] = Type<T>::pack(c[j][0], c[j][1]);
    stage[(g + 8) * W + ((j ^ (g & (CH - 1))) << 2) + q] = Type<T>::pack(c[j][2], c[j][3]);
  }
  __syncwarp();
  if constexpr (!PART) {
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      const int chunk = lane + 32 * i, r = chunk / CH, ch = chunk % CH;
      if (ch * 8 < d)
        *reinterpret_cast<uint4*>(out + r * sl + ch * 8) =
            *reinterpret_cast<const uint4*>(stage + r * W + ((ch ^ (r & 7 & (CH - 1))) << 2));
    }
  } else {
#pragma unroll
    for (int i = 0; i < CH / 2; ++i) {
      const int chunk = lane + 32 * i, r = chunk / CH, ch = chunk % CH;
      const uint4 v = *reinterpret_cast<const uint4*>(stage + r * W + ((ch ^ (r & 7 & (CH - 1))) << 2));
      if (ch * 8 < d) store_part(out + r * sl + ch * 8, v, min(8, d - ch * 8));
    }
  }
}

template <int HD, int NWG> struct Fwd {
  using L = Tile<HD>;
  static constexpr int ROWS_BLK = NWG * 64;
  static constexpr int STAGES = HD == 128 ? 2 : HD == 64 ? 3 : 4;  // K/V tiles in flight
  static constexpr uint32_t Q_BYTES = ROWS_BLK * L::ROW;
  static constexpr uint32_t KV_BYTES = KT * L::ROW;  // a 128-row tile
  static constexpr uint32_t OUT = 16 * L::ROW;       // a warp's output rows
  static constexpr uint32_t smem = 1024 + Q_BYTES + STAGES * (2 * KV_BYTES + KT * 4) + NWG * 4 * OUT;
};
static_assert(Fwd<32, 3>::smem <= 232448 - 128 && Fwd<64, 3>::smem <= 232448 - 128 &&
                  Fwd<128, 2>::smem <= 232448 - 128,
              "K11's ring must fit a block's shared memory");

template <typename T, int HD, int NWG, bool COPIES>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, int heads_inner, T* __restrict__ O, View vo,
                       const int* __restrict__ qseg, const int* __restrict__ kvseg, float* __restrict__ l_out,
                       float* __restrict__ m_out, int nh, int Lq, int Lk, int n_tiles, float scale,
                       const __grid_constant__ Heads hs) {
  using C = Fwd<HD, NWG>;
  using L = Tile<HD>;
  constexpr int ROWS_BLK = C::ROWS_BLK, STAGES = C::STAGES, NA = L::COLS;  // NA: P V's N a wgmma
  static_assert(HD <= 64 || NWG == 2, "at head dim 128 a consumer needs setmaxnreg's 232 registers");
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], q_full, q_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;               // Q: NWG x 64 rows
  const uint32_t skv = sq + C::Q_BYTES;                     // [stage][K, V]
  const uint32_t sseg = skv + STAGES * 2 * C::KV_BYTES;     // [stage][128] key segment ids
  const int* const seg_base = reinterpret_cast<const int*>(smem_raw + (sseg - raw));
  // [warp][16 rows] for the output rows
  uint32_t* const out_stage = reinterpret_cast<uint32_t*>(smem_raw + (sseg + STAGES * KT * 4 - raw));
  const int n_qb = Lq / ROWS_BLK, n_kt = Lk / KT;

  if (threadIdx.x == 0) {
    // the producer's expect_tx; with copies also the lanes of the slot's warp, or of all four for Q
    constexpr uint32_t fills = COPIES ? 33 : 1, q_fills = COPIES ? 129 : 1;
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], fills);
      mbar_init(&empty[s], NWG * 4);   // every consumer warp
    }
    mbar_init(&q_full, q_fills);
    mbar_init(&q_empty, NWG * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // ---- producer: keeps Q and the K/V ring full, tile after tile: one thread's TMA loop, or with copies
    // (Heads::w) the four warps' jobs ----
    if constexpr (NWG == 3 && COPIES)  // the copies' loop: 32 registers, the consumers' 160 all that is left
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    else if constexpr (NWG == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (!COPIES && threadIdx.x == NWG * 128) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
        mbar_wait(&q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_expect_tx(&q_full, C::Q_BYTES);
        load_rows<HD>(sq, &map_q, heads_inner & 1, ROWS_BLK, h, qb * ROWS_BLK, b, &q_full);
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * C::KV_BYTES + KT * 4);
          const uint32_t st = skv + stage * 2 * C::KV_BYTES;
          load_rows<HD>(st, &map_k, heads_inner & 2, KT, h, kt * KT, b, &full[stage]);
          load_rows<HD>(st + C::KV_BYTES, &map_v, heads_inner & 4, KT, h, kt * KT, b, &full[stage]);
          bulk_load(sseg + stage * KT * 4, kvseg + (long long)b * Lk + kt * KT, KT * 4, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (COPIES) {
      const int pw = threadIdx.x / 32 - NWG * 4, lane = threadIdx.x % 32;
      produce<STAGES, 4>(
          pw, n_tiles, n_kt, &q_empty, empty,
          [&](int t) {  // the Q tile, a quarter of its rows a warp
            const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
            if (pw == 0 && lane == 0) mbar_arrive(&q_full);
            copy_tile<HD, 4>(sq, hs, 0, ROWS_BLK, h, qb * ROWS_BLK, b, lane, pw);
            copies_done(&q_full);
          },
          [&](int t, int kt, int stage) {  // a K/V stage and its key segment ids
            const int h = (t / n_qb) % nh, b = t / (n_qb * nh);
            const uint32_t st = skv + stage * 2 * C::KV_BYTES;
            if (lane == 0) {
              mbar_expect_tx(&full[stage], KT * 4);
              bulk_load(sseg + stage * KT * 4, kvseg + (long long)b * Lk + kt * KT, KT * 4, &full[stage]);
            }
            copy_tile<HD>(st, hs, 1, KT, h, kt * KT, b, lane);
            copy_tile<HD>(st + C::KV_BYTES, hs, 2, KT, h, kt * KT, b, lane);
            copies_done(&full[stage]);
          });
    }
  } else {
    // ---- consumers: 64 query rows each ----
    if constexpr (NWG == 3)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = threadIdx.x / 128, lane = threadIdx.x % 32, qd = lane & 3;
    const int row = wgi * 64 + (threadIdx.x % 128) / 32 * 16 + (lane >> 2);  // rows row and row + 8 of the block
    const unsigned char* const q_tile = smem_raw + (sq - raw);
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
      for (int ks = 0; ks < HD / 16; ++ks)
        load_a<HD>(qf[ks], q_tile + wgi * 64 * L::SPAN, ROWS_BLK, (threadIdx.x % 128) / 32 * 16, ks, lane);
      if (lane == 0) mbar_arrive(&q_empty);  // this warp is done with the Q tile
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t ka = skv + stage * 2 * C::KV_BYTES, va = ka + C::KV_BYTES;
        const int* st = seg_base + stage * KT;

        fence_acc(s);
        fence_a(qf);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs<T, KT, 0>(s, qf[kk], L::desc(ka) + L::kstep(KT, kk), kk);
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
        for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk)
            wgmma_rs<T, NA, 1>(cols<NA / 8>(pv, a * NA / 8), pa[kk], L::desc(va) + L::atom(KT, a) + L::MN_STEP * kk,
                               kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        fence_acc(pv);
        fence_a(pa);
        if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with K and V
        add_pv(acc, pv, inv);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      const int row0 = row - (lane >> 2);  // this warp's first row
      store_rows_staged<T, HD, COPIES>(O + b * vo.sb + h * vo.sh + (long long)(q0 + row0) * vo.sl, vo.sl, acc,
                                       out_stage + threadIdx.x / 32 * (C::OUT / 4), lane, hs.d);
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
// QT-query Q and dO tiles with m, 1 / l, di and the query segment ids in a
// ring of STAGES.  Each consumer takes its K and V rows into registers as A
// fragments (freeing their buffer for the next tile at once), then for each
// query tile: S^T = K Q^T and dP^T = V dO^T by wgmma m64nQTk16 (Q and dO as
// K-major B), committed apart; p from S^T while dP^T runs, then dV += P^T dO
// (P^T in registers, dO as MN-major B, a wgmma an atom of the head dim)
// issued; ds from dP^T while dV runs, then dK += dS^T Q issued, and left
// running under the next tile's S^T and dP^T.  dK and dV stay in registers
// over the queries (no atomics) and leave through shared memory as whole
// rows.  At head dim 128, dK and dV alone take 128 fp32 registers a thread:
// K and V stay in shared memory for the tile as wgmma's A operand (the
// buffer freed at the tile's end), and the query tiles are 32 rows (S^T and
// dP^T 16 registers each), 6 deep.

template <int HD> struct Dkv {
  using L = Tile<HD>;
  static constexpr int QT = HD == 128 ? 32 : 64;       // queries a tile
  static constexpr int STAGES = HD == 128 ? 6 : 8;     // Q/dO tiles in flight
  static constexpr bool SS = HD == 128;                // K and V read from shared memory by each product
  static constexpr uint32_t KV_BYTES = KT * L::ROW;
  static constexpr uint32_t QT_BYTES = QT * L::ROW;
  static constexpr uint32_t ROWS_BYTES = 4 * QT * 4;   // a tile's m, 1 / l, di, segment ids
  static constexpr uint32_t OUT = 16 * L::ROW;
  static constexpr uint32_t smem = 1024 + 2 * KV_BYTES + STAGES * (2 * QT_BYTES + ROWS_BYTES) + 8 * OUT;
};
static_assert(Dkv<32>::smem <= 232448 - 128 && Dkv<64>::smem <= 232448 - 128 && Dkv<128>::smem <= 232448 - 128,
              "K12's ring must fit a block's shared memory");

template <typename T, int HD, bool COPIES>
__global__ void __launch_bounds__(384, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                       int heads_inner, const int* __restrict__ qseg, const int* __restrict__ kvseg,
                       const float* __restrict__ inv_l, const float* __restrict__ m_in,
                       const float* __restrict__ di_in, T* __restrict__ dK, T* __restrict__ dV, View vdk, View vdv,
                       int nh, int Lq, int Lk, int n_tiles, float scale, const __grid_constant__ Heads hs) {
  using C = Dkv<HD>;
  using L = Tile<HD>;
  constexpr int QT = C::QT, STAGES = C::STAGES, NA = L::COLS, KF = C::SS ? 1 : HD / 16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kv_full, kv_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t skv = (raw + 1023u) & ~1023u;                 // K, V: 128 rows each
  const uint32_t sqo = skv + 2 * C::KV_BYTES;                  // [stage][Q, dO]
  const uint32_t srows = sqo + STAGES * 2 * C::QT_BYTES;       // [stage][m, 1 / l, di, seg][QT]
  const float* const rows_base = reinterpret_cast<const float*>(smem_raw + (srows - raw));
  uint32_t* const out_stage = reinterpret_cast<uint32_t*>(smem_raw + (srows + STAGES * C::ROWS_BYTES - raw));
  const int n_kb = Lk / KT, n_qt = Lq / QT;

  if (threadIdx.x == 0) {
    // the producer's expect_tx; with copies also the lanes of the slot's warp, or of all four for K and V
    constexpr uint32_t fills = COPIES ? 33 : 1, kv_fills = COPIES ? 129 : 1;
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], fills);
      mbar_init(&empty[s], 2 * 4);
    }
    mbar_init(&kv_full, kv_fills);
    mbar_init(&kv_empty, 2 * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: keeps K, V and the Q/dO ring full: one thread's TMA loop, or with copies (Heads::w) the
    // four warps' jobs ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (!COPIES && threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0, kv_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int kb = t % n_kb, h = (t / n_kb) % nh, b = t / (n_kb * nh);
        const long long rows0 = ((long long)b * nh + h) * Lq;
        mbar_wait(&kv_empty, kv_phase ^ 1);
        kv_phase ^= 1;
        mbar_expect_tx(&kv_full, 2 * C::KV_BYTES);
        load_rows<HD>(skv, &map_k, heads_inner & 2, KT, h, kb * KT, b, &kv_full);
        load_rows<HD>(skv + C::KV_BYTES, &map_v, heads_inner & 4, KT, h, kb * KT, b, &kv_full);
        for (int qt = 0; qt < n_qt; ++qt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * C::QT_BYTES + C::ROWS_BYTES);
          const uint32_t st = sqo + stage * 2 * C::QT_BYTES, rt = srows + stage * C::ROWS_BYTES;
          load_rows<HD>(st, &map_q, heads_inner & 1, QT, h, qt * QT, b, &full[stage]);
          load_rows<HD>(st + C::QT_BYTES, &map_do, heads_inner & 8, QT, h, qt * QT, b, &full[stage]);
          bulk_load(rt, m_in + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + QT * 4, inv_l + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + 2 * QT * 4, di_in + rows0 + qt * QT, QT * 4, &full[stage]);
          bulk_load(rt + 3 * QT * 4, qseg + (long long)b * Lq + qt * QT, QT * 4, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (COPIES) {
      const int pw = threadIdx.x / 32 - 8, lane = threadIdx.x % 32;
      produce<STAGES, 4>(
          pw, n_tiles, n_qt, &kv_empty, empty,
          [&](int t) {  // the block's K and V, a quarter of their rows a warp
            const int kb = t % n_kb, h = (t / n_kb) % nh, b = t / (n_kb * nh);
            if (pw == 0 && lane == 0) mbar_arrive(&kv_full);
            copy_tile<HD, 4>(skv, hs, 1, KT, h, kb * KT, b, lane, pw);
            copy_tile<HD, 4>(skv + C::KV_BYTES, hs, 2, KT, h, kb * KT, b, lane, pw);
            copies_done(&kv_full);
          },
          [&](int t, int qt, int stage) {  // a Q/dO stage and its rows' m, 1 / l, di and segment ids
            const int h = (t / n_kb) % nh, b = t / (n_kb * nh);
            const long long rows0 = ((long long)b * nh + h) * Lq;
            const uint32_t st = sqo + stage * 2 * C::QT_BYTES, rt = srows + stage * C::ROWS_BYTES;
            if (lane == 0) {
              mbar_expect_tx(&full[stage], C::ROWS_BYTES);
              bulk_load(rt, m_in + rows0 + qt * QT, QT * 4, &full[stage]);
              bulk_load(rt + QT * 4, inv_l + rows0 + qt * QT, QT * 4, &full[stage]);
              bulk_load(rt + 2 * QT * 4, di_in + rows0 + qt * QT, QT * 4, &full[stage]);
              bulk_load(rt + 3 * QT * 4, qseg + (long long)b * Lq + qt * QT, QT * 4, &full[stage]);
            }
            copy_tile<HD>(st, hs, 0, QT, h, qt * QT, b, lane);
            copy_tile<HD>(st + C::QT_BYTES, hs, 3, QT, h, qt * QT, b, lane);
            copies_done(&full[stage]);
          });
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, qd = lane & 3;
    const int key = wgi * 64 + warp * 16 + (lane >> 2);  // keys key and key + 8 of the block
    const unsigned char* const kv_tile = smem_raw + (skv - raw);
    // its K and V rows as wgmma's A operand in shared memory (C::SS): descriptors of k-step 0
    const uint64_t k_desc = L::desc(skv) + wgi * (64 * L::SPAN / 16), v_desc = k_desc + C::KV_BYTES / 16;
    int stage = 0;
    uint32_t phase = 0, kv_phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int kb = t % n_kb, h = (t / n_kb) % nh, b = t / (n_kb * nh);
      const int k0 = kb * KT;
      const int kseg0 = kvseg[(long long)b * Lk + k0 + key], kseg1 = kvseg[(long long)b * Lk + k0 + key + 8];
      float dk[HD / 8][4], dv[HD / 8][4], p[QT / 8][4], ds[QT / 8][4];  // p: S^T, then P^T; ds: dP^T, then dS^T
      uint32_t kf[KF][4], vf[KF][4], ap[QT / 16][4] = {}, as[QT / 16][4] = {};
      zero(dk);
      zero(dv);
      zero(p);
      zero(ds);
      mbar_wait(&kv_full, kv_phase);
      kv_phase ^= 1;
      if constexpr (!C::SS) {
#pragma unroll
        for (int ks = 0; ks < HD / 16; ++ks) {
          load_a<HD>(kf[ks], kv_tile + wgi * 64 * L::SPAN, KT, warp * 16, ks, lane);
          load_a<HD>(vf[ks], kv_tile + C::KV_BYTES + wgi * 64 * L::SPAN, KT, warp * 16, ks, lane);
        }
        if (lane == 0) mbar_arrive(&kv_empty);  // this warp is done with the K and V buffer
      }
      int prev = -1;
      for (int qt = 0; qt < n_qt; ++qt) {
        mbar_wait(&full[stage], phase);
        const uint32_t qa = sqo + stage * 2 * C::QT_BYTES, oa = qa + C::QT_BYTES;
        // B operands' descriptors; a k-step advances one by 32 bytes (K-major) or 16 rows (MN-major)
        const uint64_t dq = L::desc(qa), dout = L::desc(oa);
        const float* mt = rows_base + stage * (C::ROWS_BYTES / 4);
        const float* it = mt + QT;
        const float* dt = mt + 2 * QT;
        const int* segt = reinterpret_cast<const int*>(mt + 3 * QT);

        fence_acc(p);
        fence_acc(ds);
        fence_a(kf);
        fence_a(vf);
        hopper::wgmma_fence();
        if constexpr (C::SS) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss32<T>(p, k_desc + L::kstep(KT, kk), dq + L::kstep(QT, kk), kk);
          hopper::wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss32<T>(ds, v_desc + L::kstep(KT, kk), dout + L::kstep(QT, kk), kk);
        } else {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs<T, QT, 0>(p, kf[kk], dq + L::kstep(QT, kk), kk);
          hopper::wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs<T, QT, 0>(ds, vf[kk], dout + L::kstep(QT, kk), kk);
        }
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
        for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk)
            wgmma_rs<T, NA, 1>(cols<NA / 8>(dv, a * NA / 8), ap[kk], dout + L::atom(QT, a) + L::MN_STEP * kk, 1);
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
        for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk)
            wgmma_rs<T, NA, 1>(cols<NA / 8>(dk, a * NA / 8), as[kk], dq + L::atom(QT, a) + L::MN_STEP * kk, 1);
        hopper::wgmma_commit();
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      fence_a(ap);
      fence_a(as);
      if (lane == 0) {
        mbar_arrive(&empty[prev]);
        if constexpr (C::SS) mbar_arrive(&kv_empty);  // this warp's products are done with K and V
      }
      const int key0 = k0 + key - (lane >> 2);  // this warp's first key
      uint32_t* const own = out_stage + threadIdx.x / 32 * (C::OUT / 4);
      store_rows_staged<T, HD, COPIES>(dK + b * vdk.sb + h * vdk.sh + (long long)key0 * vdk.sl, vdk.sl, dk, own,
                                       lane, hs.d);
      store_rows_staged<T, HD, COPIES>(dV + b * vdv.sb + h * vdv.sh + (long long)key0 * vdv.sl, vdv.sl, dv, own,
                                       lane, hs.d);
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
// (from the rows kernel), di and segment ids once, and keeps KT-key K and V
// tiles with their segment ids in a ring of STAGES.  Each consumer takes
// its Q and dO rows into A fragments and its rows' m, 1 / l, di and segment
// ids into registers (freeing the tile's buffer for the next tile at once),
// then per key tile: S = Q K^T and dP = dO V^T by wgmma m64nKTk16 (K and V
// as K-major B), committed apart; p from S while dP runs; ds from dP and p,
// rounded into A fragments; dQ += dS K (K as MN-major B, the transpose bit
// set, a wgmma an atom of the head dim) issued and left running under the
// next tile's S and dP.  dQ stays in
// registers over the keys (no atomics) and leaves through shared memory as
// whole rows.  Key tiles of 64 (32 at head dim 128), not the JAX block's
// 128: at 128 keys S and dP hold 128 fp32 accumulators a thread and dS 32 A
// registers, with dQ and the Q and dO fragments 224 live at head dim 64,
// past the 232 setmaxnreg leaves a consumer once addresses and loop state
// are counted; at head dim 128 dQ and the fragments alone take 128.  Two
// consumer warpgroups, not K11's three (192 rows where they tile Lq): at
// three, setmaxnreg leaves 160 registers, ptxas serialised the wgmmas for
// want of them, and the kernel ran 6% slower (PERF.md §6).

template <int HD> struct Dq {
  using L = Tile<HD>;
  static constexpr int NWG = 2;                             // consumer warpgroups
  static constexpr int ROWS_BLK = NWG * 64;
  static constexpr int KT = HD == 128 ? 32 : 64;            // keys a tile
  static constexpr int STAGES = HD == 128 ? 6 : 8;          // K/V tiles in flight
  static constexpr uint32_t Q_BYTES = ROWS_BLK * L::ROW;
  static constexpr uint32_t KV_BYTES = KT * L::ROW;
  static constexpr uint32_t ROWS_BYTES = 4 * ROWS_BLK * 4;  // a tile's m, 1 / l, di, segment ids
  static constexpr uint32_t OUT = 16 * L::ROW;
  static constexpr uint32_t smem = 1024 + 2 * Q_BYTES + STAGES * (2 * KV_BYTES + KT * 4) + ROWS_BYTES + NWG * 4 * OUT;
};
static_assert(Dq<32>::smem <= 232448 - 128 && Dq<64>::smem <= 232448 - 128 && Dq<128>::smem <= 232448 - 128,
              "K13's ring must fit a block's shared memory");

template <typename T, int HD, bool COPIES>
__global__ void __launch_bounds__((Dq<HD>::NWG + 1) * 128, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                      int heads_inner, const int* __restrict__ qseg, const int* __restrict__ kvseg,
                      const float* __restrict__ inv_l, const float* __restrict__ m_in,
                      const float* __restrict__ di_in, T* __restrict__ dQ, View vdq, int nh, int Lq, int Lk,
                      int n_tiles, float scale, const __grid_constant__ Heads hs) {
  using C = Dq<HD>;
  using L = Tile<HD>;
  constexpr int NWG = C::NWG, ROWS_BLK = C::ROWS_BLK, KT = C::KT, STAGES = C::STAGES, NA = L::COLS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], q_full, q_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;                  // Q, then dO: NWG x 64 rows each
  const uint32_t skv = sq + 2 * C::Q_BYTES;                    // [stage][K, V]
  const uint32_t sseg = skv + STAGES * 2 * C::KV_BYTES;        // [stage][KT] key segment ids
  const uint32_t srows = sseg + STAGES * KT * 4;               // [m, 1 / l, di, seg][ROWS_BLK]
  const int* const seg_base = reinterpret_cast<const int*>(smem_raw + (sseg - raw));
  const float* const rows_base = reinterpret_cast<const float*>(smem_raw + (srows - raw));
  uint32_t* const out_stage = reinterpret_cast<uint32_t*>(smem_raw + (srows + C::ROWS_BYTES - raw));
  const int n_qb = Lq / ROWS_BLK, n_kt = Lk / KT;

  if (threadIdx.x == 0) {
    // the producer's expect_tx; with copies also the lanes of the slot's warp, or of all four for Q and dO
    constexpr uint32_t fills = COPIES ? 33 : 1, q_fills = COPIES ? 129 : 1;
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], fills);
      mbar_init(&empty[s], NWG * 4);
    }
    mbar_init(&q_full, q_fills);
    mbar_init(&q_empty, NWG * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= NWG * 128) {
    // ---- producer: keeps Q, dO, their rows and the K/V ring full: one thread's TMA loop, or with copies
    // (Heads::w) the four warps' jobs ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (!COPIES && threadIdx.x == NWG * 128) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
        const long long rows0 = ((long long)b * nh + h) * Lq + qb * ROWS_BLK;
        mbar_wait(&q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_expect_tx(&q_full, 2 * C::Q_BYTES + C::ROWS_BYTES);
        load_rows<HD>(sq, &map_q, heads_inner & 1, ROWS_BLK, h, qb * ROWS_BLK, b, &q_full);
        load_rows<HD>(sq + C::Q_BYTES, &map_do, heads_inner & 8, ROWS_BLK, h, qb * ROWS_BLK, b, &q_full);
        bulk_load(srows, m_in + rows0, ROWS_BLK * 4, &q_full);
        bulk_load(srows + ROWS_BLK * 4, inv_l + rows0, ROWS_BLK * 4, &q_full);
        bulk_load(srows + 2 * ROWS_BLK * 4, di_in + rows0, ROWS_BLK * 4, &q_full);
        bulk_load(srows + 3 * ROWS_BLK * 4, qseg + (long long)b * Lq + qb * ROWS_BLK, ROWS_BLK * 4, &q_full);
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * C::KV_BYTES + KT * 4);
          const uint32_t st = skv + stage * 2 * C::KV_BYTES;
          load_rows<HD>(st, &map_k, heads_inner & 2, KT, h, kt * KT, b, &full[stage]);
          load_rows<HD>(st + C::KV_BYTES, &map_v, heads_inner & 4, KT, h, kt * KT, b, &full[stage]);
          bulk_load(sseg + stage * KT * 4, kvseg + (long long)b * Lk + kt * KT, KT * 4, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (COPIES) {
      const int pw = threadIdx.x / 32 - NWG * 4, lane = threadIdx.x % 32;
      produce<STAGES, 4>(
          pw, n_tiles, n_kt, &q_empty, empty,
          [&](int t) {  // the block's Q and dO, a quarter of their rows a warp, and their m, 1 / l, di, segment ids
            const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
            const long long rows0 = ((long long)b * nh + h) * Lq + qb * ROWS_BLK;
            if (pw == 0 && lane == 0) {
              mbar_expect_tx(&q_full, C::ROWS_BYTES);
              bulk_load(srows, m_in + rows0, ROWS_BLK * 4, &q_full);
              bulk_load(srows + ROWS_BLK * 4, inv_l + rows0, ROWS_BLK * 4, &q_full);
              bulk_load(srows + 2 * ROWS_BLK * 4, di_in + rows0, ROWS_BLK * 4, &q_full);
              bulk_load(srows + 3 * ROWS_BLK * 4, qseg + (long long)b * Lq + qb * ROWS_BLK, ROWS_BLK * 4, &q_full);
            }
            copy_tile<HD, 4>(sq, hs, 0, ROWS_BLK, h, qb * ROWS_BLK, b, lane, pw);
            copy_tile<HD, 4>(sq + C::Q_BYTES, hs, 3, ROWS_BLK, h, qb * ROWS_BLK, b, lane, pw);
            copies_done(&q_full);
          },
          [&](int t, int kt, int stage) {  // a K/V stage and its key segment ids
            const int h = (t / n_qb) % nh, b = t / (n_qb * nh);
            const uint32_t st = skv + stage * 2 * C::KV_BYTES;
            if (lane == 0) {
              mbar_expect_tx(&full[stage], KT * 4);
              bulk_load(sseg + stage * KT * 4, kvseg + (long long)b * Lk + kt * KT, KT * 4, &full[stage]);
            }
            copy_tile<HD>(st, hs, 1, KT, h, kt * KT, b, lane);
            copy_tile<HD>(st + C::KV_BYTES, hs, 2, KT, h, kt * KT, b, lane);
            copies_done(&full[stage]);
          });
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, qd = lane & 3;
    const int row = wgi * 64 + warp * 16 + (lane >> 2);  // rows row and row + 8 of the block
    const unsigned char* const q_tile = smem_raw + (sq - raw);
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
      float dq[HD / 8][4], s[KT / 8][4], dp[KT / 8][4];  // s: S, then P; dp: dP, then dS
      uint32_t qf[HD / 16][4], of[HD / 16][4], as[KT / 16][4] = {};
      zero(dq);
      zero(s);
      zero(dp);
      mbar_wait(&q_full, q_phase);
      q_phase ^= 1;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        load_a<HD>(qf[ks], q_tile + wgi * 64 * L::SPAN, ROWS_BLK, warp * 16, ks, lane);
        load_a<HD>(of[ks], q_tile + C::Q_BYTES + wgi * 64 * L::SPAN, ROWS_BLK, warp * 16, ks, lane);
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
        const uint32_t ka = skv + stage * 2 * C::KV_BYTES;
        // B operands' descriptors; a k-step advances one by 32 bytes (K-major) or 16 rows (MN-major)
        const uint64_t kdesc = L::desc(ka), vdesc = L::desc(ka + C::KV_BYTES);
        const int* st = seg_base + stage * KT;

        fence_acc(s);
        fence_acc(dp);
        fence_a(qf);
        fence_a(of);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs<T, KT, 0>(s, qf[kk], kdesc + L::kstep(KT, kk), kk);
        hopper::wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) wgmma_rs<T, KT, 0>(dp, of[kk], vdesc + L::kstep(KT, kk), kk);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S, and the last tile's dQ
        fence_acc(s);
        fence_acc(dq);
        fence_a(as);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);  // this warp is done with the last tile

#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
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
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = __fmul_rn(__fmul_rn(__fsub_rn(dp[j][e], di[e >> 1]), s[j][e]), scale);
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) acc_to_a<T>(as[kk], dp, kk);
        fence_a(as);
        hopper::wgmma_fence();
#pragma unroll
        for (int a = 0; a < L::ATOMS; ++a)
#pragma unroll
          for (int kk = 0; kk < KT / 16; ++kk)
            wgmma_rs<T, NA, 1>(cols<NA / 8>(dq, a * NA / 8), as[kk], kdesc + L::atom(KT, a) + L::MN_STEP * kk, 1);
        hopper::wgmma_commit();
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      hopper::wgmma_wait<0>();
      fence_acc(dq);
      fence_a(as);
      if (lane == 0) mbar_arrive(&empty[prev]);
      const int row0 = qb * ROWS_BLK + row - (lane >> 2);  // this warp's first row
      store_rows_staged<T, HD, COPIES>(dQ + b * vdq.sb + h * vdq.sh + (long long)row0 * vdq.sl, vdq.sl, dq,
                                       out_stage + threadIdx.x / 32 * (C::OUT / 4), lane, hs.d);
    }
  }
}

// ---- the backward's per-row inputs: di and 1 / l ----
//
// di = sum(o * do) over the head dim in fp32, read once in the input type:
// hd / 8 threads a row, each summing the products of its 8 elements in
// order, then the hd / 8 partial sums pairwise by lane distance hd / 16, ..., 2, 1
// (ops/flash_attention.py::flash_di_card_order is this order in torch);
// 1 / l rounded once a row, for K12's p = exp(s - m) * (1 / l).  A head dim
// d below the template HD sums the products of columns d .. HD - 1 as zeros
// (loaded element by element, as are rows not 16-byte aligned: `vec` 0).

template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_rows_kernel(const T* __restrict__ O, const T* __restrict__ dO, const float* __restrict__ l, View vo,
                  View vdo, float* __restrict__ di, float* __restrict__ inv_l, int nh, int L, int d, int vec) {
  constexpr int LANES = HD / 8;  // threads a row
  const long long i = (long long)blockIdx.x * (256 / LANES) + threadIdx.x / LANES;  // the row: ((b * nh) + h) * L + r
  const int c = threadIdx.x % LANES;
  const long long bh = i / L;
  const int r = int(i - bh * L), h = int(bh % nh);
  const long long b = bh / nh;
  const T* const po = O + b * vo.sb + h * vo.sh + r * vo.sl + c * 8;
  const T* const pd = dO + b * vdo.sb + h * vdo.sh + r * vdo.sl + c * 8;
  float s = 0.0f;
  if (vec) {
    const uint4 a = *reinterpret_cast<const uint4*>(po);
    const uint4 g = *reinterpret_cast<const uint4*>(pd);
    const T* x = reinterpret_cast<const T*>(&a);
    const T* y = reinterpret_cast<const T*>(&g);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = __fadd_rn(s, __fmul_rn(Type<T>::f(x[e]), Type<T>::f(y[e])));
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = c * 8 + e < d;
      s = __fadd_rn(s, __fmul_rn(in ? Type<T>::f(po[e]) : 0.0f, in ? Type<T>::f(pd[e]) : 0.0f));
    }
  }
#pragma unroll
  for (int d = LANES / 2; d >= 1; d /= 2) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, d));
  if (c == 0) {
    di[i] = s;
    inv_l[i] = __fdiv_rn(1.0f, l[i]);
  }
}

}  // namespace wg

// ---- route "fp32": the rows kernel on fp32 inputs ----
//
// fp32 o and do (model.dtype "float32") take this route in the rows kernel
// (K11, K12 and K13 take route "tf32", below): di from fp32 products and
// sums on the CUDA cores, 1 / l once a row.

namespace f32 {

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// di and 1 / l of fp32 rows: hd / 8 threads a row, each summing the products
// of its 8 elements in order, then the partial sums pairwise by lane distance
// hd / 16, ..., 2, 1 (flash_di_card_order's order; here the products round in fp32).
template <int HD>
__global__ void __launch_bounds__(256)
flash_rows_kernel(const float* __restrict__ O, const float* __restrict__ dO, const float* __restrict__ l, View vo,
                  View vdo, float* __restrict__ di, float* __restrict__ inv_l, int nh, int L, int d, int vec) {
  constexpr int LANES = HD / 8;
  const long long i = (long long)blockIdx.x * (256 / LANES) + threadIdx.x / LANES;  // the row: ((b * nh) + h) * L + r
  const int c = threadIdx.x % LANES;
  const long long bh = i / L;
  const int r = int(i - bh * L), h = int(bh % nh);
  const long long b = bh / nh;
  const float* x = O + b * vo.sb + h * vo.sh + r * vo.sl + c * 8;
  const float* y = dO + b * vdo.sb + h * vdo.sh + r * vdo.sl + c * 8;
  float xs[8], ys[8];
  if (vec) {
    const float4 x0 = ld4(x), x1 = ld4(x + 4), y0 = ld4(y), y1 = ld4(y + 4);
    xs[0] = x0.x, xs[1] = x0.y, xs[2] = x0.z, xs[3] = x0.w, xs[4] = x1.x, xs[5] = x1.y, xs[6] = x1.z, xs[7] = x1.w;
    ys[0] = y0.x, ys[1] = y0.y, ys[2] = y0.z, ys[3] = y0.w, ys[4] = y1.x, ys[5] = y1.y, ys[6] = y1.z, ys[7] = y1.w;
  } else {  // below the template, or rows not 16-byte aligned: element by element, zeros past d
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool in = c * 8 + e < d;
      xs[e] = in ? x[e] : 0.0f;
      ys[e] = in ? y[e] : 0.0f;
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) s = __fadd_rn(s, __fmul_rn(xs[e], ys[e]));
#pragma unroll
  for (int d = LANES / 2; d >= 1; d /= 2) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, d));
  if (c == 0) {
    di[i] = s;
    inv_l[i] = __fdiv_rn(1.0f, l[i]);
  }
}

}  // namespace f32
// ---- route "tf32": K11, K12 and K13 on fp32 inputs, three TF32 products on wgmma ----
//
// Each fp32 product A . B is hi(A) hi(B) + hi(A) lo(B) + lo(A) hi(B), hi =
// tf32(x) and lo = tf32(x - hi) rounded to nearest, ties away (maxsim.cu's
// split; cvt.rna's bits for finite x, by integer operations, and a NaN lo
// for a NaN x: split), on wgmma m64nNk8 .tf32 with fp32 accumulators; the
// arithmetic around the products is the plain version's (the mask, p =
// exp(s - m) * (1 / l), ds = (dp - di) p scale) but for exp, route
// "wgmma"'s ex2.approx of (s - m) log2(e) (2 ulps; expf cost 1-4% more
// time, ~4e-7 of a head vector apart: PERF.md §6).  Layout: a tile of fp32
// rows of hd is hd / 32 atoms (columns 0-31, 32-63, ...) of 128-byte rows
// with the 128-byte swizzle, one TMA box
// each; wgmma's .tf32 operands in shared memory are K-major only (no
// transpose bit), so:
//   * the products over the head dim (S^T = K Q^T, dP^T = V dO^T in K12; S
//     = Q K^T, dP = dO V^T in K13) read the TMA tile as B as it lands, after
//     the producer warpgroup's three spare warps split it in place (hi over
//     the raw words, lo into a twin tile at the same offsets);
//   * the products over the rows give transposed outputs, dV^T = dO^T P and
//     dK^T = Q^T dS (K12), dQ^T = K^T dS^T (K13): B is the P^T or dS tile
//     the kernel writes itself, K-major, split as it is written; A (dO^T,
//     Q^T, K^T) is read from the split tiles into registers by 4-byte loads,
//     the transpose happening there; the accumulators, whose rows are the
//     head dim, leave by 4-byte stores that fill whole 32-byte sectors
//     (8 head-dim values of one row).  Their M is the head dim: at 32 the
//     wgmma's 64 rows are half zeros (warps 2 and 3 load no A, store
//     nothing), at 128 two wgmmas of 64 one after the other.
// Row k of such a product (a query, or a key) sits at position 8 (k / 8) +
// (k % 8) / 2 + 4 (k % 2) of its 8-group in the written tile, so that a
// thread's A registers of one k-step (columns t and t + 4 of the m64nNk8
// tf32 A fragment) read rows 2t and 2t + 1: with the swizzle, a warp's
// 4-byte loads then hit 32 distinct banks.  Each product sums its three
// terms small first (hi lo, lo hi, then hi hi): the tensor cores truncate
// each k-step's sum, so the large terms come last; the outputs sum each
// stage in a fresh accumulator added to the running sum with round-to-
// nearest (K3's lesson: one accumulator over 144 truncating k-steps drifts
// by ~1e-5).  K11 is described with its kernel, after K13's.  In K12 and
// K13 two consumer warpgroups share the work of a block unequally
// in kind but equally in products: warpgroup 0 holds the S side (K or Q in
// A registers, p), warpgroup 1 the dP side (V or dO, ds); P crosses from
// one to the other through shared memory, thread for thread (both hold the
// same accumulator layout), behind named barrier 1.
//   K12: 64 keys a block; K and V A fragments (split in registers) once a
//        tile; 32-query stages of Q, dO (split tiles), m, 1 / l, di and
//        segment ids, DKV_STAGES deep.  Warpgroup 0: S^T (m64n32k8), P^T
//        into its B tile and P for warpgroup 1, dV^T += dO^T P (m64n64k8);
//        warpgroup 1: dP^T, dS^T into its B tile, dK^T += Q^T dS.
//   K13: 64 query rows a block; Q and dO A fragments once a tile; 64-key
//        stages of K, V (split) and key segment ids, DQ_STAGES deep.
//        Warpgroup 0: S (m64n64k8), P for warpgroup 1; warpgroup 1: dP, dS
//        into the B tile (named barrier 2); then each warpgroup dQ^T +=
//        K^T dS^T for 32 of the 64 query rows (m64n32k8).
// At head dim 128 the A operand held over the head dim (K11's Q, K12's K
// and V, K13's Q and dO: 128 registers, hi and lo) does not fit beside the
// accumulators: the raw tile stays in shared memory for the tile and each
// stage splits it into registers a 32-column atom at a time, each atom's
// three products (hi lo, lo hi, hi hi) before the next atom's; K11's and
// K13's stages are 32 keys and K12's ring one stage deep, for shared memory
// (Hd below).
// Bounds at the retriever's doc pass (68, 12, 384, 64): K12's 8 L^2 hd
// flops a head as three TF32 products, 1.85e11 at 495 TFLOP/s, 0.373 ms;
// K13's 6, 0.280 ms; the bytes (fp32 q, k, v, do, dk, dv: 0.144 ms) below
// both.  What the design spends beside the products: the split (K12 a
// stage reads 16 KB and writes 32 KB of shared memory, K13 32 and 64), the
// B operands' reads (a m64nNk8 tf32 wgmma reads 32 N bytes for 1,024 N
// flops: half the shared-memory rate at the tensor cores' peak), and the
// transposed A loads.  Measured (PERF.md §6): the products alone run at
// about the bound, the rest alone takes longer than they do and overlaps
// them little; the consumers are bound by instruction issue, which is why
// the split rounds by integer operations and not by cvt.rna's longer
// sequence.  A pipelined schedule (the next stage's head-dim product issued
// before this stage's product over rows, p under the latter; P and dS
// double-buffered, K13 at 32-key stages) ran 0-11% slower.

namespace tf {

using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::sw128_desc;
using wg::fence_a;
using wg::fence_acc;

constexpr int RB = 64;         // keys a K12 block, query rows a K13 block
constexpr int QT = 32;         // queries a K12 stage
constexpr int KT = 64;         // keys a K13 stage
constexpr int DKV_STAGES = 4;  // Q/dO stages in flight in K12
constexpr int DQ_STAGES = 2;   // K/V stages in flight in K13
constexpr int FWD_STAGES = 2;  // K/V stages in flight in K11
constexpr int SPLIT_THREADS = 96;  // the producer warpgroup's warps 1-3

// What the head dim changes: the A operand held over the head dim (split
// once a tile, HELD, or an atom at a time each stage), the keys of a K11 and
// a K13 stage, K12's ring, and the head dim's 64-row halves (the M of the
// products over rows).
template <int HD> struct Hd {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head dims 32, 64 and 128");
  static constexpr bool HELD = HD <= 64;
  static constexpr int AK = HELD ? HD / 8 : 4;          // k-steps of A fragments in registers at once
  static constexpr int KEYS = HD == 128 ? 32 : KT;      // keys a K11 and a K13 stage
  static constexpr int DKV_DEPTH = HD == 128 ? 1 : DKV_STAGES;
  static constexpr int MH = HD == 128 ? 2 : 1;          // 64-row halves of the head dim
};

// Byte offset of (row, col) in an R-row tile of fp32 rows: atoms of 32
// columns, each R 128-byte rows, 16-byte chunks XOR-swizzled by the row.
template <int R>
__device__ __forceinline__ uint32_t at(int row, int col) {
  return (col >> 5) * (R * 128) + row * 128 + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

// Where row k of a product over rows sits in its 8-group (see above).
__device__ __forceinline__ int pos(int k) { return (k & ~7) + ((k & 7) >> 1) + ((k & 1) << 2); }

// tf32(x), rounded to nearest with ties away from zero: cvt.rna.tf32.f32's
// bits for finite x, by two integer operations (half a tf32 ulp added to the
// magnitude, the 13 low bits cleared).  A NaN's mantissa may carry into its
// sign (0x7FFFFFFF gives -0.0): split keeps lo a NaN.
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// x = hi + lo to ~2^-22: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact).
// For a NaN x, x - hi is the canonical NaN 0x7FFFFFFF whatever hi is; as a
// signed word it is clamped to 0x7FFFEFFF (above every other non-negative
// word), which rounds to a NaN lo: each product lo enters, and its output,
// is NaN as the plain version's is.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__int_as_float(min(__float_as_int(__fsub_rn(x, __uint_as_float(hi))), 0x7FFFEFFF)));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Columns c0 .. c0 + 31 of rows row .. row + box - 1 of head h, batch b (a
// 4-D map of make_rows_map) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_half(uint32_t dst, const CUtensorMap* map, bool heads_inner, int c0, int h,
                                         int row, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(heads_inner ? h : row),
        "r"(heads_inner ? row : h), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// An R-row tile (every atom) of rows row .. row + R - 1.
template <int R, int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, bool heads_inner, int h, int row,
                                         int b, uint64_t* bar) {
#pragma unroll
  for (int a = 0; a < HD / 32; ++a) tma_half(dst + a * R * 128, map, heads_inner, 32 * a, h, row, b, bar);
}

// tma_tile by the copies of the producer's warp 8 (Heads::w > 0): input i of `hs`.
template <int R, int HD>
__device__ __forceinline__ void copy_tile(uint32_t dst, const Heads& hs, int i, int h, int row, int b, int lane) {
  copy_rows<HD / 4, 1>(dst, hs, i, 4, R, h, row, b, lane, 0, [](int r, int c) { return at<R>(r, 4 * c); });
}

// B descriptor of k-step kk (8 columns) of a K-major R-row tile, from the
// tile's own (sw128_desc of its first atom): the next atom R * 128 bytes
// on, a k-step 32 bytes (the address field counts 16).
template <int R>
__device__ __forceinline__ uint64_t desc64(uint64_t tile, int kk) {
  return tile + (kk >> 2) * (R * 128 / 16) + 2 * (kk & 3);
}

// `bytes` of raw fp32 words at `raw` (16-byte aligned) split: hi over the
// words, lo at raw + `lo_off`; the split warps' share, then made visible to
// the tensor cores.
__device__ __forceinline__ void split_tiles(unsigned char* raw, uint32_t bytes, uint32_t lo_off, int si) {
  for (uint32_t i = si * 16; i < bytes; i += SPLIT_THREADS * 16) {
    const float4 x = *reinterpret_cast<const float4*>(raw + i);
    uint4 hi, lo;
    split(x.x, hi.x, lo.x);
    split(x.y, hi.y, lo.y);
    split(x.z, hi.z, lo.z);
    split(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(raw + i) = hi;
    *reinterpret_cast<uint4*>(raw + lo_off + i) = lo;
  }
  fence_proxy_async();
}

// A fragments (hi, lo) of a warp's 16 rows r0 .. r0 + 15 over KS k-steps
// from column c0 of a raw R-row tile, split in registers: k-step kk,
// registers (row, col) (g, c0 + 8kk + t), (g + 8, ...), (g, c0 + 8kk + t +
// 4), (g + 8, ...).
template <int R, int KS>
__device__ __forceinline__ void rows_a(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4], const unsigned char* tile,
                                       int r0, int lane, int c0 = 0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(*reinterpret_cast<const float*>(tile + at<R>(r0 + g + 8 * (r & 1), c0 + 8 * kk + t + 4 * (r >> 1))),
            hi[kk][r], lo[kk][r]);
}

// A fragments of the transposed operand of a product over rows: the head-dim
// rows h0 .. h0 + 15 (M) by rows 0 .. 8 KS - 1 of an R-row split tile (K, at
// pos(k)), from its hi and lo twins.  The offsets of k-step 0 (cols_offsets)
// are the thread's own; k-step kk reads 8 kk rows further (the swizzle takes
// the row modulo 8).
template <int R>
__device__ __forceinline__ void cols_offsets(uint32_t (&off)[4], int h0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) off[r] = at<R>(2 * t + (r >> 1), h0 + g + 8 * (r & 1));
}

template <int KS>
__device__ __forceinline__ void cols_a(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4], const unsigned char* tile_hi,
                                       const unsigned char* tile_lo, const uint32_t (&off)[4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(tile_hi + off[r] + kk * 8 * 128);
      lo[kk][r] = *reinterpret_cast<const uint32_t*>(tile_lo + off[r] + kk * 8 * 128);
    }
}

// cols_a for the head-dim rows from h0 of a head dim of HD, zeros past it
// (the padding of M at head dim 32).
template <int HD, int KS>
__device__ __forceinline__ void cols_a_hd(uint32_t (&hi)[KS][4], uint32_t (&lo)[KS][4], const unsigned char* tile_hi,
                                          const unsigned char* tile_lo, const uint32_t (&off)[4], int h0) {
  if (h0 < HD) {
    cols_a(hi, lo, tile_hi, tile_lo, off);
  } else {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) hi[kk][r] = lo[kk][r] = 0u;
  }
}

// An accumulator (rows r0 + g, r0 + g + 8; columns 8j + 2t, + 1) into the
// K-major B tiles of a product over its columns (one 128-byte swizzle atom
// of 32 columns per 32-column group), hi and lo, each column at pos().
template <int R, int N>
__device__ __forceinline__ void acc_to_b(unsigned char* tile_hi, unsigned char* tile_lo, const float (&c)[N][4],
                                         int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = at<R>(r0 + g + 8 * (e >> 1), pos(8 * j + 2 * t + (e & 1)));
      uint32_t hi, lo;
      split(c[j][e], hi, lo);
      *reinterpret_cast<uint32_t*>(tile_hi + off) = hi;
      *reinterpret_cast<uint32_t*>(tile_lo + off) = lo;
    }
}

// An accumulator as a thread-major block of float4s: float4 j of thread w at
// j * 128 + w, read back by the other warpgroup's thread of the same index.
template <int N>
__device__ __forceinline__ void to_thread(float* buf, const float (&c)[N][4], int wtid) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    reinterpret_cast<float4*>(buf)[j * 128 + wtid] = make_float4(c[j][0], c[j][1], c[j][2], c[j][3]);
}

// d (+)= A[64 x 8] . B[N x 8]^T, tf32 A from registers, B K-major in shared
// memory (128-byte swizzle; no transpose for .tf32); scale_d = 0 overwrites d.
__device__ __forceinline__ void mma_n64(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),
        "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_n32(float (&d)[4][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N][4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  static_assert(N == 8 || N == 4, "wgmma .tf32 N 64 or 32 here");
  if constexpr (N == 8)
    mma_n64(d, a, db, scale_d);
  else
    mma_n32(d, a, db, scale_d);
}

// Issues d = A . B over KS k-steps as three TF32 products, the small terms
// first, and commits them as one group; desc(kk) and desc_lo(kk) are B's hi
// and lo descriptors of k-step kk; `fresh`: the first k-step overwrites d
// (else every one adds to it).  The caller waits (wgmma_wait<0>) and
// then calls done() on what the group used, before touching it; registers
// the group does not use stay free meanwhile.
template <int N, int KS, typename D, typename DL>
__device__ __forceinline__ void issue3(float (&d)[N][4], uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4], D desc,
                                       DL desc_lo, bool fresh = true) {
  fence_acc(d);
  fence_a(ah);
  fence_a(al);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma<N>(d, ah[kk], desc_lo(kk), kk > 0 || !fresh);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma<N>(d, al[kk], desc(kk), 1);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma<N>(d, ah[kk], desc(kk), 1);
  hopper::wgmma_commit();
}

template <int N, int KS>
__device__ __forceinline__ void done(float (&d)[N][4], uint32_t (&ah)[KS][4], uint32_t (&al)[KS][4]) {
  fence_acc(d);
  fence_a(ah);
  fence_a(al);
}

template <int N>
__device__ __forceinline__ void add_rn(float (&acc)[N][4], const float (&part)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], part[j][e]);
}

// d = A . B over the head dim, A the warp's 16 rows from r0 of the raw
// R-row tile `a_tile` an atom at a time (HD 128: split into fh and fl each
// time, the atom's products waited for before the next atom's split), B the
// K-major split tile whose k-step kk desc(kk) and desc_lo(kk) give.  The
// small terms (hi lo, lo hi) of every atom sum in d and the large (hi hi) in
// a second accumulator, added to d once with round-to-nearest: in one
// accumulator, atom by atom, the small terms of atoms 1-3 land on the large
// sum of the atoms before them and lose the tensor cores' truncation of
// each k-step to it (on an H100, dq at (68, 8, 384, 128) fp32 then came to
// 1.06e-5 of its head vector against the plain version, past
// FP32_HEAD_REL; with the second accumulator 4.9e-6).  Waits for the
// products.
template <int R, int HD, int N, typename D, typename DL>
__device__ __forceinline__ void by_atoms(float (&d)[N][4], uint32_t (&fh)[4][4], uint32_t (&fl)[4][4],
                                         const unsigned char* a_tile, int r0, int lane, D desc, DL desc_lo) {
  float big[N][4];
#pragma unroll
  for (int a = 0; a < HD / 32; ++a) {
    rows_a<R, 4>(fh, fl, a_tile, r0, lane, 32 * a);
    fence_acc(d);
    fence_acc(big);
    fence_a(fh);
    fence_a(fl);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<N>(d, fh[kk], desc_lo(4 * a + kk), kk > 0 || a > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<N>(d, fl[kk], desc(4 * a + kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma<N>(big, fh[kk], desc(4 * a + kk), kk > 0 || a > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_acc(d);
    fence_acc(big);
    fence_a(fh);
    fence_a(fl);
  }
  add_rn(d, big);
}

// A transposed accumulator (rows: the head dim h0 + g, + 8; columns: rows
// 8j + 2t, + 1 of the output from `row0`) to its (row, head dim) places
// below the head dim d.
template <int N>
__device__ __forceinline__ void store_t(float* out, long long sl, const float (&c)[N][4], int h0, int lane, int d) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (h0 + g + 8 * (e >> 1) < d) out[(long long)(8 * j + 2 * t + (e & 1)) * sl + h0 + g + 8 * (e >> 1)] = c[j][e];
}

// ---- K12, route "tf32" ----

template <int HD> struct Dkv {
  static constexpr int STAGES = Hd<HD>::DKV_DEPTH;
  static constexpr uint32_t KV_TILE = RB * HD * 4;   // a block's K (or V) rows: 16 KB at hd 64
  static constexpr uint32_t Q_TILE = QT * HD * 4;    // a stage's Q (or dO) rows: 8 KB at hd 64
  static constexpr uint32_t HI = 2 * Q_TILE;         // Q, dO (hi after the split)
  static constexpr uint32_t ROWS = 4 * QT * 4;       // m, 1 / l, di, segment ids
  static constexpr uint32_t STAGE = 2 * HI + 1024;   // hi, lo, rows
  static constexpr uint32_t PT = RB * 128;           // P^T or dS^T: 64 keys x 32 queries
  static constexpr uint32_t PEX = RB * QT * 4;       // P for warpgroup 1, thread-major
  static constexpr uint32_t smem = 1024 + 2 * KV_TILE + STAGES * STAGE + 4 * PT + 2 * PEX;
};
static_assert(Dkv<32>::smem <= 232448 - 1024 && Dkv<64>::smem <= 232448 - 1024 && Dkv<128>::smem <= 232448 - 1024,
              "K12's route tf32 must fit a block's shared memory");

template <int HD, bool COPIES>
__global__ void __launch_bounds__(384, 1)
flash_dkv_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                            int heads_inner, const int* __restrict__ qseg, const int* __restrict__ kvseg,
                            const float* __restrict__ inv_l, const float* __restrict__ m_in,
                            const float* __restrict__ di_in, float* __restrict__ dK, float* __restrict__ dV,
                            View vdk, View vdv, int nh, int Lq, int Lk, int n_tiles, float scale,
                            const __grid_constant__ Heads hs) {
  using C = Dkv<HD>;
  using H = Hd<HD>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], ready[STAGES], empty[STAGES], kv_full, kv_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t skv = (raw + 1023u) & ~1023u;                // K, V: 64 rows each
  const uint32_t sst = skv + 2 * C::KV_TILE;                  // [stage][hi: Q, dO][lo: Q, dO][rows]
  const uint32_t spt = sst + STAGES * C::STAGE;               // P^T hi, lo; dS^T hi, lo
  const uint32_t spex = spt + 4 * C::PT;                      // [2][P]
  unsigned char* const base = smem_raw + (skv - raw);         // generic pointer of skv
  const int n_kb = Lk / RB, n_qt = Lq / QT;

  if (threadIdx.x == 0) {
    constexpr uint32_t fills = COPIES ? 33 : 1;  // the producer's expect_tx; with copies (Heads) also warp 8's lanes
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], fills);
      mbar_init(&ready[s], SPLIT_THREADS);
      mbar_init(&empty[s], 2 * 4);
    }
    mbar_init(&kv_full, fills);
    mbar_init(&kv_empty, 2 * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: thread 256's TMA loop (below hd 128) or warp 8's jobs (produce: its lane 0 issuing TMA at
    // hd 128, or with copies the whole warp) keep K, V and the Q/dO ring full; warps 9-11 split.  At hd 128 the
    // consumers take 232 registers (at 224 they spilled) and the producer's 40 hold warp 8's jobs, where the
    // one thread's loop spilled ----
    constexpr bool LOOP = !COPIES && HD != 128;
    if constexpr (HD == 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (LOOP && threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0, kv_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int kb = t % n_kb, h = (t / n_kb) % nh, b = t / (n_kb * nh);
        const long long rows0 = ((long long)b * nh + h) * Lq;
        mbar_wait(&kv_empty, kv_phase ^ 1);
        kv_phase ^= 1;
        mbar_expect_tx(&kv_full, 2 * C::KV_TILE);
        tma_tile<RB, HD>(skv, &map_k, heads_inner & 2, h, kb * RB, b, &kv_full);
        tma_tile<RB, HD>(skv + C::KV_TILE, &map_v, heads_inner & 4, h, kb * RB, b, &kv_full);
        for (int qt = 0; qt < n_qt; ++qt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], C::HI + C::ROWS);
          const uint32_t st = sst + stage * C::STAGE, rt = st + 2 * C::HI;
          tma_tile<QT, HD>(st, &map_q, heads_inner & 1, h, qt * QT, b, &full[stage]);
          tma_tile<QT, HD>(st + C::Q_TILE, &map_do, heads_inner & 8, h, qt * QT, b, &full[stage]);
          wg::bulk_load(rt, m_in + rows0 + qt * QT, QT * 4, &full[stage]);
          wg::bulk_load(rt + QT * 4, inv_l + rows0 + qt * QT, QT * 4, &full[stage]);
          wg::bulk_load(rt + 2 * QT * 4, di_in + rows0 + qt * QT, QT * 4, &full[stage]);
          wg::bulk_load(rt + 3 * QT * 4, qseg + (long long)b * Lq + qt * QT, QT * 4, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (!LOOP && threadIdx.x < 288) {
      // ---- or warp 8: its lane 0 issuing TMA (hd 128), or with copies the whole warp ----
      const int lane = threadIdx.x - 256;
      produce<STAGES, 1>(
          0, n_tiles, n_qt, &kv_empty, empty,
          [&](int t) {  // the block's K and V
            const int kb = t % n_kb, h = (t / n_kb) % nh, b = t / (n_kb * nh);
            if (lane == 0) mbar_expect_tx(&kv_full, COPIES ? 0 : 2 * C::KV_TILE);
            if constexpr (COPIES) {
              copy_tile<RB, HD>(skv, hs, 1, h, kb * RB, b, lane);
              copy_tile<RB, HD>(skv + C::KV_TILE, hs, 2, h, kb * RB, b, lane);
              copies_done(&kv_full);
            } else if (lane == 0) {
              tma_tile<RB, HD>(skv, &map_k, heads_inner & 2, h, kb * RB, b, &kv_full);
              tma_tile<RB, HD>(skv + C::KV_TILE, &map_v, heads_inner & 4, h, kb * RB, b, &kv_full);
            }
          },
          [&](int t, int qt, int stage) {  // a Q/dO stage and its rows' m, 1 / l, di and segment ids
            const int h = (t / n_kb) % nh, b = t / (n_kb * nh);
            const long long rows0 = ((long long)b * nh + h) * Lq;
            const uint32_t st = sst + stage * C::STAGE, rt = st + 2 * C::HI;
            if (lane == 0) {
              mbar_expect_tx(&full[stage], (COPIES ? 0 : C::HI) + C::ROWS);
              if constexpr (!COPIES) {
                tma_tile<QT, HD>(st, &map_q, heads_inner & 1, h, qt * QT, b, &full[stage]);
                tma_tile<QT, HD>(st + C::Q_TILE, &map_do, heads_inner & 8, h, qt * QT, b, &full[stage]);
              }
              wg::bulk_load(rt, m_in + rows0 + qt * QT, QT * 4, &full[stage]);
              wg::bulk_load(rt + QT * 4, inv_l + rows0 + qt * QT, QT * 4, &full[stage]);
              wg::bulk_load(rt + 2 * QT * 4, di_in + rows0 + qt * QT, QT * 4, &full[stage]);
              wg::bulk_load(rt + 3 * QT * 4, qseg + (long long)b * Lq + qt * QT, QT * 4, &full[stage]);
            }
            if constexpr (COPIES) {
              copy_tile<QT, HD>(st, hs, 0, h, qt * QT, b, lane);
              copy_tile<QT, HD>(st + C::Q_TILE, hs, 3, h, qt * QT, b, lane);
              copies_done(&full[stage]);
            }
          });
    } else if (threadIdx.x >= 288) {
      const int si = threadIdx.x - 288;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
        for (int qt = 0; qt < n_qt; ++qt) {
          mbar_wait(&full[stage], phase);
          split_tiles(base + (sst - skv) + stage * C::STAGE, C::HI, C::HI, si);
          mbar_arrive(&ready[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // ---- consumers: warpgroup 0 the S side (S^T, P^T, dV^T), warpgroup 1 the dP side (dP^T, dS^T, dK^T) ----
  if constexpr (HD == 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wgi = threadIdx.x / 128, wtid = threadIdx.x % 128, warp = wtid / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int key = warp * 16 + g;  // this thread's keys: key and key + 8 of the block
  unsigned char* const pt_hi = base + (spt - skv) + wgi * 2 * C::PT;  // P^T (wg 0) or dS^T (wg 1)
  unsigned char* const pt_lo = pt_hi + C::PT;
  const uint32_t pt_hi_s = spt + wgi * 2 * C::PT, pt_lo_s = pt_hi_s + C::PT;
  float* const pex = reinterpret_cast<float*>(base + (spex - skv));
  const unsigned char* const kv_rows = base + wgi * C::KV_TILE;  // K (wg 0) or V (wg 1), raw
  uint32_t a_off[H::MH][4];  // this thread's offsets in the stage's tiles for the transposed A (cols_a), by half
#pragma unroll
  for (int mh = 0; mh < H::MH; ++mh) cols_offsets<QT>(a_off[mh], mh * 64 + warp * 16, lane);
  int stage = 0, pb = 0;
  uint32_t phase = 0, kv_phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int kb = t % n_kb, h = (t / n_kb) % nh, b = t / (n_kb * nh);
    const int k0 = kb * RB;
    const int kseg0 = kvseg[(long long)b * Lk + k0 + key], kseg1 = kvseg[(long long)b * Lk + k0 + key + 8];
    uint32_t fh[H::AK][4], fl[H::AK][4];  // K (wg 0) or V (wg 1): this warp's 16 keys over the head dim (an atom)
    mbar_wait(&kv_full, kv_phase);
    kv_phase ^= 1;
    if constexpr (H::HELD) {
      rows_a<RB, H::AK>(fh, fl, kv_rows, warp * 16, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty);  // this warp is done with the K and V buffer
    }
    // dV^T or dK^T (head dim x keys, by 64-row half); a stage's share; S^T or dP^T
    float acc[8 * H::MH][4], part[8][4], s[4][4];
    uint32_t ah[4][4], al[4][4];           // dO^T (wg 0) or Q^T (wg 1) of a stage
    zero(acc);
    zero(part);
    zero(s);
    for (int qt = 0; qt < n_qt; ++qt) {
      mbar_wait(&full[stage], phase);   // the rows' TMA bytes
      mbar_wait(&ready[stage], phase);  // the split
      const uint32_t st = sst + stage * C::STAGE;
      unsigned char* const stp = base + (st - skv);
      const float* const rows = reinterpret_cast<const float*>(stp + 2 * C::HI);  // m, 1 / l, di, seg
      // S^T = K Q^T (wg 0) or dP^T = V dO^T (wg 1): B is the stage's Q or dO tile; under it, the
      // transposed A of dV^T += dO^T P (wg 0) or dK^T += Q^T dS (wg 1) from the stage's other tile
      const uint64_t d_hi = sw128_desc(st + wgi * C::Q_TILE), d_lo = d_hi + C::HI / 16;
      const unsigned char* const a_hi = stp + (1 - wgi) * C::Q_TILE;
      auto desc = [&](int kk) { return desc64<QT>(d_hi, kk); };
      auto desc_lo = [&](int kk) { return desc64<QT>(d_lo, kk); };
      if constexpr (H::HELD) {
        issue3(s, fh, fl, desc, desc_lo);
        cols_a_hd<HD>(ah, al, a_hi, a_hi + C::HI, a_off[0], warp * 16);
        hopper::wgmma_wait<0>();
        done(s, fh, fl);
      } else {
        by_atoms<RB, HD>(s, fh, fl, kv_rows, warp * 16, lane, desc, desc_lo);
        cols_a_hd<HD>(ah, al, a_hi, a_hi + C::HI, a_off[0], warp * 16);
      }
      float* const pbuf = pex + pb * (RB * QT);
      if (wgi == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = 8 * j + 2 * t4;
          const float2 mm = *reinterpret_cast<const float2*>(rows + qi);
          const float2 il = *reinterpret_cast<const float2*>(rows + QT + qi);
          const int2 sg = *reinterpret_cast<const int2*>(rows + 3 * QT + qi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool odd = e & 1;
            const float x = masked(s[j][e], scale, (e < 2 ? kseg0 : kseg1) == (odd ? sg.y : sg.x));
            s[j][e] = __fmul_rn(wg::exp_p(x - (odd ? mm.y : mm.x)), odd ? il.y : il.x);
          }
        }
        acc_to_b<RB>(pt_hi, pt_lo, s, warp * 16, lane);
        to_thread(pbuf, s, wtid);
        fence_proxy_async();
        named_sync(1, 256);  // P ready for warpgroup 1; P^T for this warpgroup's tensor cores
      } else {
        named_sync(1, 256);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(rows + 2 * QT + 8 * j + 2 * t4);
          const float4 p = reinterpret_cast<const float4*>(pbuf)[j * 128 + wtid];  // to_thread's order
          const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = __fmul_rn(__fmul_rn(__fsub_rn(s[j][e], (e & 1) ? dd.y : dd.x), pj[e]), scale);
        }
        acc_to_b<RB>(pt_hi, pt_lo, s, warp * 16, lane);
        fence_proxy_async();
        named_sync(2, 128);  // dS^T written by the whole warpgroup
      }
      // dV^T += dO^T P (wg 0) or dK^T += Q^T dS (wg 1), a 64-row half of the head dim at a time
      const uint64_t p_hi = sw128_desc(pt_hi_s), p_lo = sw128_desc(pt_lo_s);
#pragma unroll
      for (int mh = 0; mh < H::MH; ++mh) {
        if (mh > 0) cols_a_hd<HD>(ah, al, a_hi, a_hi + C::HI, a_off[mh], mh * 64 + warp * 16);
        issue3(part, ah, al, [&](int kk) { return p_hi + 2 * kk; }, [&](int kk) { return p_lo + 2 * kk; });
        hopper::wgmma_wait<0>();
        done(part, ah, al);
        add_rn(wg::cols<8>(acc, 8 * mh), part);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
      pb ^= 1;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (!H::HELD) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty);  // this warp is done with the K and V buffer
    }
    float* const out = wgi == 0 ? dV + b * vdv.sb + h * vdv.sh + (long long)k0 * vdv.sl
                                : dK + b * vdk.sb + h * vdk.sh + (long long)k0 * vdk.sl;
    const long long sl = wgi == 0 ? vdv.sl : vdk.sl;
#pragma unroll
    for (int mh = 0; mh < H::MH; ++mh)
      if (mh * 64 + warp * 16 < HD)
        store_t(out, sl, wg::cols<8>(acc, 8 * mh), mh * 64 + warp * 16, lane, hs.d);
  }
}

// ---- K13, route "tf32" ----

template <int HD> struct Dq {
  static constexpr int KEYS = Hd<HD>::KEYS;
  static constexpr uint32_t Q_TILE = RB * HD * 4;    // a block's Q (or dO) rows: 16 KB at hd 64
  static constexpr uint32_t ROWS = 4 * RB * 4;       // m, 1 / l, di, segment ids
  static constexpr uint32_t KV_TILE = KEYS * HD * 4; // a stage's K (or V) rows: 16 KB at hd 64
  static constexpr uint32_t HI = 2 * KV_TILE;        // K, V (hi after the split)
  static constexpr uint32_t STAGE = 2 * HI + 1024;   // hi, lo, key segment ids
  static constexpr uint32_t DS = RB * KEYS * 4;      // dS hi (or lo): 64 query rows x the stage's keys
  static constexpr uint32_t PEX = RB * KEYS * 4;     // P for warpgroup 1, thread-major
  static constexpr uint32_t smem = 1024 + 2 * Q_TILE + 1024 + DQ_STAGES * STAGE + 2 * DS + PEX;
};
static_assert(Dq<32>::smem <= 232448 - 1024 && Dq<64>::smem <= 232448 - 1024 && Dq<128>::smem <= 232448 - 1024,
              "K13's route tf32 must fit a block's shared memory");

template <int HD, bool COPIES>
__global__ void __launch_bounds__(384, 1)
flash_dq_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
                           int heads_inner, const int* __restrict__ qseg, const int* __restrict__ kvseg,
                           const float* __restrict__ inv_l, const float* __restrict__ m_in,
                           const float* __restrict__ di_in, float* __restrict__ dQ, View vdq, int nh, int Lq, int Lk,
                           int n_tiles, float scale, const __grid_constant__ Heads hs) {
  using C = Dq<HD>;
  using H = Hd<HD>;
  constexpr int KEYS = C::KEYS;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[DQ_STAGES], ready[DQ_STAGES], empty[DQ_STAGES], q_full, q_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;         // Q, dO: 64 rows each
  const uint32_t srows = sq + 2 * C::Q_TILE;          // m, 1 / l, di, segment ids of the 64 rows
  const uint32_t sst = srows + 1024;                  // [stage][hi: K, V][lo: K, V][key segment ids]
  const uint32_t sds = sst + DQ_STAGES * C::STAGE;    // dS hi, lo
  const uint32_t spex = sds + 2 * C::DS;              // P
  unsigned char* const base = smem_raw + (sq - raw);
  const int n_qb = Lq / RB, n_kt = Lk / KEYS;

  if (threadIdx.x == 0) {
    constexpr uint32_t fills = COPIES ? 33 : 1;  // the producer's expect_tx; with copies (Heads) also warp 8's lanes
#pragma unroll
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], fills);
      mbar_init(&ready[s], SPLIT_THREADS);
      mbar_init(&empty[s], 2 * 4);
    }
    mbar_init(&q_full, fills);
    mbar_init(&q_empty, 2 * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: thread 256's TMA loop, or with copies (Heads) warp 8's jobs, keep Q, dO, their rows and the
    // K/V ring full; warps 9-11 split each stage ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");  // its TMA loop and the split
    if (!COPIES && threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
        const long long rows0 = ((long long)b * nh + h) * Lq + qb * RB;
        mbar_wait(&q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_expect_tx(&q_full, 2 * C::Q_TILE + C::ROWS);
        tma_tile<RB, HD>(sq, &map_q, heads_inner & 1, h, qb * RB, b, &q_full);
        tma_tile<RB, HD>(sq + C::Q_TILE, &map_do, heads_inner & 8, h, qb * RB, b, &q_full);
        wg::bulk_load(srows, m_in + rows0, RB * 4, &q_full);
        wg::bulk_load(srows + RB * 4, inv_l + rows0, RB * 4, &q_full);
        wg::bulk_load(srows + 2 * RB * 4, di_in + rows0, RB * 4, &q_full);
        wg::bulk_load(srows + 3 * RB * 4, qseg + (long long)b * Lq + qb * RB, RB * 4, &q_full);
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], C::HI + KEYS * 4);
          const uint32_t st = sst + stage * C::STAGE;
          tma_tile<KEYS, HD>(st, &map_k, heads_inner & 2, h, kt * KEYS, b, &full[stage]);
          tma_tile<KEYS, HD>(st + C::KV_TILE, &map_v, heads_inner & 4, h, kt * KEYS, b, &full[stage]);
          wg::bulk_load(st + 2 * C::HI, kvseg + (long long)b * Lk + kt * KEYS, KEYS * 4, &full[stage]);
          if (++stage == DQ_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (COPIES && threadIdx.x < 288) {
      // ---- or warp 8's copies ----
      const int lane = threadIdx.x - 256;
      produce<DQ_STAGES, 1>(
          0, n_tiles, n_kt, &q_empty, empty,
          [&](int t) {  // the block's Q and dO and their rows' m, 1 / l, di and segment ids
            const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
            const long long rows0 = ((long long)b * nh + h) * Lq + qb * RB;
            if (lane == 0) {
              mbar_expect_tx(&q_full, C::ROWS);
              wg::bulk_load(srows, m_in + rows0, RB * 4, &q_full);
              wg::bulk_load(srows + RB * 4, inv_l + rows0, RB * 4, &q_full);
              wg::bulk_load(srows + 2 * RB * 4, di_in + rows0, RB * 4, &q_full);
              wg::bulk_load(srows + 3 * RB * 4, qseg + (long long)b * Lq + qb * RB, RB * 4, &q_full);
            }
            copy_tile<RB, HD>(sq, hs, 0, h, qb * RB, b, lane);
            copy_tile<RB, HD>(sq + C::Q_TILE, hs, 3, h, qb * RB, b, lane);
            copies_done(&q_full);
          },
          [&](int t, int kt, int stage) {  // a K/V stage and its key segment ids
            const int h = (t / n_qb) % nh, b = t / (n_qb * nh);
            const uint32_t st = sst + stage * C::STAGE;
            if (lane == 0) {
              mbar_expect_tx(&full[stage], KEYS * 4);
              wg::bulk_load(st + 2 * C::HI, kvseg + (long long)b * Lk + kt * KEYS, KEYS * 4, &full[stage]);
            }
            copy_tile<KEYS, HD>(st, hs, 1, h, kt * KEYS, b, lane);
            copy_tile<KEYS, HD>(st + C::KV_TILE, hs, 2, h, kt * KEYS, b, lane);
            copies_done(&full[stage]);
          });
    } else if (threadIdx.x >= 288) {
      const int si = threadIdx.x - 288;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&full[stage], phase);
          split_tiles(base + (sst - sq) + stage * C::STAGE, C::HI, C::HI, si);
          mbar_arrive(&ready[stage]);
          if (++stage == DQ_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // ---- consumers: warpgroup 0 the S side (S, P), warpgroup 1 the dP side (dP, dS); dQ^T halved between them ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wgi = threadIdx.x / 128, wtid = threadIdx.x % 128, warp = wtid / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int row = warp * 16 + g;  // this thread's query rows: row and row + 8 of the block
  const float* const rows = reinterpret_cast<const float*>(base + (srows - sq));
  unsigned char* const ds_hi = base + (sds - sq);
  unsigned char* const ds_lo = ds_hi + C::DS;
  float* const pex = reinterpret_cast<float*>(base + (spex - sq));
  const unsigned char* const q_rows = base + wgi * C::Q_TILE;  // Q (wg 0) or dO (wg 1), raw
  uint32_t a_off[H::MH][4];  // this thread's offsets in the stage's K tile for the transposed A (cols_a), by half
#pragma unroll
  for (int mh = 0; mh < H::MH; ++mh) cols_offsets<KEYS>(a_off[mh], mh * 64 + warp * 16, lane);
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
    uint32_t fh[H::AK][4], fl[H::AK][4];  // Q (wg 0) or dO (wg 1): this warp's 16 rows over the head dim (an atom)
    mbar_wait(&q_full, q_phase);
    q_phase ^= 1;
    if constexpr (H::HELD) rows_a<RB, H::AK>(fh, fl, q_rows, warp * 16, lane);
    float m_row[2], il[2], di[2];
    int seg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_row[r] = rows[row + 8 * r];
      il[r] = rows[RB + row + 8 * r];
      di[r] = rows[2 * RB + row + 8 * r];
      seg[r] = reinterpret_cast<const int*>(rows)[3 * RB + row + 8 * r];
    }
    if constexpr (H::HELD) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty);  // this warp is done with the Q, dO and rows buffer
    }
    // dQ^T (head dim x 32 query rows, by 64-row half); a stage's share; S or dP
    float acc[4 * H::MH][4], part[4][4], s[KEYS / 8][4];
    uint32_t ah[KEYS / 8][4], al[KEYS / 8][4];  // K^T of a stage
    zero(acc);
    zero(part);
    zero(s);
    for (int kt = 0; kt < n_kt; ++kt) {
      mbar_wait(&full[stage], phase);   // the key segment ids' TMA bytes
      mbar_wait(&ready[stage], phase);  // the split
      const uint32_t st = sst + stage * C::STAGE;
      unsigned char* const stp = base + (st - sq);
      // S = Q K^T (wg 0) or dP = dO V^T (wg 1): B is the stage's K or V tile; under it, the transposed A
      // of dQ^T += K^T dS^T from the stage's K tile
      const uint64_t d_hi = sw128_desc(st + wgi * C::KV_TILE), d_lo = d_hi + C::HI / 16;
      auto desc = [&](int kk) { return desc64<KEYS>(d_hi, kk); };
      auto desc_lo = [&](int kk) { return desc64<KEYS>(d_lo, kk); };
      if constexpr (H::HELD) {
        issue3(s, fh, fl, desc, desc_lo);
        cols_a_hd<HD>(ah, al, stp, stp + C::HI, a_off[0], warp * 16);
        hopper::wgmma_wait<0>();
        done(s, fh, fl);
      } else {
        by_atoms<RB, HD>(s, fh, fl, q_rows, warp * 16, lane, desc, desc_lo);
        cols_a_hd<HD>(ah, al, stp, stp + C::HI, a_off[0], warp * 16);
      }
      if (wgi == 0) {
        const int* const kseg = reinterpret_cast<const int*>(stp + 2 * C::HI);
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
          const int2 ks = *reinterpret_cast<const int2*>(kseg + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float x = masked(s[j][e], scale, seg[r] == ((e & 1) ? ks.y : ks.x));
            s[j][e] = __fmul_rn(wg::exp_p(x - m_row[r]), il[r]);
          }
        }
        to_thread(pex, s, wtid);
        named_sync(1, 256);  // P ready for warpgroup 1
      } else {
        named_sync(1, 256);
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
          const float4 p = reinterpret_cast<const float4*>(pex)[j * 128 + wtid];  // to_thread's order
          const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = __fmul_rn(__fmul_rn(__fsub_rn(s[j][e], di[e >> 1]), pj[e]), scale);
        }
        acc_to_b<RB>(ds_hi, ds_lo, s, warp * 16, lane);
        fence_proxy_async();
      }
      named_sync(2, 256);  // dS written (and P read)
      // dQ^T += K^T dS^T over this warpgroup's 32 query rows, a 64-row half of the head dim at a time
      const uint64_t dd_hi = sw128_desc(sds + wgi * 32 * 128), dd_lo = dd_hi + C::DS / 16;
#pragma unroll
      for (int mh = 0; mh < H::MH; ++mh) {
        if (mh > 0) cols_a_hd<HD>(ah, al, stp, stp + C::HI, a_off[mh], mh * 64 + warp * 16);
        issue3(part, ah, al, [&](int kk) { return desc64<RB>(dd_hi, kk); },
               [&](int kk) { return desc64<RB>(dd_lo, kk); });
        hopper::wgmma_wait<0>();
        done(part, ah, al);
        add_rn(wg::cols<4>(acc, 4 * mh), part);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (++stage == DQ_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (!H::HELD) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty);  // this warp is done with the Q, dO and rows buffer
    }
    float* const out = dQ + b * vdq.sb + h * vdq.sh + (long long)(qb * RB + wgi * 32) * vdq.sl;
#pragma unroll
    for (int mh = 0; mh < H::MH; ++mh)
      if (mh * 64 + warp * 16 < HD)
        store_t(out, vdq.sl, wg::cols<4>(acc, 4 * mh), mh * 64 + warp * 16, lane, hs.d);
  }
}

// ---- K11, route "tf32" ----
//
// A block is two consumer warpgroups of 64 query rows (128, the JAX query
// block) and the producer warpgroup, persistent over (query block, head,
// batch) tiles, a head's query blocks adjacent.  The producer's thread 256
// loads the block's Q rows once a tile and KEYS-key stages of K, V and the
// key segment ids into a ring of FWD_STAGES; its warps 9-11 split each
// stage: K in place (hi) with its lo twin, the B operand of S = Q K^T; V
// transposed into V^T hi and lo tiles (split_t), the B operand of O = P V,
// with each key at pos(key) of its 8-group, so that S's accumulator
// registers, once exponentiated and split, are P's A fragments of the same
// k-step with no shuffle.  A consumer takes its Q rows into A fragments
// once a tile (split in registers; at head dim 128 an atom at a time each
// stage) and then, a stage at a time: S = Q K^T (three TF32 products, 24
// m64n64k8 wgmmas at hd 64), the mask and the online softmax over the
// stage's keys in fp32 registers (a NaN-keeping max, ex2.approx), O's
// running sum rescaled, P split into hi and lo A fragments, P V (a fresh
// accumulator; m64nNk8 with N the head dim, two of 64 at 128), added to O
// times 1 / l.  O leaves by 8-byte stores of whole 32-byte sectors, l and m
// from the accumulator rows' first lane.  No branch splits a commit from its wait;
// the two consumer warpgroups share nothing but the ring: turns for them at
// the tensor cores (named barriers, one's softmax under the other's
// products) measured no faster (PERF.md §6).
//
// Bounds at the retriever's doc pass (68, 12, 384, 64): 4 L^2 hd flops a
// head as three TF32 products, 9.2e10 at 495 TFLOP/s, 0.187 ms, against q,
// k, v and o's 321 MB (0.096 ms).  A stage's shared-memory traffic a block:
// the split reads 32 KB and writes 64 KB; the products read 192 KB of B
// (K and V^T: lo once and hi twice for each warpgroup) against 3,072 cycles
// of tensor-core time (48 m64n64k8 TF32 wgmmas a warpgroup).

template <int HD> struct Fwd {
  static constexpr int ROWS_BLK = 2 * RB;                // query rows a block
  static constexpr int KEYS = Hd<HD>::KEYS;              // keys a stage
  static constexpr uint32_t Q_TILE = ROWS_BLK * HD * 4;  // the block's Q rows: 32 KB at hd 64
  static constexpr uint32_t KV_TILE = KEYS * HD * 4;     // a stage's K (or V, or V^T) rows: 16 KB at hd 64
  // [K hi (the raw tile split in place), K lo, V raw, V^T hi, V^T lo, key segment ids]; at hd 128 the stages'
  // segment ids after the stages, where a stage's 1 KB of them would not fit
  static constexpr uint32_t K_LO = KV_TILE, V_RAW = 2 * KV_TILE, VT_HI = 3 * KV_TILE, VT_LO = 4 * KV_TILE;
  static constexpr bool SEG_IN = HD <= 64;
  static constexpr uint32_t STAGE = 5 * KV_TILE + (SEG_IN ? 1024 : 0);
  static constexpr uint32_t SEG = Q_TILE + FWD_STAGES * STAGE;
  static constexpr uint32_t smem = 1024 + SEG + (SEG_IN ? 0 : FWD_STAGES * KEYS * 4);
  // stage s's key segment ids, bytes past the Q tile's start
  static __device__ __forceinline__ uint32_t seg(int s) {
    return SEG_IN ? Q_TILE + s * STAGE + 5 * KV_TILE : SEG + s * KEYS * 4;
  }
};
static_assert(Fwd<32>::smem <= 232448 - 1024 && Fwd<64>::smem <= 232448 - 1024 && Fwd<128>::smem <= 232448 - 1024,
              "K11's route tf32 must fit a block's shared memory");

// max(a, b), NaN if either is: the plain version's amax and maximum keep a
// NaN logit, fmaxf drops it.
__device__ __forceinline__ float max_nan(float a, float b) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(a), "f"(b));
  return y;
}

__device__ __forceinline__ float quad_max_nan(float x) {
  x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return max_nan(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// A raw KEYS-row tile of fp32 rows of HD (one a key) split into the K-major
// B tiles of its transpose, hi and lo: row h (the head dim) holds the keys,
// key k at column pos(k).  A warp takes 16 keys x two 16-byte chunks of one
// atom a turn: its reads (8 keys a quarter-warp) and its 4-byte writes (8
// swizzled chunks x 4 words) each hit distinct banks.
template <int KEYS, int HD>
__device__ __forceinline__ void split_t(const unsigned char* raw, unsigned char* t_hi, unsigned char* t_lo, int si) {
  constexpr int KG = KEYS / 16, NQ = HD / 32;  // 16-key groups; atoms of a raw row
  const int lane = si & 31;
  for (int turn = si >> 5; turn < KG * NQ * 4; turn += SPLIT_THREADS / 32) {
    const unsigned u = turn, rest = u / KG;
    const int key = (u % KG) * 16 + (lane & 15), half = rest % NQ, cg = 2 * (rest / NQ) + (lane >> 4);
    const float4 x = *reinterpret_cast<const float4*>(raw + half * (KEYS * 128) + key * 128 + (((cg ^ key) & 7) << 4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const int h0 = half * 32 + 4 * cg, col = pos(key);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t hi, lo;
      split(xs[i], hi, lo);
      const uint32_t off = at<HD>(h0 + i, col);
      *reinterpret_cast<uint32_t*>(t_hi + off) = hi;
      *reinterpret_cast<uint32_t*>(t_lo + off) = lo;
    }
  }
}

template <int HD, bool COPIES>
__global__ void __launch_bounds__(384, 1)
flash_fwd_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, int heads_inner, float* __restrict__ O,
                            View vo, const int* __restrict__ qseg, const int* __restrict__ kvseg,
                            float* __restrict__ l_out, float* __restrict__ m_out, int nh, int Lq, int Lk,
                            int n_tiles, float scale, const __grid_constant__ Heads hs) {
  using C = Fwd<HD>;
  using H = Hd<HD>;
  constexpr int KEYS = C::KEYS, NV = HD == 32 ? 4 : 8;  // NV: P V's N a wgmma, in 8-column groups
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[FWD_STAGES], ready[FWD_STAGES], empty[FWD_STAGES], q_full, q_empty;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // Q: 128 rows
  const uint32_t sst = sq + C::Q_TILE;          // [stage][C's tiles]
  unsigned char* const base = smem_raw + (sq - raw);
  const int n_qb = Lq / C::ROWS_BLK, n_kt = Lk / KEYS;

  if (threadIdx.x == 0) {
    constexpr uint32_t fills = COPIES ? 33 : 1;  // the producer's expect_tx; with copies (Heads) also warp 8's lanes
#pragma unroll
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&full[s], fills);
      mbar_init(&ready[s], SPLIT_THREADS);
      mbar_init(&empty[s], 2 * 4);
    }
    mbar_init(&q_full, fills);
    mbar_init(&q_empty, 2 * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: thread 256's TMA loop (below hd 128) or warp 8's jobs (produce: its lane 0 issuing TMA at
    // hd 128, or with copies the whole warp) keep Q and the K/V ring full; warps 9-11 split.  At hd 128 the
    // consumers take 232 registers (at 224 they spilled) and the producer's 40 hold warp 8's jobs, where the
    // one thread's loop spilled ----
    constexpr bool LOOP = !COPIES && HD != 128;
    if constexpr (HD == 128)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (LOOP && threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
        mbar_wait(&q_empty, q_phase ^ 1);
        q_phase ^= 1;
        mbar_expect_tx(&q_full, C::Q_TILE);
        tma_tile<C::ROWS_BLK, HD>(sq, &map_q, heads_inner & 1, h, qb * C::ROWS_BLK, b, &q_full);
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * C::KV_TILE + KEYS * 4);
          const uint32_t st = sst + stage * C::STAGE;
          tma_tile<KEYS, HD>(st, &map_k, heads_inner & 2, h, kt * KEYS, b, &full[stage]);
          tma_tile<KEYS, HD>(st + C::V_RAW, &map_v, heads_inner & 4, h, kt * KEYS, b, &full[stage]);
          wg::bulk_load(sq + C::seg(stage), kvseg + (long long)b * Lk + kt * KEYS, KEYS * 4, &full[stage]);
          if (++stage == FWD_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (!LOOP && threadIdx.x < 288) {
      // ---- or warp 8: its lane 0 issuing TMA (hd 128), or with copies the whole warp ----
      const int lane = threadIdx.x - 256;
      produce<FWD_STAGES, 1>(
          0, n_tiles, n_kt, &q_empty, empty,
          [&](int t) {  // the block's Q
            const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
            if (lane == 0) mbar_expect_tx(&q_full, COPIES ? 0 : C::Q_TILE);
            if constexpr (COPIES) {
              copy_tile<C::ROWS_BLK, HD>(sq, hs, 0, h, qb * C::ROWS_BLK, b, lane);
              copies_done(&q_full);
            } else if (lane == 0) {
              tma_tile<C::ROWS_BLK, HD>(sq, &map_q, heads_inner & 1, h, qb * C::ROWS_BLK, b, &q_full);
            }
          },
          [&](int t, int kt, int stage) {  // a K/V stage and its key segment ids
            const int h = (t / n_qb) % nh, b = t / (n_qb * nh);
            const uint32_t st = sst + stage * C::STAGE;
            if (lane == 0) {
              mbar_expect_tx(&full[stage], (COPIES ? 0 : 2 * C::KV_TILE) + KEYS * 4);
              if constexpr (!COPIES) {
                tma_tile<KEYS, HD>(st, &map_k, heads_inner & 2, h, kt * KEYS, b, &full[stage]);
                tma_tile<KEYS, HD>(st + C::V_RAW, &map_v, heads_inner & 4, h, kt * KEYS, b, &full[stage]);
              }
              wg::bulk_load(sq + C::seg(stage), kvseg + (long long)b * Lk + kt * KEYS, KEYS * 4, &full[stage]);
            }
            if constexpr (COPIES) {
              copy_tile<KEYS, HD>(st, hs, 1, h, kt * KEYS, b, lane);
              copy_tile<KEYS, HD>(st + C::V_RAW, hs, 2, h, kt * KEYS, b, lane);
              copies_done(&full[stage]);
            }
          });
    } else if (threadIdx.x >= 288) {
      const int si = threadIdx.x - 288;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
        for (int kt = 0; kt < n_kt; ++kt) {
          mbar_wait(&full[stage], phase);
          unsigned char* const stp = base + C::Q_TILE + stage * C::STAGE;
          split_t<KEYS, HD>(stp + C::V_RAW, stp + C::VT_HI, stp + C::VT_LO, si);
          split_tiles(stp, C::KV_TILE, C::K_LO, si);  // K, then the fence for both
          mbar_arrive(&ready[stage]);
          if (++stage == FWD_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  if constexpr (HD == 128)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int wgi = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wgi * 64 + warp * 16;  // this warp's first row of the block: the thread's rows r0 + g and + 8
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int qb = t % n_qb, h = (t / n_qb) % nh, b = t / (n_qb * nh);
    const int row = qb * C::ROWS_BLK + r0 + g;  // the thread's first query row
    const int seg0 = qseg[(long long)b * Lq + row], seg1 = qseg[(long long)b * Lq + row + 8];
    uint32_t fh[H::AK][4], fl[H::AK][4];  // this warp's 16 Q rows over the head dim (an atom)
    mbar_wait(&q_full, q_phase);
    q_phase ^= 1;
    if constexpr (H::HELD) {
      rows_a<C::ROWS_BLK, H::AK>(fh, fl, base, r0, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty);  // this warp is done with the Q buffer
    }
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
    float acc[HD / 8][4], s[KEYS / 8][4], pv[HD / 8][4];  // O (rows x head dim); S, then P; the stage's P V
    zero(acc);
    zero(s);
    zero(pv);
    for (int kt = 0; kt < n_kt; ++kt) {
      mbar_wait(&full[stage], phase);   // the key segment ids' TMA bytes
      mbar_wait(&ready[stage], phase);  // the split
      const uint32_t st = sst + stage * C::STAGE;
      const int* const kseg = reinterpret_cast<const int*>(base + C::seg(stage));
      // S = Q K^T: B the stage's split K tile
      const uint64_t dk = sw128_desc(st), dk_lo = dk + C::K_LO / 16;
      auto desc = [&](int kk) { return desc64<KEYS>(dk, kk); };
      auto desc_lo = [&](int kk) { return desc64<KEYS>(dk_lo, kk); };
      if constexpr (H::HELD) {
        issue3(s, fh, fl, desc, desc_lo);
        hopper::wgmma_wait<0>();
        done(s, fh, fl);
      } else {
        by_atoms<C::ROWS_BLK, HD>(s, fh, fl, base, r0, lane, desc, desc_lo);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        const int2 ks = *reinterpret_cast<const int2*>(kseg + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = masked(s[j][e], scale, (e < 2 ? seg0 : seg1) == ((e & 1) ? ks.y : ks.x));
          mx[e >> 1] = max_nan(mx[e >> 1], s[j][e]);
        }
      }
      float m_next[2], sum[2] = {0.0f, 0.0f}, inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) m_next[r] = max_nan(m_run[r], quad_max_nan(mx[r]));
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = wg::exp_p(s[j][e] - m_next[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_corr = __fmul_rn(wg::exp_p(m_run[r] - m_next[r]), l_run[r]);
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
      // P's A fragments: accumulator columns 8kk + 2t and + 1 are A columns t and t + 4 (V^T's pos())
      uint32_t ph[KEYS / 8][4], pl[KEYS / 8][4];
#pragma unroll
      for (int kk = 0; kk < KEYS / 8; ++kk) {
        split(s[kk][0], ph[kk][0], pl[kk][0]);
        split(s[kk][2], ph[kk][1], pl[kk][1]);
        split(s[kk][1], ph[kk][2], pl[kk][2]);
        split(s[kk][3], ph[kk][3], pl[kk][3]);
      }
      // P V: B the stage's split V^T tile, a wgmma a 64-row half of the head dim at 128
      const uint64_t dv = sw128_desc(st + C::VT_HI), dv_lo = dv + (C::VT_LO - C::VT_HI) / 16;
#pragma unroll
      for (int n = 0; n < HD / (8 * NV); ++n) {
        const uint64_t dn = dv + n * (64 * 128 / 16), dn_lo = dv_lo + n * (64 * 128 / 16);
        issue3(wg::cols<NV>(pv, n * NV), ph, pl, [&](int kk) { return desc64<HD>(dn, kk); },
               [&](int kk) { return desc64<HD>(dn_lo, kk); });
      }
      hopper::wgmma_wait<0>();
      done(pv, ph, pl);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the stage
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = __fadd_rn(acc[j][e], __fmul_rn(pv[j][e], inv[e >> 1]));
      if (++stage == FWD_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (!H::HELD) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty);  // this warp is done with the Q buffer
    }
    float* const out = O + b * vo.sb + h * vo.sh + (long long)row * vo.sl;
    if (hs.d == HD) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<float2*>(out + 8 * j + 2 * t4) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(out + 8 * vo.sl + 8 * j + 2 * t4) = make_float2(acc[j][2], acc[j][3]);
      }
    } else {  // below the template: the columns below d, 4 bytes a store
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t4 + (e & 1) < hs.d) out[8 * vo.sl * (e >> 1) + 8 * j + 2 * t4 + (e & 1)] = acc[j][e];
    }
    if (t4 == 0) {
      const long long i = ((long long)b * nh + h) * Lq + row;
      l_out[i] = l_run[0];
      l_out[i + 8] = l_run[1];
      m_out[i] = m_run[0];
      m_out[i + 8] = m_run[1];
    }
  }
}

}  // namespace tf
View view(const long long* s) { return View{s[0], s[1], s[2]}; }

bool aligned(const void* p, const long long* s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s[0] % 8 == 0 && s[1] % 8 == 0 && s[2] % 8 == 0;
}

// The template a head dim runs on (routes "wgmma", "tf32" and the rows
// kernel): the least of 32, 64 and 128 that holds it; 0 below 1 and past 128
// (the JAX kernel's multiples of 128 above it wait for ROADMAP Queue 1 step 12).
int head_dim_template(int hd) { return hd < 1 || hd > 128 ? 0 : hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }

// How routes "wgmma" and "tf32" read the `n` inputs of `ptrs` (q, k, v, do)
// with (batch, head, row) strides `views`, head dim d, eb bytes an element:
// by the tensor maps (w 0) where every address and every stride in bytes (of
// a dim longer than 1) is a multiple of 16 and `maps` holds, else by the
// producer's copies of the largest power of two that divides them all (16
// where `maps` alone fails).
Heads heads_of(const void* const* ptrs, const long long* const* views, int n, int d, int eb, int B, int nh,
               bool maps = true) {
  Heads hs{};
  uint64_t bits = 16;
  for (int i = 0; i < n; ++i) {
    hs.p[i] = static_cast<const unsigned char*>(ptrs[i]);
    hs.v[i] = view(views[i]);
    bits |= uint64_t(reinterpret_cast<uintptr_t>(ptrs[i])) | uint64_t(views[i][2] * eb);
    if (B > 1) bits |= uint64_t(views[i][0] * eb);
    if (nh > 1) bits |= uint64_t(views[i][1] * eb);
  }
  const int w = int(bits & (~bits + 1));  // the lowest bit set
  hs.d = d;
  hs.w = w == 16 ? (maps ? 0 : 16) : w;
  return hs;
}

// Route "wgmma"'s tensor-map launches store whole 16-byte chunks of the
// outputs: d a multiple of 8 and each output's rows 16-byte aligned.
bool whole_chunks(int d, std::initializer_list<std::pair<const void*, const long long*>> outs) {
  for (const auto& x : outs)
    if (!aligned(x.first, x.second)) return false;
  return d % 8 == 0;
}

// An output the kernels may store: rows 16-byte aligned at the template's
// own head dim (whole-row stores), any element-aligned layout below it.
bool out_ok(const void* p, const long long* s, int hd, int eb) {
  return hd == head_dim_template(hd) ? aligned(p, s) : reinterpret_cast<uintptr_t>(p) % eb == 0;
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

// 0 if the shape is one the kernels take (routes "wgmma", "tf32", the rows
// kernel: head dims 1-128; route "simple": HD alone, check_route), else
// cudaErrorInvalidValue.
int check_shape(int B, int nh, int Lq, int Lk, int hd, int dtype, int device) {
  if (B < 1 || nh < 1 || B > 65535 || nh > 65535 || dtype < 0 || dtype > 2 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  if (head_dim_template(hd) == 0) return (int)cudaErrorInvalidValue;
  if (Lq < FWD_TILE || Lk < FWD_TILE || Lq % FWD_TILE || Lk % FWD_TILE) return (int)cudaErrorInvalidValue;
  return 0;
}

// `f` with the template the head dim runs on as a template argument: f(std::integral_constant<int, 32>()) ...
template <typename F>
int by_head_dim(int hd, F f) {
  switch (head_dim_template(hd)) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
  }
  return (int)cudaErrorInvalidValue;
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


// A (B, nh, L, hd) view with (batch, head, row) strides `s` in elements as a
// 4-D tensor map cut into boxes of one swizzle row of the template `tile_hd`
// (bf16 or fp16: 64 elements, 128 bytes, or at template 32 the row's 32, 64
// bytes; fp32: 32, 128 bytes) x `box_rows` rows with the 128-byte (64-byte)
// swizzle; a row is tile_hd / (the box's elements) boxes, the columns from hd
// on zeros (out of bounds).  Its dims run (hd, nh, L, B) when a head's
// rows lie further apart than its heads do (the models' layout: heads-major
// views of (B, L, nh, hd)), else (hd, L, nh, B); `heads_inner` says which.
// A dim of extent 1 takes the largest stride, so that it sorts outside.
bool make_rows_map(CUtensorMap* map, const void* ptr, int dtype, int B, int nh, int L, int hd, int tile_hd,
                   const long long* s, uint32_t box_rows, bool* heads_inner) {
  hopper::EncodeTiledFn enc = hopper::encode_tiled();
  if (enc == nullptr) return false;
  long long sb = s[0], sh = s[1];
  const long long sl = s[2];
  const long long big = std::max(std::max(sb, sh), std::max(sl, (long long)hd));
  if (nh == 1) sh = big;
  if (B == 1) sb = big;
  const bool hi = sh < sl;
  *heads_inner = hi;
  const int eb = dtype == 2 ? 4 : 2;                         // bytes an element
  const uint32_t span = (dtype != 2 && tile_hd == 32) ? 64 : 128;  // bytes a box row: wg::Tile::SPAN, or fp32's 128
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(hi ? nh : L), cuuint64_t(hi ? L : nh), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(eb * (hi ? sh : sl)), cuuint64_t(eb * (hi ? sl : sh)),
                                 cuuint64_t(eb * sb)};
  const cuuint32_t box[4] = {cuuint32_t(span / eb), hi ? 1u : box_rows, hi ? box_rows : 1u, 1u};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  return enc(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
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

// A persistent grid: the SMs, or fewer tiles; 0 past INT32_MAX tiles.
int persistent_grid(long long tiles, int device, int* grid) {
  int sms = 0;
  if (int e = sm_count(device, &sms)) return e;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  *grid = int(tiles < sms ? tiles : sms);
  return 0;
}

template <typename T, int HD, int NWG>
int fwd_wgmma(const void* q, const void* k, const void* v, void* o, const int* qseg, const int* kvseg, float* l,
              float* m, const long long* vq, const long long* vk, const long long* vv, const long long* vo, int B,
              int nh, int Lq, int Lk, int hd, float scale, int dtype, int device, cudaStream_t stream) {
  using C = wg::Fwd<HD, NWG>;
  static std::atomic<bool> smem_set[2][kMaxDevices];  // by instantiation: COPIES false, true
  const void* ptrs[] = {q, k, v};
  const long long* views[] = {vq, vk, vv};
  const Heads hs = heads_of(ptrs, views, 3, hd, 2, B, nh, whole_chunks(hd, {{o, vo}}));
  CUtensorMap mq{}, mk{}, mv{};
  bool hq = false, hk = false, hv = false;
  if (hs.w == 0 && (!make_rows_map(&mq, q, dtype, B, nh, Lq, hd, HD, vq, C::ROWS_BLK, &hq) ||
                    !make_rows_map(&mk, k, dtype, B, nh, Lk, hd, HD, vk, wg::KT, &hk) ||
                    !make_rows_map(&mv, v, dtype, B, nh, Lk, hd, HD, vv, wg::KT, &hv)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(Lq / C::ROWS_BLK) * nh * B;
  int grid = 0;
  if (int e = persistent_grid(tiles, device, &grid)) return e;
  auto launch = [&](auto kernel, std::atomic<bool>* done) {
    const cudaError_t err = allow_smem(kernel, (int)C::smem, device, done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, (NWG + 1) * 128, C::smem, stream>>>(
        mq, mk, mv, int(hq) | int(hk) << 1 | int(hv) << 2, static_cast<T*>(o), view(vo), qseg, kvseg, l, m, nh, Lq, Lk,
        int(tiles), scale, hs);
    return (int)cudaGetLastError();
  };
  return hs.w ? launch(wg::flash_fwd_wgmma_kernel<T, HD, NWG, true>, smem_set[1])
                : launch(wg::flash_fwd_wgmma_kernel<T, HD, NWG, false>, smem_set[0]);
}

template <typename T, int HD>
int dkv_wgmma(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg, const float* inv_l,
              const float* m, const void* dout, const float* di, void* dk, void* dv, const long long* vq,
              const long long* vk, const long long* vv, const long long* vdo, const long long* vdk,
              const long long* vdv, int B, int nh, int Lq, int Lk, int hd, float scale, int dtype, int device,
              cudaStream_t stream) {
  using C = wg::Dkv<HD>;
  static std::atomic<bool> smem_set[2][kMaxDevices];  // by instantiation: COPIES false, true
  const void* ptrs[] = {q, k, v, dout};
  const long long* views[] = {vq, vk, vv, vdo};
  const Heads hs = heads_of(ptrs, views, 4, hd, 2, B, nh, whole_chunks(hd, {{dk, vdk}, {dv, vdv}}));
  CUtensorMap mq{}, mk{}, mv{}, mo{};
  bool hq = false, hk = false, hv = false, ho = false;
  if (hs.w == 0 && (!make_rows_map(&mq, q, dtype, B, nh, Lq, hd, HD, vq, C::QT, &hq) ||
                    !make_rows_map(&mk, k, dtype, B, nh, Lk, hd, HD, vk, wg::KT, &hk) ||
                    !make_rows_map(&mv, v, dtype, B, nh, Lk, hd, HD, vv, wg::KT, &hv) ||
                    !make_rows_map(&mo, dout, dtype, B, nh, Lq, hd, HD, vdo, C::QT, &ho)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(Lk / wg::KT) * nh * B;
  int grid = 0;
  if (int e = persistent_grid(tiles, device, &grid)) return e;
  auto launch = [&](auto kernel, std::atomic<bool>* done) {
    const cudaError_t err = allow_smem(kernel, (int)C::smem, device, done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, 384, C::smem, stream>>>(
        mq, mk, mv, mo, int(hq) | int(hk) << 1 | int(hv) << 2 | int(ho) << 3, qseg, kvseg, inv_l, m, di,
        static_cast<T*>(dk), static_cast<T*>(dv), view(vdk), view(vdv), nh, Lq, Lk, int(tiles), scale, hs);
    return (int)cudaGetLastError();
  };
  return hs.w ? launch(wg::flash_dkv_wgmma_kernel<T, HD, true>, smem_set[1])
                : launch(wg::flash_dkv_wgmma_kernel<T, HD, false>, smem_set[0]);
}

template <typename T, int HD>
int dq_wgmma(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg, const float* inv_l,
             const float* m, const void* dout, const float* di, void* dq_, const long long* vq, const long long* vk,
             const long long* vv, const long long* vdo, const long long* vdq, int B, int nh, int Lq, int Lk, int hd,
             float scale, int dtype, int device, cudaStream_t stream) {
  using C = wg::Dq<HD>;
  static std::atomic<bool> smem_set[2][kMaxDevices];  // by instantiation: COPIES false, true
  const void* ptrs[] = {q, k, v, dout};
  const long long* views[] = {vq, vk, vv, vdo};
  const Heads hs = heads_of(ptrs, views, 4, hd, 2, B, nh, whole_chunks(hd, {{dq_, vdq}}));
  CUtensorMap mq{}, mk{}, mv{}, mo{};
  bool hq = false, hk = false, hv = false, ho = false;
  if (hs.w == 0 && (!make_rows_map(&mq, q, dtype, B, nh, Lq, hd, HD, vq, C::ROWS_BLK, &hq) ||
                    !make_rows_map(&mk, k, dtype, B, nh, Lk, hd, HD, vk, C::KT, &hk) ||
                    !make_rows_map(&mv, v, dtype, B, nh, Lk, hd, HD, vv, C::KT, &hv) ||
                    !make_rows_map(&mo, dout, dtype, B, nh, Lq, hd, HD, vdo, C::ROWS_BLK, &ho)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(Lq / C::ROWS_BLK) * nh * B;
  int grid = 0;
  if (int e = persistent_grid(tiles, device, &grid)) return e;
  auto launch = [&](auto kernel, std::atomic<bool>* done) {
    const cudaError_t err = allow_smem(kernel, (int)C::smem, device, done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, (C::NWG + 1) * 128, C::smem, stream>>>(
        mq, mk, mv, mo, int(hq) | int(hk) << 1 | int(hv) << 2 | int(ho) << 3, qseg, kvseg, inv_l, m, di,
        static_cast<T*>(dq_), view(vdq), nh, Lq, Lk, int(tiles), scale, hs);
    return (int)cudaGetLastError();
  };
  return hs.w ? launch(wg::flash_dq_wgmma_kernel<T, HD, true>, smem_set[1])
                : launch(wg::flash_dq_wgmma_kernel<T, HD, false>, smem_set[0]);
}

// Rows read by 16-byte loads (`vec`) at the template's own head dim where o's
// and do's rows are 16-byte aligned; else element by element.
int rows_vec(const void* o, const void* dout, const long long* vo, const long long* vdo, int hd) {
  return hd == head_dim_template(hd) && aligned(o, vo) && aligned(dout, vdo);
}

template <typename T, int HD>
int rows(const void* o, const void* dout, const float* l, float* di, float* inv_l, const long long* vo,
         const long long* vdo, int B, int nh, int L, int hd, cudaStream_t stream) {
  const long long n = (long long)B * nh * L;  // a multiple of 128: L is
  constexpr int per_block = 256 / (HD / 8);   // rows a block
  if (n / per_block > INT32_MAX) return (int)cudaErrorInvalidValue;
  wg::flash_rows_kernel<T, HD><<<int(n / per_block), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), l, view(vo), view(vdo), di, inv_l, nh, L, hd,
      rows_vec(o, dout, vo, vdo, hd));
  return (int)cudaGetLastError();
}

// ---- route "fp32" launches (the rows kernel) ----

template <int HD>
int rows_fp32(const void* o, const void* dout, const float* l, float* di, float* inv_l, const long long* vo,
              const long long* vdo, int B, int nh, int L, int hd, cudaStream_t stream) {
  const long long n = (long long)B * nh * L;  // a multiple of 128: L is
  constexpr int per_block = 256 / (HD / 8);
  if (n / per_block > INT32_MAX) return (int)cudaErrorInvalidValue;
  f32::flash_rows_kernel<HD><<<int(n / per_block), 256, 0, stream>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), l, view(vo), view(vdo), di, inv_l, nh, L, hd,
      rows_vec(o, dout, vo, vdo, hd));
  return (int)cudaGetLastError();
}

// ---- route "tf32" launches (K11, K12, K13) ----

template <int HD>
int fwd_tf32(const void* q, const void* k, const void* v, void* o, const int* qseg, const int* kvseg, float* l,
             float* m, const long long* vq, const long long* vk, const long long* vv, const long long* vo, int B,
             int nh, int Lq, int Lk, int hd, float scale, int device, cudaStream_t stream) {
  using C = tf::Fwd<HD>;
  static std::atomic<bool> smem_set[2][kMaxDevices];  // by instantiation: COPIES false, true
  const void* ptrs[] = {q, k, v};
  const long long* views[] = {vq, vk, vv};
  const Heads hs = heads_of(ptrs, views, 3, hd, 4, B, nh);
  CUtensorMap mq{}, mk{}, mv{};
  bool hq = false, hk = false, hv = false;
  if (hs.w == 0 && (!make_rows_map(&mq, q, 2, B, nh, Lq, hd, HD, vq, C::ROWS_BLK, &hq) ||
                    !make_rows_map(&mk, k, 2, B, nh, Lk, hd, HD, vk, C::KEYS, &hk) ||
                    !make_rows_map(&mv, v, 2, B, nh, Lk, hd, HD, vv, C::KEYS, &hv)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(Lq / C::ROWS_BLK) * nh * B;
  int grid = 0;
  if (int e = persistent_grid(tiles, device, &grid)) return e;
  auto launch = [&](auto kernel, std::atomic<bool>* done) {
    const cudaError_t err = allow_smem(kernel, (int)C::smem, device, done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, 384, C::smem, stream>>>(
        mq, mk, mv, int(hq) | int(hk) << 1 | int(hv) << 2, static_cast<float*>(o), view(vo), qseg, kvseg, l, m, nh, Lq,
        Lk, int(tiles), scale, hs);
    return (int)cudaGetLastError();
  };
  return hs.w ? launch(tf::flash_fwd_tf32_wgmma_kernel<HD, true>, smem_set[1])
                : launch(tf::flash_fwd_tf32_wgmma_kernel<HD, false>, smem_set[0]);
}

template <int HD>
int dkv_tf32(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg, const float* inv_l,
             const float* m, const void* dout, const float* di, void* dk, void* dv, const long long* vq,
             const long long* vk, const long long* vv, const long long* vdo, const long long* vdk,
             const long long* vdv, int B, int nh, int Lq, int Lk, int hd, float scale, int device,
             cudaStream_t stream) {
  using C = tf::Dkv<HD>;
  static std::atomic<bool> smem_set[2][kMaxDevices];  // by instantiation: COPIES false, true
  const void* ptrs[] = {q, k, v, dout};
  const long long* views[] = {vq, vk, vv, vdo};
  const Heads hs = heads_of(ptrs, views, 4, hd, 4, B, nh);
  CUtensorMap mq{}, mk{}, mv{}, mo{};
  bool hq = false, hk = false, hv = false, ho = false;
  if (hs.w == 0 && (!make_rows_map(&mq, q, 2, B, nh, Lq, hd, HD, vq, tf::QT, &hq) ||
                    !make_rows_map(&mk, k, 2, B, nh, Lk, hd, HD, vk, tf::RB, &hk) ||
                    !make_rows_map(&mv, v, 2, B, nh, Lk, hd, HD, vv, tf::RB, &hv) ||
                    !make_rows_map(&mo, dout, 2, B, nh, Lq, hd, HD, vdo, tf::QT, &ho)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(Lk / tf::RB) * nh * B;
  int grid = 0;
  if (int e = persistent_grid(tiles, device, &grid)) return e;
  auto launch = [&](auto kernel, std::atomic<bool>* done) {
    const cudaError_t err = allow_smem(kernel, (int)C::smem, device, done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, 384, C::smem, stream>>>(
        mq, mk, mv, mo, int(hq) | int(hk) << 1 | int(hv) << 2 | int(ho) << 3, qseg, kvseg, inv_l, m, di,
        static_cast<float*>(dk), static_cast<float*>(dv), view(vdk), view(vdv), nh, Lq, Lk, int(tiles), scale, hs);
    return (int)cudaGetLastError();
  };
  return hs.w ? launch(tf::flash_dkv_tf32_wgmma_kernel<HD, true>, smem_set[1])
                : launch(tf::flash_dkv_tf32_wgmma_kernel<HD, false>, smem_set[0]);
}

template <int HD>
int dq_tf32(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg, const float* inv_l,
            const float* m, const void* dout, const float* di, void* dq_, const long long* vq, const long long* vk,
            const long long* vv, const long long* vdo, const long long* vdq, int B, int nh, int Lq, int Lk, int hd,
            float scale, int device, cudaStream_t stream) {
  using C = tf::Dq<HD>;
  static std::atomic<bool> smem_set[2][kMaxDevices];  // by instantiation: COPIES false, true
  const void* ptrs[] = {q, k, v, dout};
  const long long* views[] = {vq, vk, vv, vdo};
  const Heads hs = heads_of(ptrs, views, 4, hd, 4, B, nh);
  CUtensorMap mq{}, mk{}, mv{}, mo{};
  bool hq = false, hk = false, hv = false, ho = false;
  if (hs.w == 0 && (!make_rows_map(&mq, q, 2, B, nh, Lq, hd, HD, vq, tf::RB, &hq) ||
                    !make_rows_map(&mk, k, 2, B, nh, Lk, hd, HD, vk, C::KEYS, &hk) ||
                    !make_rows_map(&mv, v, 2, B, nh, Lk, hd, HD, vv, C::KEYS, &hv) ||
                    !make_rows_map(&mo, dout, 2, B, nh, Lq, hd, HD, vdo, tf::RB, &ho)))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)(Lq / tf::RB) * nh * B;
  int grid = 0;
  if (int e = persistent_grid(tiles, device, &grid)) return e;
  auto launch = [&](auto kernel, std::atomic<bool>* done) {
    const cudaError_t err = allow_smem(kernel, (int)C::smem, device, done);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, 384, C::smem, stream>>>(
        mq, mk, mv, mo, int(hq) | int(hk) << 1 | int(hv) << 2 | int(ho) << 3, qseg, kvseg, inv_l, m, di,
        static_cast<float*>(dq_), view(vdq), nh, Lq, Lk, int(tiles), scale, hs);
    return (int)cudaGetLastError();
  };
  return hs.w ? launch(tf::flash_dq_tf32_wgmma_kernel<HD, true>, smem_set[1])
                : launch(tf::flash_dq_tf32_wgmma_kernel<HD, false>, smem_set[0]);
}

// 0 if `route` is one the dtype and head dim take: routes 0 ("simple", head
// dim HD only) and 1 ("wgmma") for bf16 and fp16; route 3 ("tf32") for
// fp32, in K11, K12 and K13 alike.
int check_route(int dtype, int route, int hd) {
  const bool ok = dtype == 2 ? route == 3 : (route == 1 || (route == 0 && hd == HD));
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// The inputs a launch takes: route "simple" 16-byte aligned rows (its
// cp.async copies whole chunks); the others any element-aligned layout
// (heads_of picks how they are read).
bool inputs_ok(int route, int dtype, std::initializer_list<std::pair<const void*, const long long*>> xs) {
  for (const auto& x : xs)
    if (route == 0 ? !aligned(x.first, x.second) : reinterpret_cast<uintptr_t>(x.first) % (dtype == 2 ? 4 : 2) != 0)
      return false;
  return true;
}

}  // namespace

// The template a head dim runs on, for the wrapper's check of its own rule
// (ops/flash_attention.py::template_head_dim): the least of 32, 64 and 128
// that holds hd, or 0 where the kernels refuse hd (below 1, past 128).
extern "C" int flash_head_dim_template(int hd) { return head_dim_template(hd); }

// K11.  q (B, nh, Lq, hd), k and v (B, nh, Lk, hd), o like q, each with its
// (batch, head, row) strides in elements (`vq`..`vo`, three each), unit
// stride along the head dim; o's rows 16-byte aligned at hd 32, 64 and 128;
// segment ids (B, Lq) and (B, Lk) int32, l and m (B, nh, Lq) fp32, all
// contiguous and 16-byte aligned; Lq and Lk multiples of 128; hd 1-128;
// dtype 0 bf16, 1 fp16, 2 fp32; route 1 "wgmma", 0 "simple" (the first
// design, hd 64 only, rows 16-byte aligned) for bf16 and fp16, 3 "tf32" for
// fp32.  `device` is the tensors' card: made current for the launch if it is
// not, and the caller's restored after.  Returns a cudaError_t (0 on success,
// cudaErrorInvalidValue for a shape or layout it does not take).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, const int* qseg,
                                const int* kvseg, float* l, float* m, const long long* vq, const long long* vk,
                                const long long* vv, const long long* vo, int B, int nh, int Lq, int Lk, int hd,
                                float scale, int dtype, int route, int device, void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, hd, dtype, device)) return e;
  if (int e = check_route(dtype, route, hd)) return e;
  if (!inputs_ok(route, dtype, {{q, vq}, {k, vk}, {v, vv}}) || !out_ok(o, vo, hd, dtype == 2 ? 4 : 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (route == 0)
      return dtype == 0 ? fwd<__nv_bfloat16>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, scale,
                                             device, s)
                        : fwd<__half>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, scale, device, s);
    return by_head_dim(hd, [&](auto h) {
      constexpr int D = decltype(h)::value;
      if (route == 3)
        return fwd_tf32<D>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk, hd, scale, device, s);
      // 192-row blocks where they tile Lq and the head dim leaves three consumer warpgroups their registers, else 128
      if constexpr (D <= 64) {
        if (Lq % wg::Fwd<D, 3>::ROWS_BLK == 0)
          return dtype == 0 ? fwd_wgmma<__nv_bfloat16, D, 3>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh,
                                                             Lq, Lk, hd, scale, dtype, device, s)
                            : fwd_wgmma<__half, D, 3>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk,
                                                      hd, scale, dtype, device, s);
      }
      return dtype == 0 ? fwd_wgmma<__nv_bfloat16, D, 2>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq,
                                                         Lk, hd, scale, dtype, device, s)
                        : fwd_wgmma<__half, D, 2>(q, k, v, o, qseg, kvseg, l, m, vq, vk, vv, vo, B, nh, Lq, Lk,
                                                  hd, scale, dtype, device, s);
    });
  });
}

// K12: dk and dv (like k and v) from q, k, v, do (like q), m and di (B, nh,
// Lq) fp32, and l (route "simple") or 1 / l (routes "wgmma" and "tf32",
// from flash_bwd_rows_launch) likewise; the one the route does not read may
// be null.  Route 3 "tf32" (three TF32 products on wgmma) for fp32, 1
// "wgmma" or 0 "simple" (hd 64 only) for bf16 and fp16.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg,
                                    const float* l, const float* inv_l, const float* m, const void* dout,
                                    const float* di, void* dk, void* dv, const long long* vq, const long long* vk,
                                    const long long* vv, const long long* vdo, const long long* vdk,
                                    const long long* vdv, int B, int nh, int Lq, int Lk, int hd, float scale,
                                    int dtype, int route, int device, void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, hd, dtype, device)) return e;
  if (int e = check_route(dtype, route, hd)) return e;
  const int eb = dtype == 2 ? 4 : 2;
  if (!inputs_ok(route, dtype, {{q, vq}, {k, vk}, {v, vv}, {dout, vdo}}) || !out_ok(dk, vdk, hd, eb) ||
      !out_ok(dv, vdv, hd, eb) || (route != 0 && inv_l == nullptr) || (route == 0 && l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (route == 0)
      return dtype == 0 ? dkv<__nv_bfloat16>(q, k, v, qseg, kvseg, l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk,
                                             vdv, B, nh, Lq, Lk, scale, device, s)
                        : dkv<__half>(q, k, v, qseg, kvseg, l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk, vdv, B,
                                      nh, Lq, Lk, scale, device, s);
    return by_head_dim(hd, [&](auto h) {
      constexpr int D = decltype(h)::value;
      if (route == 3)
        return dkv_tf32<D>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk, vdv, B, nh, Lq,
                           Lk, hd, scale, device, s);
      return dtype == 0 ? dkv_wgmma<__nv_bfloat16, D>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dk, dv, vq, vk, vv,
                                                      vdo, vdk, vdv, B, nh, Lq, Lk, hd, scale, dtype, device, s)
                        : dkv_wgmma<__half, D>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dk, dv, vq, vk, vv, vdo, vdk,
                                               vdv, B, nh, Lq, Lk, hd, scale, dtype, device, s);
    });
  });
}

// The backward's per-row inputs on the card: di = sum(o * do) over the head
// dim and 1 / l, (B, nh, L) fp32 contiguous, from o and do (B, nh, L, hd)
// views as K11 takes them and l (B, nh, L) fp32 contiguous.
extern "C" int flash_bwd_rows_launch(const void* o, const void* dout, const float* l, float* di, float* inv_l,
                                     const long long* vo, const long long* vdo, int B, int nh, int L, int hd,
                                     int dtype, int device, void* stream) {
  if (int e = check_shape(B, nh, L, L, hd, dtype, device)) return e;
  if (!inputs_ok(1, dtype, {{o, vo}, {dout, vdo}})) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return by_head_dim(hd, [&](auto h) {
      constexpr int D = decltype(h)::value;
      if (dtype == 2) return rows_fp32<D>(o, dout, l, di, inv_l, vo, vdo, B, nh, L, hd, s);
      return dtype == 0 ? rows<__nv_bfloat16, D>(o, dout, l, di, inv_l, vo, vdo, B, nh, L, hd, s)
                        : rows<__half, D>(o, dout, l, di, inv_l, vo, vdo, B, nh, L, hd, s);
    });
  });
}

// K13: dq (like q) from the same inputs: l (route "simple") or 1 / l (routes
// "wgmma" and "tf32", from flash_bwd_rows_launch), as K12 takes them;
// the one the route does not read may be null; routes as K12's.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const int* qseg, const int* kvseg,
                                   const float* l, const float* inv_l, const float* m, const void* dout,
                                   const float* di, void* dq_, const long long* vq, const long long* vk,
                                   const long long* vv, const long long* vdo, const long long* vdq, int B, int nh,
                                   int Lq, int Lk, int hd, float scale, int dtype, int route, int device,
                                   void* stream) {
  if (int e = check_shape(B, nh, Lq, Lk, hd, dtype, device)) return e;
  if (int e = check_route(dtype, route, hd)) return e;
  if (!inputs_ok(route, dtype, {{q, vq}, {k, vk}, {v, vv}, {dout, vdo}}) || !out_ok(dq_, vdq, hd, dtype == 2 ? 4 : 2) ||
      (route != 0 && inv_l == nullptr) || (route == 0 && l == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (route == 0)
      return dtype == 0 ? dq<__nv_bfloat16>(q, k, v, qseg, kvseg, l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B, nh,
                                            Lq, Lk, scale, device, s)
                        : dq<__half>(q, k, v, qseg, kvseg, l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B, nh, Lq, Lk,
                                     scale, device, s);
    return by_head_dim(hd, [&](auto h) {
      constexpr int D = decltype(h)::value;
      if (route == 3)
        return dq_tf32<D>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B, nh, Lq, Lk, hd,
                          scale, device, s);
      return dtype == 0 ? dq_wgmma<__nv_bfloat16, D>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dq_, vq, vk, vv, vdo,
                                                     vdq, B, nh, Lq, Lk, hd, scale, dtype, device, s)
                        : dq_wgmma<__half, D>(q, k, v, qseg, kvseg, inv_l, m, dout, di, dq_, vq, vk, vv, vdo, vdq, B,
                                              nh, Lq, Lk, hd, scale, dtype, device, s);
    });
  });
}
