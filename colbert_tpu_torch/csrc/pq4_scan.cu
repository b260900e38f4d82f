// PQ4 fast-scan list scan (K8) for Hopper (sm_90a), bound with ctypes.
//
// Replaces K8, the TPU kernel _kernel of colbert_tpu/ops/pq4.py:125
// (pallas_call at :254, reached through pq4_block_scan and ivf_probe_pq4).
//
// What it computes.  For each query token t and each of its nprobe probed
// IVF lists l = lists[t, j], every CSR row x of l (rows [offsets[l],
// offsets[l+1]) of the packed codes, m/2 bytes a row, byte jj holding
// nibble 2jj in its low and nibble 2jj+1 in its high half) is scored
//   score = sum_j lut[t, j, nib(x, j)]
// in fp32, over the token's LUT (m x 16 entries) rounded to bf16 by the
// wrapper, as the TPU kernel's LUT planes are.  Each (token, list) keeps its
// top r (score, CSR row), best first, written to out[(t * nprobe + j) * r + i];
// unfilled entries are (-inf, -1), so an empty list yields only those.  The
// TPU kernel instead writes a dense (K, r, T_pad) pair over every list and
// token (604 MB at the serving point, almost all unread); this output is the
// (T, nprobe, r) subset that ivf_probe_pq4 reads.
//
// Tie rule, as the TPU kernel merges (pq4.py:165-193): blocks of 128 rows
// counted from the list start (no 32-row alignment); within a block the
// lowest row wins a tie, a block row beats an equal score held from an
// earlier block, and among equal scores the block's rows go first.  The
// result is the top r under the total order (score desc, block desc, row
// asc), so the selection equals the TPU merge's, duplicate rows included,
// whatever order the rows are visited in.
//
// Two routes (ops/pq4.py::pq4_scan_plan picks "onehot" for every shape):
//
// "onehot" (pq4_onehot_kernel).  The TPU kernel's arithmetic: it scores a
// block against every token as a one-hot product on its matrix unit
// (pq4.py:143-160), score = onehot(nibbles) . lut.  One subspace has exactly
// 16 codewords, one k16 step of the tensor cores, so row x's A fragment for
// subspace j is bf16 1.0 at column nib(x, j) and 0 elsewhere, and B is the
// tokens' LUT slice of that subspace.
//   Exact: each product is 1.0 x a bf16 value or 0 x one, so a k16 step adds
//   exactly one LUT entry to an fp32 accumulator; the only roundings are
//   those fp32 additions.  The even and the odd subspaces accumulate apart,
//   two fp32 sums added at the end, as the TPU kernel's two nibble planes,
//   route "lookup" and the plain version do; the tensor cores' fp32 adds may
//   still round otherwise than the plain version's reductions.
//   Items: one probed list and up to 64 of its member tokens, every (token,
//   probe) pair in exactly one item.  The pairs are grouped by list on the
//   card, with no host sync (a memset and four small kernels: count each
//   list's pairs; give each list its pair range and count its items into 32
//   buckets of work, 64-row tiles x 16-token tiles; place the items, most
//   work first; fill each list's pairs; plain version
//   ops/pq4.py::pq4_work_list); one block an SM takes items through a
//   counter, as K6's route "mma" does.
//   A block is warp-specialised, its roles joined by mbarriers.  A producer
//   warpgroup stages each pass of up to 128 rows of the item's list: the
//   rows' codes, then the members' bf16 LUT, 4 subspaces (128 bytes) a token
//   a stage, into an 8-stage shared-memory ring with cp.async (128-byte
//   swizzle).  Two consumer warpgroups, a 64-row tile each, build a stage's
//   one-hot A fragments in registers (a byte permute and two clamped shifts a
//   register) and issue its four wgmma m64nNk16 as one group, A from
//   registers, B the LUT slice (N = 16, 32, 48 or 64 by the item's members),
//   freeing the slot once the group is done; each pass's fp32 scores go to
//   one of two score tiles.  A walker warpgroup walks each token's column of
//   each tile into a top r of 64-bit keys with branch-free sorting networks
//   (csrc/topr.cuh, as K6's route "mma"), merges the two tiles' lists and
//   writes the item's pairs.  setmaxnreg moves the producer's registers to
//   the consumers' accumulators.
//   What bounds it (scripts/pq4_scan_variants.py; PERF.md): not the tensor
//   cores' rate (the function's own bound, 2 x 16 x m FLOP a (token, row)
//   pair, is 0.115 ms at the serving point; padded to 64-row and 16-token
//   tiles, 0.17 ms) but two costs the pipeline overlaps: the LUT staging, a
//   pass moving its members' whole LUT (4 KB a token at m 128) through L2,
//   1.44 GB a serving batch, ~0.5 ms alone; and the consumers' wgmmas, at
//   most 64 tokens wide, whose cost an instruction (not their width) sets
//   the pace, ~0.6 ms alone.
//
// "lookup" (pq4_scan_kernel; the first design, reached only on request): one
// block per token holds that token's LUT in shared memory (8 KB of fp32 at
// m = 128); one warp per probed list, one lane per row, so the 32 lanes of a
// warp look up one subspace at a time, 16 consecutive words: 16 banks, no
// conflict, and lanes with the same nibble share a broadcast.  A lane reads
// its row's code bytes with 16-byte loads, adds the even and the odd
// subspaces apart, keeps its top r in registers (`before`: the order above),
// and the warp merges the lanes' lists with r rounds of shuffles.  Bounded by
// the lookups, m shared-memory loads and m fp32 adds a (token, row) pair,
// and by re-reading each list's codes for every token that probes it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "topr.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int KSUB = 16;
constexpr int LOG_BLOCK_ROWS = 7;  // the TPU kernel's 128-row block: sets the tie rule

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// (sa, ra) goes before (sb, rb) in a list that starts at row lo.
__device__ __forceinline__ bool before(float sa, int ra, float sb, int rb, int lo) {
  if (sa != sb) return sa > sb;
  const int ba = (ra - lo) >> LOG_BLOCK_ROWS, bb = (rb - lo) >> LOG_BLOCK_ROWS;
  if (ba != bb) return ba > bb;
  return ra < rb;
}

template <int R>
__device__ __forceinline__ void insert(float (&ss)[R], int (&sr)[R], float s, int row, int lo) {
  if (!before(s, row, ss[R - 1], sr[R - 1], lo)) return;
  bool done = false;
#pragma unroll
  for (int i = R - 1; i > 0; --i) {
    if (!done) {
      if (before(s, row, ss[i - 1], sr[i - 1], lo)) {
        ss[i] = ss[i - 1];
        sr[i] = sr[i - 1];
      } else {
        ss[i] = s;
        sr[i] = row;
        done = true;
      }
    }
  }
  if (!done) {
    ss[0] = s;
    sr[0] = row;
  }
}

// One 32-bit word of codes = code bytes 4w .. 4w+3.
template <int BPR>
__device__ __forceinline__ void add_word(uint32_t v, int w, const float* __restrict__ lut,
                                         float& ae, float& ao) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int jj = 4 * w + k;
    const uint32_t b = (v >> (8 * k)) & 0xffu;
    ae += lut[(2 * jj) * KSUB + (b & 15u)];
    ao += lut[(2 * jj + 1) * KSUB + (b >> 4)];
  }
}

template <int BPR>
__device__ __forceinline__ float score_row(const uint8_t* __restrict__ row, const float* __restrict__ lut) {
  float ae = 0.0f, ao = 0.0f;
  if constexpr (BPR % 16 == 0) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int v = 0; v < BPR / 16; ++v) {
      const uint4 q = __ldg(src + v);
      add_word<BPR>(q.x, 4 * v, lut, ae, ao);
      add_word<BPR>(q.y, 4 * v + 1, lut, ae, ao);
      add_word<BPR>(q.z, 4 * v + 2, lut, ae, ao);
      add_word<BPR>(q.w, 4 * v + 3, lut, ae, ao);
    }
  } else {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int w = 0; w < BPR / 4; ++w) add_word<BPR>(__ldg(src + w), w, lut, ae, ao);
  }
  return ae + ao;
}

template <int BPR, int R>
__global__ void __launch_bounds__(THREADS)
pq4_scan_kernel(const int* __restrict__ lists,      // (T, nprobe)
                const int* __restrict__ offsets,    // (K+1,)
                const float* __restrict__ lut,      // (T, 2*BPR, 16) bf16 values in fp32
                const uint8_t* __restrict__ codes,  // (N, BPR)
                float* __restrict__ out_s, int* __restrict__ out_r, int nprobe, int r) {
  constexpr int M = 2 * BPR;
  __shared__ __align__(16) float lut_sh[M * KSUB];
  const int64_t t = blockIdx.x;
  const float4* src = reinterpret_cast<const float4*>(lut + t * M * KSUB);
  for (int i = threadIdx.x; i < M * KSUB / 4; i += THREADS)
    reinterpret_cast<float4*>(lut_sh)[i] = __ldg(src + i);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = warp; j < nprobe; j += WARPS) {
    const int l = lists[t * nprobe + j];
    const int lo = offsets[l], hi = offsets[l + 1];
    float ss[R];
    int sr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      ss[i] = neg_inf();
      sr[i] = -1;
    }
    // each lane visits its rows in ascending order
    for (int row = lo + lane; row < hi; row += 32)
      insert<R>(ss, sr, score_row<BPR>(codes + int64_t(row) * BPR, lut_sh), row, lo);

    // r rounds: the warp's best head entry is the next of the list's top r
    float my_s = neg_inf();
    int my_r = -1;
    for (int i = 0; i < r; ++i) {
      float bs = ss[0];
      int br = sr[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, bs, off);
        const int orow = __shfl_xor_sync(0xffffffffu, br, off);
        if (before(os, orow, bs, br, lo)) {
          bs = os;
          br = orow;
        }
      }
      if (lane == i) {
        my_s = bs;
        my_r = br;
      }
      if (br >= 0 && sr[0] == br) {  // rows are unique: only the owner pops
#pragma unroll
        for (int k = 0; k < R - 1; ++k) {
          ss[k] = ss[k + 1];
          sr[k] = sr[k + 1];
        }
        ss[R - 1] = neg_inf();
        sr[R - 1] = -1;
      }
    }
    if (lane < r) {
      const int64_t o = (t * nprobe + j) * r + lane;
      out_s[o] = my_s;
      out_r[o] = my_r;
    }
  }
}

template <int BPR>
cudaError_t launch_r(const int* lists, const int* offsets, const float* lut, const uint8_t* codes,
                     float* out_s, int* out_r, int T, int nprobe, int r, cudaStream_t stream) {
  // the top r of a longer held list starts with the top r: round r up
  if (r <= 8)
    pq4_scan_kernel<BPR, 8><<<T, THREADS, 0, stream>>>(lists, offsets, lut, codes, out_s, out_r, nprobe, r);
  else
    pq4_scan_kernel<BPR, 16><<<T, THREADS, 0, stream>>>(lists, offsets, lut, codes, out_s, out_r, nprobe, r);
  return cudaGetLastError();
}

}  // namespace

// ---- route "onehot" ----

namespace {  // internal linkage: a launch's static state is this library's own
namespace oh {

using namespace hopper;

constexpr int NT = 64;                 // member tokens an item: the widest wgmma n
constexpr int TILE = 64;               // rows a wgmma m-tile: one consumer warpgroup's
constexpr int CONS = 2;                // consumer warpgroups: tile w of a pass is warpgroup w's
constexpr int PASS_ROWS = TILE * CONS;
constexpr int WALK_PARTS = 2;          // walker threads a token column: one a tile
constexpr int THREADS = 128 * (CONS + 2);  // consumers, then the walker warpgroup, then the producer's
constexpr int WALKER = 128 * CONS, PRODUCER = 128 * (CONS + 1);  // first thread of each
constexpr int SUBS = 4;                // subspaces a LUT stage: 64 bf16, one 128-byte swizzle row a token
constexpr int STAGES = 8;              // the LUT ring
constexpr int LUT_STAGE = NT * 128;    // bytes a stage
constexpr int SC_STRIDE = NT + 8;      // floats a score-tile row (padded against bank conflicts)
constexpr int MAX_BPR = 128;
constexpr int RING_BYTES = STAGES * LUT_STAGE;
constexpr int CODE_BUF = PASS_ROWS * (MAX_BPR + 16);  // a pass's codes; two buffers
constexpr int TILE_BUF = PASS_ROWS * SC_STRIDE * 4;   // a pass's scores; two buffers
template <int R>
constexpr int smem_bytes() {  // + the walker's merge buffer, + alignment
  return RING_BYTES + 2 * CODE_BUF + 2 * TILE_BUF + R * NT * 8 + 1024;
}
static_assert(RING_BYTES % 1024 == 0 && LUT_STAGE % 1024 == 0, "128-byte swizzle atoms are 1024-byte aligned");
static_assert(smem_bytes<16>() <= 232448, "one block an SM");
static_assert(WALK_PARTS * NT == 128, "the walker warpgroup: a thread a (token, tile)");
static_assert(16 * 8 >= 128, "every producer thread copies a part of each LUT stage, so each arrives");
static_assert(128 * (40 + 120) + 128 * CONS * 176 <= 65536, "setmaxnreg: the block's registers");

// ---- the work list: (list, up to NT member tokens) items, most work first ----

constexpr int WL_THREADS = 128;  // list kernels: one thread a list
constexpr int PAIR_THREADS = 256;
constexpr int NB = 32;           // buckets: 64-row tiles x 16-token tiles of an item, longer items share the last
constexpr int CTL = 3 + 2 * NB;  // n_items, pair cursor, next item, bucket totals, bucket cursors

// The work buffer (int32 words): cnt[K], fill[K], ctl[CTL] (all zeroed before
// the list kernels), lstart[K], pairs[P], items[max_items].  pairs[lstart[l] ..
// + cnt[l]) are list l's pairs t * nprobe + j; an item is the index of its
// first pair, its list and members follow from the pairs.
struct Work {
  int *cnt, *fill, *ctl, *lstart, *pairs, *items;
};

__host__ __device__ __forceinline__ int max_items(int P, int K) { return P / NT + (P < K ? P : K); }
__host__ __device__ __forceinline__ int64_t work_words(int P, int K) {
  return 3 * int64_t(K) + CTL + P + max_items(P, K);
}
__host__ __device__ __forceinline__ Work work_of(int* w, int K, int P) {
  return {w, w + K, w + 2 * K, w + 2 * K + CTL, w + 3 * K + CTL, w + 3 * K + CTL + P};
}

// The bucket of an item of list l with `members` tokens: its 64-row tiles x
// 16-token tiles, capped at the last bucket.
__device__ __forceinline__ int item_bucket(const int* __restrict__ offsets, int l, int members) {
  const int tiles = (__ldg(offsets + l + 1) - __ldg(offsets + l) + TILE - 1) / TILE;
  return min(tiles * ((members + 15) / 16), NB - 1);
}

__global__ void __launch_bounds__(PAIR_THREADS) pair_count_kernel(const int* __restrict__ lists, int P, Work w) {
  const int p = blockIdx.x * PAIR_THREADS + threadIdx.x;
  if (p < P) atomicAdd(w.cnt + __ldg(lists + p), 1);
}

// Per list: its range of the pairs (a block reserves its lists' total with
// one atomic, each list its own part) and its items counted into buckets.
__global__ void __launch_bounds__(WL_THREADS) item_count_kernel(const int* __restrict__ offsets, int K, Work w) {
  __shared__ int tot[NB], pairs_sh, base_sh;
  const int tid = threadIdx.x, l = blockIdx.x * WL_THREADS + tid;
  if (tid < NB) tot[tid] = 0;
  if (tid == 0) pairs_sh = 0;
  __syncthreads();
  const int c = l < K ? w.cnt[l] : 0;
  int at = 0;
  if (c) {
    at = atomicAdd(&pairs_sh, c);
    const int ni = (c + NT - 1) / NT;
    if (ni > 1) atomicAdd(&tot[item_bucket(offsets, l, NT)], ni - 1);
    atomicAdd(&tot[item_bucket(offsets, l, c - (ni - 1) * NT)], 1);
  }
  __syncthreads();
  if (tid == 0 && pairs_sh) base_sh = atomicAdd(w.ctl + 1, pairs_sh);
  if (tid < NB && tot[tid]) atomicAdd(w.ctl + 3 + tid, tot[tid]);
  __syncthreads();
  if (c) w.lstart[l] = base_sh + at;
}

// Per list: its items placed after every bucket with more work; a block
// reserves its range in a bucket with one atomic and each list its own, so the
// order within a bucket follows the atomics.
__global__ void __launch_bounds__(WL_THREADS) item_place_kernel(const int* __restrict__ offsets, int K, Work w) {
  __shared__ int start[NB], tot[NB], base[NB];
  const int tid = threadIdx.x, l = blockIdx.x * WL_THREADS + tid;
  if (tid < NB) tot[tid] = 0;
  if (tid == 0) {
    int run = 0;
    for (int b = NB - 1; b >= 0; --b) {
      start[b] = run;
      run += w.ctl[3 + b];
    }
    if (blockIdx.x == 0) w.ctl[0] = run;
  }
  __syncthreads();
  const int c = l < K ? w.cnt[l] : 0;
  const int ni = (c + NT - 1) / NT;
  int bf = 0, bl = 0, atf = 0, atl = 0;
  if (c) {
    if (ni > 1) {
      bf = item_bucket(offsets, l, NT);
      atf = atomicAdd(&tot[bf], ni - 1);
    }
    bl = item_bucket(offsets, l, c - (ni - 1) * NT);
    atl = atomicAdd(&tot[bl], 1);
  }
  __syncthreads();
  if (tid < NB && tot[tid]) base[tid] = start[tid] + atomicAdd(w.ctl + 3 + NB + tid, tot[tid]);
  __syncthreads();
  if (c) {
    const int ps = w.lstart[l];
    for (int k = 0; k < ni - 1; ++k) w.items[base[bf] + atf + k] = ps + k * NT;
    w.items[base[bl] + atl] = ps + (ni - 1) * NT;
  }
}

__global__ void __launch_bounds__(PAIR_THREADS) pair_fill_kernel(const int* __restrict__ lists, int P, Work w) {
  const int p = blockIdx.x * PAIR_THREADS + threadIdx.x;
  if (p < P) {
    const int l = __ldg(lists + p);
    w.pairs[w.lstart[l] + atomicAdd(w.fill + l, 1)] = p;
  }
}

cudaError_t launch_work_list(const int* lists, const int* offsets, int* work, int P, int K, cudaStream_t stream) {
  const Work w = work_of(work, K, P);
  cudaError_t err = cudaMemsetAsync(work, 0, (2 * size_t(K) + CTL) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int pb = (P + PAIR_THREADS - 1) / PAIR_THREADS, lb = (K + WL_THREADS - 1) / WL_THREADS;
  pair_count_kernel<<<pb, PAIR_THREADS, 0, stream>>>(lists, P, w);
  item_count_kernel<<<lb, WL_THREADS, 0, stream>>>(offsets, K, w);
  item_place_kernel<<<lb, WL_THREADS, 0, stream>>>(offsets, K, w);
  pair_fill_kernel<<<pb, PAIR_THREADS, 0, stream>>>(lists, P, w);
  return cudaGetLastError();
}

// ---- the scan ----

// A row's one-hot fragment registers for one subspace.  word holds 16 x
// nibbles, one a byte; sel (0x4440 + b) takes byte b alone, 16 x the row's
// nibble v; q32 = 32 x (lane % 4).  The thread holds fragment columns
// (codewords) 2q, 2q+1 in `lo` and 2q+8, 2q+9 in `hi`, bf16 1.0 (0x3F80) at
// v's column: s = 16v - 32q is 0 or 16 exactly when v is 2q or 2q+1, s ^ 128
// is 0 or 16 exactly when v is 2q+8 or 2q+9, and every other v gives a shift
// of 32 or more (a wrapped negative included), which PTX's shl clamps to 0.
// One volatile asm: the compiler keeps it before the group's wgmma fence.
__device__ __forceinline__ void onehot(uint32_t word, uint32_t sel, uint32_t q32, uint32_t& lo, uint32_t& hi) {
  asm volatile(
      "{\n"
      ".reg .b32 v, s, t;\n"
      "prmt.b32 v, %2, 0, %3;\n"
      "sub.u32 s, v, %4;\n"
      "xor.b32 t, s, 128;\n"
      "shl.b32 %0, 16256, s;\n"
      "shl.b32 %1, 16256, t;\n"
      "}\n"
      : "=r"(lo), "=r"(hi)
      : "r"(word), "r"(sel), "r"(q32));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Folds an A fragment's registers into `sink` once the group that read them
// is retired: a real use, so that ptxas keeps them until then and gives the
// next fragment other registers (writing a register an in-flight wgmma reads
// makes ptxas serialize every wgmma).  `sink` is stored once a pass.
template <int N>
__device__ __forceinline__ void retire(uint32_t& sink, const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) sink ^= a[j][0] ^ a[j][1] ^ a[j][2] ^ a[j][3];
}

// 4 bytes from global into shared memory, asynchronously; zero-filled when
// src_bytes is 0 (rows of 4 or 8 bytes).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// d (+)= A[64 x 16] . B[N x 16]^T: A (the one-hot) from registers, B (N
// tokens' LUT slice) K-major in shared memory, 128-byte swizzle; scale_d = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_oh(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_oh<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
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

template <>
__device__ __forceinline__ void wgmma_oh<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_oh<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_oh<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// An arrival on `bar` by the threads whose `pred` holds, through a predicate
// rather than a branch (a branch among wgmmas in flight serializes them).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(int(pred)) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrives on `bar` when every cp.async this thread issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// An item as the producer publishes it to the consumers and the walker.
struct Item {
  int stop, lo, hi, n;
  int tok[NT], pair[NT];  // member tokens and their pairs, -1 past n
};

// The shared state of a block: the ring's and the buffers' mbarriers, two item slots.
struct Shared {
  uint64_t lut_full[STAGES], lut_empty[STAGES], codes_empty[2], tile_full[2], tile_empty[2];
  uint64_t item_full[2], item_empty[2];
  Item item[2];
  int next;
  uint32_t sink[128 * CONS];  // the consumers' retired A fragments, folded (never read)
};

// The member tokens' LUT columns a pass's wgmma takes: 16 to 64, a multiple of 16.
__device__ __forceinline__ int width(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : n <= 48 ? 48 : 64; }

// ---- the producer warpgroup: items, then each pass's codes and LUT stages ----
__device__ __forceinline__ void produce(Shared& sh, uint32_t ring, uint32_t codes_sh, const Work& w,
                                        const int* __restrict__ lists, const int* __restrict__ offsets,
                                        const __nv_bfloat16* __restrict__ lut, const uint8_t* __restrict__ codes,
                                        int nprobe, int bpr, int cstride) {
  const int pt = threadIdx.x - PRODUCER, m = 2 * bpr, nst = m / SUBS, count = w.ctl[0];
  int k = 0, ps = 0, st = 0;  // items, passes and stages so far
  for (;; ++k) {
    Item& it = sh.item[k % 2];
    mbar_wait(&sh.item_empty[k % 2], ((k / 2) & 1) ^ 1);
    if (pt == 0) sh.next = atomicAdd(w.ctl + 2, 1);
    bar_sync(1, 128);
    const int i = sh.next;
    const bool stop = i >= count;
    int lo = 0, hi = 0, n = 0;
    if (!stop) {
      const int ps0 = w.items[i];
      const int l = __ldg(lists + w.pairs[ps0]);
      n = min(NT, w.lstart[l] + w.cnt[l] - ps0);
      lo = __ldg(offsets + l);
      hi = __ldg(offsets + l + 1);
      if (pt < NT) {
        const int p = pt < n ? w.pairs[ps0 + pt] : -1;
        it.pair[pt] = p;
        it.tok[pt] = p >= 0 ? p / nprobe : -1;
      }
    }
    if (pt == 0) {
      it.stop = stop;
      it.lo = lo;
      it.hi = hi;
      it.n = n;
    }
    bar_sync(1, 128);  // the item's fields are written (and sh.next read)
    if (pt == 0) mbar_arrive(&sh.item_full[k % 2]);
    if (stop) return;
    // this thread's LUT units of every stage: token rows pt / 8 + 16 i, 16-byte unit pt % 8
    // (at row * 128 + (unit ^ (row % 8)) * 16 of a slot, the 128-byte swizzle); zero past the members
    const int nv = width(n), u = pt % 8;
    const __nv_bfloat16* src[NT * 8 / 128];
    uint32_t dst[NT * 8 / 128];
#pragma unroll
    for (int i = 0; i < NT * 8 / 128; ++i) {
      const int row = pt / 8 + 16 * i, t = row < nv ? it.tok[row] : -1;
      src[i] = t >= 0 ? lut + int64_t(t) * m * 16 + u * 8 : nullptr;
      dst[i] = row * 128 + ((u ^ (row & 7)) * 16);
    }
    for (int p0 = lo; p0 < hi; p0 += PASS_ROWS, ++ps) {
      const int rows_p = min(PASS_ROWS, hi - p0), nrows = (rows_p + TILE - 1) / TILE * TILE;
      const uint32_t cb = codes_sh + (ps % 2) * CODE_BUF;
      mbar_wait(&sh.codes_empty[ps % 2], ((ps / 2) & 1) ^ 1);
      for (int s = 0; s < nst; ++s, ++st) {
        const int slot = st % STAGES;
        mbar_wait(&sh.lut_empty[slot], ((st / STAGES) & 1) ^ 1);
        if (s == 0) {  // the pass's codes (zero past the list), landing with LUT stage 0
          if (bpr >= 16) {
            const int units = bpr / 16;
            for (int j = pt; j < nrows * units; j += 128) {
              const int row = j / units, u = j % units;
              const bool in = row < rows_p;
              cp_async16(cb + row * cstride + u * 16, in ? codes + int64_t(p0 + row) * bpr + u * 16 : codes,
                         in ? 16 : 0);
            }
          } else {
            const int units = bpr / 4;
            for (int j = pt; j < nrows * units; j += 128) {
              const int row = j / units, u = j % units;
              const bool in = row < rows_p;
              cp_async4(cb + row * cstride + u * 4, in ? codes + int64_t(p0 + row) * bpr + u * 4 : codes,
                        in ? 4 : 0);
            }
          }
        }
        // LUT stage s (subspaces 4s .. 4s+3) of the nv token rows
        const uint32_t base = ring + slot * LUT_STAGE;
#pragma unroll
        for (int i = 0; i < NT * 8 / 128; ++i)
          if (16 * i < nv) cp_async16(base + dst[i], src[i] ? src[i] + s * SUBS * 16 : lut, src[i] ? 16 : 0);
        cp_async_arrive(&sh.lut_full[slot]);
      }
    }
  }
}

// ---- the consumer warpgroups: one-hot products, the score tiles ----

// One pass's products for consumer warpgroup wg over NV token columns: its
// tile's rows against every subspace, LUT stage by stage from the ring (HAS:
// the pass has rows in this warpgroup's tile).  A stage's four subspaces are
// one wgmma group, their one-hot A fragments built first (in a0 for even
// stages, a1 for odd ones: the group of the stage before may still read the
// other); the even and the odd subspaces accumulate apart, in de and dd (the
// TPU kernel's two nibble planes).  A stage's slot is released (one arrival a
// warp, by lane 0 through a predicate) once its group is done; a warpgroup
// with no rows in the pass releases each stage as it lands.  No branch sits
// among the wgmmas in flight: ptxas would serialize them.
template <int NV, bool HAS>
__device__ __forceinline__ void consume_pass(Shared& sh, uint32_t ring, uint32_t cb, float* tile, int nst,
                                             int cstride, int& st) {
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32, g = lane / 4;
  const bool leader = lane == 0;
  if constexpr (!HAS) {
    for (int s = 0; s < nst; ++s, ++st) {
      mbar_wait(&sh.lut_full[st % STAGES], (st / STAGES) & 1);
      mbar_arrive_if(&sh.lut_empty[st % STAGES], leader);
    }
    return;
  } else {
    const uint32_t q32 = 32u * (lane % 4);
    const uint32_t ra = cb + (wg * TILE + warp * 16 + g) * cstride, rb = ra + 8 * cstride;
    float de[NV / 2], dd[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i) de[i] = dd[i] = 0.0f;
    uint32_t a0[SUBS][4] = {}, a1[SUBS][4] = {};  // A fragments of even and odd stages: [subspace][register]
    uint32_t sink = 0;
    // stage s into `as`; FIRST: s is 0 (the sums start at 0); RELEASE: stage s - 2's slot is freed
    auto stage = [&](int s, uint32_t(&as)[SUBS][4], auto first, auto release) {
      const int slot = st % STAGES;
      mbar_wait(&sh.lut_full[slot], (st / STAGES) & 1);
      const uint32_t lut_slot = ring + slot * LUT_STAGE;
      // bytes 2s, 2s + 1 of rows g and g + 8 of this warp's 16 (subspaces 4s .. 4s+3):
      // word s / 2, bytes 2 (s % 2) + {0, 1}; 16 x each byte's low / high nibble
      const int word = (s / 2) * 4, b0 = 2 * (s % 2);
      const uint32_t x0 = lds32(ra + word), x1 = lds32(rb + word);
      const uint32_t xl0 = (x0 << 4) & 0xF0F0F0F0u, xl1 = (x1 << 4) & 0xF0F0F0F0u;
      const uint32_t xh0 = x0 & 0xF0F0F0F0u, xh1 = x1 & 0xF0F0F0F0u;
      wgmma_wait<1>();  // stage s - 2's group is done: `as` and its slot are free
      retire(sink, as);
      if constexpr (decltype(release)::value) mbar_arrive_if(&sh.lut_empty[(st - 2) % STAGES], leader);
#pragma unroll
      for (int jj = 0; jj < SUBS; ++jj) {
        const uint32_t sel = 0x4440u + b0 + jj / 2;  // byte b0 + jj/2 alone
        onehot(jj % 2 ? xh0 : xl0, sel, q32, as[jj][0], as[jj][2]);
        onehot(jj % 2 ? xh1 : xl1, sel, q32, as[jj][1], as[jj][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < SUBS; ++jj)
        wgmma_oh<NV>(jj % 2 ? dd : de, as[jj], sw128_desc(lut_slot + jj * 32), decltype(first)::value ? jj > 1 : 1);
      wgmma_commit();
      ++st;
    };
    using yes = std::true_type;
    using no = std::false_type;
    fence_acc(de);
    fence_acc(dd);
    stage(0, a0, yes{}, no{});
    stage(1, a1, no{}, no{});
    for (int s = 2; s < nst; s += 2) {  // nst = m / 4 is even
      stage(s, a0, no{}, yes{});
      stage(s + 1, a1, no{}, yes{});
    }
    wgmma_wait<0>();
    retire(sink, a0);
    retire(sink, a1);
    sh.sink[threadIdx.x] = sink;
    fence_acc(de);
    fence_acc(dd);
    mbar_arrive_if(&sh.lut_empty[(st - 2) % STAGES], leader);
    mbar_arrive_if(&sh.lut_empty[(st - 1) % STAGES], leader);
    // score = the even sum + the odd sum; accumulator (row 16 warp + g (+ 8),
    // column 8j + 2q (+ 1)) in d[4j + {0, 1} (+ 2)]
    float* o = tile + (wg * TILE + warp * 16 + g) * SC_STRIDE + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(de[4 * j] + dd[4 * j], de[4 * j + 1] + dd[4 * j + 1]);
      *reinterpret_cast<float2*>(o + 8 * SC_STRIDE + 8 * j) =
          make_float2(de[4 * j + 2] + dd[4 * j + 2], de[4 * j + 3] + dd[4 * j + 3]);
    }
  }
}

// One pass on NV token columns, with or without rows in this warpgroup's tile.
template <int NV>
__device__ __forceinline__ void consume_pass(Shared& sh, uint32_t ring, uint32_t cb, float* tile, int nst,
                                             int cstride, bool has, int& st) {
  if (has)
    consume_pass<NV, true>(sh, ring, cb, tile, nst, cstride, st);
  else
    consume_pass<NV, false>(sh, ring, cb, tile, nst, cstride, st);
}

__device__ __forceinline__ void consume(Shared& sh, uint32_t ring, uint32_t codes_sh, float* tiles, int bpr,
                                        int cstride) {
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, nst = 2 * bpr / SUBS;
  int k = 0, ps = 0, st = 0;
  for (;; ++k) {
    mbar_wait(&sh.item_full[k % 2], (k / 2) & 1);
    const Item& it = sh.item[k % 2];
    const bool stop = it.stop;
    const int lo = it.lo, hi = it.hi, nv = width(it.n);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.item_empty[k % 2]);  // this warp has read the item
    if (stop) return;
    for (int p0 = lo; p0 < hi; p0 += PASS_ROWS, ++ps) {
      const uint32_t cb = codes_sh + (ps % 2) * CODE_BUF;
      float* tile = tiles + (ps % 2) * (TILE_BUF / 4);
      const bool has = wg * TILE < hi - p0;  // uniform across the warpgroup
      // the walker is done with this tile buffer's pass before last
      mbar_wait(&sh.tile_empty[ps % 2], ((ps / 2) & 1) ^ 1);
      if (nv == 16)
        consume_pass<16>(sh, ring, cb, tile, nst, cstride, has, st);
      else if (nv == 32)
        consume_pass<32>(sh, ring, cb, tile, nst, cstride, has, st);
      else if (nv == 48)
        consume_pass<48>(sh, ring, cb, tile, nst, cstride, has, st);
      else
        consume_pass<64>(sh, ring, cb, tile, nst, cstride, has, st);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&sh.codes_empty[ps % 2]);
        mbar_arrive(&sh.tile_full[ps % 2]);
      }
    }
  }
}

// ---- the walker warpgroup: each member token's top r of each pass, merged ----
template <int R>
__device__ __forceinline__ void walk(Shared& sh, const float* tiles, uint64_t* merge, float* __restrict__ out_s,
                                     int* __restrict__ out_r, int r) {
  const int wt = threadIdx.x - WALKER, tok = wt % NT, part = wt / NT, lane = threadIdx.x % 32;
  int k = 0, ps = 0;
  for (;; ++k) {
    mbar_wait(&sh.item_full[k % 2], (k / 2) & 1);
    const Item& it = sh.item[k % 2];
    if (it.stop) return;
    const int lo = it.lo, hi = it.hi, n = it.n;
    uint64_t h[R];  // this thread's top r of its tile's rows, best first; 0: none
#pragma unroll
    for (int i = 0; i < R; ++i) h[i] = 0;
    for (int p0 = lo; p0 < hi; p0 += PASS_ROWS, ++ps) {
      mbar_wait(&sh.tile_full[ps % 2], (ps / 2) & 1);
      const int rows = min(TILE, hi - p0 - part * TILE);
      if (tok < n && rows > 0)
        topr::walk_stage<R, SC_STRIDE>(h, tiles + (ps % 2) * (TILE_BUF / 4) + part * TILE * SC_STRIDE + tok,
                                       p0 - lo + part * TILE, rows);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sh.tile_empty[ps % 2]);
    }
    // the two tiles' lists merged, written to pair p's r entries
    if (part == 1 && tok < n) {
#pragma unroll
      for (int i = 0; i < R; ++i) merge[i * NT + tok] = h[i];
    }
    bar_sync(2, 128);
    if (part == 0 && tok < n) {
      uint64_t o[R];
#pragma unroll
      for (int i = 0; i < R; ++i) o[i] = merge[i * NT + tok];
      topr::merge_desc<R>(h, o);
      const int64_t at = int64_t(it.pair[tok]) * r;
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < r) {
          out_s[at + i] = topr::key_score(h[i]);
          out_r[at + i] = h[i] ? lo + topr::key_rel(h[i]) : -1;
        }
    }
    bar_sync(2, 128);  // the merge buffer and the item are read
    if (wt == 0) mbar_arrive(&sh.item_empty[k % 2]);
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS, 1)
pq4_onehot_kernel(const int* __restrict__ lists,           // (T * nprobe,)
                  const int* __restrict__ offsets,         // (K+1,)
                  const __nv_bfloat16* __restrict__ lut,   // (T, m, 16) bf16
                  const uint8_t* __restrict__ codes,       // (N, bpr)
                  int* __restrict__ work,                  // the work list, built by launch_work_list
                  float* __restrict__ out_s, int* __restrict__ out_r, int K, int P, int nprobe, int bpr,
                  int r) {
  const Work w = work_of(work, K, P);
  extern __shared__ unsigned char smem_raw[];
  __shared__ Shared sh;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the LUT ring, the codes buffers, the tiles, the merge buffer
  const uint32_t codes_sh = ring + RING_BYTES;
  unsigned char* base = smem_raw + (ring - raw);
  float* tiles = reinterpret_cast<float*>(base + RING_BYTES + 2 * CODE_BUF);
  uint64_t* merge = reinterpret_cast<uint64_t*>(base + RING_BYTES + 2 * CODE_BUF + 2 * TILE_BUF);
  const int cstride = bpr + (bpr >= 16 ? 16 : 4);  // bytes a staged code row

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&sh.lut_full[i], 128);        // every producer thread's copies
      mbar_init(&sh.lut_empty[i], 4 * CONS);  // every consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sh.codes_empty[i], 4 * CONS);
      mbar_init(&sh.tile_full[i], 4 * CONS);
      mbar_init(&sh.tile_empty[i], 4);        // every walker warp
      mbar_init(&sh.item_full[i], 1);
      mbar_init(&sh.item_empty[i], 4 * CONS + 1);  // every consumer warp when read, the walker when done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // registers moved from the producer to the consumers' accumulators and A fragments
  if (threadIdx.x >= PRODUCER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    produce(sh, ring, codes_sh, w, lists, offsets, lut, codes, nprobe, bpr, cstride);
  } else if (threadIdx.x >= WALKER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 120;\n" ::: "memory");
    walk<R>(sh, tiles, merge, out_s, out_r, r);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 176;\n" ::: "memory");
    consume(sh, ring, codes_sh, tiles, bpr, cstride);
  }
}

template <int R>
cudaError_t launch(const int* lists, const int* offsets, const __nv_bfloat16* lut, const uint8_t* codes, int* work,
                   float* out_s, int* out_r, int P, int K, int nprobe, int bpr, int r, cudaStream_t stream) {
  auto kernel = pq4_onehot_kernel<R>;
  constexpr int smem = smem_bytes<R>();
  // the SMs, found once a device (host calls, no sync): one block each
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= MAX_DEVICES) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  err = launch_work_list(lists, offsets, work, P, K, stream);
  if (err != cudaSuccess) return err;
  const int items = max_items(P, K), grid = items < sms[dev] ? items : sms[dev];
  kernel<<<grid, THREADS, smem, stream>>>(lists, offsets, lut, codes, work, out_s, out_r, K, P, nprobe, bpr, r);
  return cudaGetLastError();
}

}  // namespace oh
}  // namespace

extern "C" {

// The most entries per (token, list) the kernels keep; the wrapper checks it first.
int pq4_scan_max_r() { return 16; }

// Route "lookup": lists (T, nprobe) int32, offsets (K+1,) int32, lut (T,
// 2*bpr, 16) fp32, codes (N, bpr) int8 16-byte aligned, out (T, nprobe, r).
// Returns a cudaError_t: 0 when the launch was accepted.
int pq4_scan_launch(const void* lists, const void* offsets, const void* lut, const void* codes,
                    void* out_s, void* out_r, int T, int nprobe, int bpr, int r, void* stream) {
  if (T < 1 || nprobe < 1 || r < 1 || r > 16) return int(cudaErrorInvalidValue);
  const int* li = static_cast<const int*>(lists);
  const int* of = static_cast<const int*>(offsets);
  const float* lu = static_cast<const float*>(lut);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  float* os = static_cast<float*>(out_s);
  int* orow = static_cast<int*>(out_r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bpr) {
    case 4: return int(launch_r<4>(li, of, lu, c, os, orow, T, nprobe, r, s));
    case 8: return int(launch_r<8>(li, of, lu, c, os, orow, T, nprobe, r, s));
    case 16: return int(launch_r<16>(li, of, lu, c, os, orow, T, nprobe, r, s));
    case 32: return int(launch_r<32>(li, of, lu, c, os, orow, T, nprobe, r, s));
    case 64: return int(launch_r<64>(li, of, lu, c, os, orow, T, nprobe, r, s));
    case 128: return int(launch_r<128>(li, of, lu, c, os, orow, T, nprobe, r, s));
    default: return int(cudaErrorInvalidValue);
  }
}

// Route "onehot"'s layout: member tokens an item, work-list buckets, and the
// int32 words of its work buffer for P = T * nprobe pairs over K lists.
int pq4_onehot_group() { return oh::NT; }
int pq4_work_buckets() { return oh::NB; }
long long pq4_onehot_work_words(int P, int K) { return oh::work_words(P, K); }

// Route "onehot"'s work list alone (the first launches of the route): work
// (pq4_onehot_work_words(P, K),) int32.  Returns a cudaError_t.
int pq4_work_list_launch(const void* lists, const void* offsets, void* work, int P, int K, void* stream) {
  if (P < 1 || K < 1 || work == nullptr) return int(cudaErrorInvalidValue);
  return int(oh::launch_work_list(static_cast<const int*>(lists), static_cast<const int*>(offsets),
                                  static_cast<int*>(work), P, K, static_cast<cudaStream_t>(stream)));
}

// Route "onehot": lists (T, nprobe) int32 in [0, K), offsets (K+1,) int32,
// lut (T, 2*bpr, 16) bf16, codes (N, bpr) int8 16-byte aligned, work
// (pq4_onehot_work_words(T * nprobe, K),) int32 scratch, out (T, nprobe, r).
// On `stream`: a memset and four launches for the work list, then the scan.
// Returns a cudaError_t: 0 when every launch was accepted.
int pq4_onehot_launch(const void* lists, const void* offsets, const void* lut, const void* codes, void* work,
                      void* out_s, void* out_r, int T, int nprobe, int K, int bpr, int r, void* stream) {
  if (T < 1 || nprobe < 1 || K < 1 || r < 1 || r > 16 || bpr < 4 || bpr > oh::MAX_BPR || bpr % 4 ||
      (bpr & (bpr - 1)) || int64_t(T) * nprobe > (int64_t(1) << 30))
    return int(cudaErrorInvalidValue);
  const int* li = static_cast<const int*>(lists);
  const int* of = static_cast<const int*>(offsets);
  const __nv_bfloat16* lu = static_cast<const __nv_bfloat16*>(lut);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  int* w = static_cast<int*>(work);
  float* os = static_cast<float*>(out_s);
  int* orow = static_cast<int*>(out_r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = T * nprobe;
  return int(r <= 8 ? oh::launch<8>(li, of, lu, c, w, os, orow, P, K, nprobe, bpr, r, s)
                    : oh::launch<16>(li, of, lu, c, w, os, orow, P, K, nprobe, bpr, r, s));
}

}  // extern "C"
