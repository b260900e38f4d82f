// IVF list scans of the sq codec for Hopper (sm_90a), bound with ctypes.
//
// Replaces two TPU kernels of colbert_tpu/ops/sq_probe_batched.py:
//   K6  _kernel      (sq_probe_batched.py:221, reached through sq_batch_list_scan)
//   K7  _hot_kernel  (sq_probe_batched.py:345, reached through sq_hot_list_scan)
//
// What they compute.  A work unit is one IVF list and up to 128 query tokens:
//   K6: one slot of the dense schedule (slot s scans list s % K for the
//       tokens qidx[s, :], -1 empty); qs holds the projected queries
//       already rounded to bf16, as the TPU kernel rounds qsT;
//   K7: one hot list (hot_ids[h], -1 none) for up to 128 tokens (route
//       "staged": 128 consecutive tokens; "mma": 128 of its member tokens);
//       qs in fp32, as the TPU kernel's bands are fp32.
// Every row of the list, [offsets[l], offsets[l+1]) of the CSR codes
// (N, D) int8, is scored against every token of the unit,
//   score = sum_d float(code[row, d]) * qs[token, d]      fp32 accumulation,
// and each token keeps its top-r of (score, global CSR row).
//
// Tie rule, as the TPU kernel merges (sq_probe_batched.py:298-336): the list
// is cut into 128-row blocks that start at offsets[l] rounded down to a
// multiple of 32 (the TPU's DMA windows).  Rows order by score descending,
// then block index descending, then row ascending: a total order, so the
// top-r does not depend on the order rows are visited in.  Unfilled
// entries are (-inf, -1).
//
// Outputs: K6 (S, r, tpl) for slots whose qidx[s, 0] >= 0 (an empty slot
// is skipped and its output left unwritten: no pair ever reads it; empty
// positions of a filled slot get -inf / -1); K7 (H, r, T) for hot_ids[h]
// >= 0 (a -1 entry is skipped and left unwritten: no pair reads it; route
// "mma" writes member entries only).
//
// Two designs:
//   "staged" (list_scan_kernel; the first design of both): one
//     block a unit, one thread a token, the query in registers, each
//     32-row chunk widened to fp32 in shared memory and every row scored by
//     a chain of D dependent FMAs, then inserted into the token's sorted
//     top-r in row order (`beats`: a row beats an equal score held from an
//     earlier block).  For K6 the grid is every dense slot, most of them
//     empty.
//   "mma" (K6 and K7): a work list of the filled slots only, most 64-row
//     stages first (work_count_kernel, work_place_kernel: one thread a
//     list, no host sync), then a persistent grid (slot_scan_mma_kernel) whose
//     blocks take items through a counter zeroed on the launching stream.
//     A slot's tokens are gathered once into shared memory as the bf16 B
//     operand; the list's rows stream through a double-buffered 16-byte
//     cp.async ring, 64 rows a stage; each warp widens its 16 rows to bf16
//     (exact) in registers and runs mma.sync m16n8k16 over the n-tiles that
//     hold members; the fp32 score tile goes to shared memory and each
//     token's thread merges its column into its top-r 8 rows at a time,
//     with the order above packed into one 64-bit key (row_key) and
//     branch-free sorting networks.
//     K7 on this route scans member tokens only, in one cooperative launch
//     (hot_scan_mma_kernel, no host sync, no memset) of three phases with a
//     grid-wide barrier between them: each hot list's member tokens (those
//     that probe it; every token when no membership is given), ascending,
//     laid out into slots of 128, slot g*H + h for the g-th 128 of hot list
//     h; a work list of those slots in K6's order (one block); the same
//     scan, the list of slot s being hot_ids[s % H].  With no hot list, the
//     served case at nprobe 128, it is one launch that does nothing, as
//     "staged"'s is.
//     The fp32 query goes in as three bf16 terms (hi, mid, lo: their sum is
//     qs exactly for normal floats, and an int8 code widens exactly to
//     bf16), three mma.sync a (k-step, n-tile) with fp32 accumulation (hi
//     into one accumulator, mid and lo into another, added at the end), so
//     the scores differ from an fp32 FMA chain only in summation order.
//     Results go to (H, r, T) at [h, :, token].
//
// What bounds them: not bytes (K6 reads ~20 MB, 0.019 ms at 3.35 TB/s) and
// not the products (0.11 GMAC a batch on the tensor cores) but the top-r
// selection: ~28 M (row, token) pairs a serving batch, each compared and
// merged by the token's thread.  In "staged" a warp runs the insertion
// whenever one of its 32 tokens needs it, nearly every row, as a chain of
// dependent compares; "mma" merges without branches, with short chains.
// K7 "staged" scores every row of a hot list against every token, though
// only the tokens that probe the list are read back: route "mma" selects
// over the member pairs alone (at chip_smoke.py's forced 128-list shape
// 5.1 M of 36.9 M).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "topr.cuh"  // row_key, walk_stage: the top-r under the TPU tie order

namespace {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;     // one thread per token of the unit
constexpr int BLOCK_ROWS = 128;  // the TPU kernel's block: sets the tie rule
constexpr int CHUNK_ROWS = 32;   // rows staged in shared memory at a time
constexpr int ALIGN_ROWS = 32;   // block starts: list start rounded down to this

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// A row of the block starting at `base` with score s goes before held entry (es, er).
__device__ __forceinline__ bool beats(float s, int base, float es, int er) {
  return s > es || (s == es && er < base);
}

template <int R>
__device__ __forceinline__ void insert(float (&ss)[R], int (&sr)[R], float s, int row, int base) {
  if (!beats(s, base, ss[R - 1], sr[R - 1])) return;
  bool done = false;
#pragma unroll
  for (int i = R - 1; i > 0; --i) {
    if (!done) {
      if (beats(s, base, ss[i - 1], sr[i - 1])) {
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

template <int D, int R, bool HOT>
__global__ void __launch_bounds__(THREADS)
list_scan_kernel(const int* __restrict__ qidx,      // K6: (S, tpl)
                 const int* __restrict__ hot_ids,   // K7: (H,)
                 const int* __restrict__ offsets,   // (K+1,)
                 const float* __restrict__ qs,      // (T, D)
                 const int8_t* __restrict__ codes,  // (N, D)
                 float* __restrict__ out_s, int* __restrict__ out_r,
                 int K, int T, int tpl, int r) {
  __shared__ __align__(16) float rows_sh[CHUNK_ROWS * D];
  const int tid = threadIdx.x;
  int list, t;
  if (HOT) {
    list = hot_ids[blockIdx.x];
    if (list < 0) return;  // no hot list here (uniform across the block)
    t = blockIdx.y * THREADS + tid;
    if (t >= T) t = -1;
  } else {
    const int64_t s = blockIdx.x;
    if (qidx[s * tpl] < 0) return;  // empty slot (uniform across the block)
    list = int(s % K);
    t = tid < tpl ? qidx[s * tpl + tid] : -1;
  }

  float ss[R];
  int sr[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    ss[i] = neg_inf();
    sr[i] = -1;
  }

  float q[D];
  if (t >= 0) {
    const float4* src = reinterpret_cast<const float4*>(qs + int64_t(t) * D);
#pragma unroll
    for (int d = 0; d < D / 4; ++d) {
      const float4 v = __ldg(src + d);
      q[4 * d] = v.x;
      q[4 * d + 1] = v.y;
      q[4 * d + 2] = v.z;
      q[4 * d + 3] = v.w;
    }
  }
  const int off_lo = offsets[list], off_hi = offsets[list + 1];
  for (int base = off_lo - off_lo % ALIGN_ROWS; base < off_hi; base += BLOCK_ROWS) {
    const int blk_hi = min(base + BLOCK_ROWS, off_hi);
    for (int c0 = max(base, off_lo); c0 < blk_hi; c0 += CHUNK_ROWS) {
      const int n = min(CHUNK_ROWS, blk_hi - c0);
      __syncthreads();  // the previous chunk is consumed
      const char4* src = reinterpret_cast<const char4*>(codes + int64_t(c0) * D);
      for (int i = tid; i < n * (D / 4); i += THREADS) {
        const char4 v = __ldg(src + i);
        reinterpret_cast<float4*>(rows_sh)[i] = make_float4(v.x, v.y, v.z, v.w);
      }
      __syncthreads();
      if (t >= 0) {
        for (int j = 0; j < n; ++j) {
          const float4* row = reinterpret_cast<const float4*>(rows_sh + j * D);
          float acc = 0.0f;
#pragma unroll
          for (int d = 0; d < D / 4; ++d) {
            const float4 v = row[d];
            acc = fmaf(v.x, q[4 * d], acc);
            acc = fmaf(v.y, q[4 * d + 1], acc);
            acc = fmaf(v.z, q[4 * d + 2], acc);
            acc = fmaf(v.w, q[4 * d + 3], acc);
          }
          insert<R>(ss, sr, acc, c0 + j, base);
        }
      }
    }
  }

  if (HOT) {
    if (t < 0) return;
    const int64_t o = int64_t(blockIdx.x) * r * T + t;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < r) {
        out_s[o + int64_t(i) * T] = ss[i];
        out_r[o + int64_t(i) * T] = sr[i];
      }
  } else {
    if (tid >= tpl) return;
    const int64_t o = int64_t(blockIdx.x) * r * tpl + tid;
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < r) {
        out_s[o + int64_t(i) * tpl] = ss[i];
        out_r[o + int64_t(i) * tpl] = sr[i];
      }
  }
}

template <int D, int R>
cudaError_t launch(const int* qidx, const int* hot_ids, const int* offsets, const float* qs,
                   const int8_t* codes, float* out_s, int* out_r, int units, int K, int T,
                   int tpl, int r, int hot, cudaStream_t stream) {
  if (hot) {
    dim3 grid(units, (T + THREADS - 1) / THREADS);
    list_scan_kernel<D, R, true><<<grid, THREADS, 0, stream>>>(
        qidx, hot_ids, offsets, qs, codes, out_s, out_r, K, T, tpl, r);
  } else {
    list_scan_kernel<D, R, false><<<units, THREADS, 0, stream>>>(
        qidx, hot_ids, offsets, qs, codes, out_s, out_r, K, T, tpl, r);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_r(const int* qidx, const int* hot_ids, const int* offsets, const float* qs,
                     const int8_t* codes, float* out_s, int* out_r, int units, int K, int T,
                     int tpl, int r, int hot, cudaStream_t stream) {
  // the top-r of a longer held list starts with the top-r: round r up
  if (r <= 2)
    return launch<D, 2>(qidx, hot_ids, offsets, qs, codes, out_s, out_r, units, K, T, tpl, r, hot, stream);
  if (r <= 8)
    return launch<D, 8>(qidx, hot_ids, offsets, qs, codes, out_s, out_r, units, K, T, tpl, r, hot, stream);
  return launch<D, 16>(qidx, hot_ids, offsets, qs, codes, out_s, out_r, units, K, T, tpl, r, hot, stream);
}

// ---- route "mma" (K6) ----

constexpr int MMA_ROWS = 64;            // list rows a stage: 16 a warp
constexpr int SC_STRIDE = THREADS + 8;  // floats a score-tile row (padded against bank conflicts)
constexpr int WL_THREADS = 128;         // work-list kernels: one thread a list
constexpr int WL_BUCKETS = 16;          // work-list order: 64-row stages a list, longer lists share the last

template <int D, int TERMS>
struct MmaSmem {
  static constexpr int A_STRIDE = D + 16;  // bytes a staged code row (padded, 16-byte aligned)
  static constexpr int B_STRIDE = D + 16;  // bf16 a staged token row (padded, 16-byte aligned)
  static constexpr int B_TERM = THREADS * B_STRIDE;  // bf16 a query term's tile
  static constexpr int SC_BYTES = MMA_ROWS * SC_STRIDE * 4;
  static constexpr int B_BYTES = TERMS * B_TERM * 2;
  static constexpr int A_BYTES = 2 * MMA_ROWS * A_STRIDE;
  static constexpr int TOTAL = SC_BYTES + B_BYTES + A_BYTES;
};

// The work list's bucket of list l: its 64-row stages (the scan's work),
// capped at the last bucket.
__device__ __forceinline__ int list_bucket(const int* __restrict__ offsets, int l) {
  return min((__ldg(offsets + l + 1) - __ldg(offsets + l) + MMA_ROWS - 1) / MMA_ROWS, WL_BUCKETS - 1);
}

// The work list, in two kernels over the lists (one thread a list; list l
// owns slots l, l + K, l + 2K, ... < S; a filled one has qidx[s, 0] >= 0):
// the work buffer holds items[S], then n_items, then per bucket the filled
// slots (totals) and a cursor, both zero at the first launch.  Count: each
// bucket's filled slots.  Place: bucket b's slots go after every bucket with
// more stages; a block reserves its range in a bucket with one atomic, and
// within it each list its own, so the order inside a bucket follows the
// atomics.  Plain version: ops/sq_probe_batched.py::slot_work_list.
__global__ void __launch_bounds__(WL_THREADS)
work_count_kernel(const int* __restrict__ qidx, const int* __restrict__ offsets, int S, int K, int tpl,
                  int* __restrict__ work) {
  __shared__ int tot[WL_BUCKETS];
  const int tid = threadIdx.x, l = blockIdx.x * WL_THREADS + tid;
  if (tid < WL_BUCKETS) tot[tid] = 0;
  __syncthreads();
  if (l < K) {
    int filled = 0;
    for (int s = l; s < S; s += K) filled += __ldg(qidx + int64_t(s) * tpl) >= 0;
    if (filled) atomicAdd(&tot[list_bucket(offsets, l)], filled);
  }
  __syncthreads();
  if (tid < WL_BUCKETS && tot[tid]) atomicAdd(work + S + 1 + tid, tot[tid]);
}

__global__ void __launch_bounds__(WL_THREADS)
work_place_kernel(const int* __restrict__ qidx, const int* __restrict__ offsets, int S, int K, int tpl,
                  int* __restrict__ work) {
  __shared__ int start[WL_BUCKETS], tot[WL_BUCKETS], base[WL_BUCKETS];
  const int tid = threadIdx.x, l = blockIdx.x * WL_THREADS + tid;
  const int* totals = work + S + 1;
  int* cursor = work + S + 1 + WL_BUCKETS;
  if (tid < WL_BUCKETS) tot[tid] = 0;
  if (tid == 0) {
    int run = 0;
    for (int b = WL_BUCKETS - 1; b >= 0; --b) {
      start[b] = run;
      run += totals[b];
    }
    if (blockIdx.x == 0) work[S] = run;
  }
  __syncthreads();
  int filled = 0, bucket = 0, at = 0;
  if (l < K) {
    for (int s = l; s < S; s += K) filled += __ldg(qidx + int64_t(s) * tpl) >= 0;
    bucket = list_bucket(offsets, l);
    if (filled) at = atomicAdd(&tot[bucket], filled);
  }
  __syncthreads();
  if (tid < WL_BUCKETS && tot[tid]) base[tid] = start[tid] + atomicAdd(cursor + tid, tot[tid]);
  __syncthreads();
  if (filled) {
    int* out = work + base[bucket] + at;
    for (int s = l; s < S; s += K)
      if (__ldg(qidx + int64_t(s) * tpl) >= 0) *out++ = s;
  }
}

// K7's schedule on route "mma", phase 1 for one hot entry h (a block):
// lays out hot list h's member tokens (members[t, h] of the (T, H) bool
// mask, or every token when members is null), ascending, into its slots
// s = g*H + h of qidx (G*H, 128), G = ceil(T / 128), -1 past the last, and
// writes its count of filled slots to n_slots[h].  A -1 hot entry writes 0:
// its slots are never read.  Plain version:
// ops/sq_probe_batched.py::hot_member_schedule.
__device__ void lay_out_members(int h, const int* __restrict__ hot_ids, const uint8_t* __restrict__ members,
                                int H, int T, int* qidx, int* n_slots) {
  __shared__ int warp_n[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (hot_ids[h] < 0) {  // uniform across the block
    if (tid == 0) n_slots[h] = 0;
    return;
  }
  const int G = (T + THREADS - 1) / THREADS;
  auto at = [&](int rank) { return (int64_t(rank / THREADS) * H + h) * THREADS + rank % THREADS; };
  int base = 0;  // members before this tile of tokens
  for (int t0 = 0; t0 < T; t0 += THREADS) {
    const int t = t0 + tid;
    const bool m = t < T && (members == nullptr || members[int64_t(t) * H + h]);
    const unsigned ballot = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      before += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (m) qidx[at(base + before + __popc(ballot & ((1u << lane) - 1u)))] = t;
    base += total;
    __syncthreads();  // warp_n is rewritten for the next tile
  }
  for (int rank = base + tid; rank < G * THREADS; rank += THREADS) qidx[at(rank)] = -1;
  if (tid == 0) n_slots[h] = (base + THREADS - 1) / THREADS;
}

// K7's work list, phase 2 (one block, after every n_slots is written): the
// filled slots in the order of K6's (most 64-row stages first, the same
// buckets; hot entry h's are g*H + h, g < n_slots[h]), the item count, and
// the scan's item counter zeroed.  Order within a bucket follows its
// atomics.  Plain version: ops/sq_probe_batched.py::slot_work_list with
// lmap = hot_ids.  n_slots was written by other blocks of this launch: read
// past L1.
__device__ void place_hot_items(const int* __restrict__ hot_ids, const int* __restrict__ offsets,
                                const int* n_slots, int H, int S, int* work) {
  __shared__ int tot[WL_BUCKETS], cursor[WL_BUCKETS];
  const int tid = threadIdx.x;
  if (tid < WL_BUCKETS) tot[tid] = 0;
  __syncthreads();
  for (int h = tid; h < H; h += blockDim.x) {
    const int n = __ldcg(n_slots + h);
    if (n) atomicAdd(&tot[list_bucket(offsets, hot_ids[h])], n);
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int b = WL_BUCKETS - 1; b >= 0; --b) {
      cursor[b] = run;
      run += tot[b];
    }
    work[S] = run;                       // n_items
    work[S + 1 + 2 * WL_BUCKETS] = 0;    // the scan's next item
  }
  __syncthreads();
  for (int h = tid; h < H; h += blockDim.x) {
    const int n = __ldcg(n_slots + h);
    if (n) {
      const int at = atomicAdd(&cursor[list_bucket(offsets, hot_ids[h])], n);
      for (int g = 0; g < n; ++g) work[at + g] = g * H + h;
    }
  }
}

// K6 (HOT false, TERMS 1): slot s scans list s % K for its tokens, qs
// rounded to bf16, output (S, r, tpl).  K7 (HOT true, TERMS 3): slot s
// scans list lmap[s % K] (K = H hot entries), qs as three bf16 terms, output
// (H, r, T) at [s % K, :, token] for member tokens only.
//
// qidx, items and n_items are read past L1 (__ldcg): K7 writes them earlier
// in the same launch, from other blocks.
template <int D, int R, int TERMS, bool HOT>
__device__ __forceinline__ void
scan_items(const int* qidx,                      // (S, tpl)
           const int* items,                     // the filled slots, most stages first
           const int* n_items,                   // how many
           int* next_item,                       // the next item to take, 0 at the start
           const int* __restrict__ offsets,      // (K_lists+1,)
           const int* __restrict__ lmap,         // K7: hot_ids (K,)
           const float* __restrict__ qs,         // (T, D) fp32, split into bf16 terms here
           const int8_t* __restrict__ codes,     // (N, D)
           float* __restrict__ out_s, int* __restrict__ out_r, int K, int tpl, int r, int T) {
  using SM = MmaSmem<D, TERMS>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);
  __nv_bfloat16* bsh = reinterpret_cast<__nv_bfloat16*>(smem + SM::SC_BYTES);
  int8_t* ash = reinterpret_cast<int8_t*>(smem + SM::SC_BYTES + SM::B_BYTES);
  __shared__ int tok_sh[THREADS];
  __shared__ int item_sh, last_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int count = __ldcg(n_items);
  constexpr int QVEC = D / 4;   // float4s a fp32 token row
  constexpr int AVEC = D / 16;  // 16-byte vectors a code row

  for (;;) {
    if (tid == 0) {
      item_sh = atomicAdd(next_item, 1);
      last_sh = -1;
    }
    __syncthreads();
    if (item_sh >= count) break;  // uniform across the block
    const int64_t s = __ldcg(items + item_sh);
    const int list = HOT ? lmap[s % K] : int(s % K);
    const int t = tid < tpl ? __ldcg(qidx + s * tpl + tid) : -1;
    tok_sh[tid] = t;
    if (t >= 0) atomicMax(&last_sh, tid);
    __syncthreads();
    const int n_tiles = (last_sh + 8) / 8;  // n-tiles up to the last member (a filled slot has one)

    uint64_t h[R];  // the held top-r keys, best first; 0: none (below every row's key)
#pragma unroll
    for (int i = 0; i < R; ++i) h[i] = 0;
    const int lo = offsets[list], hi = offsets[list + 1];
    const int astart = lo - lo % ALIGN_ROWS;
    const int n_chunks = (hi - lo + MMA_ROWS - 1) / MMA_ROWS;
    // rows lo + c*64 .. of chunk c into ring slot c & 1; rows past the list are zero
    auto stage = [&](int c) {
      const int r0 = lo + c * MMA_ROWS;
      int8_t* dst = ash + (c & 1) * MMA_ROWS * SM::A_STRIDE;
      for (int i = tid; i < MMA_ROWS * AVEC; i += THREADS) {
        const int row = i / AVEC, v = i % AVEC;
        const bool in = r0 + row < hi;
        const int8_t* src = in ? codes + int64_t(r0 + row) * D + v * 16 : codes;
        hopper::cp_async16(hopper::smem_u32(dst + row * SM::A_STRIDE + v * 16), src, in ? 16 : 0);
      }
      hopper::cp_async_commit();
    };
    if (n_chunks > 0) stage(0);
    // the slot's tokens: the B operand, token-major (n x k), zero where
    // empty; term j is the bf16 rounding of what terms 0..j-1 leave of qs
    // (each remainder exact in fp32), so one term rounds qs to bf16 and
    // three sum to qs exactly
    for (int i = tid; i < n_tiles * 8 * QVEC; i += THREADS) {
      const int p = i / QVEC, v = i % QVEC;
      const int tk = tok_sh[p];
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (tk >= 0) x = __ldg(reinterpret_cast<const float4*>(qs + int64_t(tk) * D) + v);
#pragma unroll
      for (int j = 0; j < TERMS; ++j) {
        const __nv_bfloat162 lo2 = __floats2bfloat162_rn(x.x, x.y), hi2 = __floats2bfloat162_rn(x.z, x.w);
        *reinterpret_cast<uint2*>(bsh + j * SM::B_TERM + p * SM::B_STRIDE + v * 4) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo2), *reinterpret_cast<const uint32_t*>(&hi2));
        if (j + 1 < TERMS) {
          const float2 a = __bfloat1622float2(lo2), b = __bfloat1622float2(hi2);
          x = make_float4(x.x - a.x, x.y - a.y, x.z - b.x, x.w - b.y);
        }
      }
    }

    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        stage(c + 1);
        hopper::cp_async_wait<1>();
      } else {
        hopper::cp_async_wait<0>();
      }
      __syncthreads();  // chunk c and the tokens are in; the last chunk's walk is done
      const int r0 = lo + c * MMA_ROWS, n = min(MMA_ROWS, hi - r0);
      if (warp * 16 < n) {
        // A: this warp's 16 rows, widened in registers.  A thread widens bytes
        // 4q..4q+3 of a 16-dim step into fragment columns 2q, 2q+1 (a[0]) and
        // 2q+8, 2q+9 (a[2]); B's fragment takes the same dims, so the k order
        // is permuted alike on both sides and the sum is unchanged.
        const int8_t* ab = ash + (c & 1) * MMA_ROWS * SM::A_STRIDE + (warp * 16 + g) * SM::A_STRIDE + 4 * q;
        uint32_t a[AVEC][4];
#pragma unroll
        for (int ks = 0; ks < AVEC; ++ks) {
          hopper::widen4(*reinterpret_cast<const uint32_t*>(ab + ks * 16), a[ks][0], a[ks][2]);
          hopper::widen4(*reinterpret_cast<const uint32_t*>(ab + 8 * SM::A_STRIDE + ks * 16), a[ks][1],
                         a[ks][3]);
        }
        float* o = sc + (warp * 16 + g) * SC_STRIDE + 2 * q;
        for (int nt = 0; nt < n_tiles; ++nt) {
          const __nv_bfloat16* bb = bsh + (nt * 8 + g) * SM::B_STRIDE + 4 * q;
          // the small terms sum apart (e), so that the tensor cores' sums
          // of the large ones (d) do not truncate them
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f}, e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < AVEC; ++ks)
#pragma unroll
            for (int j = 0; j < TERMS; ++j) {
              const uint2 b = *reinterpret_cast<const uint2*>(bb + j * SM::B_TERM + ks * 16);
              hopper::mma_bf16_16816(j ? e : d, a[ks], b.x, b.y);
            }
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] += e[i];
          *reinterpret_cast<float2*>(o + nt * 8) = make_float2(d[0], d[1]);
          *reinterpret_cast<float2*>(o + 8 * SC_STRIDE + nt * 8) = make_float2(d[2], d[3]);
        }
      }
      __syncthreads();  // the score tile is complete
      if (t >= 0) topr::walk_stage<R, SC_STRIDE>(h, sc + tid, r0 - astart, n);
    }

    if (HOT ? t >= 0 : tid < tpl) {
      const int64_t o = HOT ? (s % K) * r * T + t : s * r * tpl + tid;
      const int64_t step = HOT ? T : tpl;
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < r) {
          out_s[o + i * step] = topr::key_score(h[i]);
          out_r[o + i * step] = h[i] ? astart + topr::key_rel(h[i]) : -1;
        }
    }
    __syncthreads();  // every thread has read this item's shared state
  }
}

// K6 on route "mma": the scan over the work list built by the list kernels.
template <int D, int R>
__global__ void __launch_bounds__(THREADS)
slot_scan_mma_kernel(const int* __restrict__ qidx, const int* __restrict__ items, const int* __restrict__ n_items,
                     int* __restrict__ next_item, const int* __restrict__ offsets, const float* __restrict__ qs,
                     const int8_t* __restrict__ codes, float* __restrict__ out_s, int* __restrict__ out_r, int K,
                     int tpl, int r) {
  scan_items<D, R, 1, false>(qidx, items, n_items, next_item, offsets, nullptr, qs, codes, out_s, out_r, K, tpl,
                             r, 0);
}

// K7 on route "mma", one cooperative launch (every block resident): phase 1
// lays out each hot entry's members (blocks take entries in turn), phase 2
// (block 0) places the work list, phase 3 scans it, a grid-wide barrier
// between phases.  With no hot list (the served case at nprobe 128) it is
// one launch that does nothing, as "staged"'s.  scratch: qidx (G*H, 128),
// the work buffer of its S = G*H slots, n_slots (H,).  schedule_only stops
// after phase 2 (the card tests' and chip_smoke.py's view of the schedule).
template <int D, int R>
__global__ void __launch_bounds__(THREADS)
hot_scan_mma_kernel(const int* __restrict__ hot_ids, const uint8_t* __restrict__ members,
                    const int* __restrict__ offsets, const float* __restrict__ qs, const int8_t* __restrict__ codes,
                    float* __restrict__ out_s, int* __restrict__ out_r, int* scratch, int H, int T, int r,
                    int schedule_only) {
  cg::grid_group grid = cg::this_grid();
  const int S = (T + THREADS - 1) / THREADS * H;
  int* work = scratch + int64_t(S) * THREADS;
  int* n_slots = work + S + 2 + 2 * WL_BUCKETS;
  for (int h = blockIdx.x; h < H; h += gridDim.x) lay_out_members(h, hot_ids, members, H, T, scratch, n_slots);
  grid.sync();
  if (blockIdx.x == 0) place_hot_items(hot_ids, offsets, n_slots, H, S, work);
  grid.sync();
  if (schedule_only) return;
  scan_items<D, R, 3, true>(scratch, work, work + S, work + S + 1 + 2 * WL_BUCKETS, offsets, hot_ids, qs, codes,
                            out_s, out_r, H, THREADS, r, T);
}

cudaError_t launch_work_list(const int* qidx, const int* offsets, int* work, int S, int K, int tpl,
                             cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(work + S, 0, (2 + 2 * WL_BUCKETS) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  const int blocks = (K + WL_THREADS - 1) / WL_THREADS;
  work_count_kernel<<<blocks, WL_THREADS, 0, stream>>>(qidx, offsets, S, K, tpl, work);
  work_place_kernel<<<blocks, WL_THREADS, 0, stream>>>(qidx, offsets, S, K, tpl, work);
  return cudaGetLastError();
}

// The blocks of `kernel` that fit on the card at once with `smem` bytes of
// dynamic shared memory, found once a device (host calls, no sync).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, int (&resident)[64], int& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per_sm * sms;
  }
  out = resident[dev];
  return cudaSuccess;
}

template <int D, int R>
cudaError_t launch_mma(const int* qidx, int* work, const int* offsets, const float* qs, const int8_t* codes,
                       float* out_s, int* out_r, int S, int K, int tpl, int r, cudaStream_t stream) {
  auto kernel = slot_scan_mma_kernel<D, R>;
  constexpr int smem = MmaSmem<D, 1>::TOTAL;
  static int resident[64] = {0};
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, smem, resident, blocks);
  if (err == cudaSuccess) err = launch_work_list(qidx, offsets, work, S, K, tpl, stream);
  if (err != cudaSuccess) return err;
  kernel<<<S < blocks ? S : blocks, THREADS, smem, stream>>>(qidx, work, work + S, work + S + 1 + 2 * WL_BUCKETS,
                                                              offsets, qs, codes, out_s, out_r, K, tpl, r);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma_r(const int* qidx, int* work, const int* offsets, const float* qs, const int8_t* codes,
                         float* out_s, int* out_r, int S, int K, int tpl, int r, cudaStream_t stream) {
  if (r <= 2) return launch_mma<D, 2>(qidx, work, offsets, qs, codes, out_s, out_r, S, K, tpl, r, stream);
  if (r <= 8) return launch_mma<D, 8>(qidx, work, offsets, qs, codes, out_s, out_r, S, K, tpl, r, stream);
  return launch_mma<D, 16>(qidx, work, offsets, qs, codes, out_s, out_r, S, K, tpl, r, stream);
}

// K7 on route "mma": one cooperative launch of every resident block.
template <int D, int R>
cudaError_t launch_hot_mma(const int* hot_ids, const uint8_t* members, int* scratch, const int* offsets,
                           const float* qs, const int8_t* codes, float* out_s, int* out_r, int H, int T, int r,
                           int schedule_only, cudaStream_t stream) {
  auto kernel = hot_scan_mma_kernel<D, R>;
  constexpr int smem = MmaSmem<D, 3>::TOTAL;
  static int resident[64] = {0};
  int blocks = 0;
  cudaError_t err = resident_blocks(kernel, smem, resident, blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&hot_ids, &members, &offsets, &qs, &codes, &out_s, &out_r, &scratch, &H, &T, &r, &schedule_only};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(THREADS), args, smem,
                                     stream);
}

template <int D>
cudaError_t launch_hot_mma_r(const int* hot_ids, const uint8_t* members, int* scratch, const int* offsets,
                             const float* qs, const int8_t* codes, float* out_s, int* out_r, int H, int T, int r,
                             cudaStream_t stream) {
  if (r <= 2)
    return launch_hot_mma<D, 2>(hot_ids, members, scratch, offsets, qs, codes, out_s, out_r, H, T, r, 0, stream);
  if (r <= 8)
    return launch_hot_mma<D, 8>(hot_ids, members, scratch, offsets, qs, codes, out_s, out_r, H, T, r, 0, stream);
  return launch_hot_mma<D, 16>(hot_ids, members, scratch, offsets, qs, codes, out_s, out_r, H, T, r, 0, stream);
}

}  // namespace

extern "C" {

// Shape limits the kernel takes; the Python wrapper checks them first.
int sq_scan_max_tokens() { return THREADS; }
int sq_scan_max_r() { return 16; }

// K6 (hot == 0): units = S slots, qidx (S, tpl).  K7 (hot != 0): units = H
// hot lists, hot_ids (H,), tokens 0..T-1.  Returns a cudaError_t: 0 when the
// launch was accepted.
int sq_list_scan_launch(const void* qidx, const void* hot_ids, const void* offsets,
                        const void* qs, const void* codes, void* out_s, void* out_r,
                        int units, int K, int T, int D, int tpl, int r, int hot, void* stream) {
  if (units < 1 || K < 1 || T < 1 || r < 1 || r > 16 ||
      (!hot && (tpl < 1 || tpl > THREADS || qidx == nullptr)) || (hot && hot_ids == nullptr) ||
      (hot && (T + THREADS - 1) / THREADS > 65535))
    return int(cudaErrorInvalidValue);
  const int* qi = static_cast<const int*>(qidx);
  const int* hi = static_cast<const int*>(hot_ids);
  const int* of = static_cast<const int*>(offsets);
  const float* q = static_cast<const float*>(qs);
  const int8_t* c = static_cast<const int8_t*>(codes);
  float* os = static_cast<float*>(out_s);
  int* orow = static_cast<int*>(out_r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return int(launch_r<16>(qi, hi, of, q, c, os, orow, units, K, T, tpl, r, hot, s));
    case 32: return int(launch_r<32>(qi, hi, of, q, c, os, orow, units, K, T, tpl, r, hot, s));
    case 64: return int(launch_r<64>(qi, hi, of, q, c, os, orow, units, K, T, tpl, r, hot, s));
    case 128: return int(launch_r<128>(qi, hi, of, q, c, os, orow, units, K, T, tpl, r, hot, s));
    default: return int(cudaErrorInvalidValue);
  }
}

// Words of route "mma"'s work buffer for S slots (items, count, per-bucket
// totals and cursors, the scan's item counter).
int sq_slot_work_words(int S) { return S + 2 + 2 * WL_BUCKETS; }

// K6's work list alone (the first launches of route "mma"): work
// (sq_slot_work_words(S),) int32, the filled slots in work[0 .. n) and n in
// work[S].
int sq_slot_work_list_launch(const void* qidx, const void* offsets, void* work, int S, int K, int tpl,
                             void* stream) {
  if (S < 1 || K < 1 || tpl < 1 || qidx == nullptr || work == nullptr) return int(cudaErrorInvalidValue);
  return int(launch_work_list(static_cast<const int*>(qidx), static_cast<const int*>(offsets),
                              static_cast<int*>(work), S, K, tpl, static_cast<cudaStream_t>(stream)));
}

// K6 on route "mma": S slots, qidx (S, tpl); work (sq_slot_work_words(S),)
// int32 scratch for the work list; qs (T, D) fp32 (rounded to bf16 in the
// kernel).  On `stream`: a memset and two launches for the work list, then
// the scan.  Returns a
// cudaError_t: 0 when both launches were accepted.
int sq_slot_scan_mma_launch(const void* qidx, void* work, const void* offsets, const void* qs,
                            const void* codes, void* out_s, void* out_r, int S, int K, int D, int tpl, int r,
                            void* stream) {
  if (S < 1 || K < 1 || r < 1 || r > 16 || tpl < 1 || tpl > THREADS || qidx == nullptr || work == nullptr)
    return int(cudaErrorInvalidValue);
  const int* qi = static_cast<const int*>(qidx);
  int* w = static_cast<int*>(work);
  const int* of = static_cast<const int*>(offsets);
  const float* q = static_cast<const float*>(qs);
  const int8_t* c = static_cast<const int8_t*>(codes);
  float* os = static_cast<float*>(out_s);
  int* orow = static_cast<int*>(out_r);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return int(launch_mma_r<16>(qi, w, of, q, c, os, orow, S, K, tpl, r, st));
    case 32: return int(launch_mma_r<32>(qi, w, of, q, c, os, orow, S, K, tpl, r, st));
    case 64: return int(launch_mma_r<64>(qi, w, of, q, c, os, orow, S, K, tpl, r, st));
    case 128: return int(launch_mma_r<128>(qi, w, of, q, c, os, orow, S, K, tpl, r, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// Words of K7's route "mma" scratch for H hot entries and T tokens: qidx
// (G*H, 128), G = ceil(T / 128), the work buffer of its G*H slots, then
// each hot entry's count of filled slots.
int sq_hot_scratch_words(int H, int T) {
  const int S = (T + THREADS - 1) / THREADS * H;
  return S * THREADS + sq_slot_work_words(S) + H;
}

// K7's schedule and work list alone (phases 1 and 2 of its route "mma"):
// members (T, H) bool or null (every token); scratch
// (sq_hot_scratch_words(H, T),) int32.  qidx rows of a -1 hot entry are
// left unwritten.
int sq_hot_schedule_launch(const void* hot_ids, const void* members, const void* offsets, void* scratch, int H,
                           int T, void* stream) {
  if (H < 1 || T < 1 || hot_ids == nullptr || scratch == nullptr) return int(cudaErrorInvalidValue);
  return int(launch_hot_mma<16, 2>(static_cast<const int*>(hot_ids), static_cast<const uint8_t*>(members),
                                   static_cast<int*>(scratch), static_cast<const int*>(offsets), nullptr, nullptr,
                                   nullptr, nullptr, H, T, 1, 1, static_cast<cudaStream_t>(stream)));
}

// K7 on route "mma": H hot entries hot_ids (H,) (-1 none), members (T, H)
// bool or null (every token), scratch (sq_hot_scratch_words(H, T),) int32,
// qs (T, D) fp32 (three bf16 terms in the kernel), out (H, r, T), written
// at member entries of real hot lists only.  On `stream`: one cooperative
// launch (schedule, work list and scan).  Returns a cudaError_t: 0 when the
// launch was accepted.
int sq_hot_scan_mma_launch(const void* hot_ids, const void* members, void* scratch, const void* offsets,
                           const void* qs, const void* codes, void* out_s, void* out_r, int H, int T, int D, int r,
                           void* stream) {
  if (H < 1 || T < 1 || r < 1 || r > 16 || hot_ids == nullptr || scratch == nullptr)
    return int(cudaErrorInvalidValue);
  const int* hi = static_cast<const int*>(hot_ids);
  const uint8_t* m = static_cast<const uint8_t*>(members);
  int* w = static_cast<int*>(scratch);
  const int* of = static_cast<const int*>(offsets);
  const float* q = static_cast<const float*>(qs);
  const int8_t* c = static_cast<const int8_t*>(codes);
  float* os = static_cast<float*>(out_s);
  int* orow = static_cast<int*>(out_r);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return int(launch_hot_mma_r<16>(hi, m, w, of, q, c, os, orow, H, T, r, st));
    case 32: return int(launch_hot_mma_r<32>(hi, m, w, of, q, c, os, orow, H, T, r, st));
    case 64: return int(launch_hot_mma_r<64>(hi, m, w, of, q, c, os, orow, H, T, r, st));
    case 128: return int(launch_hot_mma_r<128>(hi, m, w, of, q, c, os, orow, H, T, r, st));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
