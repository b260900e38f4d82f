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
//   K7: one hot list (hot_ids[h], -1 none) for a tile of 128 consecutive
//       tokens; qs in fp32, as the TPU kernel's bands are fp32.
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
// >= 0 (a -1 entry is skipped and left unwritten: no pair reads it).
//
// Two designs:
//   "staged" (list_scan_kernel; K7's kernel, and K6's first design): one
//     block a unit, one thread a token, the query in registers, each
//     32-row chunk widened to fp32 in shared memory and every row scored by
//     a chain of D dependent FMAs, then inserted into the token's sorted
//     top-r in row order (`beats`: a row beats an equal score held from an
//     earlier block).  For K6 the grid is every dense slot, most of them
//     empty.
//   "mma" (K6): a work list of the filled slots only, most 64-row stages
//     first (work_count_kernel, work_place_kernel: one thread a list, no
//     host sync), then a persistent grid (slot_scan_mma_kernel) whose
//     blocks take items through a counter zeroed on the launching stream.
//     A slot's tokens are gathered once into shared memory as the bf16 B
//     operand; the list's rows stream through a double-buffered 16-byte
//     cp.async ring, 64 rows a stage; each warp widens its 16 rows to bf16
//     (exact) in registers and runs mma.sync m16n8k16 over the n-tiles that
//     hold members; the fp32 score tile goes to shared memory and each
//     token's thread merges its column into its top-r 8 rows at a time,
//     with the order above packed into one 64-bit key (row_key) and
//     branch-free sorting networks.
//
// What bounds them: not bytes (K6 reads ~20 MB, 0.019 ms at 3.35 TB/s) and
// not the products (0.11 GMAC a batch on the tensor cores) but the top-r
// selection: ~28 M (row, token) pairs a serving batch, each compared and
// merged by the token's thread.  In "staged" a warp runs the insertion
// whenever one of its 32 tokens needs it, nearly every row, as a chain of
// dependent compares; "mma" merges without branches, with short chains.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "topr.cuh"  // row_key, walk_stage: the top-r under the TPU tie order

namespace {

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

template <int D>
struct MmaSmem {
  static constexpr int A_STRIDE = D + 16;  // bytes a staged code row (padded, 16-byte aligned)
  static constexpr int B_STRIDE = D + 16;  // bf16 a staged token row (padded, 16-byte aligned)
  static constexpr int SC_BYTES = MMA_ROWS * SC_STRIDE * 4;
  static constexpr int B_BYTES = THREADS * B_STRIDE * 2;
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

template <int D, int R>
__global__ void __launch_bounds__(THREADS)
slot_scan_mma_kernel(const int* __restrict__ qidx,       // (S, tpl)
                     const int* __restrict__ items,      // the filled slots, most stages first
                     const int* __restrict__ n_items,    // how many
                     int* __restrict__ next_item,        // the next item to take, 0 at launch
                     const int* __restrict__ offsets,    // (K+1,)
                     const float* __restrict__ qs,       // (T, D) fp32, rounded to bf16 here
                     const int8_t* __restrict__ codes,   // (N, D)
                     float* __restrict__ out_s, int* __restrict__ out_r, int K, int tpl, int r) {
  using SM = MmaSmem<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);
  __nv_bfloat16* bsh = reinterpret_cast<__nv_bfloat16*>(smem + SM::SC_BYTES);
  int8_t* ash = reinterpret_cast<int8_t*>(smem + SM::SC_BYTES + SM::B_BYTES);
  __shared__ int tok_sh[THREADS];
  __shared__ int item_sh, last_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int count = *n_items;
  constexpr int QVEC = D / 4;   // float4s a fp32 token row
  constexpr int AVEC = D / 16;  // 16-byte vectors a code row

  for (;;) {
    if (tid == 0) {
      item_sh = atomicAdd(next_item, 1);
      last_sh = -1;
    }
    __syncthreads();
    if (item_sh >= count) break;  // uniform across the block
    const int64_t s = items[item_sh];
    const int list = int(s % K);
    const int t = tid < tpl ? qidx[s * tpl + tid] : -1;
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
    // the slot's tokens, rounded to bf16: the B operand, token-major (n x k), zero where empty
    for (int i = tid; i < n_tiles * 8 * QVEC; i += THREADS) {
      const int p = i / QVEC, v = i % QVEC;
      const int tk = tok_sh[p];
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (tk >= 0) x = __ldg(reinterpret_cast<const float4*>(qs + int64_t(tk) * D) + v);
      const __nv_bfloat162 lo2 = __floats2bfloat162_rn(x.x, x.y), hi2 = __floats2bfloat162_rn(x.z, x.w);
      *reinterpret_cast<uint2*>(bsh + p * SM::B_STRIDE + v * 4) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo2), *reinterpret_cast<const uint32_t*>(&hi2));
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
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int ks = 0; ks < AVEC; ++ks) {
            const uint2 b = *reinterpret_cast<const uint2*>(bb + ks * 16);
            hopper::mma_bf16_16816(d, a[ks], b.x, b.y);
          }
          *reinterpret_cast<float2*>(o + nt * 8) = make_float2(d[0], d[1]);
          *reinterpret_cast<float2*>(o + 8 * SC_STRIDE + nt * 8) = make_float2(d[2], d[3]);
        }
      }
      __syncthreads();  // the score tile is complete
      if (t >= 0) topr::walk_stage<R, SC_STRIDE>(h, sc + tid, r0 - astart, n);
    }

    if (tid < tpl) {
      const int64_t o = s * r * tpl + tid;
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (i < r) {
          out_s[o + int64_t(i) * tpl] = topr::key_score(h[i]);
          out_r[o + int64_t(i) * tpl] = h[i] ? astart + topr::key_rel(h[i]) : -1;
        }
    }
    __syncthreads();  // every thread has read this item's shared state
  }
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

template <int D, int R>
cudaError_t launch_mma(const int* qidx, int* work, const int* offsets, const float* qs, const int8_t* codes,
                       float* out_s, int* out_r, int S, int K, int tpl, int r, cudaStream_t stream) {
  auto kernel = slot_scan_mma_kernel<D, R>;
  constexpr int smem = MmaSmem<D>::TOTAL;
  // the blocks that fit on the card at once, found once a device (host calls, no sync)
  constexpr int MAX_DEVICES = 64;
  static int resident[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= MAX_DEVICES) return err != cudaSuccess ? err : cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    resident[dev] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  err = launch_work_list(qidx, offsets, work, S, K, tpl, stream);
  if (err != cudaSuccess) return err;
  const int grid = S < resident[dev] ? S : resident[dev];
  kernel<<<grid, THREADS, smem, stream>>>(qidx, work, work + S, work + S + 1 + 2 * WL_BUCKETS, offsets, qs, codes,
                                          out_s, out_r, K, tpl, r);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma_r(const int* qidx, int* work, const int* offsets, const float* qs, const int8_t* codes,
                         float* out_s, int* out_r, int S, int K, int tpl, int r, cudaStream_t stream) {
  if (r <= 2) return launch_mma<D, 2>(qidx, work, offsets, qs, codes, out_s, out_r, S, K, tpl, r, stream);
  if (r <= 8) return launch_mma<D, 8>(qidx, work, offsets, qs, codes, out_s, out_r, S, K, tpl, r, stream);
  return launch_mma<D, 16>(qidx, work, offsets, qs, codes, out_s, out_r, S, K, tpl, r, stream);
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

}  // extern "C"
