// Token-major sq probe for Hopper (sm_90a), bound with ctypes: two routes.
//
// Route "fused" (sq_window_topk_kernel) replaces K10 together with the
// selection after it: the TPU kernel _kernel of
// colbert_tpu/ops/sq_probe_pallas.py:40 (pallas_call at :121) and the
// _probe_topk of colbert_tpu/ops/ivf.py:213 (an exact top_k, approx=False),
// reached from ivf_probe_sq when serve.probe_impl="token".  Route "staged"
// (sq_window_scan_kernel) is the first design: K10 alone, its dense output
// selected afterwards in torch (ops/sq_probe.py::_window_topk).
//
// What both compute.  For each query token t and each of its nprobe windows
// (start = starts[t, j], len = min(lens[t, j], cap): the rows of one probed
// IVF list in the CSR codes (N, D) int8), row start + i scores
//   qs[t] . codes[start + i]
// summed in fp32 with qs in fp32, as the TPU kernel keeps its query bands
// (sq_probe_pallas.py:54).  Its column is j * cap + i.  The TPU kernel
// aligns each window down to 32 rows and pads cap to a multiple of 128 for
// its DMA and stores; neither changes which rows are scored or the (probe,
// row) order of the columns, so here a window is exactly the list.
//
// Route "staged" writes the dense (T, nprobe * cap) fp32 matrix, -inf past
// each window's end: one block per token, one thread per slot.  Its bound
// is that output (546 MB at the serving point, 2,304 tokens x 128 lists x
// cap 463, of which 27.7 M slots are rows), and its caller then builds an
// int64 key for every slot and takes a top-depth over all of them.
//
// Route "fused" writes each token's top-depth (scores (T, depth) fp32, CSR
// rows (T, depth) int32, best first, -inf / -1 padded) in jax.lax.top_k's
// order: score descending, equal scores by the lower column first, -0.0
// below +0.0.  One block per token:
//   1. the window prefix sums; positions p in [0, n) number the token's
//      real rows in (probe, row) order, so a position is monotone in the
//      column and a tie resolves to the lower position;
//   2. every real row is scored with the staged kernel's own arithmetic
//      (row_score: the same byte widening, the same fmaf order from 0.0f),
//      so the scores are bit-equal to route "staged"'s.  Consecutive
//      threads take consecutive positions, which are consecutive rows of a
//      window: the loads coalesce.  Each score becomes an order-preserving
//      32-bit key, stored at its position in shared memory, and counted in
//      a histogram of its top 11 bits;
//   3. radix select of the depth-th largest key: 11, 11 and 10-bit digits,
//      each pass counting the keys that match the prefix so far; it stops
//      early when every key of the chosen prefix is taken;
//   4. every key above the threshold prefix is taken, and of the keys equal
//      to it the lowest positions, by a block-wide prefix count in position
//      order (only when the equal keys are more than the places left);
//   5. the survivors are sorted as 64-bit (key, complemented position)
//      pairs by a bitonic network (sort_desc: the steps within a warp by
//      shuffles, the wider ones in shared memory), and written with their
//      scores and rows starts[t, j] + i.
// A token whose real rows fit in keys_cap (by default what fits beside the
// rest in 112 KB, so that two blocks share an SM: 25,343 keys at nprobe 128
// and depth 512) keeps its keys on the chip; a token with more re-scores
// its rows on each pass instead (no workspace, no host sync).
// When n <= depth every row is taken and steps 3-4 are skipped.
//
// What bounds route "fused": the fp32 FMAs, 2 * D per real row (3.55 GFLOP,
// 0.053 ms at 67 TFLOP/s at the serving point), over the bytes (the
// distinct probed codes once, 20.5 MB, plus qs, the windows and the
// (T, depth) output: ~0.010 ms).  What it meets first is neither: every
// token re-reads its probed lists from L2 (~12,000 rows x 64 B a token,
// ~1.8 GB in all), and the selection's block-wide passes.  The design keeps
// the re-reads to one pass over each token's rows (the keys stay in shared
// memory) and leaves the sharing of lists between a query's tokens, which
// would cut the L2 traffic, to a later design.  Tensor cores would buy
// little against that, and would lose the bit-equality with route "staged".

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int FUSED_THREADS = 512;
constexpr int FUSED_WARPS = FUSED_THREADS / 32;
constexpr int FUSED_MAX_DEPTH = 2048;  // mirrored by FUSED_MAX_DEPTH in ops/sq_probe.py
constexpr int HIST_BINS = 2048;        // 11-bit digits
constexpr int MAX_DYNAMIC_SMEM = 231424;  // 226 KB of the 227 KB a block may use; static smem < 1 KB
// The keys' default room: two blocks share an SM's 228 KB (1 KB reserved
// each, static smem < 1 KB).  With the whole block's room for keys (one
// block an SM) the serving point ran 0.88 ms against 0.65 with two blocks
// (scripts/sq_token_variants.py, an H100 80GB HBM3 at 700 W), where no
// token has more rows than this.
constexpr int KEYS_SMEM_BUDGET = 112 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// fp32 value of signed byte k of v.  (v ^ 0x80808080) holds b + 128 in each
// byte; placed in the low byte of the fp32 pattern of 2^23 it is 2^23 + b + 128.
__device__ __forceinline__ float byte_value(uint32_t biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + k)) - 8388736.0f;
}

// qs[t] . row: D int8 codes read with 16-byte loads, D fmaf from 0.0f in
// order d = 0 .. D - 1.  Both routes score with it, so they agree bit for bit.
template <int D>
__device__ __forceinline__ float row_score(const int8_t* codes_row, const float4* q4) {
  const uint4* row = reinterpret_cast<const uint4*>(codes_row);
  float acc = 0.0f;
#pragma unroll
  for (int v = 0; v < D / 16; ++v) {
    const uint4 c = __ldg(row + v);
    const uint32_t w[4] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u, c.w ^ 0x80808080u};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 q = q4[4 * v + k];
      acc = fmaf(byte_value(w[k], 0), q.x, acc);
      acc = fmaf(byte_value(w[k], 1), q.y, acc);
      acc = fmaf(byte_value(w[k], 2), q.z, acc);
      acc = fmaf(byte_value(w[k], 3), q.w, acc);
    }
  }
  return acc;
}

// ---- route "staged" ----

template <int D>
__global__ void __launch_bounds__(THREADS)
sq_window_scan_kernel(const int* __restrict__ starts,  // (T, nprobe)
                      const int* __restrict__ lens,    // (T, nprobe)
                      const float* __restrict__ qs,    // (T, D)
                      const int8_t* __restrict__ codes,  // (N, D)
                      float* __restrict__ out,         // (T, nprobe * cap)
                      int nprobe, int cap) {
  __shared__ __align__(16) float q_sh[D];
  const int64_t t = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += THREADS) q_sh[d] = qs[t * D + d];
  __syncthreads();
  const float4* q4 = reinterpret_cast<const float4*>(q_sh);
  float* o = out + t * nprobe * int64_t(cap);
  for (int j = 0; j < nprobe; ++j) {
    const int start = starts[t * nprobe + j];
    const int len = min(lens[t * nprobe + j], cap);
    for (int i = threadIdx.x; i < cap; i += THREADS)
      o[int64_t(j) * cap + i] = i < len ? row_score<D>(codes + int64_t(start + i) * D, q4) : neg_inf();
  }
}

// ---- route "fused" ----

// The order-preserving key of a score (-0.0 below +0.0, as XLA's top_k and
// ops/sq_probe.py::topk_first order them), and back.
__device__ __forceinline__ uint32_t order_key(float s) {
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}
// Sorted descending, larger is better: the key, then the lower position.
__device__ __forceinline__ uint64_t pack(uint32_t key, int p) {
  return (uint64_t(key) << 32) | uint32_t(~uint32_t(p));
}

// Block-wide exclusive sum of v; every thread gets the total.  tmp: 32 ints
// of shared memory, free again when the call returns to every thread.
__device__ __forceinline__ int block_exclusive_sum(int v, int* tmp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();  // an earlier call's readers are done with tmp
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < FUSED_WARPS ? tmp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    tmp[lane] = w;
  }
  __syncthreads();
  total = tmp[FUSED_WARPS - 1];
  return x - v + (warp > 0 ? tmp[warp - 1] : 0);
}

// hist[bin] += 1 for each lane with on set; lanes of a warp with the same
// bin add once together (scores crowd into few bins of the top digit).
// Every lane of the warp calls it.
__device__ __forceinline__ void hist_add(uint32_t* hist, bool on, uint32_t bin) {
  const unsigned active = __ballot_sync(FULL, on);
  if (!on) return;
  const unsigned peers = __match_any_sync(active, bin);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], uint32_t(__popc(peers)));
}

// A slot of *counter for each lane with on set.  Every lane of the warp calls it.
__device__ __forceinline__ int warp_slot(bool on, int* counter) {
  const unsigned m = __ballot_sync(FULL, on);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(counter, __popc(m));
  base = __shfl_sync(FULL, base, 0);
  return base + __popc(m & ((1u << lane) - 1u));
}

struct Selection {
  int bin;      // the bin holding the need-th largest key
  int need_eq;  // keys of that bin still to take
  int cnt_eq;   // keys in that bin
};

// Of hist's nbins bins, the bin b with fewer than need keys above it and at
// least need at or above it.  Thread tid owns nbins / FUSED_THREADS bins,
// counting down from the top.  Every thread calls it and gets the answer.
__device__ Selection find_bin(const uint32_t* hist, int nbins, int need, int* tmp, Selection* sel_sh) {
  const int per = nbins / FUSED_THREADS;
  const int top = nbins - 1 - int(threadIdx.x) * per;
  int local = 0;
  for (int b = 0; b < per; ++b) local += int(hist[top - b]);
  int total;
  int acc = block_exclusive_sum(local, tmp, total);
  if (acc < need && need <= acc + local) {
    for (int b = 0; b < per; ++b) {
      const int c = int(hist[top - b]);
      if (need <= acc + c) {
        *sel_sh = Selection{top - b, need - acc, c};
        break;
      }
      acc += c;
    }
  }
  __syncthreads();
  const Selection s = *sel_sh;
  __syncthreads();
  return s;
}

// Sort surv[0, n) descending in place, n <= FUSED_MAX_DEPTH, by a bitonic
// network over the next power of two (zeros past n sort last).  Element
// i = m * FUSED_THREADS + tid stays in v[m] of thread tid: the steps of
// stride below 32 exchange between lanes, the wider ones go through shared
// memory.  Every thread calls it; surv is complete when it returns.
__device__ void sort_desc(uint64_t* surv, int n) {
  constexpr int PER = FUSED_MAX_DEPTH / FUSED_THREADS;
  const int tid = threadIdx.x;
  int P = 2;
  while (P < n) P <<= 1;
  uint64_t v[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int i = m * FUSED_THREADS + tid;
    v[m] = i < n ? surv[i] : 0;
  }
  const int held = P > FUSED_THREADS ? P / FUSED_THREADS : 1;  // elements a thread holds
  for (int k = 2; k <= P; k <<= 1) {
    int h = k >> 1;
    if (h >= 32) {  // each thread reads and writes only its own elements outside the steps
#pragma unroll
      for (int m = 0; m < PER; ++m)
        if (m * FUSED_THREADS + tid < P) surv[m * FUSED_THREADS + tid] = v[m];
      __syncthreads();
      for (; h >= 32; h >>= 1) {
        for (int idx = tid; idx < P / 2; idx += FUSED_THREADS) {
          const int i = (idx / h) * 2 * h + idx % h;
          const uint64_t a = surv[i], b = surv[i + h];
          if (((i & k) == 0) ? a < b : a > b) {
            surv[i] = b;
            surv[i + h] = a;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < PER; ++m)
        if (m * FUSED_THREADS + tid < P) v[m] = surv[m * FUSED_THREADS + tid];
    }
    for (; h > 0; h >>= 1) {
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        if (m >= held) break;
        const int i = m * FUSED_THREADS + tid;
        const uint64_t o = __shfl_xor_sync(FULL, v[m], h);
        // the pair's lower index keeps the larger value on a descending run
        v[m] = (((i & k) == 0) == ((i & h) == 0)) ? (v[m] > o ? v[m] : o) : (v[m] < o ? v[m] : o);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < PER; ++m)
    if (m * FUSED_THREADS + tid < n) surv[m * FUSED_THREADS + tid] = v[m];
  __syncthreads();
}

template <int D>
struct TokenRows {
  const int* pre;  // (nprobe + 1,) window prefix sums of the row counts
  const int* st;   // (nprobe,) window starts
  const int8_t* codes;
  const float4* q4;
  int n;

  __device__ __forceinline__ float score(int p, int& j) const {
    while (pre[j + 1] <= p) ++j;
    return row_score<D>(codes + int64_t(st[j] + p - pre[j]) * D, q4);
  }

  // f(p, valid, key) for each position, in order, in chunks of the block;
  // every thread calls f the same number of times.  keys: the stored keys,
  // or nullptr to score the rows again.
  template <typename F>
  __device__ __forceinline__ void visit(const uint32_t* keys, F f) const {
    int j = 0;
    for (int base = 0; base < n; base += FUSED_THREADS) {
      const int p = base + int(threadIdx.x);
      const bool valid = p < n;
      uint32_t key = 0;
      if (valid) key = keys ? keys[p] : order_key(score(p, j));
      f(p, valid, key);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(FUSED_THREADS, 2)
sq_window_topk_kernel(const int* __restrict__ starts,  // (T, nprobe)
                      const int* __restrict__ lens,    // (T, nprobe)
                      const float* __restrict__ qs,    // (T, D)
                      const int8_t* __restrict__ codes,  // (N, D)
                      float* __restrict__ out_s,       // (T, depth)
                      int* __restrict__ out_r,         // (T, depth)
                      int nprobe, int cap, int depth, int surv_cap, int keys_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* surv = reinterpret_cast<uint64_t*>(smem);          // (surv_cap,) survivors
  uint32_t* hist = reinterpret_cast<uint32_t*>(surv + surv_cap);  // (HIST_BINS,)
  int* pre = reinterpret_cast<int*>(hist + HIST_BINS);         // (nprobe + 1,)
  int* st = pre + nprobe + 1;                                  // (nprobe,)
  uint32_t* keys = reinterpret_cast<uint32_t*>(st + nprobe);   // (keys_cap,)
  __shared__ __align__(16) float q_sh[D];
  __shared__ int tmp[32];
  __shared__ Selection sel_sh;
  __shared__ int n_gt;

  const int64_t t = blockIdx.x;
  const int tid = threadIdx.x;
  for (int d = tid; d < D; d += FUSED_THREADS) q_sh[d] = qs[t * D + d];
  int n = 0;
  for (int j0 = 0; j0 < nprobe; j0 += FUSED_THREADS) {
    const int j = j0 + tid;
    int len = 0;
    if (j < nprobe) {
      len = min(max(lens[t * nprobe + j], 0), cap);
      st[j] = starts[t * nprobe + j];
    }
    int total;
    const int ex = block_exclusive_sum(len, tmp, total);
    if (j < nprobe) pre[j] = n + ex;
    n += total;
  }
  for (int b = tid; b < HIST_BINS; b += FUSED_THREADS) hist[b] = 0;
  if (tid == 0) {
    pre[nprobe] = n;
    n_gt = 0;
  }
  __syncthreads();

  const TokenRows<D> rows{pre, st, codes, reinterpret_cast<const float4*>(q_sh), n};
  const bool stored = n <= keys_cap;
  const bool pick = n > depth;  // else every row is taken
  // 1. score every row once: keep its key (or, when every row is taken,
  //    its survivor entry) and count its top digit
  {
    int j = 0;
    for (int base = 0; base < n; base += FUSED_THREADS) {
      const int p = base + tid;
      const bool valid = p < n;
      uint32_t key = 0;
      if (valid) {
        key = order_key(rows.score(p, j));
        if (!pick) surv[p] = pack(key, p);
        else if (stored) keys[p] = key;
      }
      if (pick) hist_add(hist, valid, key >> 21);
    }
  }
  __syncthreads();
  const int take = min(depth, n);
  if (pick) {
    const uint32_t* kp = stored ? keys : nullptr;
    // 2. radix select: the prefix of the depth-th largest key, 11 + 11 + 10 bits
    Selection s = find_bin(hist, HIST_BINS, depth, tmp, &sel_sh);
    uint32_t prefix = uint32_t(s.bin);
    int shift = 21;
    if (s.need_eq != s.cnt_eq) {
      for (int b = tid; b < HIST_BINS; b += FUSED_THREADS) hist[b] = 0;
      __syncthreads();
      rows.visit(kp, [&](int, bool valid, uint32_t key) {
        hist_add(hist, valid && (key >> 21) == prefix, (key >> 10) & 0x7ffu);
      });
      __syncthreads();
      s = find_bin(hist, HIST_BINS, s.need_eq, tmp, &sel_sh);
      prefix = (prefix << 11) | uint32_t(s.bin);
      shift = 10;
      if (s.need_eq != s.cnt_eq) {
        for (int b = tid; b < HIST_BINS; b += FUSED_THREADS) hist[b] = 0;
        __syncthreads();
        rows.visit(kp, [&](int, bool valid, uint32_t key) {
          hist_add(hist, valid && (key >> 10) == prefix, key & 0x3ffu);
        });
        __syncthreads();
        s = find_bin(hist, HIST_BINS / 2, s.need_eq, tmp, &sel_sh);
        prefix = (prefix << 10) | uint32_t(s.bin);
        shift = 0;
      }
    }
    // 3. take the keys above the prefix, and of those equal to it the
    //    need_eq at the lowest positions
    if (s.need_eq == s.cnt_eq) {
      rows.visit(kp, [&](int p, bool valid, uint32_t key) {
        const bool on = valid && (key >> shift) >= prefix;
        const int slot = warp_slot(on, &n_gt);
        if (on) surv[slot] = pack(key, p);
      });
    } else {
      const int above = depth - s.need_eq;
      int eq_base = 0;
      rows.visit(kp, [&](int p, bool valid, uint32_t key) {
        const bool gt = valid && (key >> shift) > prefix;
        const bool eq = valid && (key >> shift) == prefix;
        const int slot = warp_slot(gt, &n_gt);
        if (gt) surv[slot] = pack(key, p);
        int n_eq;
        const int rank = eq_base + block_exclusive_sum(eq ? 1 : 0, tmp, n_eq);
        if (eq && rank < s.need_eq) surv[above + rank] = pack(key, p);
        eq_base += n_eq;
      });
    }
  }
  // 4. sort the survivors, best first
  __syncthreads();
  sort_desc(surv, take);
  // 5. write scores and CSR rows, -inf / -1 past the real rows
  float* os = out_s + t * depth;
  int* orow = out_r + t * depth;
  for (int r = tid; r < depth; r += FUSED_THREADS) {
    if (r < take) {
      const uint64_t v = surv[r];
      const int p = int(~uint32_t(v));
      int lo = 0, hi = nprobe;  // pre[lo] <= p < pre[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid] <= p) lo = mid;
        else hi = mid;
      }
      os[r] = key_score(uint32_t(v >> 32));
      orow[r] = st[lo] + p - pre[lo];
    } else {
      os[r] = neg_inf();
      orow[r] = -1;
    }
  }
}

template <int D>
cudaError_t launch(const int* starts, const int* lens, const float* qs, const int8_t* codes,
                   float* out, int T, int nprobe, int cap, cudaStream_t stream) {
  sq_window_scan_kernel<D><<<T, THREADS, 0, stream>>>(starts, lens, qs, codes, out, nprobe, cap);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_topk(const int* starts, const int* lens, const float* qs, const int8_t* codes,
                        float* out_s, int* out_r, int T, int nprobe, int cap, int depth, int surv_cap,
                        int keys_cap, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sq_window_topk_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  sq_window_topk_kernel<D><<<T, FUSED_THREADS, smem, stream>>>(starts, lens, qs, codes, out_s, out_r,
                                                              nprobe, cap, depth, surv_cap, keys_cap);
  return cudaGetLastError();
}

// Dynamic shared memory of route "fused": survivors, histogram, windows, keys.
size_t topk_smem(int nprobe, int surv_cap, int keys_cap) {
  return size_t(surv_cap) * 8 + size_t(HIST_BINS) * 4 + (2 * size_t(nprobe) + 1) * 4 + size_t(keys_cap) * 4;
}

}  // namespace

extern "C" {

// starts/lens (T, nprobe) int32, qs (T, D) fp32, codes (N, D) int8 16-byte
// aligned, out (T, nprobe * cap) fp32.  Returns a cudaError_t: 0 when the
// launch was accepted.
int sq_window_scan_launch(const void* starts, const void* lens, const void* qs, const void* codes,
                          void* out, int T, int nprobe, int cap, int D, void* stream) {
  if (T < 1 || nprobe < 1 || cap < 1) return int(cudaErrorInvalidValue);
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(lens);
  const float* q = static_cast<const float*>(qs);
  const int8_t* c = static_cast<const int8_t*>(codes);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return int(launch<16>(st, ln, q, c, o, T, nprobe, cap, s));
    case 32: return int(launch<32>(st, ln, q, c, o, T, nprobe, cap, s));
    case 64: return int(launch<64>(st, ln, q, c, o, T, nprobe, cap, s));
    case 128: return int(launch<128>(st, ln, q, c, o, T, nprobe, cap, s));
    default: return int(cudaErrorInvalidValue);
  }
}

int sq_window_topk_max_depth() { return FUSED_MAX_DEPTH; }

// The keys a token keeps in shared memory by default at this nprobe and
// depth: what fits beside the rest of route "fused"'s dynamic shared memory
// in KEYS_SMEM_BUDGET (0: none fits).
int sq_window_topk_keys_room(int nprobe, int depth) {
  int surv_cap = 2;
  while (surv_cap < depth) surv_cap <<= 1;
  const size_t fixed = topk_smem(nprobe, surv_cap, 0);
  return fixed >= size_t(KEYS_SMEM_BUDGET) ? 0 : int((size_t(KEYS_SMEM_BUDGET) - fixed) / 4);
}

// Route "fused": starts/lens (T, nprobe) int32, qs (T, D) fp32, codes (N, D)
// int8 16-byte aligned -> out_s (T, depth) fp32, out_r (T, depth) int32.
// A token keeps its keys in shared memory when its real rows number at most
// keys_cap, else scores them again on each pass.  Returns a cudaError_t: 0
// when the launch was accepted.
int sq_window_topk_launch(const void* starts, const void* lens, const void* qs, const void* codes,
                          void* out_s, void* out_r, int T, int nprobe, int cap, int depth, int keys_cap,
                          int D, void* stream) {
  if (T < 1 || nprobe < 1 || cap < 1 || depth < 1 || depth > FUSED_MAX_DEPTH || keys_cap < 0 ||
      int64_t(nprobe) * cap > int64_t(INT32_MAX))
    return int(cudaErrorInvalidValue);
  const int64_t slots = int64_t(nprobe) * cap;
  int surv_cap = 2;
  while (surv_cap < depth && surv_cap < slots) surv_cap <<= 1;
  const size_t smem = topk_smem(nprobe, surv_cap, keys_cap);
  if (smem > size_t(MAX_DYNAMIC_SMEM)) return int(cudaErrorInvalidValue);
  const int* st = static_cast<const int*>(starts);
  const int* ln = static_cast<const int*>(lens);
  const float* q = static_cast<const float*>(qs);
  const int8_t* c = static_cast<const int8_t*>(codes);
  float* os = static_cast<float*>(out_s);
  int* orow = static_cast<int*>(out_r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return int(launch_topk<16>(st, ln, q, c, os, orow, T, nprobe, cap, depth, surv_cap, keys_cap, smem, s));
    case 32: return int(launch_topk<32>(st, ln, q, c, os, orow, T, nprobe, cap, depth, surv_cap, keys_cap, smem, s));
    case 64: return int(launch_topk<64>(st, ln, q, c, os, orow, T, nprobe, cap, depth, surv_cap, keys_cap, smem, s));
    case 128: return int(launch_topk<128>(st, ln, q, c, os, orow, T, nprobe, cap, depth, surv_cap, keys_cap, smem, s));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
