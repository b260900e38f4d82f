// IVF list scans of the sq codec for Hopper (sm_90a), bound with ctypes.
//
// Replaces two TPU kernels of colbert_tpu/ops/sq_probe_batched.py:
//   K6  _kernel      (sq_probe_batched.py:221, reached through sq_batch_list_scan)
//   K7  _hot_kernel  (sq_probe_batched.py:345, reached through sq_hot_list_scan)
// One kernel template; `HOT` switches where the tokens and the list come from.
//
// What it computes.  A work unit is one IVF list and up to 128 query tokens:
//   K6: one slot of the dense schedule (slot s scans list s % K for the
//       tokens qidx[s, :], -1 empty); qs holds the projected queries
//       already rounded to bf16, as the TPU kernel rounds qsT;
//   K7: one hot list (hot_ids[h], -1 none) for a tile of 128 consecutive
//       tokens; qs in fp32, as the TPU kernel's bands are fp32.
// Every row of the list, [offsets[l], offsets[l+1]) of the CSR codes
// (N, D) int8, is scored against every token of the unit,
//   score = sum_d float(code[row, d]) * qs[token, d]      fp32 accumulation,
// and each token keeps a running top-r of (score, global CSR row).
//
// Tie rule, as the TPU kernel merges (sq_probe_batched.py:298-336): the list
// is cut into 128-row blocks that start at offsets[l] rounded down to a
// multiple of 32 (the TPU's DMA windows); within a block the lowest row wins
// a tie, a block row beats an equal score held from an earlier block, and
// every entry taken removes one row, so duplicate scores all survive.  Rows
// are visited in ascending order, so inserting each row before the first
// held entry it beats reproduces that merge exactly.  Unfilled entries are
// (-inf, -1).
//
// Outputs: K6 (S, r, tpl) for slots whose qidx[s, 0] >= 0 (an empty slot
// is skipped and its output left unwritten: no pair ever reads it; empty
// positions of a filled slot get -inf / -1); K7 (H, r, T) for hot_ids[h]
// >= 0 (a -1 entry is skipped and left unwritten: no pair reads it).
//
// What bounds it: the codes are small (D bytes a row) and each row is
// multiplied against up to 128 tokens, so the work is D FMAs per (row,
// token) on the CUDA cores.  The design converts each 32-row chunk of codes
// to fp32 in shared memory once per block (int8->fp32 conversion runs at a
// quarter of the FMA rate, so no thread converts rows it shares), keeps its
// token's query in registers, and keeps the top-r in registers.  Most of
// K6's 8*K dense slots are empty: their blocks read one int and exit.

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
