// PQ4 fast-scan list scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces K8, the TPU kernel _kernel of colbert_tpu/ops/pq4.py:125
// (pallas_call at :254, reached through pq4_block_scan and ivf_probe_pq4).
//
// What it computes.  For each query token t and each of its nprobe probed
// IVF lists l = lists[t, j], every CSR row x of l (rows [offsets[l],
// offsets[l+1]) of the packed codes, m/2 bytes a row, byte jj holding
// nibble 2jj in its low and nibble 2jj+1 in its high half) is scored
//   score = sum_{jj} lut[t, 2jj, lo(x, jj)]  +  sum_{jj} lut[t, 2jj+1, hi(x, jj)]
// in fp32, over the token's LUT (m x 16 entries) already rounded to bf16
// by the wrapper, as the TPU kernel's bf16 LUT planes are; the even and the
// odd subspaces are summed apart and added, as the TPU kernel adds its two
// nibble planes.  Each (token, list) keeps its top r (score, CSR row), best
// first, written to out[(t * nprobe + j) * r + i]; unfilled entries are
// (-inf, -1), so an empty list yields only those.  The TPU kernel instead
// writes a dense (K, r, T_pad) pair over every list and token (604 MB at
// the serving point, almost all unread); this output is the (T, nprobe, r)
// subset that ivf_probe_pq4 reads.
//
// Tie rule, as the TPU kernel merges (pq4.py:165-193): blocks of 128 rows
// counted from the list start (no 32-row alignment); within a block the
// lowest row wins a tie, a block row beats an equal score held from an
// earlier block, and among equal scores the block's rows go first.  The
// result is the top r under the total order (score desc, block desc, row
// asc), which is what `before` below compares: each lane keeps its own
// top r of the rows it scored, and the warp merges the 32 lists by that
// order, so the selection equals the TPU merge's, duplicate rows included.
//
// What bounds it: the lookups.  Each row costs m shared-memory loads (one
// per subspace) and m fp32 adds, and the codes, 20.5 MB at the serving
// point, stay in the 50 MB L2 while every probing token re-reads its lists.
// The design: one block per token holds that token's LUT in shared memory
// (8 KB at m = 128); one warp per probed list, one lane per row, so the 32
// lanes of a warp look up one subspace at a time, 16 consecutive words:
// 16 banks, no conflict, and lanes with the same nibble share a broadcast.
// A lane reads its row's code bytes with 16-byte loads, keeps its top r in
// registers, and the warp merges the lanes' lists with r rounds of shuffles.

#include <cuda_runtime.h>
#include <stdint.h>

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

extern "C" {

// The most entries per (token, list) the kernel keeps; the wrapper checks it first.
int pq4_scan_max_r() { return 16; }

// lists (T, nprobe) int32, offsets (K+1,) int32, lut (T, 2*bpr, 16) fp32,
// codes (N, bpr) int8 16-byte aligned, out (T, nprobe, r).  Returns a
// cudaError_t: 0 when the launch was accepted.
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

}  // extern "C"
