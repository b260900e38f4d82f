// The top-r selection of the list scans' tensor-core routes (csrc/sq_probe.cu
// route "mma", csrc/pq4_scan.cu route "onehot"): the TPU kernels' tie rule as
// one total order on 64-bit keys, and branch-free sorting networks over them.
//
// The TPU kernels merge each 128-row block of a list into a held top-r: within
// a block the lowest row wins a tie, a block row beats an equal score held from
// an earlier block.  The result is the top r under (score desc, block desc,
// row asc), so any visiting order that keeps the best keys gives the same rows.
#pragma once

#include <stdint.h>

namespace topr {

constexpr int BLOCK_ROWS = 128;  // the TPU kernels' block: sets the tie rule

// A row's key in the top-r order: score descending, then 128-row block
// descending, then row ascending, as one 64-bit integer that is larger for
// the better row.  rel = row - the list's first block start.  -0.0 keys as
// +0.0 (they compare equal as scores).  0 is below every row's key: "none".
__device__ __forceinline__ uint64_t row_key(float v, int rel) {
  const uint32_t u = __float_as_uint(v + 0.0f);
  const uint32_t hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const uint32_t lo = uint32_t(rel) ^ uint32_t(BLOCK_ROWS - 1);  // in-block offset x -> 127 - x
  return (uint64_t(hi) << 32) | lo;
}

// The score of a key (-inf for none) and its rel.
__device__ __forceinline__ float key_score(uint64_t k) {
  const uint32_t kh = uint32_t(k >> 32);
  return k ? __uint_as_float((kh & 0x80000000u) ? (kh & 0x7fffffffu) : ~kh) : __int_as_float(0xff800000);
}
__device__ __forceinline__ int key_rel(uint64_t k) { return int(uint32_t(k) ^ uint32_t(BLOCK_ROWS - 1)); }

// Compare-exchange: the larger key to a (descending order).
__device__ __forceinline__ void cas(uint64_t& a, uint64_t& b) {
  const uint64_t x = a, y = b;
  a = x > y ? x : y;
  b = x > y ? y : x;
}

// Sorts 8 keys descending: the 19-comparator network of depth 6.
__device__ __forceinline__ void sort8_desc(uint64_t (&k)[8]) {
  constexpr int P[19][2] = {{0, 2}, {1, 3}, {4, 6}, {5, 7}, {0, 4}, {1, 5}, {2, 6}, {3, 7}, {0, 1}, {2, 3},
                            {4, 5}, {6, 7}, {2, 4}, {3, 5}, {1, 4}, {3, 6}, {1, 2}, {3, 4}, {5, 6}};
#pragma unroll
  for (int i = 0; i < 19; ++i) cas(k[P[i][0]], k[P[i][1]]);
}

// c (M keys, a descending run followed by an ascending one) sorted
// descending: the bitonic merge network.
template <int M>
__device__ __forceinline__ void bitonic_desc(uint64_t (&c)[M]) {
#pragma unroll
  for (int stride = M / 2; stride > 0; stride /= 2)
#pragma unroll
    for (int i = 0; i < M; ++i)
      if ((i ^ stride) > i) cas(c[i], c[i ^ stride]);
}

// h (the held top R, descending) becomes the top R of h and o (descending):
// h against o reversed is bitonic.  R is a power of two.
template <int R>
__device__ __forceinline__ void merge_desc(uint64_t (&h)[R], const uint64_t (&o)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) h[i] = h[i] > o[R - 1 - i] ? h[i] : o[R - 1 - i];
  bitonic_desc<R>(h);
}

constexpr int WALK_BATCH = 8;  // rows a token's walk sorts and merges at once

// One stage of a token's top-r walk over a score-tile column `col` (rows
// STRIDE floats apart, whose rel are rel0 .. rel0+n-1), 8 rows at a time:
// their keys sorted by a network, then merged with the held keys
// (descending): h against the batch reversed is bitonic, and a bitonic merge
// sorts it, keeping the best R.  Branch-free, so a warp's 32 tokens never
// wait on one another's inserts.
template <int R, int STRIDE>
__device__ __forceinline__ void walk_stage(uint64_t (&h)[R], const float* col, int rel0, int n) {
  constexpr int M = R > WALK_BATCH ? R : WALK_BATCH;  // the merge width
  for (int j0 = 0; j0 < n; j0 += WALK_BATCH) {
    uint64_t k[WALK_BATCH];
#pragma unroll
    for (int i = 0; i < WALK_BATCH; ++i)
      k[i] = j0 + i < n ? row_key(col[(j0 + i) * STRIDE], rel0 + j0 + i) : 0;
    sort8_desc(k);
    uint64_t c[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const uint64_t hv = i < R ? h[i] : 0;
      const uint64_t kv = M - 1 - i < WALK_BATCH ? k[M - 1 - i] : 0;
      c[i] = hv > kv ? hv : kv;
    }
    bitonic_desc<M>(c);
#pragma unroll
    for (int i = 0; i < R; ++i) h[i] = c[i];
  }
}

}  // namespace topr
