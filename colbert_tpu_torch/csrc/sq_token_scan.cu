// Token-major sq list-window scan for Hopper (sm_90a), bound with ctypes.
//
// Replaces K10, the TPU kernel _kernel of colbert_tpu/ops/sq_probe_pallas.py:40
// (pallas_call at :121, reached through sq_list_scan from ivf_probe_sq when
// serve.probe_impl="token").
//
// What it computes.  For each query token t and each of its nprobe windows
// (start = starts[t, j], len = lens[t, j]: the rows of one probed IVF list
// in the CSR codes (N, D) int8), slot (t, j * cap + i) of the output
// (T, nprobe * cap) fp32 is
//   qs[t] . codes[start + i]   for i < len,      -inf for len <= i < cap,
// summed in fp32 with qs in fp32, as the TPU kernel keeps its query bands
// (sq_probe_pallas.py:54).  The TPU kernel aligns each window down to 32
// rows and pads cap to a multiple of 128 for its DMA and stores; neither
// changes which rows are scored or the (probe, row) order of the columns,
// so here a window is exactly the list and cap is the longest list.
//
// What bounds it: the output.  T * nprobe * cap fp32 values (546 MB at the
// serving point, 2,304 tokens x 128 lists x cap 463) are written once; the
// codes of the probed lists (20.5 MB in all) are re-read from L2 by every
// token that probes them.  The design: one block per token, its query in
// shared memory (read as broadcasts), one thread per slot, consecutive
// threads on consecutive slots, so the stores are coalesced and a slot
// past the list's end costs one store.  A row's D int8 codes are read with
// 16-byte loads and widened with a byte permute into the exponent field of
// 2^23 (exact, and cheaper than the conversion instruction), then 64 FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// fp32 value of signed byte k of v.  (v ^ 0x80808080) holds b + 128 in each
// byte; placed in the low byte of the fp32 pattern of 2^23 it is 2^23 + b + 128.
__device__ __forceinline__ float byte_value(uint32_t biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + k)) - 8388736.0f;
}

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
    for (int i = threadIdx.x; i < cap; i += THREADS) {
      float acc = neg_inf();
      if (i < len) {
        const uint4* row = reinterpret_cast<const uint4*>(codes + int64_t(start + i) * D);
        acc = 0.0f;
#pragma unroll
        for (int v = 0; v < D / 16; ++v) {
          const uint4 c = __ldg(row + v);
          const uint32_t w[4] = {c.x ^ 0x80808080u, c.y ^ 0x80808080u, c.z ^ 0x80808080u,
                                 c.w ^ 0x80808080u};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 q = q4[4 * v + k];
            acc = fmaf(byte_value(w[k], 0), q.x, acc);
            acc = fmaf(byte_value(w[k], 1), q.y, acc);
            acc = fmaf(byte_value(w[k], 2), q.z, acc);
            acc = fmaf(byte_value(w[k], 3), q.w, acc);
          }
        }
      }
      o[int64_t(j) * cap + i] = acc;
    }
  }
}

template <int D>
cudaError_t launch(const int* starts, const int* lens, const float* qs, const int8_t* codes,
                   float* out, int T, int nprobe, int cap, cudaStream_t stream) {
  sq_window_scan_kernel<D><<<T, THREADS, 0, stream>>>(starts, lens, qs, codes, out, nprobe, cap);
  return cudaGetLastError();
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

}  // extern "C"
