// K9: byte-threshold dropout with its mask drawn by a counter-based Philox.
//
// Replaces the TPU kernel of colbert_tpu/ops/dropout_pallas.py (`_kernel`,
// called by `hw_dropout`, custom VJP): one random byte per element, the
// element kept where byte >= thr and then scaled by 256 / (256 - thr) in
// the input's dtype, dropped elements written as zero.  The backward pass
// is this same kernel on the gradient with the same seed: the mask is
// regenerated, never stored.
//
// Random bits: Philox4x32-10 (Salmon et al., SC'11), keyed by the 64-bit
// per-call seed, counter = (i mod 2^32, i div 2^32, 0, 0) for the i-th
// group of 16 elements.  Its four 32-bit output words give the 16 mask
// bytes, little end first: element 16*i + j takes byte j % 4 of word j / 4.
// ops/dropout.py::hw_dropout_ref computes the same stream with torch
// integer ops, and the two agree bit for bit.
//
// Bound: bytes.  The function reads each element once and writes it once
// (481 MB for the bf16 attention probabilities (68, 12, 384, 384) of the
// training step: 0.14 ms at 3.35 TB/s); ten Philox rounds per 16 elements
// are about 2 integer operations per byte, far below the card's integer
// rate.  Design: a grid-stride loop, one thread per 16 elements, 16-byte
// vector loads and stores where the pointers allow, nothing in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl key increments
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half from_f(float v) { return __float2half_rn(v); }
};

// `scale` is exactly representable in T, so the fp32 product of two T
// values is exact and one rounding gives T's own product (what the plain
// version computes).
template <typename T>
__device__ __forceinline__ T apply(T v, uint32_t byte, uint32_t thr, float scale) {
  return byte >= thr ? Cvt<T>::from_f(Cvt<T>::to_f(v) * scale) : Cvt<T>::from_f(0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, uint32_t k0, uint32_t k1,
               uint32_t thr, float scale, int vec_ok) {
  constexpr int kVecs = sizeof(T);  // 16 elements = sizeof(T) 16-byte vectors
  const long long groups = (n + 15) / 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < groups; i += stride) {
    const uint4 r = philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u), k0, k1);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    const long long e0 = i * 16;
    if (vec_ok && e0 + 16 <= n) {
      uint4 buf[kVecs];
      const uint4* src = reinterpret_cast<const uint4*>(x + e0);
#pragma unroll
      for (int q = 0; q < kVecs; ++q) buf[q] = src[q];
      T* v = reinterpret_cast<T*>(buf);
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = apply(v[j], (w[j >> 2] >> ((j & 3) * 8)) & 0xFFu, thr, scale);
      uint4* dst = reinterpret_cast<uint4*>(y + e0);
#pragma unroll
      for (int q = 0; q < kVecs; ++q) dst[q] = buf[q];
    } else {
      for (int j = 0; j < 16 && e0 + j < n; ++j)
        y[e0 + j] = apply(x[e0 + j], (w[j >> 2] >> ((j & 3) * 8)) & 0xFFu, thr, scale);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, long long n, unsigned long long seed, int thr, float scale,
                   int vec_ok, cudaStream_t stream) {
  const long long groups = (n + 15) / 16;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  dropout_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, (uint32_t)(seed & 0xFFFFFFFFull),
      (uint32_t)(seed >> 32), (uint32_t)thr, scale, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  vec_ok: x and y are 16-byte aligned.
// Returns a cudaError_t (0 on success).
extern "C" int dropout_launch(const void* x, void* y, long long n, int dtype, unsigned long long seed,
                              int thr, float scale, int vec_ok, void* stream) {
  if (n <= 0) return 0;
  if (thr < 1 || thr > 255) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, y, n, seed, thr, scale, vec_ok, s);
    case 1: return (int)launch<__nv_bfloat16>(x, y, n, seed, thr, scale, vec_ok, s);
    case 2: return (int)launch<__half>(x, y, n, seed, thr, scale, vec_ok, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
