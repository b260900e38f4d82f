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
// per-call seed, counter = (c mod 2^32, c div 2^32, 0, 0) with c = base + i
// for the i-th group of 16 elements.  Its four 32-bit output words give the
// 16 mask bytes, little end first: element 16*i + j takes byte j % 4 of
// word j / 4.  `base` (route "packed"; 0 for route "simple") is where a
// call's rows start in a larger tensor: a data-parallel rank draws the
// masks that one device draws for the same rows of the global batch.
// A call may also hold a slice of a larger tensor's rows (route "packed";
// a tensor-parallel position's heads or columns): its groups come in runs
// of `inner`, run r starting at full group r * stride, so that group g of
// the call draws counter base + (g div inner) * stride + (g mod inner) and
// the position drops what one device drops there.  Contiguous calls
// (stride == inner) take the kernels without that mapping.
// ops/dropout.py::hw_dropout_ref computes the same stream with torch
// integer ops, and both routes agree with it bit for bit.
//
// Bound: bytes.  The function reads each element once and writes it once
// (189 MB for the cross-encoder's bf16 attention probabilities (20, 16,
// 384, 384): 0.056 ms at 3.35 TB/s).  Its integer work comes next: ten
// Philox rounds a group, and in the first design ~12.6 SASS instructions
// an element in all.
//
// Two routes:
// * "packed" (the default).  The first design let each thread own a group
//   and write its 32 or 64 bytes as two or four 16-byte stores, so a warp's
//   store instruction wrote half of every sector it touched; it ran at
//   64-66% of the byte bound whether it computed Philox or not
//   (scripts/dropout_variants.py).  Here a warp takes tiles of 32 x
//   kChunks 16-byte chunks, lane l the chunks l + 32 j, so each load and
//   store instruction of a warp covers 512 contiguous bytes.  A chunk is
//   half a group (bf16, fp16) or a quarter (fp32), and its lane computes
//   its group's Philox itself: the lanes of a group repeat the rounds, which
//   the integer pipe affords.  A lane issues all its loads before the
//   rounds, whose keys come precomputed in the kernel's parameters (the
//   constant bank).  A tensor that fits in the card's L2 is read and
//   written plainly by the card's resident blocks (the SM count times the
//   kernel's occupancy, asked once), a larger one with evict-first hints by
//   a block for every 8 tiles (see load_in).  Each mask word is compared with thr
//   four bytes at once (SWAR, 3 integer instructions), its keep bits are
//   spread to 16- or 32-bit lane masks by PRMT's sign replication, and two
//   bf16/fp16 elements are scaled by one HMUL2 (fp32: one FMUL) and ANDed
//   with their mask.  `scale` is exactly representable in T, so the product
//   of two T values is exact in fp32 and HMUL2's one rounding (to nearest,
//   subnormals kept) gives what the plain version computes; a dropped
//   element is +0.0.  Views off 16-byte alignment and the groups after the
//   last whole tile take the first design's element-by-element path.
// * "simple" (the first design, on request only): one thread per group, 16
//   scalar selects, a grid capped at 132 x 16 blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;  // Philox multipliers
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;  // Weyl key increments
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

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

// 16 elements from element e0 one at a time, for the ragged end and unaligned views
template <typename T>
__device__ __forceinline__ void scalar_group(const T* __restrict__ x, T* __restrict__ y, long long e0, long long n,
                                             uint4 r, uint32_t thr, float scale) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  for (int j = 0; j < 16 && e0 + j < n; ++j)
    y[e0 + j] = apply(x[e0 + j], (w[j >> 2] >> ((j & 3) * 8)) & 0xFFu, thr, scale);
}

// ---- route "simple": the first design ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
simple_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, uint32_t k0, uint32_t k1,
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
      scalar_group(x, y, e0, n, r, thr, scale);
    }
  }
}

// ---- route "packed" ----

struct RoundKeys {  // the ten rounds' (k0, k1), kernel parameters: operands from the constant bank
  uint32_t k0[10], k1[10];
};

__device__ __forceinline__ uint4 philox_keyed(uint32_t lo, uint32_t hi, const RoundKeys& k) {
  uint32_t c0 = lo, c1 = hi, c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned long long p0 = (unsigned long long)kM0 * c0;  // one IMAD.WIDE: high and low words
    const unsigned long long p1 = (unsigned long long)kM1 * c2;
    const uint32_t n0 = (uint32_t)(p1 >> 32) ^ c1 ^ k.k0[r];
    const uint32_t n2 = (uint32_t)(p0 >> 32) ^ c3 ^ k.k1[r];
    c1 = (uint32_t)p1;
    c3 = (uint32_t)p0;
    c0 = n0;
    c2 = n2;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Bit 7 of each byte of the result: that byte of `w` is >= thr.  `bias` is
// (0x80 - (thr & 0x7F)) * 0x01010101: bit 7 of each byte of d tells
// (byte & 0x7F) >= (thr & 0x7F), with no carry between bytes; the byte's
// own bit 7 decides the rest (HI: thr >= 128).
template <bool HI>
__device__ __forceinline__ uint32_t keep_bits(uint32_t w, uint32_t bias) {
  const uint32_t d = (w & 0x7F7F7F7Fu) + bias;
  return HI ? (w & d) : (w | d);
}

// PRMT with sign replication: each selector nibble 0x8 | b fills its byte with bit 7 of byte b
__device__ __forceinline__ uint32_t spread(uint32_t keep, uint32_t sel) {
  uint32_t m;
  asm("prmt.b32 %0, %1, %1, %2;" : "=r"(m) : "r"(keep), "r"(sel));
  return m;
}

__device__ __forceinline__ uint32_t mul2(uint32_t a, __nv_bfloat162 s) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a), s);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t mul2(uint32_t a, __half2 s) {
  const __half2 p = __hmul2(*reinterpret_cast<const __half2*>(&a), s);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <typename T> struct Pair;  // the 32-bit two-element type of T
template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type of(float s) { return __float2bfloat162_rn(s); }
};
template <> struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type of(float s) { return __float2half2_rn(s); }
};
template <> struct Pair<float> {
  using type = float;
  static __device__ __forceinline__ type of(float s) { return s; }
};

// One 16-byte chunk, part `part` of its group (bf16/fp16: 8 elements, mask
// words 2 part and 2 part + 1; fp32: 4 elements, word `part`), in place.
template <typename T, bool HI>
__device__ __forceinline__ uint4 apply_chunk(uint4 v, uint4 r, int part, uint32_t bias, typename Pair<T>::type s) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t ka = keep_bits<HI>(part ? r.z : r.x, bias), kb = keep_bits<HI>(part ? r.w : r.y, bias);
    v.x = mul2(v.x, s) & spread(ka, 0x9988u);  // elements 0, 1: bytes 0, 1 of the first word
    v.y = mul2(v.y, s) & spread(ka, 0xBBAAu);  // elements 2, 3: bytes 2, 3
    v.z = mul2(v.z, s) & spread(kb, 0x9988u);
    v.w = mul2(v.w, s) & spread(kb, 0xBBAAu);
  } else {
    const uint32_t k = keep_bits<HI>(part & 2 ? (part & 1 ? r.w : r.z) : (part & 1 ? r.y : r.x), bias);
    v.x = __float_as_uint(__fmul_rn(__uint_as_float(v.x), s)) & spread(k, 0x8888u);
    v.y = __float_as_uint(__fmul_rn(__uint_as_float(v.y), s)) & spread(k, 0x9999u);
    v.z = __float_as_uint(__fmul_rn(__uint_as_float(v.z), s)) & spread(k, 0xAAAAu);
    v.w = __float_as_uint(__fmul_rn(__uint_as_float(v.w), s)) & spread(k, 0xBBBBu);
  }
  return v;
}

// Two ways through a tensor, by whether it fits in L2 (it may still be there
// from the kernel that wrote it, and the output stays for the one that reads
// it): plain loads and stores from a grid of the card's resident blocks
// striding over the tiles, or, past the L2's size, streaming ones
// (__ldcs/__stcs, evict first) from a block for every 8 tiles, which the
// block scheduler spreads.  Each way is the faster one at its sizes, by
// 5-7% over the 189 and 481 MB probabilities and 6-13% at the 31 MB hidden
// states (scripts/dropout_variants.py).
template <bool STREAM>
__device__ __forceinline__ uint4 load_in(const uint4* p) {
  if constexpr (STREAM) return __ldcs(p);
  else return *p;
}
template <bool STREAM>
__device__ __forceinline__ void store_out(uint4* p, uint4 v) {
  if constexpr (STREAM) __stcs(p, v);
  else *p = v;
}

constexpr int kChunks = 2;  // 16-byte chunks a lane takes in one pass of the loop

// A call's groups as a slice of a larger tensor: runs of `inner` groups, run
// r starting at full group r * (inner + skip).  g div inner is one
// multiply-high and a shift (the round-up method of Granlund and Montgomery,
// as CUTLASS's FastDivmod): mul = ceil(2^(31 + l) / inner), shr = l - 1 with
// l = ceil(log2 inner), exact for g < 2^31 (ops/dropout.py::divisor_magic
// computes the pair and the host checks the bound).
struct Slice {
  unsigned long long skip;  // stride - inner, in groups
  uint32_t inner, mul, shr;
};

__device__ __forceinline__ unsigned long long full_group(unsigned long long g, const Slice& s) {
  const uint32_t q = s.inner == 1 ? (uint32_t)g : __umulhi((uint32_t)g, s.mul) >> s.shr;
  return g + (unsigned long long)q * s.skip;
}

template <typename T, bool HI, bool STREAM, bool SLICED>
__global__ void __launch_bounds__(kThreads)
packed_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, const RoundKeys keys, uint32_t bias,
              uint32_t thr, float scale, int vec_ok, unsigned long long base, const Slice slice) {
  constexpr int kParts = sizeof(T);       // 16-byte chunks a group of 16 elements
  constexpr int kTile = 32 * kChunks;     // chunks a warp takes in one pass: lane + 32 j
  const typename Pair<T>::type s = Pair<T>::of(scale);
  const int lane = threadIdx.x & 31, part = lane % kParts;  // a lane's chunks are all this part of their group
  const long long tiles = vec_ok ? n / (kTile * 16 / (long long)sizeof(T)) : 0;
  const long long warps = (long long)gridDim.x * (kThreads / 32);
  const uint4* src = reinterpret_cast<const uint4*>(x);
  uint4* dst = reinterpret_cast<uint4*>(y);
  for (long long t = ((long long)blockIdx.x * kThreads + threadIdx.x) / 32; t < tiles; t += warps) {
    const long long c0 = t * kTile + lane;
    uint4 v[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) v[j] = load_in<STREAM>(src + c0 + 32 * j);
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      unsigned long long g = (unsigned long long)(c0 + 32 * j) / kParts;
      if constexpr (SLICED) g = full_group(g, slice);
      g += base;
      v[j] = apply_chunk<T, HI>(v[j], philox_keyed((uint32_t)g, (uint32_t)(g >> 32), keys), part, bias, s);
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) store_out<STREAM>(dst + c0 + 32 * j, v[j]);
  }
  // what the tiles leave (fewer than kTile chunks), or every group of an unaligned view
  const long long groups = (n + 15) / 16, stride = (long long)gridDim.x * kThreads;
  for (long long i = tiles * (kTile / kParts) + (long long)blockIdx.x * kThreads + threadIdx.x; i < groups;
       i += stride) {
    unsigned long long gi = (unsigned long long)i;
    if constexpr (SLICED) gi = full_group(gi, slice);
    gi += base;
    scalar_group(x, y, i * 16, n, philox_keyed((uint32_t)gi, (uint32_t)(gi >> 32), keys), thr, scale);
  }
}

// an attribute of a card, asked once per device (0 if the query fails)
int card_attribute(cudaDeviceAttr attr, int device, std::atomic<int>* cache) {
  int v = cache[device].load(std::memory_order_relaxed);
  if (v > 0) return v;
  if (cudaDeviceGetAttribute(&v, attr, device) != cudaSuccess) return 0;
  cache[device].store(v, std::memory_order_relaxed);
  return v;
}

// blocks of `kernel` resident on the whole card at kThreads threads: the
// SM count times the occupancy, asked once per device (0 if a query fails)
template <typename K>
int resident_blocks(K kernel, int device, std::atomic<int>* cache) {
  static std::atomic<int> sms_cache[kMaxDevices];
  int v = cache[device].load(std::memory_order_relaxed);
  if (v > 0) return v;
  int per_sm = 0;
  const int sms = card_attribute(cudaDevAttrMultiProcessorCount, device, sms_cache);
  if (sms <= 0 || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
    return 0;
  v = sms * per_sm;
  cache[device].store(v, std::memory_order_relaxed);
  return v;
}

cudaError_t failed_query() {
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
}

template <typename T, bool HI, bool STREAM, bool SLICED>
cudaError_t launch_packed_as(const void* x, void* y, long long n, const RoundKeys& keys, int thr, float scale,
                             int vec_ok, unsigned long long base, const Slice& slice, int device,
                             cudaStream_t stream) {
  constexpr long long kTileElems = 32 * kChunks * 16 / (long long)sizeof(T);
  const long long tiles = vec_ok ? n / kTileElems : 0;
  const long long rest = (n + 15) / 16 - tiles * kTileElems / 16;  // groups left to the element-by-element path
  const long long blocks_tiles = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const long long blocks_rest = (rest + kThreads - 1) / kThreads;
  long long blocks = blocks_tiles > blocks_rest ? blocks_tiles : blocks_rest;
  if (!STREAM) {
    static std::atomic<int> cache[kMaxDevices];
    const int cap = resident_blocks(packed_kernel<T, HI, STREAM, SLICED>, device, cache);
    if (cap <= 0) return failed_query();
    if (blocks > cap) blocks = cap;
  }
  const uint32_t bias = (0x80u - ((uint32_t)thr & 0x7Fu)) * 0x01010101u;
  packed_kernel<T, HI, STREAM, SLICED><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, keys, bias, (uint32_t)thr, scale, vec_ok, base, slice);
  return cudaGetLastError();
}

template <typename T, bool HI>
cudaError_t launch_packed(const void* x, void* y, long long n, unsigned long long seed, int thr, float scale,
                          int vec_ok, unsigned long long base, const Slice& slice, int device,
                          cudaStream_t stream) {
  static std::atomic<int> l2_cache[kMaxDevices];
  const int l2 = card_attribute(cudaDevAttrL2CacheSize, device, l2_cache);
  if (l2 <= 0) return failed_query();
  RoundKeys keys;
  uint32_t k0 = (uint32_t)(seed & 0xFFFFFFFFull), k1 = (uint32_t)(seed >> 32);
  for (int r = 0; r < 10; ++r, k0 += kW0, k1 += kW1) {
    keys.k0[r] = k0;
    keys.k1[r] = k1;
  }
  const bool streaming = (long long)sizeof(T) * n > l2;
  if (slice.skip) {
    if (streaming)
      return launch_packed_as<T, HI, true, true>(x, y, n, keys, thr, scale, vec_ok, base, slice, device, stream);
    return launch_packed_as<T, HI, false, true>(x, y, n, keys, thr, scale, vec_ok, base, slice, device, stream);
  }
  if (streaming)
    return launch_packed_as<T, HI, true, false>(x, y, n, keys, thr, scale, vec_ok, base, slice, device, stream);
  return launch_packed_as<T, HI, false, false>(x, y, n, keys, thr, scale, vec_ok, base, slice, device, stream);
}

template <typename T>
cudaError_t launch_simple(const void* x, void* y, long long n, unsigned long long seed, int thr, float scale,
                          int vec_ok, cudaStream_t stream) {
  const long long groups = (n + 15) / 16;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  simple_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, (uint32_t)(seed & 0xFFFFFFFFull),
      (uint32_t)(seed >> 32), (uint32_t)thr, scale, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int route, const void* x, void* y, long long n, unsigned long long seed, int thr, float scale,
                   int vec_ok, unsigned long long base, const Slice& slice, int device, cudaStream_t stream) {
  if (route == 1)
    return base || slice.skip ? cudaErrorInvalidValue : launch_simple<T>(x, y, n, seed, thr, scale, vec_ok, stream);
  if (thr >= 128) return launch_packed<T, true>(x, y, n, seed, thr, scale, vec_ok, base, slice, device, stream);
  return launch_packed<T, false>(x, y, n, seed, thr, scale, vec_ok, base, slice, device, stream);
}

cudaError_t dispatch(int dtype, int route, const void* x, void* y, long long n, unsigned long long seed, int thr,
                     float scale, unsigned long long base, const Slice& slice, int device, cudaStream_t stream) {
  const int vec_ok = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  switch (dtype) {
    case 0: return launch<float>(route, x, y, n, seed, thr, scale, vec_ok, base, slice, device, stream);
    case 1: return launch<__nv_bfloat16>(route, x, y, n, seed, thr, scale, vec_ok, base, slice, device, stream);
    case 2: return launch<__half>(route, x, y, n, seed, thr, scale, vec_ok, base, slice, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  route: 0 "packed", 1 "simple".
// `base`: the Philox counter of the first group (element 16 * base of a
// larger tensor whose rows this call holds); route "simple" takes 0 only.
// `inner`, `stride`, `mul`, `shr`: the call holds runs of `inner` groups,
// run r from group base + r * stride (0, 0, 0, 0: contiguous; route
// "packed" only; see Slice, the call's groups below 2^31).
// `device` is the tensors' card: made current for the launch if it is not,
// and the caller's restored after.  Returns a cudaError_t (0 on success).
extern "C" int dropout_launch_slice(const void* x, void* y, long long n, int dtype, unsigned long long seed,
                                    int thr, float scale, int route, int device, void* stream,
                                    unsigned long long base, unsigned long long inner, unsigned long long stride,
                                    unsigned int mul, unsigned int shr) {
  if (n <= 0) return 0;
  if (thr < 1 || thr > 255 || route < 0 || route > 1 || device < 0 || device >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  Slice slice{0ull, 1u, 0u, 0u};
  if (stride != inner) {
    if (inner == 0 || stride < inner || inner >= (1ull << 31) || (n + 15) / 16 >= (1ll << 31))
      return (int)cudaErrorInvalidValue;
    slice = Slice{stride - inner, (uint32_t)inner, mul, shr};
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return (int)err;
  err = dispatch(dtype, route, x, y, n, seed, thr, scale, base, slice, device, static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

// dropout_launch_slice of a contiguous call from counter 0
extern "C" int dropout_launch(const void* x, void* y, long long n, int dtype, unsigned long long seed, int thr,
                              float scale, int route, int device, void* stream) {
  return dropout_launch_slice(x, y, n, dtype, seed, thr, scale, route, device, stream, 0ull, 0ull, 0ull, 0u, 0u);
}
