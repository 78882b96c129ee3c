// The int8 activation prologue of K5 and K6 (quant_matmul.cu), hand-written
// for Hopper (sm_90a), behind one plain C entry:
//
//   flux2_quantize_rows  replaces the XLA prologue of
//       flux2_tpu/ops/quant_kernels.py:w8a8_matmul (:235-239, block = K) and
//       of w4a8_matmul (:342-350, block = 512): for every segment of
//       ``block`` columns of a row of x [M, K] (bf16 or f32),
//         xs = max(amax, 1e-30) * f32(1/127)     (amax = max |x| on the segment)
//         xq = clip(rint(x / xs), -127, 127)     (int8)
//       with xq int8 [M, K] and xs f32 [M, K / block].
//
// It is not a TPU kernel: XLA fuses this prologue into one pass outside the
// Pallas call. The port's plain version (ops/quant_kernels.py:quantize_rows)
// runs it as about seven torch kernels over x; this kernel reads x once and
// writes xq and xs once. It equals the plain version to the bit: the amax is
// exact in any float type, the scale is one f32 product by f32(1/127) (what
// torch multiplies by), x / xs is an IEEE division (__fdiv_rn: the build has
// no --use_fast_math), and rintf rounds half to even as torch.round and
// jnp.round do.
//
// What bounds it: bytes. At (M, K) = (4096, 3072) in bf16 it moves 25.2 MB in
// and 12.6 MB out, 11.3 us at 3.35 TB/s. Design: a group of threads per
// segment (a warp, four, or eight: see dispatch_quantize_rows), 16-byte loads held in
// registers between the max and the quantization (so x is read once; a
// segment beyond the registers' capacity is read again for the rest), the
// max by warp shuffles and, across warps, shared memory; the codes leave as
// one 8-byte (bf16 x) or 4-byte (f32 x) store per load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMinAmax = static_cast<float>(1e-30);     // torch.clamp's min, as torch casts it
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);  // the f32 factor torch multiplies by

// 16 bytes of x as floats (exact for bf16: its bits are the top half of an f32).
template <typename T>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& v, float (&f)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
};

template <>
struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};

template <typename T>
__device__ __forceinline__ float chunk_amax(const uint4& v) {
  float f[Chunk<T>::kN];
  Chunk<T>::unpack(v, f);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < Chunk<T>::kN; ++i) a = fmaxf(a, fabsf(f[i]));
  return a;
}

__device__ __forceinline__ uint32_t code(float f, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(f, scale)), -127.f), 127.f);
  return static_cast<uint32_t>(__float2int_rn(q)) & 0xFFu;
}

// The codes of one chunk at ``dst`` (8 bytes for bf16 x, 4 for f32 x).
template <typename T>
__device__ __forceinline__ void store_codes(int8_t* dst, const uint4& v, float scale) {
  float f[Chunk<T>::kN];
  Chunk<T>::unpack(v, f);
  uint32_t w[Chunk<T>::kN / 4];
#pragma unroll
  for (int i = 0; i < Chunk<T>::kN / 4; ++i) {
    w[i] = code(f[4 * i], scale) | code(f[4 * i + 1], scale) << 8 | code(f[4 * i + 2], scale) << 16 |
           code(f[4 * i + 3], scale) << 24;
  }
  if constexpr (Chunk<T>::kN == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = w[0];
  }
}

// kGroup threads per segment (a warp, four, or the CTA), kThreads / kGroup
// segments a CTA; kIters 16-byte loads a thread stay in registers.
template <typename T, int kGroup, int kIters>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs, long long segments,
                     int block) {
  constexpr int kN = Chunk<T>::kN;
  const long long seg = static_cast<long long>(blockIdx.x) * (kThreads / kGroup) + threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const bool live = seg < segments;  // uniform across the group
  const T* src = x + seg * block;    // row * K + b * block == (row * (K / block) + b) * block
  int8_t* dst = xq + seg * block;

  uint4 v[kIters];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int e = (i * kGroup + lane) * kN;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (live && e < block) v[i] = __ldg(reinterpret_cast<const uint4*>(src + e));
    amax = fmaxf(amax, chunk_amax<T>(v[i]));
  }
  for (int e = (kIters * kGroup + lane) * kN; live && e < block; e += kGroup * kN) {
    amax = fmaxf(amax, chunk_amax<T>(__ldg(reinterpret_cast<const uint4*>(src + e))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xFFFFFFFFu, amax, off));
  if constexpr (kGroup > 32) {  // across the group's warps
    __shared__ float warp_max[kThreads / 32];
    if (lane % 32 == 0) warp_max[threadIdx.x / 32] = amax;
    __syncthreads();
    const int first = (threadIdx.x / kGroup) * (kGroup / 32);
#pragma unroll
    for (int i = 0; i < kGroup / 32; ++i) amax = fmaxf(amax, warp_max[first + i]);
  }
  if (!live) return;

  const float scale = __fmul_rn(fmaxf(amax, kMinAmax), kInv127);
  if (lane == 0) xs[seg] = scale;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int e = (i * kGroup + lane) * kN;
    if (e < block) store_codes<T>(dst + e, v[i], scale);
  }
  for (int e = (kIters * kGroup + lane) * kN; e < block; e += kGroup * kN) {
    store_codes<T>(dst + e, __ldg(reinterpret_cast<const uint4*>(src + e)), scale);
  }
}

template <typename T, int kGroup, int kIters>
int launch_quantize_rows(const void* x, void* xq, void* xs, long long segments, int block, void* stream) {
  const long long blocks = (segments + kThreads / kGroup - 1) / (kThreads / kGroup);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  quantize_rows_kernel<T, kGroup, kIters><<<static_cast<unsigned>(blocks), kThreads, 0,
                                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), segments, block);
  return static_cast<int>(cudaGetLastError());
}

// The smallest group that holds the segment in at most 4 loads a thread (5
// for a whole CTA): a warp for K6's 512-blocks (2 loads a lane in bf16), four
// warps for K5's rows up to 4096 bf16 wide, the CTA for wider ones (a
// 9216-wide bf16 row: 4.5). Short per-thread work keeps many segments in
// flight on an SM, so loads, the divisions and stores of different
// segments overlap; wider f32 segments read the rest again.
template <typename T>
int dispatch_quantize_rows(const void* x, void* xq, void* xs, long long segments, int block, void* stream) {
  constexpr int kN = Chunk<T>::kN;
  if (block <= 32 * 4 * kN) return launch_quantize_rows<T, 32, 4>(x, xq, xs, segments, block, stream);
  if (block <= 128 * 4 * kN) return launch_quantize_rows<T, 128, 4>(x, xq, xs, segments, block, stream);
  return launch_quantize_rows<T, kThreads, 5>(x, xq, xs, segments, block, stream);
}

}  // namespace

// x [m, k] bf16 (x_f32 = 0) or f32 (x_f32 = 1), contiguous; xq int8 [m, k];
// xs f32 [m, k / block]. Needs k % block == 0, block a multiple of 16 bytes of
// x and of 8 codes, and 16-byte aligned x and xq. Returns a cudaError_t.
extern "C" int flux2_quantize_rows(const void* x, void* xq, void* xs, int m, int k, int block, int x_f32,
                                   void* stream) {
  if (m <= 0 || k <= 0 || block <= 0 || k % block || block % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(xq) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long segments = static_cast<long long>(m) * (k / block);
  if (x_f32) return dispatch_quantize_rows<float>(x, xq, xs, segments, block, stream);
  return dispatch_quantize_rows<__nv_bfloat16>(x, xq, xs, segments, block, stream);
}
