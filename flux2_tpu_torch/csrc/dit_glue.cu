// The DiT block's elementwise glue around its projections, fused, for Hopper
// (sm_90a), behind two plain C entries:
//
//   flux2_adaln_modulate (G1): out = modulate(layer_norm(x), shift, scale),
//       x [B, S, D] bf16, shift and scale [B, D] bf16 (rows of the block's
//       modulation tensor, so strided), out [B, S, D] bf16; the chain of
//       ops/normalization.py: layer_norm's f32 mean and centred variance,
//       y = bf16((x - mean) * rsqrt(var + 1e-6)), then bf16(1 + scale),
//       bf16(y * that) and bf16(. + shift).
//   flux2_qkv_heads (G2): one stream's q, k, v projections [B, S, H*128]
//       bf16 to the joint [B, H, S_joint, 128] buffers at token ``offset``;
//       q and k per (token, head) row: y = bf16(x * rsqrt(mean(x^2) + 1e-6)
//       * w) (ops/normalization.py:rms_norm), then RoPE on y in f32 at the
//       row's joint position, bf16(y * cos + rot(y) * sin) (ops/rope.py:
//       apply_rope); v only re-laid out.
//
// Neither replaces a TPU kernel: XLA fused this glue on the TPU. The port ran
// it as torch chains, about 13 launches a G1 call and 18 a q or k, each
// reading and writing the whole tensor, some in f32: at the Klein-4B single
// block's 1024^2 shape (S = 4608, D = 3072) a G1 call moved ~0.78 GB where one
// pass needs 57 MB, and q, k and v ~2.9 GB where one pass needs 175 MB.
//
// What bounds them: bytes. Each reads its inputs once and writes its outputs
// once; per element they do a few f32 operations. Designs:
//   - G1: a CTA per row, d / 16 threads, the row held in registers (two
//     16-byte loads a thread), so x is read once for the mean, the variance
//     and the output; the sums by warp shuffles, then across warps in shared
//     memory; the modulation in bf16x2 pairs. Many small CTAs keep rows at
//     every stage (load, reduce, store) in flight on an SM at once. On an
//     H100 at D = 3072-6144 this ran at 71-79% of the byte bound, level with
//     a plain 16-byte copy (75-78%); a warp a row (the row in one warp's
//     registers: 1.45 waves, all of them loading, then all storing) at
//     59-62%, and the same streamed through shared memory by cp.async at
//     44-56%.
//   - G2: a warp per (token, tensor) (grid.y picks q, k or v), 16 lanes a
//     head row (8 elements, 16 bytes a lane), two heads a pass and four passes
//     loaded before any is computed; the lane's cos and sin and norm weight
//     are loaded once for all heads; the row's sum of squares across its 16
//     lanes by shuffles. Stores are 256 contiguous bytes a head row.
// Both round where the chain rounds: every f32 operation is __fmul_rn /
// __fadd_rn / __fsub_rn, so nvcc contracts nothing into an FMA, the bf16
// roundings are round-to-nearest-even, the modulation's bf16x2 products and
// sums (mul.rn.bf16x2, add.rn.bf16x2) are correctly rounded (a product of two
// bf16 is exact in f32, and f32-then-bf16 rounding of a sum equals bf16 rounding
// since 24 >= 2 * 8 + 2), the means multiply by f32(1 / n) as torch's CUDA
// mean does, and rsqrtf is torch's rsqrt. The only freedom left is the order
// of a row's f32 sums. The build has no --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-6f;
constexpr int kHead = 128;      // G2's head dim
constexpr int kChunks = 2;            // G1: 16-byte chunks a thread
constexpr int kRowThreadsMax = 1024;  // G1: a CTA's threads, so rows up to 1024 * 16 bf16
constexpr int kTokenWarps = 8;  // G2: tokens a CTA
constexpr int kPasses = 4;      // G2: head pairs loaded before any is computed
constexpr uint32_t kOnes = 0x3F803F80u;  // bf16x2 (1, 1)

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float round_bf16(float a) { return __bfloat162float(__float2bfloat16_rn(a)); }

// bf16x2 a * b and a + b, each correctly rounded (sm_90; explicit .rn: never contracted into an FMA).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// f[0] + ... + f[7] pairwise: short dependency chains (the order is the kernels' freedom).
__device__ __forceinline__ float tree8(const float (&f)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(f[0], f[1]), __fadd_rn(f[2], f[3])),
                   __fadd_rn(__fadd_rn(f[4], f[5]), __fadd_rn(f[6], f[7])));
}

template <int kWidth>
__device__ __forceinline__ float lanes_sum(float a) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) a = __fadd_rn(a, __shfl_xor_sync(0xFFFFFFFFu, a, off));
  return a;
}

// The sum of a CTA's values, the same on every thread; ``red`` holds a float a warp.
__device__ __forceinline__ float block_sum(float a, float* red) {
  a = lanes_sum<32>(a);
  const int warp = threadIdx.x / 32, warps = blockDim.x / 32;
  __syncthreads();  // the previous sum's readers are done with red
  if (threadIdx.x % 32 == 0) red[warp] = a;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < warps; ++w) t = __fadd_rn(t, red[w]);
  return t;
}

// G1: a CTA per row, kChunks 16-byte chunks a thread (d / 16 threads).
__global__ void __launch_bounds__(kRowThreadsMax)
adaln_modulate_kernel(const __nv_bfloat16* __restrict__ x, long long x_batch, const __nv_bfloat16* __restrict__ shift,
                      long long shift_batch, const __nv_bfloat16* __restrict__ scale, long long scale_batch,
                      __nv_bfloat16* __restrict__ out, int s, int d) {
  __shared__ float red[kRowThreadsMax / 32];
  const long long row = blockIdx.x;
  const long long b = row / s;
  const int chunks = d / 8;
  const uint4* src = reinterpret_cast<const uint4*>(x + b * x_batch + (row % s) * d);
  const float inv_d = __frcp_rn(static_cast<float>(d));

  uint4 v[kChunks];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = i * blockDim.x + threadIdx.x;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < chunks) v[i] = __ldg(src + c);
    float f[8];
    unpack8(v[i], f);
    sum = __fadd_rn(sum, tree8(f));
  }
  const float mean = __fmul_rn(block_sum(sum, red), inv_d);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (i * blockDim.x + threadIdx.x < chunks) {
      float f[8];
      unpack8(v[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c = __fsub_rn(f[j], mean);
        f[j] = __fmul_rn(c, c);
      }
      sq = __fadd_rn(sq, tree8(f));
    }
  }
  const float r = rsqrtf(__fadd_rn(__fmul_rn(block_sum(sq, red), inv_d), kEps));

  const uint4* sh = reinterpret_cast<const uint4*>(shift + b * shift_batch);
  const uint4* sc = reinterpret_cast<const uint4*>(scale + b * scale_batch);
  uint4* dst = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = i * blockDim.x + threadIdx.x;
    if (c < chunks) {
      float f[8];
      unpack8(v[i], f);
      const uint4 shv = __ldg(sh + c), scv = __ldg(sc + c);
      const uint32_t sh2[4] = {shv.x, shv.y, shv.z, shv.w};
      const uint32_t sc2[4] = {scv.x, scv.y, scv.z, scv.w};
      uint32_t o2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t y = pack2(__fmul_rn(__fsub_rn(f[2 * j], mean), r), __fmul_rn(__fsub_rn(f[2 * j + 1], mean), r));
        o2[j] = add_bf16x2(mul_bf16x2(y, add_bf16x2(sc2[j], kOnes)), sh2[j]);
      }
      dst[c] = make_uint4(o2[0], o2[1], o2[2], o2[3]);
    }
  }
}

// G2's q or k head row (16 lanes, 8 elements a lane): RMSNorm, then RoPE.
__device__ __forceinline__ uint4 norm_rope(const uint4& xv, const float (&w)[8], const float (&c)[8],
                                           const float (&sn)[8]) {
  float f[8];
  unpack8(xv, f);
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(f[j], f[j]));
  const float r = rsqrtf(__fadd_rn(__fmul_rn(lanes_sum<16>(ss), 1.f / kHead), kEps));
  float y[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) y[j] = round_bf16(__fmul_rn(__fmul_rn(f[j], r), w[j]));
  uint4 o;
  uint32_t* o2 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int p = 0; p < 4; ++p) {  // pairs (2p, 2p + 1) as (real, imag): rot = (-y[2p + 1], y[2p])
    const int e0 = 2 * p, e1 = 2 * p + 1;
    const float a = __fadd_rn(__fmul_rn(y[e0], c[e0]), __fmul_rn(-y[e1], sn[e0]));
    const float bb = __fadd_rn(__fmul_rn(y[e1], c[e1]), __fmul_rn(y[e0], sn[e1]));
    o2[p] = pack2(a, bb);
  }
  return o;
}

__global__ void __launch_bounds__(kTokenWarps * 32)
qkv_heads_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ norm_q,
                 const __nv_bfloat16* __restrict__ norm_k, const float* __restrict__ cos,
                 const float* __restrict__ sin, __nv_bfloat16* __restrict__ out_q, __nv_bfloat16* __restrict__ out_k,
                 __nv_bfloat16* __restrict__ out_v, long long tokens, int s, int heads, int s_joint, int offset) {
  const long long token = static_cast<long long>(blockIdx.x) * kTokenWarps + threadIdx.x / 32;
  if (token >= tokens) return;  // uniform across the warp
  const int which = blockIdx.y;  // 0 q, 1 k, 2 v
  const int lane = threadIdx.x % 32, half = lane / 16, col = (lane % 16) * 8;
  const long long b = token / s;
  const int pos = offset + static_cast<int>(token % s);  // the row's joint position
  const __nv_bfloat16* src = (which == 0 ? q : which == 1 ? k : v) + token * heads * kHead + col;
  __nv_bfloat16* dst = (which == 0 ? out_q : which == 1 ? out_k : out_v) + (b * heads * s_joint + pos) * kHead + col;
  const long long head_stride = static_cast<long long>(s_joint) * kHead;

  if (which == 2) {
    for (int h0 = 0; h0 < heads; h0 += 2 * kPasses) {
      uint4 xv[kPasses];
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        const int h = h0 + 2 * u + half;
        if (h < heads) xv[u] = __ldg(reinterpret_cast<const uint4*>(src + h * kHead));
      }
#pragma unroll
      for (int u = 0; u < kPasses; ++u) {
        const int h = h0 + 2 * u + half;
        if (h < heads) *reinterpret_cast<uint4*>(dst + h * head_stride) = xv[u];
      }
    }
    return;
  }

  float w[8], c[8], sn[8];
  unpack8(__ldg(reinterpret_cast<const uint4*>((which == 0 ? norm_q : norm_k) + col)), w);
  const float* cp = cos + static_cast<long long>(pos) * kHead + col;
  const float* sp = sin + static_cast<long long>(pos) * kHead + col;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 c4 = __ldg(reinterpret_cast<const float4*>(cp + 4 * i));
    const float4 s4 = __ldg(reinterpret_cast<const float4*>(sp + 4 * i));
    c[4 * i] = c4.x, c[4 * i + 1] = c4.y, c[4 * i + 2] = c4.z, c[4 * i + 3] = c4.w;
    sn[4 * i] = s4.x, sn[4 * i + 1] = s4.y, sn[4 * i + 2] = s4.z, sn[4 * i + 3] = s4.w;
  }
  for (int h0 = 0; h0 < heads; h0 += 2 * kPasses) {
    uint4 xv[kPasses];
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int h = h0 + 2 * u + half;
      xv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (h < heads) xv[u] = __ldg(reinterpret_cast<const uint4*>(src + h * kHead));
    }
#pragma unroll
    for (int u = 0; u < kPasses; ++u) {
      const int h = h0 + 2 * u + half;
      const uint4 o = norm_rope(xv[u], w, c, sn);  // every lane: the shuffles need the whole warp
      if (h < heads) *reinterpret_cast<uint4*>(dst + h * head_stride) = o;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x rows of d contiguous bf16, batch b at x + b * x_batch (elements), row t of
// it at + t * d; shift / scale rows [b] at + b * *_batch; out contiguous
// [b, s, d]. Needs d % 8 == 0, d <= 16384, every pointer 16-byte aligned and
// every batch stride a multiple of 8. Returns a cudaError_t.
extern "C" int flux2_adaln_modulate(const void* x, long long x_batch, const void* shift, long long shift_batch,
                                    const void* scale, long long scale_batch, void* out, int b, int s, int d,
                                    void* stream) {
  if (b <= 0 || s <= 0 || d <= 0 || d % 8 || d > kRowThreadsMax * kChunks * 8 || x_batch % 8 || shift_batch % 8 ||
      scale_batch % 8 || !aligned16(x) || !aligned16(shift) || !aligned16(scale) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(b) * s;
  if (rows > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((d / 8 + kChunks - 1) / kChunks + 31) / 32 * 32;
  adaln_modulate_kernel<<<static_cast<unsigned>(rows), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), x_batch, static_cast<const __nv_bfloat16*>(shift), shift_batch,
      static_cast<const __nv_bfloat16*>(scale), scale_batch, static_cast<__nv_bfloat16*>(out), s, d);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v contiguous [b, s, heads * 128] bf16; norm_q, norm_k [128] bf16; cos,
// sin contiguous [>= offset + s, 128] f32; out_q, out_k, out_v contiguous
// [b, heads, s_joint, 128] bf16, written at tokens [offset, offset + s). Every
// pointer 16-byte aligned. Returns a cudaError_t.
extern "C" int flux2_qkv_heads(const void* q, const void* k, const void* v, const void* norm_q, const void* norm_k,
                               const void* cos, const void* sin, void* out_q, void* out_k, void* out_v, int b, int s,
                               int heads, int s_joint, int offset, void* stream) {
  const void* ptrs[] = {q, k, v, norm_q, norm_k, cos, sin, out_q, out_k, out_v};
  for (const void* p : ptrs) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b <= 0 || s <= 0 || heads <= 0 || offset < 0 || offset + s > s_joint) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tokens = static_cast<long long>(b) * s;
  const long long blocks = (tokens + kTokenWarps - 1) / kTokenWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), 3);
  qkv_heads_kernel<<<grid, kTokenWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(norm_q),
      static_cast<const __nv_bfloat16*>(norm_k), static_cast<const float*>(cos), static_cast<const float*>(sin),
      static_cast<__nv_bfloat16*>(out_q), static_cast<__nv_bfloat16*>(out_k), static_cast<__nv_bfloat16*>(out_v),
      tokens, s, heads, s_joint, offset);
  return static_cast<int>(cudaGetLastError());
}
