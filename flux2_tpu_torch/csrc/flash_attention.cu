// Flash-attention forward for the FLUX.2 DiT, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels flux2_tpu/ops/flash_attention.py:_flash_kernel /
// _flash_body (K1, no gradient) and :_flash_kernel_lse (K2, the forward of a
// differentiated call, which also writes each row's natural-log LSE for the
// backward kernels in flash_attention_bwd.cu). Both are one template body
// (flash_fwd_body<kWriteLse>), so they cannot drift apart; the LSE costs one
// log2f and one 4-byte store per row. Computes, per (batch*head), the non-causal
//   out = softmax(scale * Q K^T) V
// with an exact online softmax (running row max and row sum in f32, f32
// accumulation of P V), keys >= S_k masked on the ragged last tile, and the
// optional blocked span (queries in [q0, q1) see no key >= k0) applied in-tile.
//
// What bounds it on this card: at the 1024^2 Klein-4B shape (B=1, H=24,
// S=4608, D=128) one call is 4*S^2*D*H = 2.6e11 FLOP against 113 MB of
// q/k/v/o in HBM, about 2300 FLOP/byte: compute-bound, about 8x past the
// H100's ~295 FLOP/byte bf16 ridge. Each block re-reads a head's K and V
// (2.4 MB), which stays in the 50 MB L2. K1 is about 19% of a 1024^2 DiT
// step's FLOPs (25 calls, 6.5 of ~35 TFLOP; a count, not a time). The
// design's job is keeping the tensor cores fed; this first version does it
// simply:
//   - one block of 4 warps per (b*h, 64-query tile); each warp owns 16 query
//     rows and keeps its Q fragments in registers for the whole key loop;
//   - a loop over 64-key tiles, K staged row-major and V staged transposed in
//     shared memory (rows padded by 8 bf16 so fragment reads hit 32 banks);
//   - Q K^T and P V on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//     accumulate); the S accumulator's register layout is the A-fragment
//     layout of P, so P goes from registers to the second product as bf16;
//   - no cp.async/TMA pipelining, no wgmma, no warp specialisation: those are
//     later work, measured against this version.
// The C entry launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include "flash_common.cuh"

namespace {

template <bool kWriteLse>
__device__ __forceinline__ void flash_fwd_body(const __nv_bfloat16* __restrict__ q,
                                               const __nv_bfloat16* __restrict__ k,
                                               const __nv_bfloat16* __restrict__ v,
                                               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                               int s_q, int s_k, float scale_log2, int q0, int q1, int k0,
                                               int has_span) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vt[kD * kVtStride];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qh = q + bh * s_q * kD;
  const __nv_bfloat16* kh = k + bh * s_k * kD;
  const __nv_bfloat16* vh = v + bh * s_k * kD;
  __nv_bfloat16* oh = out + bh * s_q * kD;

  // This thread's two query rows.
  const int row0 = blockIdx.x * kBlockQ + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool span0 = has_span && row0 >= q0 && row0 < q1;
  const bool span1 = has_span && row1 >= q0 && row1 < q1;

  // Q fragments of the warp's 16 x 128 rows, held for the whole key loop.
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qh, row0, col, s_q);
    qf[kk][1] = load_pair(qh, row1, col, s_q);
    qf[kk][2] = load_pair(qh, row0, col + 8, s_q);
    qf[kk][3] = load_pair(qh, row1, col + 8, s_q);
  }

  float o[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running row max, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int kt = 0; kt < s_k; kt += kBlockK) {
    __syncthreads();  // every warp is done with the previous tile
    // Stage the tile: 16-byte chunks, consecutive threads on consecutive key
    // rows (conflict-free for both the K rows and the transposed V columns).
    // Rows past S_k are zero.
#pragma unroll
    for (int it = 0; it < kBlockK * kD / 8 / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i % kBlockK;
      const int c = (i / kBlockK) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (kt + r < s_k) {
        kv = *reinterpret_cast<const uint4*>(kh + (size_t)(kt + r) * kD + c);
        vv = *reinterpret_cast<const uint4*>(vh + (size_t)(kt + r) * kD + c);
      }
      *reinterpret_cast<uint4*>(ks + r * kKStride + c) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * kVtStride + r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 accumulator tiles of 8 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = ks + (j * 8 + g) * kKStride + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        b[1] = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[j], qf[kk], b);
      }
    }

    // Scale into the log2 domain, mask, and take the new row max.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt + j * 8 + 2 * t + (e & 1);
        const bool spanned = (e < 2) ? span0 : span1;
        float x = s[j][e] * scale_log2;
        if (col >= s_k) {
          x = -CUDART_INF_F;  // pad key: weight exactly 0
        } else if (spanned && col >= k0) {
          x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: P's accumulator tiles 2kk, 2kk+1 form the A fragment of keys
    // 16kk..16kk+15; V^T rows give the B fragments.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        const __nv_bfloat16* vrow = vt + (dn * 8 + g) * kVtStride + kk * 16 + 2 * t;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(vrow);
        b[1] = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_16816(o[dn], a, b);
      }
    }
  }

  // Row sums across the 4 threads of each row, then normalise and store.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const float inv0 = 1.f / l[0];
  const float inv1 = 1.f / l[1];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row0 < s_q) {
      *reinterpret_cast<uint32_t*>(oh + (size_t)row0 * kD + col) = pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
    }
    if (row1 < s_q) {
      *reinterpret_cast<uint32_t*>(oh + (size_t)row1 * kD + col) = pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
    }
  }
  if constexpr (kWriteLse) {
    if (t != 0) return;
    // Natural-log row LSE, as the JAX kernel returns it: m is the running max
    // in the log2 domain (logits * scale * log2e), so lse = (m + log2 l) * ln2.
    if (row0 < s_q) lse[bh * s_q + row0] = (m[0] + log2f(l[0])) * kLn2;
    if (row1 < s_q) lse[bh * s_q + row1] = (m[1] + log2f(l[1])) * kLn2;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                 int s_q, int s_k, float scale_log2, int q0, int q1, int k0, int has_span) {
  flash_fwd_body<false>(q, k, v, out, nullptr, s_q, s_k, scale_log2, q0, q1, k0, has_span);
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_lse_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int s_q, int s_k, float scale_log2, int q0, int q1, int k0,
                     int has_span) {
  flash_fwd_body<true>(q, k, v, out, lse, s_q, s_k, scale_log2, q0, q1, k0, has_span);
}

}  // namespace

// q, k, v, out: contiguous bf16 [bh, s, d] with d == 128; returns a cudaError_t.
extern "C" int flux2_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                         int bh, int s_q, int s_k, int d, float scale,
                                         int q0, int q1, int k0, int has_span, void* stream) {
  if (d != kD || bh <= 0 || bh > 65535 || s_q <= 0 || s_k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((s_q + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      s_q, s_k, scale * kLog2e, q0, q1, k0, has_span);
  return static_cast<int>(cudaGetLastError());
}

// As flux2_flash_attention_fwd, and lse: contiguous f32 [bh, s_q], the natural-log row LSE.
extern "C" int flux2_flash_attention_fwd_lse(const void* q, const void* k, const void* v, void* out, void* lse,
                                             int bh, int s_q, int s_k, int d, float scale,
                                             int q0, int q1, int k0, int has_span, void* stream) {
  if (d != kD || bh <= 0 || bh > 65535 || s_q <= 0 || s_k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((s_q + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_lse_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      s_q, s_k, scale * kLog2e, q0, q1, k0, has_span);
  return static_cast<int>(cudaGetLastError());
}
