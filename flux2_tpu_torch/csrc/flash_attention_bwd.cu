// Flash-attention backward for the FLUX.2 DiT, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels flux2_tpu/ops/flash_attention.py:_bwd_dq_kernel
// (K3, :313) and :_bwd_dkv_kernel (K4, :363). Given q, k, v, dO (bf16
// [bh, s, 128]), the forward's natural-log row LSE and delta = rowsum(dO * O)
// (f32 [bh, s_q], delta computed by the wrapper from the bf16 O the forward
// wrote), each kernel recomputes the probabilities tile by tile,
//   p = exp2(s * scale * log2e - lse * log2e),   s = q . k,
// with keys >= S_k and, under the blocked span (queries in [q0, q1) see no
// key >= k0), the blocked cells at weight 0, and
//   K3: dQ = scale * sum_k p (dP - delta) K,         dP = dO V^T;
//   K4: dV = sum_q p^T dO,  dK = scale * sum_q (p^T (dP^T - delta)) Q,
//       in the transposed orientation (one block owns 64 keys and loops over
//       the queries); queries >= S_q contribute nothing (loaded as zeros and
//       their p forced to 0).
// p and dS enter the tensor cores as bf16 (mma.sync m16n8k16, f32
// accumulators), as P does in the forward.
//
// No atomics: K3 owns its dQ rows and K4 its dK/dV rows, as the TPU grids do,
// so both kernels give the same bits from run to run. The cost is that both
// recompute S = Q K^T (and dP): per head at (S_q, S_k) K3 does 3 and K4 4
// products of S_q * S_k * 128 (against the forward's 2), on about the bytes of
// the forward. At the Klein-4B 1024^2 shape (bh = 24, S = 4608) that is
// 7 * 2 * S^2 * 128 * 24 = 9.1e11 FLOP against ~170 MB: compute-bound, like
// the forward, and expected at ~3.5x its time with this design.
//
// Design, simple first (wgmma, TMA and warp specialisation are later work,
// measured against this version):
//   - 4 warps per block, each owning 16 rows of the block's 64-row tile;
//   - K3 keeps its warp's Q and dO fragments in registers and stages each
//     64-key tile of K (row-major and transposed) and V (row-major) in shared
//     memory; the dQ accumulator (16 x 128 f32 per warp) stays in registers;
//   - K4 keeps its block's K and V tiles in shared memory, stages each 64-query
//     tile of Q and dO (row-major and transposed) plus their LSE and delta,
//     and holds the dK and dV accumulators in registers (128 f32 a thread);
//   - both walk their tile in 16-column chunks, so an S and a dP chunk of
//     16 x 16 are live at once and go straight from accumulators to the A
//     fragment of the next product, as P does in K1.
// Shared memory is 53,248 bytes (K3) and 107,008 bytes (K4), both dynamic.
// The C entries launch on the caller's stream, do not synchronise, allocate
// nothing, and return a cudaError_t.

#include "flash_common.cuh"

namespace {

constexpr int kTile = 64;  // rows of a staged tile (keys in K3, queries in K4) and of a block's own tile
static_assert(kTile == kBlockK && kTile == kBlockQ, "one tile size for the forward and backward kernels");
constexpr int kRowBytes = kTile * kKStride * 2;  // a row-major 64 x 128 tile, padded
constexpr int kTrBytes = kD * kVtStride * 2;     // a transposed 128 x 64 tile, padded
constexpr int kDqSmem = 2 * kRowBytes + kTrBytes;
constexpr int kDkvSmem = 4 * kRowBytes + 2 * kTrBytes + 2 * kTile * 4;

// Stage rows [row_start, row_start + 64) of a [rows, 128] bf16 matrix into
// shared memory, row-major (stride kKStride) and/or transposed (stride
// kVtStride). Rows >= rows are zero. 16-byte loads, consecutive threads on
// consecutive rows (conflict-free transposed stores), as K1 stages V.
template <bool kRowMajor, bool kTransposed>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* __restrict__ src, int row_start, int rows,
                                           __nv_bfloat16* dst, __nv_bfloat16* dst_t) {
#pragma unroll
  for (int it = 0; it < kTile * kD / 8 / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i % kTile;
    const int c = (i / kTile) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row_start + r < rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row_start + r) * kD + c);
    if constexpr (kRowMajor) *reinterpret_cast<uint4*>(dst + r * kKStride + c) = val;
    if constexpr (kTransposed) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst_t[(c + j) * kVtStride + r] = e[j];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Rows [row, row + 8) of a warp's 16 x 128 f32 accumulator, times ``mul``, to bf16 rows of ``dst``.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, float (&acc)[kD / 8][4], float mul, int row0,
                                           int rows, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row0 < rows) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)row0 * kD + col) = pack_bf16(acc[dn][0] * mul, acc[dn][1] * mul);
    }
    if (row1 < rows) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)row1 * kD + col) = pack_bf16(acc[dn][2] * mul, acc[dn][3] * mul);
    }
  }
}

// K3: one block per (64-query tile, b*h); loop over 64-key tiles.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                    int s_q, int s_k, float scale, float scale_log2, int q0, int q1, int k0, int has_span) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // K tile, row-major
  __nv_bfloat16* vs = ks + kTile * kKStride;                      // V tile, row-major
  __nv_bfloat16* kts = vs + kTile * kKStride;                     // K tile, transposed

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qh = q + bh * s_q * kD;
  const __nv_bfloat16* kh = k + bh * s_k * kD;
  const __nv_bfloat16* vh = v + bh * s_k * kD;
  const __nv_bfloat16* doh = dout + bh * s_q * kD;

  const int row0 = blockIdx.x * kTile + warp * 16 + g;
  const int row1 = row0 + 8;
  const bool span[2] = {has_span && row0 >= q0 && row0 < q1, has_span && row1 >= q0 && row1 < q1};
  // Rows past S_q: Q and dO load as zero, so their dS is 0; they are not written.
  const float lse2[2] = {row0 < s_q ? lse[bh * s_q + row0] * kLog2e : 0.f,
                         row1 < s_q ? lse[bh * s_q + row1] * kLog2e : 0.f};
  const float dl[2] = {row0 < s_q ? delta[bh * s_q + row0] : 0.f, row1 < s_q ? delta[bh * s_q + row1] : 0.f};

  uint32_t qf[kD / 16][4];  // A fragments of Q (S = Q K^T) and dO (dP = dO V^T)
  uint32_t df[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int col = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qh, row0, col, s_q);
    qf[kk][1] = load_pair(qh, row1, col, s_q);
    qf[kk][2] = load_pair(qh, row0, col + 8, s_q);
    qf[kk][3] = load_pair(qh, row1, col + 8, s_q);
    df[kk][0] = load_pair(doh, row0, col, s_q);
    df[kk][1] = load_pair(doh, row1, col, s_q);
    df[kk][2] = load_pair(doh, row0, col + 8, s_q);
    df[kk][3] = load_pair(doh, row1, col + 8, s_q);
  }
  float acc[kD / 8][4];
  zero(acc);

  for (int kt = 0; kt < s_k; kt += kTile) {
    __syncthreads();  // every warp is done with the previous tile
    stage_tile<true, true>(kh, kt, s_k, ks, kts);
    stage_tile<true, false>(vh, kt, s_k, vs, nullptr);
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {  // 16 keys at a time
      float s[2][4], dp[2][4];
      zero(s);
      zero(dp);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b[2];
          load_b(b, ks, kKStride, c * 16 + j * 8 + g, kk * 16 + 2 * t);
          mma_16816(s[j], qf[kk], b);
          load_b(b, vs, kKStride, c * 16 + j * 8 + g, kk * 16 + 2 * t);
          mma_16816(dp[j], df[kk], b);
        }
      }
      // p from the LSE, then dS = p (dP - delta), in place of S.
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kt + c * 16 + j * 8 + 2 * t + (e & 1);
          const int r = e >> 1;
          float x = s[j][e] * scale_log2;
          if (span[r] && col >= k0) x = kNegInf;
          const float p = col < s_k ? exp2f(x - lse2[r]) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[r]);
        }
      }
      uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                       pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
      // dQ += dS K: B fragments from the transposed K tile.
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        uint32_t b[2];
        load_b(b, kts, kVtStride, dn * 8 + g, c * 16 + 2 * t);
        mma_16816(acc[dn], a, b);
      }
    }
  }
  store_rows(dq + bh * s_q * kD, acc, scale, row0, s_q, t);
}

// K4: one block per (64-key tile, b*h); loop over 64-query tiles.
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int s_q, int s_k, float scale, float scale_log2, int q0, int q1, int k0, int has_span) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // the block's K rows, row-major
  __nv_bfloat16* vs = ks + kTile * kKStride;                      // its V rows, row-major
  __nv_bfloat16* qs = vs + kTile * kKStride;                      // Q tile, row-major
  __nv_bfloat16* dos = qs + kTile * kKStride;                     // dO tile, row-major
  __nv_bfloat16* qts = dos + kTile * kKStride;                    // Q tile, transposed
  __nv_bfloat16* dots = qts + kD * kVtStride;                     // dO tile, transposed
  float* lse_s = reinterpret_cast<float*>(dots + kD * kVtStride);  // the tile's LSE * log2e
  float* delta_s = lse_s + kTile;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t bh = blockIdx.y;
  const __nv_bfloat16* qh = q + bh * s_q * kD;
  const __nv_bfloat16* doh = dout + bh * s_q * kD;
  const float* lse_h = lse + bh * s_q;
  const float* delta_h = delta + bh * s_q;

  const int key_start = blockIdx.x * kTile;
  const int krow = warp * 16 + g;  // this thread's first key row in the block's tile
  const int key[2] = {key_start + krow, key_start + krow + 8};
  stage_tile<true, false>(k + bh * s_k * kD, key_start, s_k, ks, nullptr);
  stage_tile<true, false>(v + bh * s_k * kD, key_start, s_k, vs, nullptr);

  float acc_dk[kD / 8][4], acc_dv[kD / 8][4];
  zero(acc_dk);
  zero(acc_dv);

  for (int qt = 0; qt < s_q; qt += kTile) {
    __syncthreads();  // the K/V stage is done, or every warp is done with the previous tile
    stage_tile<true, true>(qh, qt, s_q, qs, qts);
    stage_tile<true, true>(doh, qt, s_q, dos, dots);
    if (threadIdx.x < kTile) {
      const int qi = qt + threadIdx.x;
      lse_s[threadIdx.x] = qi < s_q ? lse_h[qi] * kLog2e : 0.f;
      delta_s[threadIdx.x] = qi < s_q ? delta_h[qi] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {  // 16 queries at a time
      float st[2][4], dpt[2][4];  // S^T = K Q^T and dP^T = V dO^T, 16 keys x 16 queries
      zero(st);
      zero(dpt);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, ks, kKStride, krow, kk * 16 + 2 * t);
        load_a(av, vs, kKStride, krow, kk * 16 + 2 * t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t b[2];
          load_b(b, qs, kKStride, c * 16 + j * 8 + g, kk * 16 + 2 * t);
          mma_16816(st[j], ak, b);
          load_b(b, dos, kKStride, c * 16 + j * 8 + g, kk * 16 + 2 * t);
          mma_16816(dpt[j], av, b);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = c * 16 + j * 8 + 2 * t + (e & 1);
          const int qi = qt + ql;
          const int kr = key[e >> 1];
          float x = st[j][e] * scale_log2;
          if (has_span && qi >= q0 && qi < q1 && kr >= k0) x = kNegInf;
          // pad queries (their LSE slot is 0, which alone would give p = 1) and pad keys: 0
          const float p = (qi < s_q && kr < s_k) ? exp2f(x - lse_s[ql]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - delta_s[ql]);
        }
      }
      uint32_t pa[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                        pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
      uint32_t da[4] = {pack_bf16(dpt[0][0], dpt[0][1]), pack_bf16(dpt[0][2], dpt[0][3]),
                        pack_bf16(dpt[1][0], dpt[1][1]), pack_bf16(dpt[1][2], dpt[1][3])};
      // dV += p^T dO and dK += dS^T Q: B fragments from the transposed tiles.
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        uint32_t b[2];
        load_b(b, dots, kVtStride, dn * 8 + g, c * 16 + 2 * t);
        mma_16816(acc_dv[dn], pa, b);
        load_b(b, qts, kVtStride, dn * 8 + g, c * 16 + 2 * t);
        mma_16816(acc_dk[dn], da, b);
      }
    }
  }
  store_rows(dk + bh * s_k * kD, acc_dk, scale, key[0], s_k, t);
  store_rows(dv + bh * s_k * kD, acc_dv, 1.f, key[0], s_k, t);
}

bool bad_sizes(int bh, int s_q, int s_k, int d) {
  return d != kD || bh <= 0 || bh > 65535 || s_q <= 0 || s_k <= 0;
}

}  // namespace

// q, dout, dq: contiguous bf16 [bh, s_q, 128]; k, v: [bh, s_k, 128]; lse, delta:
// contiguous f32 [bh, s_q]. Writes dq; returns a cudaError_t.
extern "C" int flux2_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                            const void* lse, const void* delta, void* dq,
                                            int bh, int s_q, int s_k, int d, float scale,
                                            int q0, int q1, int k0, int has_span, void* stream) {
  if (bad_sizes(bh, s_q, s_k, d)) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s_q + kTile - 1) / kTile, bh);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
      s_q, s_k, scale, scale * kLog2e, q0, q1, k0, has_span);
  return static_cast<int>(cudaGetLastError());
}

// As flux2_flash_attention_bwd_dq; writes dk and dv, contiguous bf16 [bh, s_k, 128].
extern "C" int flux2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                             const void* lse, const void* delta, void* dk, void* dv,
                                             int bh, int s_q, int s_k, int d, float scale,
                                             int q0, int q1, int k0, int has_span, void* stream) {
  if (bad_sizes(bh, s_q, s_k, d)) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s_k + kTile - 1) / kTile, bh);
  flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), s_q, s_k, scale, scale * kLog2e, q0, q1, k0, has_span);
  return static_cast<int>(cudaGetLastError());
}
