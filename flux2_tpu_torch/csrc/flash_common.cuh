// Constants and tensor-core helpers shared by the flash-attention kernels
// (flash_attention.cu: K1/K2 forward; flash_attention_bwd.cu: K3/K4 backward)
// over [bh, s, 128] bf16 tensors. The tile constants below are the backward's:
// 4 warps over 64-row tiles with mma.sync m16n8k16 (bf16 in, f32 accumulate).
// The forward has its own tiling (three warpgroups, 128-row tiles, TMA and
// wgmma), defined in flash_attention.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                 // head dim (every FLUX.2 config)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;    // 64 query rows per block
constexpr int kBlockK = 64;             // keys per tile
constexpr int kKStride = kD + 8;        // bf16 per padded row of the K tile
constexpr int kVtStride = kBlockK + 8;  // bf16 per padded row of the transposed V tile
constexpr float kNegInf = -1e30f;       // blocked-span logit, as the JAX package's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4):
//   A: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B: b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C: c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, int row, int col, int rows) {
  return row < rows ? *reinterpret_cast<const uint32_t*>(base + (size_t)row * kD + col) : 0u;
}

// A fragment of rows [m, m+16) x cols [k, k+16) of a row-major bf16 tile in
// shared memory (``stride`` bf16 per row); pass m = tile_row + g, k = col + 2t.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* base, int stride, int m, int k) {
  const __nv_bfloat16* p = base + m * stride + k;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * stride);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * stride + 8);
}

// B fragment of a product whose B operand is stored [n][k] row-major in shared
// memory: b0 = base[n][k..k+1], b1 = base[n][k+8..k+9]; pass n = col + g, k = row + 2t.
__device__ __forceinline__ void load_b(uint32_t* b, const __nv_bfloat16* base, int stride, int n, int k) {
  const __nv_bfloat16* p = base + n * stride + k;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

}  // namespace
