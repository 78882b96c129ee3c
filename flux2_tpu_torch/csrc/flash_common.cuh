// Constants and helpers of the flash-attention kernels over [bh, s, 128]
// bf16 tensors (flash_attention.cu: K1/K2 forward; flash_attention_bwd.cu:
// K3/K4 backward), on top of hopper_common.cuh (mbarriers, TMA, descriptors,
// the shared wgmma forms, the tensor-map encoder): the head dim, the exp2
// helper, the register-A bf16 wgmma and the 3D tensor map of a [bh, s, 128]
// tensor. Each .cu is its own translation unit; the anonymous namespace gives
// each its own copy.

#pragma once

#include <math_constants.h>

#include "hopper_common.cuh"

namespace {

constexpr int kD = 128;            // head dim (every FLUX.2 config)
constexpr int kBoxCols = 64;       // bf16 in one 128-byte swizzled row: a 128-wide row is two boxes
constexpr float kNegInf = -1e30f;  // blocked-span logit, as the JAX package's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kD == 2 * kBoxCols, "a 128-wide row is two swizzled boxes");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]; A in registers (the m16n8k16
// A-fragment layout per warp: a0 = (g, 2t..), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..),
// a3 = (g + 8, 2t + 8..)), B in shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FLUX2_ACC_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FLUX2_ACC64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// ---- tensor maps (host) ----------------------------------------------------

// A 3D map over a contiguous bf16 [bh, s, 128] tensor whose box is
// ``box_rows`` rows x 64 columns with the 128-byte swizzle; rows past s read
// as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, int bh, int s, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kD) * 2, static_cast<cuuint64_t>(s) * kD * 2};
  const cuuint32_t box[3] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
