// Quantized matmuls for the FLUX.2 DiT and the Qwen3 encoder, hand-written for
// Hopper (sm_90a). Three kernels, each behind a plain C entry:
//
//   K5  flux2_w8a8_matmul   replaces flux2_tpu/ops/quant_kernels.py:_kernel_w8a8 (:182)
//       out[m, n] = float(sum_k xq[m, k] * wq[n, k]) * (xs[m] * ws[n])
//       xq int8 [M, K], xs f32 [M], wq int8 [N, K], ws f32 [N]; the int32 sum
//       spans all of K and the f32 epilogue runs once, as on the TPU.
//       Overflow: |sum| <= K * 127 * 127, 9216 * 16129 = 1.5e8 for Klein-4B's
//       largest K (3.0e8 for Dev's K = 18432), far inside int32's 2.1e9.
//   K6  flux2_w4a8_matmul   replaces quant_kernels.py:_kernel_w4a8 (:282)
//       per 512-wide K block b: an int32 sum of xq by the unpacked int4 codes,
//       then acc += float(sum) * (xs[m, b] * ws[n, b]) in f32. Codes are
//       split-half packed ([N, K/2] uint8): in block b, byte r of row n holds
//       code k = 512b + r in its low nibble and k = 512b + 256 + r in its high
//       nibble, each offset by 8. xs f32 [M, K/512], ws f32 [N, K/512].
//   K7  flux2_dequant_matmul replaces quant_kernels.py:_kernel_int8 (:41) / _kernel_int4 (:66)
//       w[n, k] = bf16(codes[n, k] * scale[n, k/64] + bias[n, k/64]) (f32 math),
//       out = bf16(x . w^T) with f32 accumulation; x bf16 [M, K]. qint8 codes
//       are uint8 [N, K]; int4 codes are [N, K/2] interleaved (low nibble =
//       even k), unlike K6's.
//
// What bounds them on the card. K5 at the 1024^2 image projections
// (M=4096, K=3072, N=3072) does 2*M*N*K = 7.7e10 int ops on ~25 MB of
// operands: compute-bound against the 1,979 TOPS int8 dense peak, of which
// mma.sync without wgmma reaches a fraction. At the modulation shapes
// (M=1..3, K=3072, N=18432) it is bound by the 57 MB of weight bytes
// (~17 us at 3.35 TB/s). K6 does the same int work plus the nibble unpack and
// one f32 rescale per 512-block; it moves half K5's weight bytes. K7 is a
// bf16 GEMM (989 TFLOP/s dense peak) with an f32 dequant of every weight
// element in each block that reads it: at large M that per-block dequant,
// repeated for every M tile, is ALU work the bf16 GEMM does not have.
//
// The design is the simple, right one, a base for later work (wgmma, TMA and
// warp specialisation are not used):
//   - one block of 8 warps per 128 x 128 output tile; warp (wm, wn) owns a
//     64 x 32 sub-tile, 4 x 4 mma tiles, accumulators in registers;
//   - K5 and K6 use mma.sync.m16n8k32 s8 x s8 -> s32; K7 uses
//     mma.sync.m16n8k16 bf16 x bf16 -> f32, with the fragment code of
//     csrc/flash_attention.cu;
//   - tiles are 64 bytes of K (int8) or 64 elements (bf16) per row, double
//     buffered in shared memory with cp.async; rows are padded (80 bytes for
//     int8, 72 bf16 for bf16) so the 32-bit fragment loads of a warp hit 32
//     distinct banks; rows >= M are zero-filled by cp.async and not stored;
//   - K6 unpacks nibbles in registers (two per-byte subtractions per 32-bit
//     word), since Hopper has no int4 mma; K7 loads the next tile's codes
//     into registers while the current tile computes, then dequantizes them
//     into shared memory;
//   - the f32 epilogues use __fmul_rn / __fadd_rn, so no multiply-add is
//     contracted: K5 and K6 perform the same f32 operations in the same order
//     as their plain versions in ops/quant_kernels.py.
// Each C entry launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 along M x 4 along N
constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16;  // m16 tiles per warp
constexpr int kNT = kWarpN / 8;   // n8 tiles per warp

constexpr int kTileK8 = 64;                       // int8 K bytes per tile row
constexpr int kStride8 = kTileK8 + 16;            // padded int8 row, bytes
constexpr int kTile8Bytes = kBM * kStride8;       // one 128-row int8 tile
constexpr int kW4Block = 512;                     // K6's K block
constexpr int kTileKbf = 64;                      // bf16 K elements per tile row
constexpr int kStrideBf = kTileKbf + 8;           // padded bf16 row, elements
constexpr int kTileBfElems = kBM * kStrideBf;     // one 128-row bf16 tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 writes zeros (rows past M).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// D[16x8] += A[16x32] * B[32x8], s8 inputs, s32 accumulators.
// Fragments (g = lane / 4, t = lane % 4), each register 4 consecutive k:
//   A: a0 = (g, 4t..), a1 = (g+8, 4t..), a2 = (g, 16+4t..), a3 = (g+8, 16+4t..)
//   B: b0 = (k 4t.., n g), b1 = (k 16+4t.., n g)
//   C: c0,c1 = (g, 2t..2t+1), c2,c3 = (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, f32 accumulators (layout as K1's).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const void* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Four packed bytes -> the four int8 codes of their low / high nibbles (minus 8).
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t p) { return __vsub4(p & 0x0F0F0F0Fu, 0x08080808u); }
__device__ __forceinline__ uint32_t nibbles_hi(uint32_t p) { return __vsub4((p >> 4) & 0x0F0F0F0Fu, 0x08080808u); }

__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}

// Stage a 128-row x 64-byte int8 tile of a row-major [rows, ld] matrix at
// (row0, col0) into shared memory; rows >= rows_valid are zero.
__device__ __forceinline__ void load_tile8(int8_t* dst, const int8_t* src, int row0, int rows_valid,
                                           size_t ld, int col0) {
#pragma unroll
  for (int it = 0; it < kBM * (kTileK8 / 16) / kThreads; ++it) {
    const int c = threadIdx.x + it * kThreads;
    const int r = c / (kTileK8 / 16);
    const int col = (c % (kTileK8 / 16)) * 16;
    const bool valid = row0 + r < rows_valid;
    const int8_t* s = valid ? src + (size_t)(row0 + r) * ld + col0 + col : src;
    cp_async16(dst + r * kStride8 + col, s, valid);
  }
}

// A fragments of m-tile mt for the k32 step at byte offset kb of a staged tile.
__device__ __forceinline__ void frag_a8(uint32_t* a, const int8_t* tile, int row, int kb, int t) {
  const int8_t* p = tile + row * kStride8 + kb + 4 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * kStride8);
  a[2] = lds32(p + 16);
  a[3] = lds32(p + 8 * kStride8 + 16);
}

// ---------------------------------------------------------------------------
// K5: W8A8
// ---------------------------------------------------------------------------

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs, const int8_t* __restrict__ wq,
            const float* __restrict__ ws, OutT* __restrict__ out, int m, int n, int k) {
  __shared__ __align__(16) int8_t as[2][kTile8Bytes];
  __shared__ __align__(16) int8_t bs[2][kTile8Bytes];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const int nk = k / kTileK8;
  load_tile8(as[0], xq, m0, m, k, 0);
  load_tile8(bs[0], wq, n0, n, k, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile8(as[st ^ 1], xq, m0, m, k, (kt + 1) * kTileK8);
      load_tile8(bs[st ^ 1], wq, n0, n, k, (kt + 1) * kTileK8);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < kTileK8; kb += 32) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* p = bs[st] + (wn * kWarpN + j * 8 + g) * kStride8 + kb + 4 * t;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        uint32_t a[4];
        frag_a8(a, as[st], wm * kWarpM + i * 16 + g, kb, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a, b[j]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // Epilogue: float(acc) * (xs[row] * ws[col]), in that order, as the TPU kernel.
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int r0 = m0 + wm * kWarpM + i * 16 + g;
    const int r1 = r0 + 8;
    const float xs0 = r0 < m ? xs[r0] : 0.f;
    const float xs1 = r1 < m ? xs[r1] : 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn * kWarpN + j * 8 + 2 * t;
      const float ws0 = ws[col], ws1 = ws[col + 1];
      if (r0 < m) {
        store2(out + (size_t)r0 * n + col, __fmul_rn(__int2float_rn(acc[i][j][0]), __fmul_rn(xs0, ws0)),
               __fmul_rn(__int2float_rn(acc[i][j][1]), __fmul_rn(xs0, ws1)));
      }
      if (r1 < m) {
        store2(out + (size_t)r1 * n + col, __fmul_rn(__int2float_rn(acc[i][j][2]), __fmul_rn(xs1, ws0)),
               __fmul_rn(__int2float_rn(acc[i][j][3]), __fmul_rn(xs1, ws1)));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: W4A8
// ---------------------------------------------------------------------------

// One pipeline stage: the x columns of the low and high halves of a 512-block
// that one 64-byte tile of packed codes covers, and that tile.
constexpr int kW4StageBytes = 3 * kTile8Bytes;
constexpr int kW4Smem = 2 * kW4StageBytes;  // 61,440 bytes: dynamic shared memory

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs, const uint8_t* __restrict__ wq,
            const float* __restrict__ ws, OutT* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(16) int8_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kblocks = k / kW4Block;
  constexpr int kTilesPerBlock = (kW4Block / 2) / kTileK8;  // 4 tiles of 64 packed bytes
  const int ntiles = kblocks * kTilesPerBlock;
  const int8_t* wq8 = reinterpret_cast<const int8_t*>(wq);

  auto load_stage = [&](int stage, int tile) {
    int8_t* base = smem + stage * kW4StageBytes;
    const int b = tile / kTilesPerBlock, j = tile % kTilesPerBlock;
    const int kx = b * kW4Block + j * kTileK8;  // x column of the low half
    load_tile8(base, xq, m0, m, k, kx);
    load_tile8(base + kTile8Bytes, xq, m0, m, k, kx + kW4Block / 2);
    load_tile8(base + 2 * kTile8Bytes, wq8, n0, n, k / 2, b * (kW4Block / 2) + j * kTileK8);
  };

  float accf[kMT][kNT][4];
  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        accf[i][j][e] = 0.f;
        acc[i][j][e] = 0;
      }

  load_stage(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < ntiles) load_stage(st ^ 1, tile + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int8_t* a_lo = smem + st * kW4StageBytes;
    const int8_t* a_hi = a_lo + kTile8Bytes;
    const int8_t* bp = a_lo + 2 * kTile8Bytes;
#pragma unroll
    for (int kb = 0; kb < kTileK8; kb += 32) {
      uint32_t blo[kNT][2], bhi[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* p = bp + (wn * kWarpN + j * 8 + g) * kStride8 + kb + 4 * t;
        const uint32_t p0 = lds32(p), p1 = lds32(p + 16);
        blo[j][0] = nibbles_lo(p0);
        blo[j][1] = nibbles_lo(p1);
        bhi[j][0] = nibbles_hi(p0);
        bhi[j][1] = nibbles_hi(p1);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int row = wm * kWarpM + i * 16 + g;
        uint32_t a[4];
        frag_a8(a, a_lo, row, kb, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a, blo[j]);
        frag_a8(a, a_hi, row, kb, t);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], a, bhi[j]);
      }
    }
    if (tile % kTilesPerBlock == kTilesPerBlock - 1) {
      // End of a 512-block: acc_f += float(acc) * (xs[row, b] * ws[col, b]).
      const int b = tile / kTilesPerBlock;
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r0 = m0 + wm * kWarpM + i * 16 + g;
        const int r1 = r0 + 8;
        const float xs0 = r0 < m ? xs[(size_t)r0 * kblocks + b] : 0.f;
        const float xs1 = r1 < m ? xs[(size_t)r1 * kblocks + b] : 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int col = n0 + wn * kWarpN + j * 8 + 2 * t;
          const float ws0 = ws[(size_t)col * kblocks + b], ws1 = ws[(size_t)(col + 1) * kblocks + b];
          const float s[4] = {__fmul_rn(xs0, ws0), __fmul_rn(xs0, ws1), __fmul_rn(xs1, ws0), __fmul_rn(xs1, ws1)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            accf[i][j][e] = __fadd_rn(accf[i][j][e], __fmul_rn(__int2float_rn(acc[i][j][e]), s[e]));
            acc[i][j][e] = 0;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int r0 = m0 + wm * kWarpM + i * 16 + g;
    const int r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn * kWarpN + j * 8 + 2 * t;
      if (r0 < m) store2(out + (size_t)r0 * n + col, accf[i][j][0], accf[i][j][1]);
      if (r1 < m) store2(out + (size_t)r1 * n + col, accf[i][j][2], accf[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// K7: grouped int8 / int4 dequant, bf16 GEMM
// ---------------------------------------------------------------------------

constexpr int kDqGroup = 64;  // == kTileKbf: one scale and bias per row of a tile
constexpr int kDqSmem = 2 * 2 * kTileBfElems * (int)sizeof(__nv_bfloat16);  // 73,728 bytes

// Each thread dequantizes 32 consecutive k of one weight row per tile.
template <bool kInt4>
struct CodeRegs {
  uint4 v[kInt4 ? 1 : 2];
  float scale, bias;
};

template <bool kInt4>
__device__ __forceinline__ void load_codes(CodeRegs<kInt4>& r, const uint8_t* codes, const float* scale,
                                           const float* bias, int row, int half, int k, int k0) {
  const int groups = k / kDqGroup;
  if (kInt4) {
    r.v[0] = *reinterpret_cast<const uint4*>(codes + (size_t)row * (k / 2) + k0 / 2 + half * 16);
  } else {
    const uint8_t* p = codes + (size_t)row * k + k0 + half * 32;
    r.v[0] = *reinterpret_cast<const uint4*>(p);
    r.v[1] = *reinterpret_cast<const uint4*>(p + 16);
  }
  r.scale = scale[(size_t)row * groups + k0 / kDqGroup];
  r.bias = bias[(size_t)row * groups + k0 / kDqGroup];
}

__device__ __forceinline__ float dequant1(uint32_t code, float s, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(code), s), b);
}

// 32 codes -> 32 bf16 weights at dst, k in order.
template <bool kInt4>
__device__ __forceinline__ void store_dequant(__nv_bfloat16* dst, const CodeRegs<kInt4>& r) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(r.v);
  uint32_t packed[16];  // bf16 pairs (k = 2i, 2i + 1)
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t lo, hi;
    if (kInt4) {  // byte i holds k = 2i (low nibble) and 2i + 1 (high nibble)
      const uint32_t byte = (words[i / 4] >> (8 * (i % 4))) & 0xFFu;
      lo = byte & 0xFu;
      hi = byte >> 4;
    } else {  // bytes 2i and 2i + 1
      const uint32_t half = words[i / 2] >> (16 * (i % 2));
      lo = half & 0xFFu;
      hi = (half >> 8) & 0xFFu;
    }
    __nv_bfloat162 v = __floats2bfloat162_rn(dequant1(lo, r.scale, r.bias), dequant1(hi, r.scale, r.bias));
    packed[i] = *reinterpret_cast<uint32_t*>(&v);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = make_uint4(packed[4 * i], packed[4 * i + 1], packed[4 * i + 2], packed[4 * i + 3]);
}

template <bool kInt4>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
               const float* __restrict__ scale, const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int m, int n, int k) {
  extern __shared__ __align__(16) __nv_bfloat16 smem_bf[];
  __nv_bfloat16* as = smem_bf;                     // [2][128][72]
  __nv_bfloat16* bs = smem_bf + 2 * kTileBfElems;  // [2][128][72], weights [n][k]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int brow = threadIdx.x / 2, bhalf = threadIdx.x % 2;  // this thread's weight row and half of k

  auto load_a = [&](int stage, int k0) {
#pragma unroll
    for (int it = 0; it < kBM * (kTileKbf / 8) / kThreads; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int r = c / (kTileKbf / 8);
      const int col = (c % (kTileKbf / 8)) * 8;
      const bool valid = m0 + r < m;
      const __nv_bfloat16* s = valid ? x + (size_t)(m0 + r) * k + k0 + col : x;
      cp_async16(as + stage * kTileBfElems + r * kStrideBf + col, s, valid);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = k / kTileKbf;
  CodeRegs<kInt4> regs;
  load_codes<kInt4>(regs, codes, scale, bias, n0 + brow, bhalf, k, 0);
  load_a(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    // Stage st was last read two tiles ago; the barrier of the previous
    // iteration orders that read before this write.
    store_dequant<kInt4>(bs + st * kTileBfElems + brow * kStrideBf + bhalf * 32, regs);
    cp_async_wait<0>();
    __syncthreads();  // A and B of tile kt are in place; every warp is done with tile kt - 1
    if (kt + 1 < nk) {
      load_codes<kInt4>(regs, codes, scale, bias, n0 + brow, bhalf, k, (kt + 1) * kTileKbf);
      load_a(st ^ 1, (kt + 1) * kTileKbf);
    }
    cp_async_commit();
    const __nv_bfloat16* at = as + st * kTileBfElems;
    const __nv_bfloat16* bt = bs + st * kTileBfElems;
#pragma unroll
    for (int kk = 0; kk < kTileKbf; kk += 16) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const __nv_bfloat16* p = bt + (wn * kWarpN + j * 8 + g) * kStrideBf + kk + 2 * t;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const __nv_bfloat16* p = at + (wm * kWarpM + i * 16 + g) * kStrideBf + kk + 2 * t;
        uint32_t a[4];
        a[0] = lds32(p);
        a[1] = lds32(p + 8 * kStrideBf);
        a[2] = lds32(p + 8);
        a[3] = lds32(p + 8 * kStrideBf + 8);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a, b[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const int r0 = m0 + wm * kWarpM + i * 16 + g;
    const int r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = n0 + wn * kWarpN + j * 8 + 2 * t;
      if (r0 < m) store2(out + (size_t)r0 * n + col, acc[i][j][0], acc[i][j][1]);
      if (r1 < m) store2(out + (size_t)r1 * n + col, acc[i][j][2], acc[i][j][3]);
    }
  }
}

bool grid_ok(int m, int n) { return m > 0 && n > 0 && (m + kBM - 1) / kBM <= 65535; }

}  // namespace

// xq int8 [m, k], xs f32 [m], wq int8 [n, k], ws f32 [n]; out [m, n] f32 if
// out_f32 else bf16. Needs k % 64 == 0 and n % 128 == 0 (the K5 gate asks
// k % 256 and n % 256). Returns a cudaError_t.
extern "C" int flux2_w8a8_matmul(const void* xq, const void* xs, const void* wq, const void* ws, void* out,
                                 int m, int n, int k, int out_f32, void* stream) {
  if (!grid_ok(m, n) || k <= 0 || k % kTileK8 || n % kBN) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const int8_t* b = static_cast<const int8_t*>(wq);
  const float* sa = static_cast<const float*>(xs);
  const float* sb = static_cast<const float*>(ws);
  if (out_f32) {
    w8a8_kernel<float><<<grid, kThreads, 0, s>>>(a, sa, b, sb, static_cast<float*>(out), m, n, k);
  } else {
    w8a8_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a, sa, b, sb, static_cast<__nv_bfloat16*>(out), m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// xq int8 [m, k], xs f32 [m, k/512], wq uint8 [n, k/2] split-half packed,
// ws f32 [n, k/512]; out as K5's. Needs k % 512 == 0 and n % 128 == 0.
extern "C" int flux2_w4a8_matmul(const void* xq, const void* xs, const void* wq, const void* ws, void* out,
                                 int m, int n, int k, int out_f32, void* stream) {
  if (!grid_ok(m, n) || k <= 0 || k % kW4Block || n % kBN) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(xq);
  const uint8_t* b = static_cast<const uint8_t*>(wq);
  const float* sa = static_cast<const float*>(xs);
  const float* sb = static_cast<const float*>(ws);
  cudaError_t err;
  if (out_f32) {
    err = cudaFuncSetAttribute(w4a8_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, kW4Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    w4a8_kernel<float><<<grid, kThreads, kW4Smem, s>>>(a, sa, b, sb, static_cast<float*>(out), m, n, k);
  } else {
    err = cudaFuncSetAttribute(w4a8_kernel<__nv_bfloat16>, cudaFuncAttributeMaxDynamicSharedMemorySize, kW4Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    w4a8_kernel<__nv_bfloat16><<<grid, kThreads, kW4Smem, s>>>(a, sa, b, sb, static_cast<__nv_bfloat16*>(out),
                                                                m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// x bf16 [m, k]; codes uint8 [n, k] (int4 = 0) or [n, k/2] (int4 = 1,
// interleaved); scale, bias f32 [n, k/group]; out bf16 [m, n]. Needs
// group == 64, k % 64 == 0 and n % 128 == 0 (the K7 gate asks k % 512).
extern "C" int flux2_dequant_matmul(const void* x, const void* codes, const void* scale, const void* bias,
                                    void* out, int m, int n, int k, int group, int int4, void* stream) {
  if (!grid_ok(m, n) || group != kDqGroup || k <= 0 || k % kTileKbf || n % kBN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xa = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (int4) {
    err = cudaFuncSetAttribute(dequant_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dequant_kernel<true><<<grid, kThreads, kDqSmem, s>>>(xa, c, sc, bi, o, m, n, k);
  } else {
    err = cudaFuncSetAttribute(dequant_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dequant_kernel<false><<<grid, kThreads, kDqSmem, s>>>(xa, c, sc, bi, o, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}
