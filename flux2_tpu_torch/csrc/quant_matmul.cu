// Quantized matmuls for the FLUX.2 DiT and the Qwen3 encoder, hand-written for
// Hopper (sm_90a). Three kernels, each behind a plain C entry:
//
//   K5  flux2_w8a8_matmul   replaces flux2_tpu/ops/quant_kernels.py:_kernel_w8a8 (:182)
//       out[m, n] = float(sum_k xq[m, k] * wq[n, k]) * (xs[m] * ws[n])
//       xq int8 [M, K], xs f32 [M], wq int8 [N, K], ws f32 [N]; the int32 sum
//       spans all of K and the f32 epilogue runs once, as on the TPU. xq and
//       xs (and K6's) come from the activation prologue, quant_prologue.cu.
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
// What bounds them on the card. At the 1024^2 image projections (M=4096,
// K=3072, N=3072) each does 2*M*N*K = 7.7e10 multiply-adds on ~25-35 MB of
// operands: compute-bound, K5 and K6 against the 1,979 TOPS int8 dense peak
// (0.0391 ms), K7 against the 989 TFLOP/s bf16 one (0.0782 ms). K6 adds the
// nibble unpack and one f32 rescale per 512-block; K7 adds the dequant of
// every weight element, once for every M tile that reads it (~4 ALU
// operations an element), which is the work a bf16 GEMM does not have. At the
// modulation shapes (M=1..8, K=3072, N=18432) they are bound by the weight
// bytes (~17 us for K5's 57 MB at 3.35 TB/s).
//
// All three are warp-specialised on the tensor cores' only full-rate path
// (TMA into a ring of stages guarded by mbarriers, one loading warpgroup,
// multiplying warpgroups issuing wgmma).
//
// K5 takes the plain form, both operands from shared memory: xq [M, K] and
// wq [N, K] are both int8 and K-major, the only layout an 8-bit wgmma reads,
// so the TMA boxes feed it as they land, with no conversion:
//   - persistent CTAs, one an SM, walk the BM x BN output tiles; a stage is
//     128 K bytes of the BM x rows and of the BN weight rows (128-byte
//     swizzle; rows past M read as zeros), 3-4 stages; mbarriers "full"
//     (TMA bytes) and "empty" (one arrival per multiplying warpgroup); the
//     loading warpgroup runs on into the next tile's stages while the
//     multiplying ones finish the last;
//   - each multiplying warpgroup owns 64 x rows: wgmma m64nBNk32 s8 -> s32
//     over the whole K (|sum| stays far inside int32, see above), one group
//     of products left in flight while the next issues, a stage released
//     when the products that read it retire;
//   - epilogue __fmul_rn(__int2float_rn(acc), __fmul_rn(xs, ws)), as the
//     plain version, so K5 equals it to the bit; each multiplying
//     warpgroup writes its tile into 32 KB of its own as 64-row, 128-byte
//     swizzled boxes, which one thread stores by TMA (rows past M dropped)
//     while the next tile's products run;
//   - tiles: 128 x 256 (two multiplying warpgroups, 128 accumulators a
//     thread, setmaxnreg as K6) where there are as many as SMs, 128 x 128
//     otherwise, and 64 x 128 with one multiplying warpgroup and two CTAs an
//     SM for M <= 64, where the weight bytes bound it.
//
// K6 and K7 take the "swapped" form: out^T = W x^T, with the weight as
// wgmma's A operand in registers and x as B from shared memory, so no
// converted weight tile passes through shared memory:
//   - one CTA of three warpgroups per 128 weight rows (output columns) and BM
//     x rows. Warpgroup 0 loads: one thread keeps a ring of stages full by
//     TMA from 2D tensor maps: the x tile (128-byte swizzle; rows past M read
//     as zeros and are never stored) and the code tile (K7 qint8 64-byte rows
//     with the 64-byte swizzle, int4 32-byte rows with the 32-byte one, K6
//     128-byte rows with the 128-byte one, so that the fragment loads below
//     meet no bank conflicts). Warpgroups 1 and 2 take 64 weight rows each:
//     every thread reads the codes of its two rows of each k-step's A
//     fragment, converts them in registers (K7: dequantized to bf16 pairs;
//     K6: one 32-bit load of packed bytes gives the low-nibble fragment for
//     x's low half and the high-nibble one for its high half), and issues
//     the tile's wgmmas against all BM x rows;
//   - mbarriers: "full" per stage (TMA bytes) and "x empty" per stage (one
//     arrival per multiplying warpgroup once the products that read it
//     retire). wgmma reads its A registers after it issues, so a warpgroup
//     converts its next tile only after its products are done; the other
//     warpgroup's products keep the tensor cores busy meanwhile;
//   - the epilogue stages each warpgroup's transposed tile in the idle ring
//     and stores 16 bytes a thread along the output rows;
//   - K7: wgmma m64nBMk16 bf16 -> f32, 64 K a tile (one dequant group: one
//     scale and bias per row a tile, read one tile ahead). float(code) is the
//     byte placed under 2^23's exponent minus 2^23 (exact, no conversion
//     instruction), then __fmul_rn and __fadd_rn as the plain version. BM =
//     256 where that still fills the card, else 128: the dequant is repeated
//     once per BM rows;
//   - K6: wgmma m64n128k32 s8 -> s32, 256 K a tile (128 packed bytes: the x
//     columns of the low and of the high half), two tiles a 512-block. The
//     nibbles unpack with per-byte subtractions (nibbles_lo/hi). At a
//     block's end each warpgroup folds its s32 sums into the f32 ones with
//     __fmul_rn / __fadd_rn in the plain version's order (the block's xs and
//     ws are written to shared memory by the two warpgroups, one array
//     each); int -> float is exact below 2^22 by the same exponent trick
//     (|sum| <= 512 * 127 * 8). K6 therefore equals its plain version to the
//     bit. BM = 128: the s32 and f32 accumulators take 128 registers a thread.
// PERF.md §6 has the designs tried on the way and their times, among them a
// converting warpgroup that writes the B tile to shared memory (form a).
// Each C entry encodes its tensor maps per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so nothing links libcuda),
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kWsThreads = 384;  // K6, K7: warpgroup 0 loads, 1 and 2 unpack or dequantize, and multiply
constexpr int kWsBN = 128;       // K6, K7: weight rows (output columns) per CTA
// setmaxnreg of the loading warpgroup and of the multiplying ones: the
// registers the first gives up are the ones the others take, from the 168 a
// thread of 384 gets at launch: 128 * (168 - 24) == 256 * (240 - 168).
constexpr int kLoadRegs = 24;
constexpr int kMmaRegs = 240;
constexpr int kRowTile = kWsBN * 128;  // 16 KB: 128 rows of 128 bytes with the 128-byte swizzle
constexpr int kW4Block = 512;          // K6's K block

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 lds_f32x2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// Byte offset of 16-byte chunk c of row r in a tile of 128-byte rows with the
// 128-byte swizzle (the layout TMA writes and wgmma's descriptors read).
__device__ __forceinline__ uint32_t sw128(int r, int c) { return r * 128 + 16 * (c ^ (r & 7)); }

// ---- K7 --------------------------------------------------------------------

constexpr int kDqGroup = 64;     // K of a tile: one scale and one bias per weight row
constexpr int kXBox = 64 * 128;  // one x box: 64 rows x 64 bf16 (8 KB)
constexpr int kStageRow = 144;   // epilogue staging: 64 bf16 and 16 bytes of padding a row

template <int kBM, bool kInt4>
struct DqLayout {
  static constexpr int kXBytes = kBM * 128;
  static constexpr int kCodeRow = kInt4 ? 32 : 64;  // code bytes of one weight row a tile
  static constexpr int kStage = kXBytes + kWsBN * kCodeRow;
  static constexpr int kStages = kBM == 256 ? 5 : 8;
  static constexpr int kBars = kStages * kStage;  // full and x-empty per stage
  static constexpr int kSmem = kBars + 16 * kStages + 1024;  // + slack to align the base
  static_assert(kStage % 1024 == 0, "stages keep the swizzle atoms aligned");
  static_assert(2 * kBM * kStageRow <= kBars, "both warpgroups' staging fits the idle ring");
};

// float(code) * s + b in f32 (__fmul_rn, __fadd_rn), code = byte ``sel`` of
// ``word``: the byte is placed under the exponent of 2^23, and 2^23 subtracted.
__device__ __forceinline__ float dequant1(uint32_t word, int sel, float s, float b) {
  const float f = __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440 + sel));
  return __fadd_rn(__fmul_rn(__fsub_rn(f, 8388608.f), s), b);
}

// The A fragments of a tile's four k16 steps for this thread's weight rows r0
// and r0 + 8 of the code tile at ``codes``: a[kk] = {(r0, k 2t, 2t+1), (r0+8,
// 2t..), (r0, 2t+8, 2t+9), (r0+8, 2t+8..)} of step kk, dequantized to bf16
// pairs. The rows' scales and biases are s[0], b[0] and s[1], b[1].
template <bool kInt4>
__device__ __forceinline__ void dequant_fragments(uint32_t (&a)[4][4], uint32_t codes, int r0, int t,
                                                  const float (&s)[2], const float (&b)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if constexpr (kInt4) {  // byte 8kk + t holds k 16kk + 2t (low nibble) and + 1; byte 8kk + 4 + t k + 8, + 9
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint4 v = lds128(codes + r * 32 + 16 * (c ^ ((r >> 2) & 1)));  // 32-byte swizzle
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t lo0 = w[2 * h] & 0x0F0F0F0Fu, hi0 = (w[2 * h] >> 4) & 0x0F0F0F0Fu;
          const uint32_t lo1 = w[2 * h + 1] & 0x0F0F0F0Fu, hi1 = (w[2 * h + 1] >> 4) & 0x0F0F0F0Fu;
          a[2 * c + h][i] = pack_bf16(dequant1(lo0, t, s[i], b[i]), dequant1(hi0, t, s[i], b[i]));
          a[2 * c + h][2 + i] = pack_bf16(dequant1(lo1, t, s[i], b[i]), dequant1(hi1, t, s[i], b[i]));
        }
      }
    } else {  // 16 bytes a step: k 2t, 2t+1 in word t / 2, k 2t+8, 2t+9 in word 2 + t / 2
      const int sel = 2 * (t & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 v = lds128(codes + r * 64 + 16 * (kk ^ ((r >> 1) & 3)));  // 64-byte swizzle
        const uint32_t lo = (t & 2) ? v.y : v.x, hi = (t & 2) ? v.w : v.z;
        a[kk][i] = pack_bf16(dequant1(lo, sel, s[i], b[i]), dequant1(lo, sel + 1, s[i], b[i]));
        a[kk][2 + i] = pack_bf16(dequant1(hi, sel, s[i], b[i]), dequant1(hi, sel + 1, s[i], b[i]));
      }
    }
  }
}

template <int kBM, bool kInt4>
__global__ void __launch_bounds__(kWsThreads, 1)
dequant_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap cmap,
               const float* __restrict__ scale, const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int m, int n, int k) {
  using L = DqLayout<kBM, kInt4>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  auto full = [&](int st) { return base + L::kBars + 8u * st; };
  auto x_empty = [&](int st) { return base + L::kBars + 8u * (S + st); };
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kWsBN;
  const int nk = k / kDqGroup;  // a multiple of 8 (the gate asks K % 512)
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(x_empty(st), 2);  // one arrival per multiplying warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Loading warpgroup: one thread refills each stage (the kBM x rows in
    // 64-row boxes, the 128 weight rows' codes) once both multiplying
    // warpgroups have retired the products that read it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs) : "memory");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % S;
        if (kt >= S) mbar_wait(x_empty(st), ((kt / S) - 1) & 1);
        const uint32_t stage = base + st * L::kStage;
        mbar_expect_tx(full(st), L::kStage);
#pragma unroll
        for (int r = 0; r < kBM / 64; ++r) tma_load_2d(stage + r * kXBox, &xmap, full(st), kt * kDqGroup, m0 + 64 * r);
        tma_load_2d(stage + L::kXBytes, &cmap, full(st), kt * L::kCodeRow, n0);
      }
    }
  } else {
    // Multiplying warpgroup w: weight rows n0 + 64w .. + 63 against all kBM
    // x rows, out^T = W x^T with W as the register A operand.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMmaRegs) : "memory");
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int wq = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
    const int r0 = 64 * w + 16 * wq + g;  // this thread's weight rows in the tile: r0 and r0 + 8
    const float* scale0 = scale + (size_t)(n0 + r0) * nk;
    const float* bias0 = bias + (size_t)(n0 + r0) * nk;
    float s[2] = {scale0[0], scale0[8 * nk]}, b[2] = {bias0[0], bias0[8 * nk]};
    float acc[kBM / 2];
    uint32_t a[4][4];
    mbar_wait(full(0), 0);
    dequant_fragments<kInt4>(a, base + L::kXBytes, r0, t, s, b);
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % S;
      if (kt + 1 < nk) {  // the next tile's scales and biases, loaded under this tile's products
        s[0] = scale0[kt + 1];
        s[1] = scale0[8 * nk + kt + 1];
        b[0] = bias0[kt + 1];
        b[1] = bias0[8 * nk + kt + 1];
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqGroup / 16; ++kk) {
        wgmma_rs_kmajor(acc, a[kk], smem_desc(base + st * L::kStage + kk * 32, 16, 1024), kt | kk);
      }
      wgmma_commit();
      // The A registers are read after issue, so the next tile's fragments
      // wait for these products (with one group left in flight the compiler
      // reused the registers under the running products: wrong, varying
      // results). The other warpgroup's products keep the tensor cores busy.
      wgmma_wait_all();
      if (tid == 0) mbar_arrive(x_empty(st));
      if (kt + 1 < nk) {
        const int st1 = (kt + 1) % S;
        mbar_wait(full(st1), ((kt + 1) / S) & 1);
        dequant_fragments<kInt4>(a, base + st1 * L::kStage + L::kXBytes, r0, t, s, b);
      }
    }
    fence_acc(acc);
    // Epilogue: acc[4j + e] is weight row 16wq + g + 8(e >> 1) of this
    // warpgroup's 64 and x row 8j + 2t + (e & 1). Staged transposed through
    // shared memory (the ring is idle once both warpgroups are here), then
    // stored 16 bytes a thread along the output rows.
    asm volatile("bar.sync 1, 256;" ::: "memory");
    const uint32_t staging = base + w * kBM * kStageRow;
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat16 v = __float2bfloat16_rn(acc[4 * j + e]);
        asm volatile("st.shared.u16 [%0], %1;" ::"r"(staging + (8 * j + 2 * t + (e & 1)) * kStageRow +
                                                      2 * (16 * wq + g + 8 * (e >> 1))),
                     "h"(*reinterpret_cast<const unsigned short*>(&v))
                     : "memory");
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(2 + w) : "memory");
    for (int i = tid; i < kBM * 8; i += 128) {
      const int row = i / 8, chunk = i % 8;
      if (m0 + row < m) {
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + row) * n + n0 + 64 * w + 8 * chunk) =
            lds128(staging + row * kStageRow + 16 * chunk);
      }
    }
  }
}

// ---- K6 --------------------------------------------------------------------

constexpr int kW4Stages = 4;
constexpr int kW4Tile = 128;            // packed code bytes of a weight row a tile: 256 K
constexpr int kW4Stage = 3 * kRowTile;  // x low half, x high half, codes (each [128, 128] bytes)
constexpr int kW4Scales = kW4Stages * kW4Stage;  // xs and ws of a block (128 f32 each), by the block's parity
constexpr int kW4Bars = kW4Scales + 2 * 1024;
constexpr int kW4Smem = kW4Bars + 16 * kW4Stages + 1024;

// Four packed bytes -> the four int8 codes of their low / high nibbles (minus 8).
__device__ __forceinline__ uint32_t nibbles_lo(uint32_t p) { return __vsub4(p & 0x0F0F0F0Fu, 0x08080808u); }
__device__ __forceinline__ uint32_t nibbles_hi(uint32_t p) { return __vsub4((p >> 4) & 0x0F0F0F0Fu, 0x08080808u); }

// Exact float of an int32 below 2^22 in magnitude: placed under the exponent
// of 1.5 * 2^23, which is then subtracted.
__device__ __forceinline__ float small_int_to_float(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), 12582912.f);
}

// The A fragments of a tile's four k32 steps for this thread's weight rows r0
// and r0 + 8 of the code tile at ``codes``: one 32-bit load of packed bytes
// gives the fragment of the low half's step (low nibbles) and of the high
// half's (high nibbles) at the same positions.
__device__ __forceinline__ void unpack_fragments(uint32_t (&lo)[4][4], uint32_t (&hi)[4][4], uint32_t codes, int r0,
                                                 int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // rows r0, r0 + 8; bytes 32kk + 4t, 32kk + 16 + 4t
      const int r = r0 + 8 * (i & 1);
      const uint32_t p = lds_u32(codes + sw128(r, 2 * kk + (i >> 1)) + 4 * t);
      lo[kk][i] = nibbles_lo(p);
      hi[kk][i] = nibbles_hi(p);
    }
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
w4a8_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap cmap,
            const float* __restrict__ xs, const float* __restrict__ ws, OutT* __restrict__ out, int m, int n, int k) {
  constexpr int S = kW4Stages;
  constexpr int kRow = 64 * sizeof(OutT) + 16;  // epilogue staging row: 64 outputs and padding
  static_assert(2 * 128 * kRow <= kW4Scales, "both warpgroups' staging fits the idle ring");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto full = [&](int st) { return base + kW4Bars + 8u * st; };
  auto x_empty = [&](int st) { return base + kW4Bars + 8u * (S + st); };
  const int m0 = blockIdx.y * 128, n0 = blockIdx.x * kWsBN;
  const int kblocks = k / kW4Block;
  const int nk = 2 * kblocks;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(x_empty(st), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Loading warpgroup: one thread refills each stage once its products retire.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs) : "memory");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % S;
        if (kt >= S) mbar_wait(x_empty(st), ((kt / S) - 1) & 1);
        const uint32_t stage = base + st * kW4Stage;
        const int kx = (kt / 2) * kW4Block + (kt % 2) * kW4Tile;  // x column of the low half
        mbar_expect_tx(full(st), kW4Stage);
        tma_load_2d(stage, &xmap, full(st), kx, m0);
        tma_load_2d(stage + kRowTile, &xmap, full(st), kx + kW4Block / 2, m0);
        tma_load_2d(stage + 2 * kRowTile, &cmap, full(st), kt * kW4Tile, n0);
      }
    }
  } else {
    // Multiplying warpgroup w: weight rows n0 + 64w .. + 63 against the 128
    // x rows, out^T = W x^T with the unpacked codes as the register A operand;
    // s32 sums of the current block, f32 sums of the blocks before it.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMmaRegs) : "memory");
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int wq = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
    const int r0 = 64 * w + 16 * wq + g;  // this thread's weight rows in the tile: r0 and r0 + 8
    int acc[64];
    float acc_f[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_f[i] = 0.f;
    uint32_t lo[4][4], hi[4][4];
    mbar_wait(full(0), 0);
    unpack_fragments(lo, hi, base + 2 * kRowTile, r0, t);
    for (int b = 0; b < kblocks; ++b) {
      // The block's scales into its parity's area: warpgroup 0 writes xs of
      // the 128 x rows, warpgroup 1 ws of the 128 weight rows. The area was
      // last read by the fold of block b - 2, which both warpgroups finished
      // before the barrier of block b - 1.
      const uint32_t sc = base + kW4Scales + (b & 1) * 1024;
      const float v = w == 0 ? (m0 + tid < m ? xs[(size_t)(m0 + tid) * kblocks + b] : 0.f)
                             : ws[(size_t)(n0 + tid) * kblocks + b];
      sts_f32(sc + 512 * w + 4 * tid, v);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kt = 2 * b + half;
        const int st = kt % S;
        const uint32_t x_lo = base + st * kW4Stage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // low nibbles by x's low half; the block's first product overwrites
          wgmma_rs_s8(acc, lo[kk], smem_desc(x_lo + kk * 32, 16, 1024), half | kk);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs_s8(acc, hi[kk], smem_desc(x_lo + kRowTile + kk * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait_all();  // the fragments may be written again (see K7)
        if (tid == 0) mbar_arrive(x_empty(st));
        if (kt + 1 < nk) {
          const int st1 = (kt + 1) % S;
          mbar_wait(full(st1), ((kt + 1) / S) & 1);
          unpack_fragments(lo, hi, base + st1 * kW4Stage + 2 * kRowTile, r0, t);
        }
      }
      // acc_f += float(sum) * (xs[row, b] * ws[col, b]), in the plain version's order.
      fence_acc(acc);
      asm volatile("bar.sync 1, 256;" ::: "memory");  // the block's xs and ws are in place
      const float w0 = lds_f32(sc + 512 + 4 * r0), w1 = lds_f32(sc + 512 + 4 * (r0 + 8));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 xv = lds_f32x2(sc + 4 * (8 * j + 2 * t));
        const float s[4] = {__fmul_rn(xv.x, w0), __fmul_rn(xv.y, w0), __fmul_rn(xv.x, w1), __fmul_rn(xv.y, w1)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc_f[4 * j + e] = __fadd_rn(acc_f[4 * j + e], __fmul_rn(small_int_to_float(acc[4 * j + e]), s[e]));
        }
      }
    }
    // Epilogue: acc_f[4j + e] is weight row 16wq + g + 8(e >> 1) of this
    // warpgroup's 64 and x row 8j + 2t + (e & 1); staged transposed through
    // the idle ring, then stored 16 bytes a thread along the output rows.
    asm volatile("bar.sync 1, 256;" ::: "memory");
    const uint32_t staging = base + w * 128 * kRow;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t at = staging + (8 * j + 2 * t + (e & 1)) * kRow + sizeof(OutT) * (16 * wq + g + 8 * (e >> 1));
        if constexpr (sizeof(OutT) == 4) {
          sts_f32(at, acc_f[4 * j + e]);
        } else {
          const __nv_bfloat16 v = __float2bfloat16_rn(acc_f[4 * j + e]);
          asm volatile("st.shared.u16 [%0], %1;" ::"r"(at), "h"(*reinterpret_cast<const unsigned short*>(&v))
                       : "memory");
        }
      }
    }
    asm volatile("bar.sync %0, 128;" ::"r"(2 + w) : "memory");
    constexpr int kChunks = 64 * sizeof(OutT) / 16;
    for (int i = tid; i < 128 * kChunks; i += 128) {
      const int row = i / kChunks, chunk = i % kChunks;
      if (m0 + row < m) {
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(out + (size_t)(m0 + row) * n + n0 + 64 * w) +
                                  16 * chunk) = lds128(staging + row * kRow + 16 * chunk);
      }
    }
  }
}

// ---- K5 --------------------------------------------------------------------

// Persistent CTAs (one an SM; two with one multiplying warpgroup) walk the
// BM x BN output tiles: kConsumers multiplying warpgroups of 64 x rows each,
// and the loading warpgroup 0. A stage holds 128 K bytes of the BM x rows and
// of the BN weight rows, both with the 128-byte swizzle. Each multiplying
// warpgroup stages its output in 32 KB of its own, so a tile's epilogue runs
// while the loading warpgroup fills the ring for the next tile.
template <int kBN, int kConsumers>
struct W8Layout {
  static constexpr int kBM = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kMinBlocks = kConsumers == 1 ? 2 : 1;
  static constexpr int kStages = kBN == 128 && kConsumers == 2 ? 4 : 3;
  static constexpr int kXBytes = kBM * 128;
  static constexpr int kStage = kXBytes + kBN * 128;
  static constexpr int kStaging = kStages * kStage;  // the staging areas: 32 KB a multiplying warpgroup
  static constexpr int kBars = kStaging + kConsumers * 32768;  // full and empty per stage
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
  // 128 s32 accumulators a thread (kBN = 256) take the loading warpgroup's
  // registers (setmaxnreg, as K6); 64 fit the launch count.
  static constexpr bool kShiftRegs = kBN == 256;
  static constexpr int kBox = 8192;  // one output box: 64 rows x 128 bytes, 128-byte swizzle
  static_assert(kStage % 1024 == 0, "stages keep the swizzle atoms aligned");
  static_assert(kMinBlocks * (kSmem + 1024) <= 233472, "the CTAs an SM holds fit its shared memory");
};

__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts_f32x2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a), "f"(b) : "memory");
}

template <int kBN, int kConsumers, typename OutT>
__global__ void __launch_bounds__(W8Layout<kBN, kConsumers>::kThreads, W8Layout<kBN, kConsumers>::kMinBlocks)
w8a8_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
            const __grid_constant__ CUtensorMap omap, const float* __restrict__ xs, const float* __restrict__ ws,
            int m, int n, int k) {
  using L = W8Layout<kBN, kConsumers>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto full = [&](int st) { return base + L::kBars + 8u * st; };
  auto empty = [&](int st) { return base + L::kBars + 8u * (S + st); };
  const int nk = k / 128;
  const int ntn = n / kBN;
  const int tiles = ((m + L::kBM - 1) / L::kBM) * ntn;  // row-tile major: neighbouring CTAs share x rows
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);  // one arrival per multiplying warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Loading warpgroup: one thread refills each stage once every
    // multiplying warpgroup has retired the products that read it, tile
    // after tile (``it`` counts this CTA's k-tiles: stage and phase).
    if constexpr (L::kShiftRegs) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoadRegs) : "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / ntn) * L::kBM, n0 = (tile % ntn) * kBN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int st = it % S;
          if (it >= S) mbar_wait(empty(st), ((it / S) - 1) & 1);
          const uint32_t stage = base + st * L::kStage;
          mbar_expect_tx(full(st), L::kStage);
          tma_load_2d(stage, &xmap, full(st), kt * 128, m0);
          tma_load_2d(stage + L::kXBytes, &wmap, full(st), kt * 128, n0);
        }
      }
    }
  } else {
    // Multiplying warpgroup w: x rows m0 + 64w .. + 63 against the kBN weight
    // rows, both operands from shared memory; one group of products stays in
    // flight while the next tile's issue, and a stage is released as soon as
    // the products that read it retire.
    if constexpr (L::kShiftRegs) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMmaRegs) : "memory");
    const int w = wg - 1;
    const int tid = threadIdx.x % 128;
    const int wq = tid / 32, g = (tid % 32) >> 2, t = tid & 3;
    const int r0 = 16 * wq + g;  // this thread's rows in the warpgroup's 64: r0 and r0 + 8
    // The output leaves in passes of 32 KB (f32 at kBN = 256: two of 128 columns).
    constexpr int kBoxCols = 128 / sizeof(OutT);
    constexpr int kPasses = (64 * kBN * static_cast<int>(sizeof(OutT)) + 32767) / 32768;
    constexpr int kPassCols = kBN / kPasses;
    const uint32_t staging = base + L::kStaging + w * 32768;
    int acc[kBN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / ntn) * L::kBM, n0 = (tile % ntn) * kBN;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int st = it % S;
        mbar_wait(full(st), (it / S) & 1);
        const uint32_t a = base + st * L::kStage + w * 64 * 128;
        const uint32_t b = base + st * L::kStage + L::kXBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // k32 steps: 32 bytes along the swizzled 128-byte rows
          wgmma_ss_s8(acc, smem_desc(a + kk * 32, 16, 1024), smem_desc(b + kk * 32, 16, 1024), kt | kk);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-tile's products have retired
        if (kt > 0 && tid == 0) mbar_arrive(empty((it - 1) % S));
      }
      wgmma_wait_all();
      fence_acc(acc);
      if (tid == 0) mbar_arrive(empty((it - 1) % S));

      // Epilogue: out = float(acc) * (xs[row] * ws[col]) in that order, as
      // the plain version. acc[4j + e] is row r0 + 8(e >> 1) and column
      // 8j + 2t + (e & 1). The tile goes into the staging area as 64-row
      // boxes of 128 bytes with the 128-byte swizzle (conflict-free: the 8
      // rows of a fragment land in 8 distinct 16-byte chunks), then one
      // thread stores them by TMA, which drops the rows past M.
      const int row0 = m0 + 64 * w + r0;
      const float xs_r[2] = {row0 < m ? xs[row0] : 0.f, row0 + 8 < m ? xs[row0 + 8] : 0.f};
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        if (tid == 0) tma_store_wait_read();  // the last stores have read the staging area
        asm volatile("bar.sync %0, 128;" ::"r"(2 + w) : "memory");
#pragma unroll
        for (int jj = 0; jj < kPassCols / 8; ++jj) {
          const int j = p * (kPassCols / 8) + jj;
          const float2 wv = *reinterpret_cast<const float2*>(ws + n0 + 8 * j + 2 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            const float v0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), __fmul_rn(xs_r[h], wv.x));
            const float v1 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), __fmul_rn(xs_r[h], wv.y));
            const int col = 8 * jj + 2 * t;  // within the pass
            const int byte = (col % kBoxCols) * sizeof(OutT);  // within the 128-byte box row
            const uint32_t at = staging + (col / kBoxCols) * L::kBox + r * 128 + 16 * ((byte / 16) ^ (r & 7)) +
                                byte % 16;
            if constexpr (sizeof(OutT) == 4) {
              sts_f32x2(at, v0, v1);
            } else {
              sts_u32(at, pack_bf16(v0, v1));
            }
          }
        }
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;" ::"r"(2 + w) : "memory");
        if (tid == 0) {
#pragma unroll 1
          for (int bx = 0; bx < kPassCols / kBoxCols; ++bx) {
            tma_store_2d(&omap, staging + bx * L::kBox, n0 + p * kPassCols + bx * kBoxCols, m0 + 64 * w);
          }
          tma_store_commit();
        }
      }
    }
    if (tid == 0) tma_store_wait_read();
  }
}

bool grid_ok(int m, int n) { return m > 0 && n > 0 && (m + 127) / 128 <= 65535; }

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
                                                   cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

template <typename OutT>
int launch_w4a8(const CUtensorMap& xmap, const CUtensorMap& cmap, const float* xs, const float* ws, OutT* out, int m,
                int n, int k, void* stream) {
  const cudaError_t attr =
      cudaFuncSetAttribute(w4a8_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kW4Smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n / kWsBN, (m + 127) / 128);
  w4a8_kernel<OutT><<<grid, kWsThreads, kW4Smem, static_cast<cudaStream_t>(stream)>>>(xmap, cmap, xs, ws, out, m, n,
                                                                                        k);
  return static_cast<int>(cudaGetLastError());
}

template <int kBM, bool kInt4>
int launch_dequant(const CUtensorMap& xmap, const CUtensorMap& cmap, const float* scale, const float* bias,
                   __nv_bfloat16* out, int m, int n, int k, void* stream) {
  using L = DqLayout<kBM, kInt4>;
  const cudaError_t attr =
      cudaFuncSetAttribute(dequant_kernel<kBM, kInt4>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n / kWsBN, (m + kBM - 1) / kBM);
  dequant_kernel<kBM, kInt4><<<grid, kWsThreads, L::kSmem, static_cast<cudaStream_t>(stream)>>>(
      xmap, cmap, scale, bias, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// K5 on one tile shape: the tensor maps (x and weight boxes of the tile's
// rows by 128 K bytes; output boxes of 64 rows by 128 bytes), then a grid of
// at most as many CTAs as the card holds at once.
template <int kBN, int kConsumers, typename OutT>
int launch_w8a8(const void* xq, const float* xs, const void* wq, const float* ws, void* out, int m, int n, int k,
                void* stream) {
  using L = W8Layout<kBN, kConsumers>;
  constexpr bool kF32 = sizeof(OutT) == 4;
  CUtensorMap xmap, wmap, omap;
  if (!encode_map_2d(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, m, k, L::kBM, 128, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&wmap, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, k, kBN, 128, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&omap, out, kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     sizeof(OutT), m, n, 64, 128 / sizeof(OutT), CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Once per instantiation in the process (the port drives one card): K5 runs
  // on every served matmul, and the host's time per call shows at the
  // smallest shapes.
  static const cudaError_t attr = cudaFuncSetAttribute(w8a8_kernel<kBN, kConsumers, OutT>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = static_cast<long long>((m + L::kBM - 1) / L::kBM) * (n / kBN);
  const int grid = static_cast<int>(tiles < sm_count() * L::kMinBlocks ? tiles : sm_count() * L::kMinBlocks);
  w8a8_kernel<kBN, kConsumers, OutT><<<grid, L::kThreads, L::kSmem, static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, omap, xs, ws, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// K5's tile shape for an [m, n] output: 64 x 128 (one multiplying warpgroup,
// two CTAs an SM) while the x rows fill one wgmma (m <= 64: the modulations
// and short prompts, bound by the weight bytes); 128 x 256 where there are
// at least as many such tiles as SMs; else 128 x 128.
template <typename OutT>
int dispatch_w8a8(const void* xq, const float* xs, const void* wq, const float* ws, void* out, int m, int n, int k,
                  void* stream) {
  if (m <= 64) return launch_w8a8<128, 1, OutT>(xq, xs, wq, ws, out, m, n, k, stream);
  if (n % 256 == 0 && ((m + 127) / 128) * (n / 256) >= sm_count()) {
    return launch_w8a8<256, 2, OutT>(xq, xs, wq, ws, out, m, n, k, stream);
  }
  return launch_w8a8<128, 2, OutT>(xq, xs, wq, ws, out, m, n, k, stream);
}

}  // namespace

// xq int8 [m, k], xs f32 [m], wq int8 [n, k], ws f32 [n]; out [m, n] f32 if
// out_f32 else bf16. Needs k % 128 == 0, n % 128 == 0 (the K5 gate asks
// k % 256 and n % 256) and 16-byte aligned xq, wq and out. Returns a
// cudaError_t.
extern "C" int flux2_w8a8_matmul(const void* xq, const void* xs, const void* wq, const void* ws, void* out,
                                 int m, int n, int k, int out_f32, void* stream) {
  if (!grid_ok(m, n) || k <= 0 || k % 128 || n % 128) return static_cast<int>(cudaErrorInvalidValue);
  const float* sa = static_cast<const float*>(xs);
  const float* sb = static_cast<const float*>(ws);
  if (out_f32) return dispatch_w8a8<float>(xq, sa, wq, sb, out, m, n, k, stream);
  return dispatch_w8a8<__nv_bfloat16>(xq, sa, wq, sb, out, m, n, k, stream);
}

// xq int8 [m, k], xs f32 [m, k/512], wq uint8 [n, k/2] split-half packed,
// ws f32 [n, k/512]; out as K5's. Needs k % 512 == 0, n % 128 == 0 and
// 16-byte aligned xq and wq.
extern "C" int flux2_w4a8_matmul(const void* xq, const void* xs, const void* wq, const void* ws, void* out,
                                 int m, int n, int k, int out_f32, void* stream) {
  if (!grid_ok(m, n) || k <= 0 || k % kW4Block || n % kWsBN) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, cmap;
  if (!encode_map_2d(&xmap, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, m, k, 128, kW4Tile, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&cmap, wq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, k / 2, kWsBN, kW4Tile,
                     CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* sa = static_cast<const float*>(xs);
  const float* sb = static_cast<const float*>(ws);
  if (out_f32) return launch_w4a8(xmap, cmap, sa, sb, static_cast<float*>(out), m, n, k, stream);
  return launch_w4a8(xmap, cmap, sa, sb, static_cast<__nv_bfloat16*>(out), m, n, k, stream);
}

// x bf16 [m, k]; codes uint8 [n, k] (int4 = 0) or [n, k/2] (int4 = 1,
// interleaved); scale, bias f32 [n, k/group]; out bf16 [m, n]. Needs
// group == 64, k % 512 == 0 (the K7 gate's), n % 128 == 0 and 16-byte aligned
// pointers.
extern "C" int flux2_dequant_matmul(const void* x, const void* codes, const void* scale, const void* bias,
                                    void* out, int m, int n, int k, int group, int int4, void* stream) {
  if (!grid_ok(m, n) || group != kDqGroup || k <= 0 || k % 512 || n % kWsBN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 256 rows a CTA halve the dequant work where the grid still fills the card.
  const bool wide = m > 128 && ((m + 255) / 256) * (n / kWsBN) >= sm_count();
  const int code_cols = int4 ? k / 2 : k;
  CUtensorMap xmap, cmap;
  if (!encode_map_2d(&xmap, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, m, k, 64, kDqGroup, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map_2d(&cmap, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, code_cols, kWsBN, int4 ? 32 : 64,
                     int4 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (int4) {
    return wide ? launch_dequant<256, true>(xmap, cmap, sc, bi, o, m, n, k, stream)
                : launch_dequant<128, true>(xmap, cmap, sc, bi, o, m, n, k, stream);
  }
  return wide ? launch_dequant<256, false>(xmap, cmap, sc, bi, o, m, n, k, stream)
              : launch_dequant<128, false>(xmap, cmap, sc, bi, o, m, n, k, stream);
}
