// Flash-attention backward for the FLUX.2 DiT, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels flux2_tpu/ops/flash_attention.py:_bwd_dq_kernel
// (K3, :313) and :_bwd_dkv_kernel (K4, :363). Given q, k, v, dO (bf16
// [bh, s, 128]), the forward's natural-log row LSE and delta = rowsum(dO * O)
// (f32 [bh, s_q], delta computed by the wrapper from the bf16 O the forward
// wrote), each kernel recomputes the probabilities tile by tile,
//   p = exp2(s * scale * log2e - lse * log2e),   s = q . k,
// with keys >= S_k and, under the blocked span (queries in [q0, q1) see no
// key >= k0, logit kNegInf, finite), the blocked cells handled as in the
// forward, and
//   K3: dQ = scale * sum_k dS K,   dS = p (dP - delta),  dP = dO V^T;
//   K4: dV = sum_q p^T dO,  dK = scale * sum_q dS^T Q,  in the transposed
//       orientation (a CTA owns a block of keys and loops over the queries).
// p and dS enter the tensor cores as bf16 with f32 accumulation, as P does in
// the forward.
//
// No atomics: K3 owns its dQ rows and K4 its dK/dV rows, as the TPU grids do,
// so both kernels give the same bits from run to run. The cost is that both
// recompute S = Q K^T, and both dP: per head at (S_q, S_k) K3 issues 3 and K4
// 4 products of S_q * S_k * 128 (the forward 2). At the Klein-4B 1024^2 shape
// (bh = 24, S = 4608) that is 3.9e11 FLOP (K3) and 5.2e11 (K4) against
// ~1e8 bytes each: compute-bound like the forward, ~20x past the H100's ~295
// FLOP/byte bf16 ridge (0.396 and 0.528 ms at 989 TFLOP/s). So the design is
// the forward's (flash_attention.cu), carried to the backward: keep the
// tensor cores fed through wgmma from TMA tiles, and keep the operands of the
// 64-wide products off shared memory where registers allow (a 64 x 64 x 16
// product with both operands in shared memory reads them at about the rate
// shared memory gives).
//   - One CTA of three warpgroups. Warpgroups 0 and 1 are the consumers, each
//     owning 64 rows (setmaxnreg.inc to 240 registers: ptxas reports the 168
//     of the launch, and the consumer code names up to R229); warpgroup 2 is
//     the producer (setmaxnreg.dec to 24): one thread issues every TMA load
//     into a 2-stage ring guarded by full mbarriers (expect_tx of the whole
//     box) and empty ones (one arrival per consumer warpgroup).
//   - K3: a CTA owns 128 queries. Q and dO are loaded once by TMA, and each
//     consumer copies its rows' A fragments of both into registers (64
//     registers); 64-key tiles of K and V stream through the ring, from the
//     same 3D tensor maps the forward uses (rows past a head's S read as
//     zeros). S = Q K^T and dP = dO V^T are wgmma m64n64k16 with A from
//     registers and B = K, V from shared memory, K-major; dQ += dS K is
//     m64n128k16 with dS packed from the accumulators into A fragments and
//     the K tile read MN-major (the transpose bit), as the forward reads V. V
//     is released after dP, K after dQ. Registers: Q and dO 64, dQ 64, S and
//     dP 32 each, dS 16.
//   - K4: a CTA owns 128 keys. K and V stay resident in shared memory;
//     64-query tiles of Q and dO stream through the ring. S^T = K Q^T and
//     dP^T = V dO^T are m64n64k16 from shared memory; dV += P^T dO and
//     dK += dS^T Q are m64n128k16 with P^T and dS^T from registers and the
//     dO and Q tiles read MN-major. So no tile is transposed by hand. Each
//     tile's LSE * log2e and delta come from the producer warpgroup's first
//     two warps, which load them with plain loads into the stage beside the
//     tile and arrive on its dO-full barrier: the f32 [bh, S_q] rows have no
//     16-byte head stride for a tensor map. Registers: dK and dV 64 each, S^T
//     and dP^T 32 each, the packed P^T and dS^T 16 each as S^T and dP^T die.
//     K's fragments in registers as well would take 32 more: ptxas then
//     spills and serialises the wgmmas, and K4 runs ~20% slower.
//   - Measured and not kept (PERF.md §6): the forward's ping-pong of the two
//     consumers (slower: K4 serialises its wgmmas for want of registers, K3
//     needs a third stage to draw level) and a 3-stage ring (level).
//   - Masks only on the tiles that need them, as the forward and the JAX
//     kernels gate them. Pad queries (rows past S_q, zero-filled, so s = 0)
//     take lse * log2e = +inf: p = exp2(-inf) = 0 exactly, with no mask. In
//     K3 pad keys get p = 0 on the last key tile of a ragged S_k; in K4 a pad
//     key's row of dK and dV is never stored, and no row of a product depends
//     on another row, so it needs none. The span mask runs only on tiles that
//     meet the span.
//   - The epilogue scales dQ and dK, converts to bf16 and stores with guarded
//     4-byte stores, dropping rows past S.
// The C entries encode the four tensor maps per call, launch on the caller's
// stream, do not synchronise, allocate nothing, and return a cudaError_t.

#include "flash_common.cuh"

namespace {

constexpr int kBwdThreads = 384;  // warpgroups 0 and 1 compute, warpgroup 2 loads
constexpr int kStages = 2;        // depth of the ring of streamed tiles
constexpr int kRows = 128;        // rows a CTA owns: queries in K3, keys in K4
constexpr int kStep = 64;         // rows of a streamed tile: keys in K3, queries in K4

__host__ __device__ constexpr int box_bytes(int rows) { return rows * kBoxCols * 2; }  // one TMA box: rows x 64 columns
__host__ __device__ constexpr int tile_bytes(int rows) { return 2 * box_bytes(rows); }  // a rows x 128 tile, two boxes

// Shared memory (dynamic, base aligned to 1024 bytes for the swizzle): the
// CTA's two resident tiles (Q and dO in K3, K and V in K4), the ring's two
// streamed tiles per stage, K4's row statistics per stage, the mbarriers.
constexpr int kSmemA = 0;
constexpr int kSmemB = kSmemA + tile_bytes(kRows);
constexpr int kSmemRingA = kSmemB + tile_bytes(kRows);
constexpr int kSmemRingB = kSmemRingA + kStages * tile_bytes(kStep);
constexpr int kSmemStats = kSmemRingB + kStages * tile_bytes(kStep);  // per stage: lse * log2e [64], delta [64]
constexpr int kSmemBar = kSmemStats + kStages * 2 * kStep * 4;
constexpr int kNumBars = 1 + 4 * kStages;  // resident-full; A-full, B-full, A-empty, B-empty of each stage
constexpr int kBwdSmem = kSmemBar + 8 * kNumBars + 1024;  // + slack to align the base to 1024 bytes

#define FLUX2_ACC32_REGS                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FLUX2_ACC32 FLUX2_ACC8(0), FLUX2_ACC8(8), FLUX2_ACC8(16), FLUX2_ACC8(24)

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]; B in shared memory, K-major; A
// in shared memory, K-major (wgmma_ss_n64) or in registers (wgmma_rs_n64,
// the A-fragment layout of wgmma_rs). The accumulator layout of wgmma_ss
// with 8 columns a j.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLUX2_ACC32_REGS ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLUX2_ACC32
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLUX2_ACC32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : FLUX2_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// Descriptor of k-step kk (16 columns of d) of a streamed 64-row tile read
// K-major: 4 steps in each 64-column box, a step 32 bytes into the box.
__device__ __forceinline__ uint64_t step_desc(uint32_t tile, int kk) {
  return smem_desc(tile + (kk / 4) * box_bytes(kStep) + (kk % 4) * 32, 16, 1024);
}

// C[64 x 64] = A B^T over d = 128, B a streamed 64-row tile; A is 64 rows of
// a resident tile (K4: ``a_rows``, boxes box_bytes(kRows) apart) or their
// fragments in registers (K3: ``a``). Issued and committed, not waited for.
__device__ __forceinline__ void issue_abt(float (&c)[32], uint32_t a_rows, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    wgmma_ss_n64(c, smem_desc(a_rows + (kk / 4) * box_bytes(kRows) + (kk % 4) * 32, 16, 1024),
                 step_desc(b_tile, kk), kk);
  }
  wgmma_commit();
}

__device__ __forceinline__ void issue_abt(float (&c)[32], const uint32_t (&a)[kD / 16][4], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_rs_n64(c, a[kk], step_desc(b_tile, kk), kk);
  wgmma_commit();
}

// C[64 x 128] += A[64 x 64] B[64 x 128]: A in registers (bf16 pairs packed
// from a 64 x 64 accumulator), B a streamed 64-row tile read MN-major: 4
// steps of 16 rows (2048 bytes), the two 64-column boxes the leading byte
// offset apart. Issued, not committed.
__device__ __forceinline__ void issue_ab(float (&c)[64], const uint32_t (&a)[16], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < kStep / 16; ++kk) {
    wgmma_rs(c, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
             smem_desc(b_tile + kk * 16 * 128, box_bytes(kStep), 1024));
  }
}

// The A fragments over d of a warp's 16 rows [row, row + 16) of a resident
// tile (``tile`` its generic address): the 128-byte swizzle stores 16-byte
// chunk c of row r at chunk c ^ (r % 8) of its 128-byte row.
__device__ __forceinline__ void load_frags(uint32_t (&a)[kD / 16][4], const uint8_t* tile, int row, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row + g + 8 * (i & 1);
      const int c = kk * 16 + 8 * (i >> 1) + 2 * t;
      const int off = (c / kBoxCols) * box_bytes(kRows) + r * 128 + ((((c % kBoxCols) / 8) ^ (r % 8)) * 16) +
                      (c % 8) * 2;
      a[kk][i] = *reinterpret_cast<const uint32_t*>(tile + off);
    }
  }
}

// Rows [row0, row0 + 8) and [row1, ...) of a warpgroup's 64 x 128 f32
// accumulator, times ``mul``, to bf16 rows of ``dst``; rows >= rows dropped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[64], float mul, int row0,
                                           int rows, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * t;
    if (row0 < rows) {
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row0) * kD + col) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    }
    if (row1 < rows) {
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row1) * kD + col) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
}

struct Ring {
  uint32_t base;  // 1024-byte aligned shared address of the layout above
  __device__ uint32_t bar(int i) const { return base + kSmemBar + 8u * i; }
  __device__ uint32_t resident_full() const { return bar(0); }
  __device__ uint32_t a_full(int st) const { return bar(1 + st); }
  __device__ uint32_t b_full(int st) const { return bar(1 + kStages + st); }
  __device__ uint32_t a_empty(int st) const { return bar(1 + 2 * kStages + st); }
  __device__ uint32_t b_empty(int st) const { return bar(1 + 3 * kStages + st); }
  __device__ uint32_t ring_a(int st) const { return base + kSmemRingA + st * tile_bytes(kStep); }
  __device__ uint32_t ring_b(int st) const { return base + kSmemRingB + st * tile_bytes(kStep); }
};

// Barriers of the ring; ``b_full_count`` arrivals complete a B-full phase.
__device__ __forceinline__ void init_ring(const Ring& r, uint32_t b_full_count) {
  mbar_init(r.resident_full(), 1);
  for (int st = 0; st < kStages; ++st) {
    mbar_init(r.a_full(st), 1);
    mbar_init(r.b_full(st), b_full_count);
    mbar_init(r.a_empty(st), 2);  // one arrival per consumer warpgroup
    mbar_init(r.b_empty(st), 2);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// The resident tiles (rows [row, row + 128) of ``ma`` and ``mb``) onto resident-full.
__device__ __forceinline__ void load_resident(const Ring& r, const CUtensorMap* ma, const CUtensorMap* mb, int row,
                                              int bh) {
  mbar_expect_tx(r.resident_full(), 2 * tile_bytes(kRows));
  tma_load(r.base + kSmemA, ma, r.resident_full(), 0, row, bh);
  tma_load(r.base + kSmemA + box_bytes(kRows), ma, r.resident_full(), kBoxCols, row, bh);
  tma_load(r.base + kSmemB, mb, r.resident_full(), 0, row, bh);
  tma_load(r.base + kSmemB + box_bytes(kRows), mb, r.resident_full(), kBoxCols, row, bh);
}

// A streamed 64-row tile of ``map`` at ``row`` into ``dst``, counted on ``full``.
__device__ __forceinline__ void load_step(uint32_t dst, const CUtensorMap* map, uint32_t full, int row, int bh) {
  mbar_expect_tx(full, tile_bytes(kStep));
  tma_load(dst, map, full, 0, row, bh);
  tma_load(dst + box_bytes(kStep), map, full, kBoxCols, row, bh);
}

// ---- K3 --------------------------------------------------------------------

// dS = p (dP - delta) of one 64-key tile, in bf16 pairs (the A fragments of
// dQ += dS K), p = exp2(s * scale * log2e - lse2) from the forward's LSE. On
// a masked tile, pad keys get p = 0 and blocked cells the logit kNegInf.
__device__ __forceinline__ void ds_tile(const float (&s)[32], const float (&dp)[32], uint32_t (&ds)[16],
                                        const float (&lse2)[2], const float (&dl)[2], float sc, bool masked,
                                        int key0, int s_k, int k0, int t, bool span0, bool span1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = fmaf(s[4 * j + e], sc, -lse2[r]);
      if (masked) {
        const int col = key0 + j * 8 + 2 * t + (e & 1);
        if ((r ? span1 : span0) && col >= k0) x = kNegInf - lse2[r];
        if (col >= s_k) x = -CUDART_INF_F;
      }
      v[e] = ex2(x) * (dp[4 * j + e] - dl[r]);
    }
    ds[2 * j] = pack_bf16(v[0], v[1]);
    ds[2 * j + 1] = pack_bf16(v[2], v[3]);
  }
}

// K3: one CTA per (128-query block, b*h); loops over 64-key tiles.
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                    int s_q, int s_k, float scale, float scale_log2, int q0, int q1, int k0, int has_span) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Ring ring{(smem_u32(smem_raw) + 1023u) & ~1023u};
  const int bh = blockIdx.y;
  const int q_blk = blockIdx.x * kRows;
  const int n_kt = (s_k + kStep - 1) / kStep;

  if (threadIdx.x == 0) init_ring(ring, 1);
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      load_resident(ring, &qmap, &domap, q_blk, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kStages;
        const uint32_t free_parity = ((kt / kStages) & 1) ^ 1;  // the first pass finds the stage free
        mbar_wait(ring.a_empty(st), free_parity);
        load_step(ring.ring_a(st), &kmap, ring.a_full(st), kt * kStep, bh);
        mbar_wait(ring.b_empty(st), free_parity);
        load_step(ring.ring_b(st), &vmap, ring.b_full(st), kt * kStep, bh);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each. Per key tile: S and dP, then
    // dS in registers, then dQ += dS K.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) >> 2;
    const int t = tid & 3;
    const int wg_row = q_blk + w * 64;
    const int row0 = wg_row + (tid / 32) * 16 + g;  // this thread's two query rows
    const int row1 = row0 + 8;
    const bool span_wg = has_span && wg_row < q1 && wg_row + 64 > q0;
    const bool span0 = has_span && row0 >= q0 && row0 < q1;
    const bool span1 = has_span && row1 >= q0 && row1 < q1;
    const bool ragged = (s_k % kStep) != 0;
    // Pad rows: lse2 = +inf gives p = 0 (their q is zero-filled, so s = 0).
    const float* lh = lse + static_cast<size_t>(bh) * s_q;
    const float* dh = delta + static_cast<size_t>(bh) * s_q;
    const float lse2[2] = {row0 < s_q ? lh[row0] * kLog2e : CUDART_INF_F,
                           row1 < s_q ? lh[row1] * kLog2e : CUDART_INF_F};
    const float dl[2] = {row0 < s_q ? dh[row0] : 0.f, row1 < s_q ? dh[row1] : 0.f};

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    float s[32], dp[32];
    uint32_t ds[16];

    // Q and dO enter S = Q K^T and dP = dO V^T from registers, loaded once:
    // then those products read only K and V from shared memory.
    mbar_wait(ring.resident_full(), 0);
    uint32_t qf[kD / 16][4], df[kD / 16][4];
    const uint8_t* smem = smem_raw + (ring.base - smem_u32(smem_raw));
    load_frags(qf, smem + kSmemA, w * 64 + (tid / 32) * 16, g, t);
    load_frags(df, smem + kSmemB, w * 64 + (tid / 32) * 16, g, t);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kStages;
      const uint32_t parity = (kt / kStages) & 1;
      const uint32_t k_tile = ring.ring_a(st);
      mbar_wait(ring.a_full(st), parity);
      wgmma_fence();
      issue_abt(s, qf, k_tile);
      mbar_wait(ring.b_full(st), parity);
      issue_abt(dp, df, ring.ring_b(st));
      wgmma_wait_all();
      fence_acc(s);
      fence_acc(dp);
      if (tid == 0) mbar_arrive(ring.b_empty(st));
      const bool masked = (ragged && kt == n_kt - 1) || (span_wg && kt * kStep + kStep > k0);
      ds_tile(s, dp, ds, lse2, dl, scale_log2, masked, kt * kStep, s_k, k0, t, span0, span1);
      wgmma_fence();
      issue_ab(acc, ds, k_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      fence_regs(ds);
      if (tid == 0) mbar_arrive(ring.a_empty(st));
    }
    store_rows(dq + static_cast<size_t>(bh) * s_q * kD, acc, scale, row0, s_q, t);
  }
}

// ---- K4 --------------------------------------------------------------------

// P^T and dS^T = P^T (dP^T - delta) of one 64-query tile (keys in rows,
// queries in columns), in bf16 pairs: the A fragments of dV += P^T dO and
// dK += dS^T Q. ``stats`` holds the tile's lse * log2e (+inf past S_q) and
// delta. On a masked tile the blocked cells get the logit kNegInf.
__device__ __forceinline__ void pds_tile(const float (&s)[32], const float (&dp)[32], uint32_t (&pt)[16],
                                         uint32_t (&dst)[16], const float* stats, float sc, bool masked,
                                         int query0, int q0, int q1, int t, bool blocked0, bool blocked1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    const float2 lse2 = *reinterpret_cast<const float2*>(stats + c);
    const float2 dl = *reinterpret_cast<const float2*>(stats + kStep + c);
    float p[4], d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = (e & 1) ? lse2.y : lse2.x;
      float x = fmaf(s[4 * j + e], sc, -l);
      if (masked) {
        const int q = query0 + c + (e & 1);
        if (((e >> 1) ? blocked1 : blocked0) && q >= q0 && q < q1) x = kNegInf - l;
      }
      p[e] = ex2(x);
      d[e] = p[e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
    }
    pt[2 * j] = pack_bf16(p[0], p[1]);
    pt[2 * j + 1] = pack_bf16(p[2], p[3]);
    dst[2 * j] = pack_bf16(d[0], d[1]);
    dst[2 * j + 1] = pack_bf16(d[2], d[3]);
  }
}

// K4: one CTA per (128-key block, b*h); loops over 64-query tiles.
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int s_q, int s_k, float scale, float scale_log2, int q0, int q1, int k0, int has_span) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const Ring ring{base};
  float* stats = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + kSmemStats);
  const int bh = blockIdx.y;
  const int key_blk = blockIdx.x * kRows;
  const int n_qt = (s_q + kStep - 1) / kStep;

  // B-full (dO) completes on the producer thread's expect_tx and one arrival
  // from each of the 64 threads that store the tile's statistics.
  if (threadIdx.x == 0) init_ring(ring, 1 + kStep);
  __syncthreads();

  if (threadIdx.x >= 256) {
    // Producer warpgroup: thread 0 issues the TMA loads; threads 0-63 load
    // the row statistics of each query tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int p = threadIdx.x - 256;
    if (p < kStep) {
      const float* lh = lse + static_cast<size_t>(bh) * s_q;
      const float* dh = delta + static_cast<size_t>(bh) * s_q;
      if (p == 0) load_resident(ring, &kmap, &vmap, key_blk, bh);
      for (int qt = 0; qt < n_qt; ++qt) {
        const int st = qt % kStages;
        const uint32_t free_parity = ((qt / kStages) & 1) ^ 1;
        const int q = qt * kStep + p;
        const float l = q < s_q ? lh[q] * kLog2e : CUDART_INF_F;  // a pad query's p is exp2(-inf) = 0
        const float d = q < s_q ? dh[q] : 0.f;
        // Q and dO are released together, on A-empty: both products of a
        // tile read both tiles.
        mbar_wait(ring.a_empty(st), free_parity);
        if (p == 0) {
          load_step(ring.ring_a(st), &qmap, ring.a_full(st), qt * kStep, bh);
          load_step(ring.ring_b(st), &domap, ring.b_full(st), qt * kStep, bh);
        }
        stats[st * 2 * kStep + p] = l;
        stats[st * 2 * kStep + kStep + p] = d;
        mbar_arrive(ring.b_full(st));
      }
    }
  } else {
    // Consumer warpgroups: 64 key rows each. Per query tile: S^T and dP^T,
    // then P^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int g = (tid % 32) >> 2;
    const int t = tid & 3;
    const int wg_key = key_blk + w * 64;
    const int key0 = wg_key + (tid / 32) * 16 + g;  // this thread's two key rows
    const bool span_wg = has_span && wg_key + 64 > k0;
    const bool blocked0 = has_span && key0 >= k0;
    const bool blocked1 = has_span && key0 + 8 >= k0;
    const uint32_t k_rows = base + kSmemA + w * 64 * 128;
    const uint32_t v_rows = base + kSmemB + w * 64 * 128;

    float acc_dk[64], acc_dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    float s[32], dp[32];
    uint32_t pt[16], dst[16];

    mbar_wait(ring.resident_full(), 0);
    for (int qt = 0; qt < n_qt; ++qt) {
      const int st = qt % kStages;
      const uint32_t parity = (qt / kStages) & 1;
      const uint32_t q_tile = ring.ring_a(st);
      const uint32_t do_tile = ring.ring_b(st);
      mbar_wait(ring.a_full(st), parity);
      wgmma_fence();
      issue_abt(s, k_rows, q_tile);
      mbar_wait(ring.b_full(st), parity);
      issue_abt(dp, v_rows, do_tile);
      wgmma_wait_all();
      fence_acc(s);
      fence_acc(dp);
      const bool masked = span_wg && qt * kStep < q1 && qt * kStep + kStep > q0;
      pds_tile(s, dp, pt, dst, stats + st * 2 * kStep, scale_log2, masked, qt * kStep, q0, q1, t, blocked0,
               blocked1);
      wgmma_fence();
      issue_ab(acc_dv, pt, do_tile);
      issue_ab(acc_dk, dst, q_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc_dv);
      fence_acc(acc_dk);
      fence_regs(pt);
      fence_regs(dst);
      if (tid == 0) mbar_arrive(ring.a_empty(st));
    }
    store_rows(dk + static_cast<size_t>(bh) * s_k * kD, acc_dk, scale, key0, s_k, t);
    store_rows(dv + static_cast<size_t>(bh) * s_k * kD, acc_dv, 1.f, key0, s_k, t);
  }
}

// The four maps of a backward call: the operands a CTA keeps resident have
// kRows-row boxes, the streamed ones kStep-row boxes.
bool encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout, int bh,
                 int s_q, int s_k, bool queries_resident) {
  const int q_rows = queries_resident ? kRows : kStep;
  const int k_rows = queries_resident ? kStep : kRows;
  return encode_map(&maps[0], q, bh, s_q, q_rows) && encode_map(&maps[1], k, bh, s_k, k_rows) &&
         encode_map(&maps[2], v, bh, s_k, k_rows) && encode_map(&maps[3], dout, bh, s_q, q_rows);
}

bool bad_sizes(int bh, int s_q, int s_k, int d, float scale) {
  return d != kD || bh <= 0 || bh > 65535 || s_q <= 0 || s_k <= 0 || !(scale > 0.f);
}

}  // namespace

// q, dout, dq: contiguous, 16-byte aligned bf16 [bh, s_q, 128]; k, v: [bh, s_k,
// 128]; lse, delta: contiguous f32 [bh, s_q]; scale > 0. Writes dq; returns a
// cudaError_t.
extern "C" int flux2_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                            const void* lse, const void* delta, void* dq,
                                            int bh, int s_q, int s_k, int d, float scale,
                                            int q0, int q1, int k0, int has_span, void* stream) {
  CUtensorMap maps[4];
  if (bad_sizes(bh, s_q, s_k, d, scale) || !encode_maps(maps, q, k, v, dout, bh, s_q, s_k, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s_q + kRows - 1) / kRows, bh);
  flash_bwd_dq_kernel<<<grid, kBwdThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), s_q, s_k, scale, scale * kLog2e, q0, q1, k0, has_span);
  return static_cast<int>(cudaGetLastError());
}

// As flux2_flash_attention_bwd_dq; writes dk and dv, contiguous bf16 [bh, s_k, 128].
extern "C" int flux2_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                             const void* lse, const void* delta, void* dk, void* dv,
                                             int bh, int s_q, int s_k, int d, float scale,
                                             int q0, int q1, int k0, int has_span, void* stream) {
  CUtensorMap maps[4];
  if (bad_sizes(bh, s_q, s_k, d, scale) || !encode_maps(maps, q, k, v, dout, bh, s_q, s_k, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s_k + kRows - 1) / kRows, bh);
  flash_bwd_dkv_kernel<<<grid, kBwdThreads, kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), s_q, s_k, scale, scale * kLog2e, q0, q1,
      k0, has_span);
  return static_cast<int>(cudaGetLastError());
}
