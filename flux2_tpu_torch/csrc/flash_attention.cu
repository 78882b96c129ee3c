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
// accumulation of P V), keys >= S_k at weight exactly 0 (logit -inf) on the
// ragged last tile, and the optional blocked span (queries in [q0, q1) see no
// key >= k0: logit kNegInf, finite, so a fully blocked row averages its keys).
//
// What bounds it on this card: at the 1024^2 Klein-4B shape (B=1, H=24,
// S=4608, D=128) one call is 4*S^2*D*H = 2.6e11 FLOP against 113 MB of
// q/k/v/o in HBM, about 2300 FLOP/byte: compute-bound, about 8x past the
// H100's ~295 FLOP/byte bf16 ridge (0.264 ms at 989 TFLOP/s). The design's
// job is keeping the tensor cores fed, which on Hopper means wgmma fed by TMA:
//   - one CTA of three warpgroups per (b*h, 128-query tile). Warpgroup 0 is
//     the producer: one thread issues every TMA load, the warpgroup gives its
//     registers away (setmaxnreg.dec). Warpgroups 1 and 2 are the consumers,
//     each owning 64 query rows (setmaxnreg.inc to 232 registers; their
//     code names up to R165, within the 168 that 384 threads get at launch);
//   - shared memory (dynamic, ~161 KB): the Q tile (128 x 128 bf16), loaded
//     once, and a 2-stage ring of 128-key K and V tiles. Each tile is two
//     boxes of 128 rows x 64 columns with the 128-byte swizzle (a swizzled
//     row holds at most 128 bytes), read by wgmma through descriptors of
//     that layout. The tensor maps are 3D [bh, s, 128], so rows past a
//     head's S are zero-filled by TMA and never read from the next head;
//   - per stage four mbarriers: K-full and V-full (armed by the producer
//     with expect_tx of the whole box, out-of-bounds rows included), and
//     K-empty and V-empty (one arrival per consumer warpgroup once its
//     product that reads the tile is done), so S = Q K^T starts while V is
//     still in flight and a K tile is refilled before its V is released;
//   - S = Q K^T is wgmma m64n128k16 with A = Q and B = K from shared memory,
//     both K-major (K's [keys][d] rows are already B's layout);
//   - O += P V is wgmma m64n128k16 with A = P from registers (the f32 S
//     accumulator packed to bf16 pairs is A's register fragment) and B = V
//     from its TMA tile, MN-major (the transpose bit), so V is never
//     transposed by hand;
//   - the softmax stays in registers: row max and row sum across the four
//     threads of a row, p = exp2(s * scale * log2e - m) as one FFMA and one
//     ex2. The pad mask runs only on the last key tile of a ragged S_k and
//     the span mask only on tiles that meet the span, as the JAX kernel gates
//     them per tile; every other tile runs maskless;
//   - ping-pong: a consumer warpgroup issues its products (O += P V of the
//     previous tile, then S of this one) only in its turn, a named barrier
//     the other warpgroup releases after issuing its own, so one
//     warpgroup's softmax runs while the other's products hold the tensor
//     cores. (Overlapping a warpgroup's own softmax with its next S as well,
//     which keeps S, P and O live at once, measured level with the ping-pong
//     on top of it and slower than it alone, so it is not done.)
//   - the epilogue normalises O in registers and stores it with guarded
//     4-byte stores (rows >= S_q dropped); K2 stores its LSE from one thread
//     per row.
// At (1, 24, 4608, 128) the grid is 36 x 24 = 864 CTAs, one per SM (the
// shared memory allows no second), 6.5 waves on 132 SMs; at the 512^2 train
// shape (S = 1056) it is 9 x 24 = 216, 1.6 waves.
// The C entry encodes the three tensor maps per call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so nothing links libcuda),
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns a cudaError_t.

#include "flash_common.cuh"

namespace {

// The forward's tiling.
constexpr int kFwdRows = 128;                      // query rows of a CTA, and keys of a K/V tile
constexpr int kFwdStages = 2;                      // depth of the K/V ring
constexpr int kFwdThreads = 384;                   // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr int kBoxBytes = kFwdRows * kBoxCols * 2;  // one TMA box: 128 rows x 64 columns, 16 KB
constexpr int kTileBytes = 2 * kBoxBytes;          // a 128 x 128 tile, two boxes side by side
constexpr int kSmemQ = 0;
constexpr int kSmemK = kSmemQ + kTileBytes;
constexpr int kSmemV = kSmemK + kFwdStages * kTileBytes;
constexpr int kSmemBar = kSmemV + kFwdStages * kTileBytes;
constexpr int kNumBars = 1 + 4 * kFwdStages;  // Q-full; K-full, V-full, K-empty and V-empty of each stage
constexpr int kFwdSmem = kSmemBar + 8 * kNumBars + 1024;  // + slack to align the base to 1024 bytes

// ---- the kernel ------------------------------------------------------------

// S = Q K^T of this warpgroup's 64 rows against one 128-key tile: 8 steps of
// 16 along d, 4 in each 64-column box; within a box a step advances the start
// address by 32 bytes. Issued, not waited for.
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss(s, smem_desc(q_rows + off, 16, 1024), smem_desc(k_tile + off, 16, 1024), kk);
  }
  wgmma_commit();
}

// O += P V over one 128-key tile: 8 steps of 16 keys; a step advances 16 rows
// (2048 bytes) of the V tile, and the two 64-column boxes are the leading byte
// offset apart. Issued, not waited for.
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&p)[32], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kFwdRows / 16; ++kk) {
    wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             smem_desc(v_tile + kk * 16 * 128, kBoxBytes, 1024));
  }
  wgmma_commit();
}

// Online softmax of one S tile (in place, masked where the tile needs it):
// new row max m, the rescale alpha of the old O and l, P in bf16 pairs.
__device__ __forceinline__ void softmax_tile(float (&s)[64], uint32_t (&p)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool masked, int key0, int s_k, int k0, int t,
                                             bool span0, bool span1, float scale_log2) {
  // A masked tile holds its logits already scaled (sc = 1); a maskless one
  // scales in the FFMA below.
  float sc = scale_log2;
  if (masked) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = key0 + j * 8 + 2 * t + (e & 1);
        float x = s[4 * j + e] * scale_log2;
        if (col >= s_k) {
          x = -CUDART_INF_F;  // pad key: weight exactly 0
        } else if (((e < 2) ? span0 : span1) && col >= k0) {
          x = kNegInf;
        }
        s[4 * j + e] = x;
      }
    }
    sc = 1.f;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float neg_m[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * sc);  // sc > 0: max commutes with the scaling
    alpha[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    neg_m[i] = -m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float p0 = ex2(fmaf(s[4 * j], sc, neg_m[0]));
    const float p1 = ex2(fmaf(s[4 * j + 1], sc, neg_m[0]));
    const float p2 = ex2(fmaf(s[4 * j + 2], sc, neg_m[1]));
    const float p3 = ex2(fmaf(s[4 * j + 3], sc, neg_m[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    p[2 * j] = pack_bf16(p0, p1);
    p[2 * j + 1] = pack_bf16(p2, p3);
  }
}

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory"); }
__device__ __forceinline__ void named_arrive(int id) { asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory"); }

template <bool kWriteLse>
__device__ __forceinline__ void flash_fwd_body(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                               const CUtensorMap* vmap, __nv_bfloat16* __restrict__ out,
                                               float* __restrict__ lse, int s_q, int s_k, float scale_log2,
                                               int q0, int q1, int k0, int has_span) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t sq = base + kSmemQ;
  const uint32_t sk = base + kSmemK;
  const uint32_t sv = base + kSmemV;
  const uint32_t bar_q = base + kSmemBar;
  auto bar_k = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_v = [&](int st) { return bar_q + 8u * (1 + kFwdStages + st); };
  auto bar_k_empty = [&](int st) { return bar_q + 8u * (1 + 2 * kFwdStages + st); };
  auto bar_v_empty = [&](int st) { return bar_q + 8u * (1 + 3 * kFwdStages + st); };

  const int bh = blockIdx.y;
  const int q_tile = blockIdx.x * kFwdRows;
  const int n_kt = (s_k + kFwdRows - 1) / kFwdRows;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(bar_k(st), 1);
      mbar_init(bar_v(st), 1);
      mbar_init(bar_k_empty(st), 2);  // one arrival per consumer warpgroup
      mbar_init(bar_v_empty(st), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kTileBytes);
      tma_load(sq, qmap, bar_q, 0, q_tile, bh);
      tma_load(sq + kBoxBytes, qmap, bar_q, kBoxCols, q_tile, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % kFwdStages;
        const uint32_t free_parity = ((kt / kFwdStages) & 1) ^ 1;  // the first pass finds the stage free
        const int row = kt * kFwdRows;
        const uint32_t k_dst = sk + st * kTileBytes;
        const uint32_t v_dst = sv + st * kTileBytes;
        mbar_wait(bar_k_empty(st), free_parity);
        mbar_expect_tx(bar_k(st), kTileBytes);
        tma_load(k_dst, kmap, bar_k(st), 0, row, bh);
        tma_load(k_dst + kBoxBytes, kmap, bar_k(st), kBoxCols, row, bh);
        mbar_wait(bar_v_empty(st), free_parity);
        mbar_expect_tx(bar_v(st), kTileBytes);
        tma_load(v_dst, vmap, bar_v(st), 0, row, bh);
        tma_load(v_dst + kBoxBytes, vmap, bar_v(st), kBoxCols, row, bh);
      }
    }
  } else {
    // Consumer warpgroups: 64 query rows each. For key tile j, in this
    // warpgroup's turn: O += P V of tile j-1, then S = Q K_j^T; out of turn:
    // the softmax of S, which rescales O and l and makes the next P.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int wg_row = q_tile + w * 64;
    const int row0 = wg_row + warp * 16 + g;  // this thread's two query rows
    const int row1 = row0 + 8;
    const bool span_wg = has_span && wg_row < q1 && wg_row + 64 > q0;
    const bool span0 = has_span && row0 >= q0 && row0 < q1;
    const bool span1 = has_span && row1 >= q0 && row1 < q1;
    const bool ragged = (s_k % kFwdRows) != 0;
    const uint32_t q_rows = sq + w * 64 * 128;  // this warpgroup's rows of each Q box (128 bytes a row)
    auto masked = [&](int kt) {
      return (ragged && kt == n_kt - 1) || (span_wg && kt * kFwdRows + kFwdRows > k0);
    };

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running row max, log2 domain
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    float alpha[2];
    float s[64];
    uint32_t p[32];  // P of the previous tile in bf16 pairs: the A fragments of O += P V

    const int my_turn = 1 + w;  // named barriers 1 and 2 (0 is __syncthreads')
    const int other_turn = 2 - w;
    if (w == 1) named_arrive(1);  // warpgroup 1 (w = 0) goes first
    mbar_wait(bar_q, 0);
    named_sync(my_turn);
    mbar_wait(bar_k(0), 0);
    wgmma_fence();
    issue_qk(s, q_rows, sk);
    named_arrive(other_turn);
    wgmma_wait_all();
    fence_acc(s);
    if (tid == 0) mbar_arrive(bar_k_empty(0));
    softmax_tile(s, p, m, l, alpha, masked(0), 0, s_k, k0, t, span0, span1, scale_log2);

    for (int kt = 1; kt < n_kt; ++kt) {
      const int st = kt % kFwdStages;
      const int prev = (kt - 1) % kFwdStages;
      named_sync(my_turn);
      mbar_wait(bar_v(prev), ((kt - 1) / kFwdStages) & 1);
      wgmma_fence();
      issue_pv(o, p, sv + prev * kTileBytes);
      wgmma_wait_all();
      fence_acc(o);
      fence_regs(p);
      if (tid == 0) mbar_arrive(bar_v_empty(prev));
      mbar_wait(bar_k(st), (kt / kFwdStages) & 1);
      wgmma_fence();
      issue_qk(s, q_rows, sk + st * kTileBytes);
      named_arrive(other_turn);
      wgmma_wait_all();
      fence_acc(s);
      if (tid == 0) mbar_arrive(bar_k_empty(st));
      softmax_tile(s, p, m, l, alpha, masked(kt), kt * kFwdRows, s_k, k0, t, span0, span1, scale_log2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
    }
    const int last = (n_kt - 1) % kFwdStages;
    named_sync(my_turn);
    mbar_wait(bar_v(last), ((n_kt - 1) / kFwdStages) & 1);
    wgmma_fence();
    issue_pv(o, p, sv + last * kTileBytes);
    wgmma_wait_all();
    fence_acc(o);
    fence_regs(p);
    if (tid == 0) mbar_arrive(bar_v_empty(last));
    if (w == 0) named_arrive(other_turn);  // the last hand-over; warpgroup 2's would find no taker

    // Row sums across the 4 threads of each row, then normalise and store.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    const float inv0 = 1.f / l[0];
    const float inv1 = 1.f / l[1];
    __nv_bfloat16* oh = out + static_cast<size_t>(bh) * s_q * kD;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + 2 * t;
      if (row0 < s_q) {
        *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row0) * kD + col) =
            pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      }
      if (row1 < s_q) {
        *reinterpret_cast<uint32_t*>(oh + static_cast<size_t>(row1) * kD + col) =
            pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
    if constexpr (kWriteLse) {
      if (t != 0) return;
      // Natural-log row LSE, as the JAX kernel returns it: m is the running max
      // in the log2 domain (logits * scale * log2e), so lse = (m + log2 l) * ln2.
      float* lh = lse + static_cast<size_t>(bh) * s_q;
      if (row0 < s_q) lh[row0] = (m[0] + log2f(l[0])) * kLn2;
      if (row1 < s_q) lh[row1] = (m[1] + log2f(l[1])) * kLn2;
    }
  }
}

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int s_q, int s_k, float scale_log2, int q0, int q1, int k0, int has_span) {
  flash_fwd_body<false>(&qmap, &kmap, &vmap, out, lse, s_q, s_k, scale_log2, q0, q1, k0, has_span);
}

__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_lse_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int s_q, int s_k, float scale_log2, int q0, int q1, int k0,
                     int has_span) {
  flash_fwd_body<true>(&qmap, &kmap, &vmap, out, lse, s_q, s_k, scale_log2, q0, q1, k0, has_span);
}

template <bool kWriteLse>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int s_q, int s_k, int d,
               float scale, int q0, int q1, int k0, int has_span, void* stream) {
  if (d != kD || bh <= 0 || bh > 65535 || s_q <= 0 || s_k <= 0 || !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map(&qmap, q, bh, s_q, kFwdRows) || !encode_map(&kmap, k, bh, s_k, kFwdRows) ||
      !encode_map(&vmap, v, bh, s_k, kFwdRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = kWriteLse ? flash_fwd_lse_kernel : flash_fwd_kernel;
  const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s_q + kFwdRows - 1) / kFwdRows, bh);
  kernel<<<grid, kFwdThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), s_q, s_k, scale * kLog2e, q0,
      q1, k0, has_span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous, 16-byte aligned bf16 [bh, s, d] with d == 128 and
// scale > 0; returns a cudaError_t.
extern "C" int flux2_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                         int bh, int s_q, int s_k, int d, float scale,
                                         int q0, int q1, int k0, int has_span, void* stream) {
  return launch_fwd<false>(q, k, v, out, nullptr, bh, s_q, s_k, d, scale, q0, q1, k0, has_span, stream);
}

// As flux2_flash_attention_fwd, and lse: contiguous f32 [bh, s_q], the natural-log row LSE.
extern "C" int flux2_flash_attention_fwd_lse(const void* q, const void* k, const void* v, void* out, void* lse,
                                             int bh, int s_q, int s_k, int d, float scale,
                                             int q0, int q1, int k0, int has_span, void* stream) {
  return launch_fwd<true>(q, k, v, out, lse, bh, s_q, s_k, d, scale, q0, q1, k0, has_span, stream);
}
