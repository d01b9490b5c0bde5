// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces the Pallas TPU kernel cips_tpu/ops/pallas/flash_attention.py:_flash_kernel,
// launched by _flash_forward. Same math: online-softmax attention over (B*H, L, Dh)
// q, k, v; scores s = scale * q k^T in fp32; running max m, denominator l and an fp32
// output accumulator; P is rounded to the input dtype before P.V; out = acc / max(l, 1e-30)
// in the input dtype; lse = m + log(max(l, 1e-30)) in fp32 and natural-log units, shape
// (B*H, Lq), kept as the residual the backward kernels read.
//
// What bounds it on an H100 SXM. At the flagship's training shape (B=2, H=4, L=2304, Dh=32)
// the two products are 4*B*H*L^2*Dh = 5.4 GFLOP: 5.5 us at 989 TFLOP/s bf16. q, k, v, out and
// lse move 4.8 MB: 1.4 us at 3.35 TB/s. The B*H*L^2 = 42.5 M exponentials run on the
// special-function units at 16 a clock per SM: 10 us at 132 SMs and 1.98 GHz. So at Dh 32
// the exponentials bound it, then the tensor cores; at Dh 128 the products do.
//
// What the bf16 design does about that.
//  - Exponentials: scores are kept in base 2. With c = scale * log2(e), the row max is taken
//    over raw scores and scaled once, and each score costs one FFMA and one ex2:
//    p = 2^(s c - m). lse is turned back into natural-log units at the end.
//  - Tensor cores: both products are wgmma (m64nNk16, fp32 accumulators). Q K^T reads Q
//    and K from swizzled shared memory; P V takes P from registers (the register-A form: two
//    score accumulator tiles are one A k-step) and reads V with wgmma's transpose bit, so
//    no tile is ever transposed by hand.
//  - Memory latency: a CTA owns 64 q rows. Q arrives once by TMA; K and V tiles of 64 keys
//    stream through a ring of 3 stages (2 at Dh 128) per warpgroup, filled by TMA
//    (cp.async.bulk.tensor with 64- or 128-byte swizzle, hardware zero fill past lk) and
//    completed on mbarriers, so the next tiles load while this one is multiplied.
//  - Warps in flight: two warpgroups per CTA split the key range (even and odd tiles) and
//    merge m, l and acc through shared memory at the end, one store, no atomics. At the
//    flagship shape that is 8 heads x 36 q tiles = 288 CTAs of 8 warps (2,304 warps) on
//    132 SMs, where one warpgroup per CTA would give half as many.
// The ragged last key tile is masked (keys to -inf); rows past lq are zero and not stored.
// Any Lq and Lk, Dh 32/64/128.
//
// fp32 inputs take a kernel of the same structure (a CTA of two groups of warps per q tile on
// even and odd key tiles of a TMA ring, exp2, merged in shared memory) whose two products are
// 3xTF32 on mma.sync m16n8k8 (mma_tf32.cuh): each fp32 operand split into two tf32 parts, three
// tensor-core passes, fp32 accumulation. wgmma takes tf32 only K-major from shared memory, and
// P V would need V transposed, so mma.sync it is. Its bound on an H100 SXM at (2, 4, 2304, 32):
// the 5.4 GFLOP three times at the TF32 rate (494.5 TFLOP/s), 33 us. Q's A fragments are split
// where they are loaded; P becomes the A operand of P V straight from the score accumulators
// (acc_to_a) and never leaves registers. The tensor cores truncate inside a sum, so no long sum
// stays in them: S over at most 4 k-steps of Dh, then fp32 adds; P V over one key tile into a
// fresh accumulator, added to O by fp32 adds after O is rescaled. A CTA owns 32 q rows (two
// groups of 2 warps), so that the last of the waves is full; three CTAs an SM at Dh 32, where
// Q's split fragments stay in registers, one at Dh 64 and 128. Its rounding model is
// flash_attention_tf32x3_reference (ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper_sm90.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBlockQ = 64;  // q rows per CTA (one wgmma M)
constexpr int kBlockK = 64;  // keys per ring tile
constexpr int kGroups = 2;   // warpgroups per CTA; group w takes key tiles w, w + 2, ...
constexpr int kGroupThreads = 128;
constexpr float kNegInf = -1e30f;  // initial running max, as in the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct FwdLayout {
  static constexpr int kStages = DH >= 128 ? 2 : 3;
  static constexpr int kTile = kTileBytes<kBlockK, DH>;  // one Q, K or V tile
  static constexpr int kStage = 2 * kTile;                // K and V
  static constexpr int kRing = kTile;                     // after the Q tile
  static constexpr int kBars = kRing + kGroups * kStages * kStage;
  static constexpr int kBytes = kBars + (1 + kGroups * kStages) * 8;
  static constexpr int kMerge = DH / 2 + 4;  // floats a thread of group 1 hands to group 0
  static_assert(kMerge * kGroupThreads * 4 <= kGroups * kStages * kStage, "merge buffer fits in the ring");
};

template <int DH>
__global__ void __launch_bounds__(kGroups * kGroupThreads) flash_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out, float* __restrict__ lse, int lq, int lk,
    float scale_log2) {
  using L = FwdLayout<DH>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // Q, then [group][stage]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int group = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;
  const int g = (tid % 32) / 4;  // fragment row within an 8-row group
  const int t = tid % 4;         // thread within the quad that shares a row
  const int r0 = q0 + (tid / 32) * 16 + g;  // this thread's rows: r0, r0 + 8
  const int n_tiles = (lk + kBlockK - 1) / kBlockK;
  const int mine = (n_tiles - group + 1) / 2;  // this group's tiles: group + 2 i
  uint64_t* full = bars + 1 + group * kStages;
  uint8_t* ring = smem + L::kRing + group * kStages * L::kStage;

  auto issue = [&](int i) {  // this group's tile i into stage i % kStages
    uint8_t* stage = ring + (i % kStages) * L::kStage;
    uint64_t* bar = &full[i % kStages];
    const int k0 = (group + 2 * i) * kBlockK;
    mbar_expect_tx(bar, L::kStage);
    tma_load_tile<kBlockK, DH>(reinterpret_cast<bf16*>(stage), &k_map, bar, k0, bh);
    tma_load_tile<kBlockK, DH>(reinterpret_cast<bf16*>(stage + L::kTile), &v_map, bar, k0, bh);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kGroups * kStages; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (group == 0) {
      mbar_expect_tx(&bars[0], L::kTile);
      tma_load_tile<kBlockQ, DH>(qs, &q_map, &bars[0], q0, bh);
    }
    for (int i = 0; i < kStages && i < mine; ++i) issue(i);
  }

  float m[2] = {kNegInf, kNegInf};  // running max of s * c, this thread's two rows
  float l[2] = {0.f, 0.f};          // partial row sums over this thread's columns
  float acc[DH / 8][4];
  float s[kBlockK / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kBlockK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int i = 0; i < mine; ++i) {
    const int k0 = (group + 2 * i) * kBlockK;
    const bf16* ks = reinterpret_cast<const bf16*>(ring + (i % kStages) * L::kStage);
    const bf16* vs = reinterpret_cast<const bf16*>(ring + (i % kStages) * L::kStage + L::kTile);
    mbar_wait(&full[i % kStages], (i / kStages) & 1);

    // s = q k^T (raw, fp32) for the warpgroup's 64 rows and the tile's 64 keys.
    fence_operand(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      wgmma_ss<kBlockK>(s, desc_k_major<kBlockQ, DH>(qs, c), desc_k_major<kBlockK, DH>(ks, c), c > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(s);

    if (k0 + kBlockK > lk) {  // the ragged last tile: keys past lk to -inf
#pragma unroll
      for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + t * 2 + (e & 1) >= lk) s[n][e] = -INFINITY;
        }
      }
    }
    // Running max across the quad, in units of s * c.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      const float alpha = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }

    // p = 2^(s c - m): the row sums take fp32 p, the product takes p rounded to bf16.
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      const float p[4] = {ex2(fmaf(s[n][0], scale_log2, -m[0])), ex2(fmaf(s[n][1], scale_log2, -m[0])),
                          ex2(fmaf(s[n][2], scale_log2, -m[1])), ex2(fmaf(s[n][3], scale_log2, -m[1]))};
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      to_a_frag(pf, n, p);
    }

    // acc += p v, V read MN-major (transposed) from its row-major tile.
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBlockK / 16; ++c) wgmma_rs<DH>(acc, pf[c], desc_mn_major<kBlockK, DH>(vs, c), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(acc);

    // Every warp of the group is done with this stage: refill it.
    named_barrier_sync(1 + group, kGroupThreads);
    if (tid == 0 && i + kStages < mine) issue(i + kStages);
  }

  // Group 1 hands m, l and acc to the thread of group 0 that holds the same rows and columns.
  __syncthreads();  // both groups are done with the ring, which now holds the hand-over
  float* merge = reinterpret_cast<float*>(smem + L::kRing) + tid;
  if (group == 1) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) merge[(d * 4 + e) * kGroupThreads] = acc[d][e];
    }
    merge[(DH / 2) * kGroupThreads] = m[0];
    merge[(DH / 2 + 1) * kGroupThreads] = m[1];
    merge[(DH / 2 + 2) * kGroupThreads] = l[0];
    merge[(DH / 2 + 3) * kGroupThreads] = l[1];
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = merge[(DH / 2 + r) * kGroupThreads];
    const float m_new = fmaxf(m[r], m1);
    const float a0 = ex2(m[r] - m_new);
    const float a1 = ex2(m1 - m_new);
    m[r] = m_new;
    l[r] = l[r] * a0 + merge[(DH / 2 + 2 + r) * kGroupThreads] * a1;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      acc[d][2 * r] = acc[d][2 * r] * a0 + merge[(d * 4 + 2 * r) * kGroupThreads] * a1;
      acc[d][2 * r + 1] = acc[d][2 * r + 1] * a0 + merge[(d * 4 + 2 * r + 1) * kGroupThreads] * a1;
    }
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  bf16* ob = out + (size_t)bh * lq * DH;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < lq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * DH + col) = pack_bf16x2(acc[d][0] / l[0], acc[d][1] / l[0]);
    }
    if (r0 + 8 < lq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + 8) * DH + col) =
          pack_bf16x2(acc[d][2] / l[1], acc[d][3] / l[1]);
    }
  }
  if (t == 0) {  // natural-log units: ln(l 2^m) = m ln 2 + ln l
    if (r0 < lq) lse[(size_t)bh * lq + r0] = fmaf(m[0], kLn2, logf(l[0]));
    if (r0 + 8 < lq) lse[(size_t)bh * lq + r0 + 8] = fmaf(m[1], kLn2, logf(l[1]));
  }
}

// ---- fp32: 3xTF32 on mma.sync (mma_tf32.cuh) -------------------------------------------------

// Each score's sum over Dh runs in the tensor cores' accumulators kScoreChunk k-steps (8
// columns each) at a time and is added to S by fp32 adds: at Dh 32 all 4 at once. The tensor
// cores truncate inside a sum, so longer chains err more (the fp32 backward's S at Dh 128: 5.5e-6
// of max|grad| over 16 k-steps, 2.2e-6 over chunks of 4; PERF.md).
constexpr int kScoreChunk = 4;
// q rows a CTA: 16 a warp, the same rows in each of the two groups of warps. 32 rows make 576
// CTAs at the flagship's shape, whose last wave is fuller than that of 288 64-row CTAs: 64-row
// CTAs took 1.16-1.29x as long at Dh 32-128 (scripts/time_flash_f32.py on an NVIDIA H100 80GB
// HBM3, 700.00 W; PERF.md).
constexpr int kF32Rows = 32;
constexpr int kF32GroupThreads = kF32Rows / 16 * 32;
// CTAs an SM that the registers are capped for: three at Dh 32 (at most 170 registers a thread;
// two ring stages leave the shared memory for three), one at Dh 64 and 128, where a cap of 168
// slowed the kernel or spilled. At Dh 32 one CTA an SM took 1.03-1.05x as long, with two ring
// stages or three (PERF.md).
template <int DH>
constexpr int kF32Ctas = DH == 32 ? 3 : 1;
// Whether Q's split A fragments stay in registers through the loop (at Dh 32, 32 registers);
// else each key tile loads them from the Q tile and splits them again.
template <int DH>
constexpr bool kHoldQ = DH == 32;

template <int DH>
struct FwdF32Layout {
  static constexpr int BK = DH >= 128 ? 32 : 64;  // keys a ring tile
  static constexpr int kStages = 2;
  static constexpr int kQTile = kF32Rows * DH * 4;
  static constexpr int kKTile = BK * DH * 4;  // K or V
  static constexpr int kStage = 2 * kKTile;
  static constexpr int kRing = kQTile;  // after the Q tile
  static constexpr int kBars = kRing + kGroups * kStages * kStage;
  static constexpr int kBytes = kBars + (1 + kGroups * kStages) * 8;
  static constexpr int kMerge = DH / 2 + 4;  // floats a thread of group 1 hands to group 0
  static_assert(kMerge * kF32GroupThreads * 4 <= kGroups * kStages * kStage, "merge buffer fits in the ring");
};

// s = Q K^T (raw, fp32) for a warp's 16 q rows (q_frag(c): Q's A fragment of k-step c) and the
// NT keys of the tile ks (NT rows, DH columns), summed over Dh in chunks of kScoreChunk k-steps.
template <int DH, int NT, class QFrag>
__device__ __forceinline__ void tile_scores(float (&s)[NT / 8][4], const QFrag& q_frag, const float* ks, int g,
                                            int t) {
  static_assert(DH / 8 % kScoreChunk == 0, "Dh is whole chunks");
  constexpr bool kWhole = kScoreChunk == DH / 8;  // one chunk: summed in s itself
#pragma unroll
  for (int n = 0; n < NT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < DH / 8; c0 += kScoreChunk) {
    float sc[kWhole ? 1 : NT / 8][4];  // this chunk's, unless kWhole
    if constexpr (!kWhole) {
#pragma unroll
      for (int n = 0; n < NT / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    }
#pragma unroll
    for (int c = c0; c < c0 + kScoreChunk; ++c) {
      const tf32x3::A qa = q_frag(c);
#pragma unroll
      for (int n = 0; n < NT / 8; ++n) {
        const tf32x3::B kb = tf32x3::load_b_rows_n<NT>(ks, n * 8, c * 8, g, t);
        if constexpr (kWhole) {
          tf32x3::mma3(s[n], qa, kb);
        } else {
          tf32x3::mma3(sc[n], qa, kb);
          if (c == c0 + kScoreChunk - 1) {  // the chunk's last k-step (known when unrolled)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += sc[n][e];
          }
        }
      }
    }
  }
}

// fp32: one CTA of two groups of kF32Rows / 16 warps per (kF32Rows q rows, batch*head), the bf16
// kernel's structure with both products 3xTF32 on mma.sync m16n8k8. Q arrives once; K and V tiles of BK
// keys stream through each group's ring. P stays fp32 (P is rounded to v's dtype, fp32 here)
// and is the A operand of P V straight from the score accumulators (acc_to_a).
template <int DH>
__global__ void __launch_bounds__(kGroups * kF32GroupThreads, kF32Ctas<DH>) flash_fwd_tf32x3_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, float* __restrict__ out, float* __restrict__ lse, int lq, int lk,
    float scale_log2) {
  using L = FwdF32Layout<DH>;
  constexpr int BK = L::BK;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const float* qs = reinterpret_cast<const float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // Q, then [group][stage]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kF32Rows;
  const int group = threadIdx.x / kF32GroupThreads;
  const int tid = threadIdx.x % kF32GroupThreads;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int m0 = (tid / 32) * 16;  // the warp's 16 rows of the CTA's 64
  const int r0 = q0 + m0 + g;      // this thread's rows: r0, r0 + 8
  const int n_tiles = (lk + BK - 1) / BK;
  const int mine = (n_tiles - group + kGroups - 1) / kGroups;  // this group's key tiles
  uint64_t* full = bars + 1 + group * kStages;
  uint8_t* ring = smem + L::kRing + group * kStages * L::kStage;

  auto issue = [&](int i) {  // this group's key tile i into stage i % kStages
    uint8_t* stage = ring + (i % kStages) * L::kStage;
    uint64_t* bar = &full[i % kStages];
    const int k0 = (group + kGroups * i) * BK;
    mbar_expect_tx(bar, L::kStage);
    tma_load_tile_f32<BK, DH>(reinterpret_cast<float*>(stage), &k_map, bar, k0, bh);
    tma_load_tile_f32<BK, DH>(reinterpret_cast<float*>(stage + L::kKTile), &v_map, bar, k0, bh);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kGroups * kStages; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (group == 0) {
      mbar_expect_tx(&bars[0], L::kQTile);
      tma_load_tile_f32<kF32Rows, DH>(reinterpret_cast<float*>(smem), &q_map, &bars[0], q0, bh);
    }
    for (int i = 0; i < kStages && i < mine; ++i) issue(i);
  }

  float m[2] = {kNegInf, kNegInf};  // running max of s * c, this thread's two rows
  float l[2] = {0.f, 0.f};          // partial row sums over this thread's columns
  float acc[DH / 8][4];             // O, unnormalised
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  mbar_wait(&bars[0], 0);
  tf32x3::A held[kHoldQ<DH> ? DH / 8 : 1];
  if constexpr (kHoldQ<DH>) {
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) held[c] = tf32x3::load_a<kF32Rows>(qs, m0, c * 8, g, t);
  }
  auto q_frag = [&](int c) {  // Q's A fragment of k-step c
    if constexpr (kHoldQ<DH>) {
      return held[c];
    } else {
      return tf32x3::load_a<kF32Rows>(qs, m0, c * 8, g, t);
    }
  };

  for (int i = 0; i < mine; ++i) {
    const int k0 = (group + kGroups * i) * BK;
    const float* ks = reinterpret_cast<const float*>(ring + (i % kStages) * L::kStage);
    const float* vs = reinterpret_cast<const float*>(ring + (i % kStages) * L::kStage + L::kKTile);
    mbar_wait(&full[i % kStages], (i / kStages) & 1);

    float s[BK / 8][4];
    tile_scores<DH, BK>(s, q_frag, ks, g, t);

    if (k0 + BK > lk) {  // the ragged last tile: keys past lk (zeros from TMA) to -inf
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + t * 2 + (e & 1) >= lk) s[n][e] = -INFINITY;
        }
      }
    }
    // Running max across the quad, in units of s * c; O and l rescaled to it.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      const float alpha = ex2(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        acc[d][2 * r] *= alpha;
        acc[d][2 * r + 1] *= alpha;
      }
    }

    // p = 2^(s c - m) in fp32, the A operand of the tile's P V, 8 keys a k-step; P V is summed
    // in the tensor cores over this tile only and added to O by fp32 adds.
    float part[DH / 8][4];
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) part[d][0] = part[d][1] = part[d][2] = part[d][3] = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float p[4] = {ex2(fmaf(s[n][0], scale_log2, -m[0])), ex2(fmaf(s[n][1], scale_log2, -m[0])),
                          ex2(fmaf(s[n][2], scale_log2, -m[1])), ex2(fmaf(s[n][3], scale_log2, -m[1]))};
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      const tf32x3::A pa = tf32x3::acc_to_a(p);
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const tf32x3::B vb = tf32x3::load_b_rows_k<BK>(vs, n * 8, d * 8, g, t);
        tf32x3::mma3(part[d], pa, vb);
      }
    }
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] += part[d][e];
    }

    named_barrier_sync(1 + group, kF32GroupThreads);  // the group is done with this stage
    if (tid == 0 && i + kStages < mine) issue(i + kStages);
  }

  // Group 1 hands m, l and O to the thread of group 0 that holds the same rows and columns.
  __syncthreads();  // both groups are done with the ring, which now holds the hand-over
  float* merge = reinterpret_cast<float*>(smem + L::kRing) + tid;
  if (group == 1) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) merge[(d * 4 + e) * kF32GroupThreads] = acc[d][e];
    }
    merge[(DH / 2) * kF32GroupThreads] = m[0];
    merge[(DH / 2 + 1) * kF32GroupThreads] = m[1];
    merge[(DH / 2 + 2) * kF32GroupThreads] = l[0];
    merge[(DH / 2 + 3) * kF32GroupThreads] = l[1];
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = merge[(DH / 2 + r) * kF32GroupThreads];
    const float m_new = fmaxf(m[r], m1);
    const float a0 = ex2(m[r] - m_new);
    const float a1 = ex2(m1 - m_new);
    m[r] = m_new;
    l[r] = l[r] * a0 + merge[(DH / 2 + 2 + r) * kF32GroupThreads] * a1;
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      acc[d][2 * r] = acc[d][2 * r] * a0 + merge[(d * 4 + 2 * r) * kF32GroupThreads] * a1;
      acc[d][2 * r + 1] = acc[d][2 * r + 1] * a0 + merge[(d * 4 + 2 * r + 1) * kF32GroupThreads] * a1;
    }
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  float* ob = out + (size_t)bh * lq * DH;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < lq) {
      *reinterpret_cast<float2*>(ob + (size_t)r0 * DH + col) = make_float2(acc[d][0] / l[0], acc[d][1] / l[0]);
    }
    if (r0 + 8 < lq) {
      *reinterpret_cast<float2*>(ob + (size_t)(r0 + 8) * DH + col) = make_float2(acc[d][2] / l[1], acc[d][3] / l[1]);
    }
  }
  if (t == 0) {  // natural-log units: ln(l 2^m) = m ln 2 + ln l
    if (r0 < lq) lse[(size_t)bh * lq + r0] = fmaf(m[0], kLn2, logf(l[0]));
    if (r0 + 8 < lq) lse[(size_t)bh * lq + r0 + 8] = fmaf(m[1], kLn2, logf(l[1]));
  }
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int lq, int lk,
                float scale, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!tile_map(&q_map, q, bh, lq, DH, kBlockQ) || !tile_map(&k_map, k, bh, lk, DH, kBlockK) ||
      !tile_map(&v_map, v, bh, lk, DH, kBlockK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = FwdLayout<DH>::kBytes + 1024;  // + the slack align_1024 takes
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_bf16_kernel<DH><<<grid, kGroups * kGroupThreads, kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), lse, lq, lk, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int lq, int lk,
               float scale, cudaStream_t stream) {
  using L = FwdF32Layout<DH>;
  CUtensorMap q_map, k_map, v_map;
  if (!tile_map_f32(&q_map, q, bh, lq, DH, kF32Rows) || !tile_map_f32(&k_map, k, bh, lk, DH, L::BK) ||
      !tile_map_f32(&v_map, v, bh, lk, DH, L::BK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = L::kBytes + 1024;  // + the slack align_1024 takes
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // All of the SM's unified data memory as shared memory, so that kF32Ctas CTAs fit on an SM.
  err = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<DH>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lq + kF32Rows - 1) / kF32Rows, bh);
  flash_fwd_tf32x3_kernel<DH><<<grid, kGroups * kF32GroupThreads, kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<float*>(out), lse, lq, lk, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch(int is_bf16, const void* q, const void* k, const void* v, void* out, float* lse, int bh, int lq,
           int lk, float scale, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<DH>(q, k, v, out, lse, bh, lq, lk, scale, stream);
  return launch_f32<DH>(q, k, v, out, lse, bh, lq, lk, scale, stream);
}

}  // namespace

// Launches the forward on `stream` and returns its CUDA error (0 on success), or
// cudaErrorInvalidValue for sizes or a head dimension the kernels do not take. Both kernels
// need scale > 0, the row max being taken before the scale (their wrapper maps any other
// scale onto one: negated or zero K). q: (bh, lq, dh), k and v:
// (bh, lk, dh), out: (bh, lq, dh), all contiguous, 16-byte aligned and of one dtype
// (is_bf16 = 1: bfloat16, 0: float32); lse: (bh, lq) float32.
extern "C" int cips_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int bh, int lq, int lk, int dh, int is_bf16,
                                        float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (dh) {
    case 32:
      return launch<32>(is_bf16, q, k, v, out, lse_f, bh, lq, lk, scale, s);
    case 64:
      return launch<64>(is_bf16, q, k, v, out, lse_f, bh, lq, lk, scale, s);
    case 128:
      return launch<128>(is_bf16, q, k, v, out, lse_f, bh, lq, lk, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
