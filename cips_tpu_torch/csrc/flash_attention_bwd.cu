// Flash-attention backward for Hopper (sm_90a), bound to PyTorch through ctypes: a dQ kernel
// and a dK/dV kernel, two launches and no atomics.
//
// Replaces the Pallas TPU kernels cips_tpu/ops/pallas/flash_attention.py:_bwd_dq_kernel and
// _bwd_dkv_kernel, launched by _flash_backward_pallas. Same math and rounding points: with
// the forward's fp32 lse and delta = rowsum(dO * O) (computed in torch, as JAX computes it
// outside its kernels),
//   P  = exp(scale * Q K^T - lse)                     fp32
//   dS = P * (dO V^T - delta)                         fp32, rounded to the input dtype
//   dQ = scale * dS K,  dK = scale * dS^T Q           fp32 accumulation, scale applied after
//   dV = P^T dO                                        P rounded to dO's dtype first
// Outputs are in the inputs' dtype. q and dO are (bh, lq, dh), k and v (bh, lk, dh), lse and
// delta (bh, lq) fp32.
//
// What bounds them on an H100 SXM. At the flagship's attention shape (B=2, H=4, L=2304,
// Dh=32, bf16) dQ does 6*B*H*L^2*Dh = 8.15 GFLOP (8.2 us at 989 TFLOP/s) and dK/dV
// 8*B*H*L^2*Dh = 10.9 GFLOP (11.0 us); each moves about 3 MB (under 1 us at 3.35 TB/s). Each
// recomputes the B*H*L^2 = 42.5 M exponentials, 10 us on the special-function units (16 a
// clock per SM, 132 SMs, 1.98 GHz). So both are bound by their products and their
// exponentials about equally at Dh 32, and by the products at larger Dh. In fp32 every product
// is taken three times at the TF32 rate (494.5 TFLOP/s): dQ 49.5 us, dK/dV 66.0 us there.
//
// What the designs do about that. Blocks run in no order on a GPU, so the TPU's sequential
// grid axis becomes a loop inside the block, and each output tile has one owner. S, P, dP
// and dS stay in registers: nothing of size L^2 touches memory. Both bf16 kernels are one CTA
// of two warpgroups per 64 output rows, on the building blocks of hopper_sm90.cuh.
//   - Tensor cores: every product is wgmma (m64nNk16, fp32 accumulators). The tile a product
//     reads once as its K-major B is read again with wgmma's transpose bit where the next
//     product needs it MN-major, so nothing is transposed by hand.
//   - Memory latency: one operand pair arrives once by TMA; the other streams through a ring
//     of 3 stages (2 at Dh 128) per warpgroup, filled by TMA (hardware zero fill past the
//     end) and completed on mbarriers, so the next tiles load while this one is multiplied.
//   - Exponentials: p = 2^(s c - lse log2 e) with c = scale log2 e, one FFMA and one ex2 per
//     score.
//   - Warps in flight: the two warpgroups split the loop (even and odd tiles) and sum their
//     fp32 partials in shared memory (the ring, once both are done with it) before the one
//     store; no atomics. At the flagship shape: 288 CTAs of 8 warps.
//   dQ: a CTA owns 64 q rows; Q and dO arrive once, K and V tiles of 64 keys stream. It is the
//     forward's loop with lse and delta given: S = Q K^T and dP = dO V^T from shared memory,
//     dS = P (dP - delta) rounded to bf16 straight into register A fragments, and
//     dQ += dS K with K read MN-major from the tile S read it K-major. Each thread keeps
//     -lse log2 e and delta of its two accumulator rows in registers. At Dh 128 a thread
//     holds S and dP (32 + 32 floats) and dQ (64). The first dQ kernel, on mma.sync with K and V
//     loaded synchronously by all threads and K transposed by hand in shared memory, took
//     0.107 ms at the flagship shape and 4.13 ms at (2, 4, 18432, 32) (PERF.md). Not tried:
//     folding dQ into the dK/dV kernel, which needs a sum across CTAs (atomics or a second
//     pass).
//   dK/dV: a CTA owns 64 keys and computes S^T = K Q^T and dP^T = V dO^T, as the TPU kernel
//     does, so P^T and dS^T come out as accumulators that are already register A operands of
//     P^T dO and dS^T Q. K and V arrive once, as the shared-memory A of S^T and dP^T; Q, dO,
//     lse and delta tiles (64 q rows; 32 at Dh 128) stream, Q and dO read transposed as the
//     B of dS^T Q and P^T dO.
// Any L: rows past L read as zeros, and P is set to 0 explicitly for keys past lk (dQ) and
// q rows past lq (dK/dV), so neither padded lse/delta values nor padded rows add anything.
// The bf16 kernels take scale > 0 (the wrapper maps a negative scale to a negated K and
// scale 0 to a zero K).
// fp32 inputs take kernels of the same structure (a CTA of two groups of 4 warps per 64 output
// rows, a TMA ring, merged partials) whose five products are 3xTF32 on mma.sync m16n8k8
// (mma_tf32.cuh): each fp32 operand split into two tf32 parts, three tensor-core passes, fp32
// accumulation, and the long sums (over keys or q rows) added up by fp32 adds a tile at a
// time, since the tensor cores truncate inside their sums. Its rounding model is
// flash_attention_bwd_tf32x3_reference (ops/flash_attention.py); the kernels stay within
// 5.8e-6 of each max|grad| of the plain fp32 backward at every case of chip_smoke.py, 18,432
// tokens included (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), where the limit is 1e-5. Plain
// TF32 (one pass) would round every operand to 11 significant bits (2^-11 relative). S, P,
// dP and dS never leave registers: an accumulator is the A fragment of the next product as
// it stands (mma_tf32.cuh).

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

constexpr int kRows = 64;  // q rows (dQ) or keys (dK/dV) owned by a CTA: one wgmma M
constexpr int kGroups = 2;  // warpgroups per CTA; group w takes key (dQ) or q (dK/dV) tiles w, w + 2, ...
constexpr int kGroupThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
constexpr int kLoopTile = DH >= 128 ? 32 : 64;  // q rows per ring tile of dK/dV

// Stores rows r, r + 8 of the 16 x DH fp32 tile acc, times `mul`, as bf16 (rows past len
// are not stored).
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DH / 8][4], float mul,
                                           int r, int len, int t) {
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (r < len) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)r * DH + col) =
          pack_bf16x2(acc[d][0] * mul, acc[d][1] * mul);
    }
    if (r + 8 < len) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)(r + 8) * DH + col) =
          pack_bf16x2(acc[d][2] * mul, acc[d][3] * mul);
    }
  }
}

// dQ, bf16: one CTA of two warpgroups per (64 q rows, batch*head); see the note at the top.
template <int DH>
struct DqLayout {
  static constexpr int kStages = DH >= 128 ? 2 : 3;
  static constexpr int kTile = kTileBytes<kRows, DH>;  // one Q, dO, K or V tile
  static constexpr int kStage = 2 * kTile;             // K and V
  static constexpr int kRing = 2 * kTile;              // after the Q and dO tiles
  static constexpr int kBars = kRing + kGroups * kStages * kStage;
  static constexpr int kBytes = kBars + (1 + kGroups * kStages) * 8;
  static constexpr int kMerge = DH / 2;  // floats a thread of group 1 hands to group 0
  static_assert(kMerge * kGroupThreads * 4 <= kGroups * kStages * kStage, "merge buffer fits in the ring");
};

template <int DH>
__global__ void __launch_bounds__(kGroups * kGroupThreads) flash_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, int lq, int lk,
    float scale) {
  using L = DqLayout<DH>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const bf16* qs = reinterpret_cast<const bf16*>(smem);
  const bf16* dos = reinterpret_cast<const bf16*>(smem + L::kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // Q/dO, then [group][stage]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int group = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int r0 = q0 + (tid / 32) * 16 + g;  // this thread's rows: r0, r0 + 8
  const int n_tiles = (lk + kRows - 1) / kRows;
  const int mine = (n_tiles - group + 1) / 2;  // this group's key tiles: group + 2 i
  const float scale_log2 = scale * kLog2e;
  uint64_t* full = bars + 1 + group * kStages;
  uint8_t* ring = smem + L::kRing + group * kStages * L::kStage;

  auto issue = [&](int i) {  // this group's key tile i into stage i % kStages
    uint8_t* stage = ring + (i % kStages) * L::kStage;
    uint64_t* bar = &full[i % kStages];
    const int k0 = (group + 2 * i) * kRows;
    mbar_expect_tx(bar, L::kStage);
    tma_load_tile<kRows, DH>(reinterpret_cast<bf16*>(stage), &k_map, bar, k0, bh);
    tma_load_tile<kRows, DH>(reinterpret_cast<bf16*>(stage + L::kTile), &v_map, bar, k0, bh);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kGroups * kStages; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (group == 0) {
      mbar_expect_tx(&bars[0], 2 * L::kTile);
      tma_load_tile<kRows, DH>(reinterpret_cast<bf16*>(smem), &q_map, &bars[0], q0, bh);
      tma_load_tile<kRows, DH>(reinterpret_cast<bf16*>(smem + L::kTile), &do_map, &bars[0], q0, bh);
    }
    for (int i = 0; i < kStages && i < mine; ++i) issue(i);
  }

  // -lse log2(e) and delta of this thread's two rows (0 past lq, where Q and dO are zero).
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    nl[r] = row < lq ? -lse[(size_t)bh * lq + row] * kLog2e : 0.f;
    dl[r] = row < lq ? delta[(size_t)bh * lq + row] : 0.f;
  }
  float acc[DH / 8][4];
  float s[kRows / 8][4];
  float dp[kRows / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kRows / 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
  }
  mbar_wait(&bars[0], 0);

  for (int i = 0; i < mine; ++i) {
    const int k0 = (group + 2 * i) * kRows;
    const bf16* ks = reinterpret_cast<const bf16*>(ring + (i % kStages) * L::kStage);
    const bf16* vs = reinterpret_cast<const bf16*>(ring + (i % kStages) * L::kStage + L::kTile);
    mbar_wait(&full[i % kStages], (i / kStages) & 1);

    // S = Q K^T and dP = dO V^T for the CTA's 64 q rows and the tile's 64 keys.
    fence_operand(s);
    fence_operand(dp);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      wgmma_ss<kRows>(s, desc_k_major<kRows, DH>(qs, c), desc_k_major<kRows, DH>(ks, c), c > 0);
    }
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      wgmma_ss<kRows>(dp, desc_k_major<kRows, DH>(dos, c), desc_k_major<kRows, DH>(vs, c), c > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(s);
    fence_operand(dp);

    // P = 2^(s c - lse log2 e), 0 for keys past lk (TMA fills them with zeros, and a zero
    // score is not P = 0); dS = P (dP - delta), rounded to bf16 into the A fragments of dS K.
    const bool ragged = k0 + kRows > lk;
    uint32_t dsf[kRows / 16][4];
#pragma unroll
    for (int n = 0; n < kRows / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool live = !ragged || k0 + n * 8 + t * 2 + (e & 1) < lk;
        const float p = live ? ex2(fmaf(s[n][e], scale_log2, nl[r])) : 0.f;
        ds[e] = p * (dp[n][e] - dl[r]);
      }
      to_a_frag(dsf, n, ds);
    }

    // dQ += dS K, K read MN-major (transposed) from the same swizzled tile as Q K^T read it.
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kRows / 16; ++c) wgmma_rs<DH>(acc, dsf[c], desc_mn_major<kRows, DH>(ks, c), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(acc);

    named_barrier_sync(1 + group, kGroupThreads);  // the group is done with this stage
    if (tid == 0 && i + kStages < mine) issue(i + kStages);
  }

  // Group 1 hands its partial dQ to the thread of group 0 that holds the same rows and
  // columns; group 0 adds it and stores.
  __syncthreads();  // both groups are done with the ring, which now holds the hand-over
  float* merge = reinterpret_cast<float*>(smem + L::kRing) + tid;
  if (group == 1) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) merge[(d * 4 + e) * kGroupThreads] = acc[d][e];
    }
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] += merge[(d * 4 + e) * kGroupThreads];
  }
  store_rows<DH>(dq + (size_t)bh * lq * DH, acc, scale, r0, lq, t);
}

// dK/dV, bf16: one CTA of two warpgroups per (64 keys, batch*head); see the note at the top.
template <int DH>
struct DkvLayout {
  static constexpr int BQ = kLoopTile<DH>;  // q rows per ring tile
  static constexpr int kStages = DH >= 128 ? 2 : 3;
  static constexpr int kKTile = kTileBytes<kRows, DH>;  // K or V, loaded once
  static constexpr int kQTile = kTileBytes<BQ, DH>;     // Q or dO
  // lse or delta of a tile, as a box of BQ + 4 floats from a 16-byte aligned start (TMA
  // boxes start on 16 bytes), 128-byte aligned in shared memory
  static constexpr int kRowBox = BQ + 4;
  static constexpr int kRows4 = (kRowBox * 4 + 127) / 128 * 128;
  // A stage: Q, dO, lse, delta; rounded up so that every tile starts on 1024 bytes.
  static constexpr int kStage = (2 * kQTile + 2 * kRows4 + 1023) / 1024 * 1024;
  static constexpr int kRing = 2 * kKTile;
  static constexpr int kBars = kRing + kGroups * kStages * kStage;
  static constexpr int kBytes = kBars + (1 + kGroups * kStages) * 8;
  static constexpr int kMerge = DH;  // floats a thread of group 1 hands to group 0 (dK, dV)
  static_assert(kMerge * kGroupThreads * 4 <= kGroups * kStages * kStage, "merge buffer fits in the ring");
};

template <int DH>
__global__ void __launch_bounds__(kGroups * kGroupThreads) flash_bwd_dkv_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap lse_map, const __grid_constant__ CUtensorMap delta_map,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int lq, int lk, float scale) {
  using L = DkvLayout<DH>;
  constexpr int BQ = L::BQ;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const bf16* ks = reinterpret_cast<const bf16*>(smem);
  const bf16* vs = reinterpret_cast<const bf16*>(smem + L::kKTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // K/V, then [group][stage]

  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kRows;
  const int group = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int c0 = key0 + (tid / 32) * 16 + g;  // this thread's keys: c0, c0 + 8
  const int n_tiles = (lq + BQ - 1) / BQ;
  const int mine = (n_tiles - group + 1) / 2;  // this group's q tiles: group + 2 i
  const float scale_log2 = scale * kLog2e;
  uint64_t* full = bars + 1 + group * kStages;
  uint8_t* ring = smem + L::kRing + group * kStages * L::kStage;

  auto issue = [&](int i) {  // this group's q tile i into stage i % kStages
    uint8_t* stage = ring + (i % kStages) * L::kStage;
    uint64_t* bar = &full[i % kStages];
    const int q0 = (group + 2 * i) * BQ;
    mbar_expect_tx(bar, 2 * L::kQTile + 2 * L::kRowBox * 4);
    tma_load_tile<BQ, DH>(reinterpret_cast<bf16*>(stage), &q_map, bar, q0, bh);
    tma_load_tile<BQ, DH>(reinterpret_cast<bf16*>(stage + L::kQTile), &do_map, bar, q0, bh);
    // lse and delta as flat (bh * lq) rows, from the 4-float boundary at or below the
    // tile's first row: a ragged tile reads the next head's values (or zeros past the
    // end), which P = 0 below keeps out of the sums.
    const int row0 = (bh * lq + q0) & ~3;
    tma_load_1d(stage + 2 * L::kQTile, &lse_map, bar, row0);
    tma_load_1d(stage + 2 * L::kQTile + L::kRows4, &delta_map, bar, row0);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kGroups * kStages; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (group == 0) {
      mbar_expect_tx(&bars[0], 2 * L::kKTile);
      tma_load_tile<kRows, DH>(reinterpret_cast<bf16*>(smem), &k_map, &bars[0], key0, bh);
      tma_load_tile<kRows, DH>(reinterpret_cast<bf16*>(smem + L::kKTile), &v_map, &bars[0], key0, bh);
    }
    for (int i = 0; i < kStages && i < mine; ++i) issue(i);
  }

  float dk_acc[DH / 8][4];
  float dv_acc[DH / 8][4];
  float st[BQ / 8][4];
  float dpt[BQ / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    dk_acc[d][0] = dk_acc[d][1] = dk_acc[d][2] = dk_acc[d][3] = 0.f;
    dv_acc[d][0] = dv_acc[d][1] = dv_acc[d][2] = dv_acc[d][3] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
    dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
  }
  mbar_wait(&bars[0], 0);

  for (int i = 0; i < mine; ++i) {
    const int q0 = (group + 2 * i) * BQ;
    const uint8_t* stage = ring + (i % kStages) * L::kStage;
    const bf16* qs = reinterpret_cast<const bf16*>(stage);
    const bf16* dos = reinterpret_cast<const bf16*>(stage + L::kQTile);
    const int skip = (bh * lq + q0) & 3;  // rows of the box before the tile's first
    const float* lse_s = reinterpret_cast<const float*>(stage + 2 * L::kQTile) + skip;
    const float* delta_s = reinterpret_cast<const float*>(stage + 2 * L::kQTile + L::kRows4) + skip;
    mbar_wait(&full[i % kStages], (i / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T for the CTA's 64 keys and the tile's BQ q rows.
    fence_operand(st);
    fence_operand(dpt);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      wgmma_ss<BQ>(st, desc_k_major<kRows, DH>(ks, c), desc_k_major<BQ, DH>(qs, c), c > 0);
    }
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      wgmma_ss<BQ>(dpt, desc_k_major<kRows, DH>(vs, c), desc_k_major<BQ, DH>(dos, c), c > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(st);
    fence_operand(dpt);

    // P^T = 2^(s c - lse log2 e), 0 for q rows past lq; dS^T = P^T (dP^T - delta). Both are
    // rounded to bf16 into A fragments of the next two products.
    const bool ragged = q0 + BQ > lq;
    uint32_t pf[BQ / 16][4];
    uint32_t dsf[BQ / 16][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + t * 2 + j;
        const float nl = -lse_s[col] * kLog2e;
        const float dl = delta_s[col];
        const bool live = !ragged || q0 + col < lq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + j;
          p[e] = live ? ex2(fmaf(st[n][e], scale_log2, nl)) : 0.f;
          ds[e] = p[e] * (dpt[n][e] - dl);
        }
      }
      to_a_frag(pf, n, p);
      to_a_frag(dsf, n, ds);
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major (transposed) from their tiles.
    fence_operand(dv_acc);
    fence_operand(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) wgmma_rs<DH>(dv_acc, pf[c], desc_mn_major<BQ, DH>(dos, c), 1);
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) wgmma_rs<DH>(dk_acc, dsf[c], desc_mn_major<BQ, DH>(qs, c), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(dv_acc);
    fence_operand(dk_acc);

    named_barrier_sync(1 + group, kGroupThreads);  // the group is done with this stage
    if (tid == 0 && i + kStages < mine) issue(i + kStages);
  }

  // Group 1 hands its partial dK and dV to the thread of group 0 that holds the same keys
  // and columns; group 0 adds them and stores.
  __syncthreads();
  float* merge = reinterpret_cast<float*>(smem + L::kRing) + tid;
  if (group == 1) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        merge[(d * 4 + e) * kGroupThreads] = dk_acc[d][e];
        merge[(DH / 2 + d * 4 + e) * kGroupThreads] = dv_acc[d][e];
      }
    }
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[d][e] += merge[(d * 4 + e) * kGroupThreads];
      dv_acc[d][e] += merge[(DH / 2 + d * 4 + e) * kGroupThreads];
    }
  }
  const size_t koff = (size_t)bh * lk * DH;
  store_rows<DH>(dk + koff, dk_acc, scale, c0, lk, t);
  store_rows<DH>(dv + koff, dv_acc, 1.f, c0, lk, t);
}

// ---- fp32: 3xTF32 on mma.sync (see the note at the top and mma_tf32.cuh) ---------------------

// The long sums (dQ over keys, dK and dV over q rows) are summed in the tensor cores a ring
// tile at a time (part, dv_part, dk_part) and added to the running sums by fp32 adds. The
// tensor cores truncate inside a sum instead of rounding to nearest: held in their
// accumulators over all keys (or q rows), the error grows with the number of steps and
// misses the fp32 limit (1.7e-5 of max|grad| at 2,304 keys, 9.1e-5 at 18,432, against 1e-5;
// scripts/time_flash_f32.py on an NVIDIA H100 80GB HBM3, 700.00 W), where fp32 adds of a
// tile's sums do not.
// The sums over Dh (S and dP) are summed in the tensor cores kScoreChunk k-steps (8 columns
// each) at a time and added by fp32 adds: at Dh 32 all 4 at once. At Dh 128 all 16 at once
// err 2.5x more (5.5e-6 of max|grad| against 2.2e-6), and one k-step at a time takes 1.3x as
// long at every Dh (scripts/time_flash_f32.py on an NVIDIA H100 80GB HBM3, 700.00 W).
constexpr int kScoreChunk = 4;
// At Dh 32 the split A fragments of the pair that arrives once (Q and dO for dQ, K and V for
// dK/dV) stay in registers through the loop; at larger Dh they are loaded and split each tile.
template <int DH>
constexpr bool kHoldA = DH == 32;

// s = X Y^T and dp = W Z^T for a warp's 16 rows (X and W: a_frag(0, c) and a_frag(1, c), the
// A fragments of k-step c) and the NT rows of the tiles y and z (NT rows, DH columns), summed
// over Dh in chunks of kScoreChunk k-steps: S and dP of dQ, S^T and dP^T of dK/dV.
template <int DH, int NT, class AFrag>
__device__ __forceinline__ void scores(float (&s)[NT / 8][4], float (&dp)[NT / 8][4], const AFrag& a_frag,
                                       const float* y, const float* z, int g, int t) {
  static_assert(DH / 8 % kScoreChunk == 0, "Dh is whole chunks");
  constexpr bool kWhole = kScoreChunk == DH / 8;  // one chunk: summed in s and dp themselves
#pragma unroll
  for (int n = 0; n < NT / 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
  }
#pragma unroll
  for (int c0 = 0; c0 < DH / 8; c0 += kScoreChunk) {
    float sc[kWhole ? 1 : NT / 8][4], dc[kWhole ? 1 : NT / 8][4];  // this chunk's, unless kWhole
    if constexpr (!kWhole) {
#pragma unroll
      for (int n = 0; n < NT / 8; ++n) {
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
        dc[n][0] = dc[n][1] = dc[n][2] = dc[n][3] = 0.f;
      }
    }
#pragma unroll
    for (int c = c0; c < c0 + kScoreChunk; ++c) {
      const tf32x3::A xa = a_frag(0, c);
      const tf32x3::A wa = a_frag(1, c);
#pragma unroll
      for (int n = 0; n < NT / 8; ++n) {
        const tf32x3::B yb = tf32x3::load_b_rows_n<NT>(y, n * 8, c * 8, g, t);
        const tf32x3::B zb = tf32x3::load_b_rows_n<NT>(z, n * 8, c * 8, g, t);
        if constexpr (kWhole) {
          tf32x3::mma3(s[n], xa, yb);
          tf32x3::mma3(dp[n], wa, zb);
        } else {
          tf32x3::mma3(sc[n], xa, yb);
          tf32x3::mma3(dc[n], wa, zb);
          if (c == c0 + kScoreChunk - 1) {  // the chunk's last k-step (known when unrolled)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[n][e] += sc[n][e];
              dp[n][e] += dc[n][e];
            }
          }
        }
      }
    }
  }
}

// dQ, fp32: one CTA of two groups per (64 q rows, batch*head). Q and dO arrive once; K and V
// tiles of BK keys stream through each group's ring.
template <int DH>
struct DqF32Layout {
  static constexpr int BK = DH >= 128 ? 32 : 64;  // keys a ring tile
  static constexpr int kStages = DH >= 64 ? 2 : 3;
  static constexpr int kTile = kRows * DH * 4;  // Q or dO
  static constexpr int kKTile = BK * DH * 4;    // K or V
  static constexpr int kStage = 2 * kKTile;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kBars = kRing + kGroups * kStages * kStage;
  static constexpr int kBytes = kBars + (1 + kGroups * kStages) * 8;
  static constexpr int kMerge = DH / 2;  // floats a thread of group 1 hands to group 0
  static_assert(kMerge * kGroupThreads * 4 <= kGroups * kStages * kStage,
                "merge buffer fits in the ring");
};

template <int DH>
__global__ void __launch_bounds__(kGroups * kGroupThreads) flash_bwd_dq_tf32x3_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, int lq, int lk,
    float scale) {
  using L = DqF32Layout<DH>;
  constexpr int BK = L::BK;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const float* qs = reinterpret_cast<const float*>(smem);
  const float* dos = reinterpret_cast<const float*>(smem + L::kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // Q/dO, then [group][stage]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int group = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int m0 = (tid / 32) * 16;  // the warp's 16 rows of the CTA's 64
  const int r0 = q0 + m0 + g;      // this thread's rows: r0, r0 + 8
  const int n_tiles = (lk + BK - 1) / BK;
  const int mine = (n_tiles - group + kGroups - 1) / kGroups;  // this group's key tiles
  const float scale_log2 = scale * kLog2e;
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
      mbar_expect_tx(&bars[0], 2 * L::kTile);
      tma_load_tile_f32<kRows, DH>(reinterpret_cast<float*>(smem), &q_map, &bars[0], q0, bh);
      tma_load_tile_f32<kRows, DH>(reinterpret_cast<float*>(smem + L::kTile), &do_map, &bars[0], q0, bh);
    }
    for (int i = 0; i < kStages && i < mine; ++i) issue(i);
  }

  // -lse log2(e) and delta of this thread's two rows (0 past lq, where Q and dO are zero).
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    nl[r] = row < lq ? -lse[(size_t)bh * lq + row] * kLog2e : 0.f;
    dl[r] = row < lq ? delta[(size_t)bh * lq + row] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  mbar_wait(&bars[0], 0);
  tf32x3::A held[kHoldA<DH> ? 2 * DH / 8 : 1];  // Q's, then dO's, with kHoldA
  if constexpr (kHoldA<DH>) {
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      held[c] = tf32x3::load_a<kRows>(qs, m0, c * 8, g, t);
      held[DH / 8 + c] = tf32x3::load_a<kRows>(dos, m0, c * 8, g, t);
    }
  }
  auto a_frag = [&](int j, int c) {  // k-step c of Q (j 0) or dO (j 1)
    if constexpr (kHoldA<DH>) {
      return held[j * DH / 8 + c];
    } else {
      return tf32x3::load_a<kRows>(j ? dos : qs, m0, c * 8, g, t);
    }
  };

  for (int i = 0; i < mine; ++i) {
    const int k0 = (group + kGroups * i) * BK;
    const float* ks = reinterpret_cast<const float*>(ring + (i % kStages) * L::kStage);
    const float* vs = reinterpret_cast<const float*>(ring + (i % kStages) * L::kStage + L::kKTile);
    mbar_wait(&full[i % kStages], (i / kStages) & 1);

    // S = Q K^T and dP = dO V^T for the warp's 16 q rows and the tile's BK keys.
    float s[BK / 8][4], dp[BK / 8][4];
    scores<DH, BK>(s, dp, a_frag, ks, vs, g, t);

    // P = 2^(s c - lse log2 e), 0 for keys past lk (TMA fills them with zeros, and a zero
    // score is not P = 0); dS = P (dP - delta), the A operand of dQ += dS K, 8 keys a k-step.
    const bool ragged = k0 + BK > lk;
    float part[DH / 8][4];  // this tile's dS K
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) part[d][0] = part[d][1] = part[d][2] = part[d][3] = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool live = !ragged || k0 + n * 8 + t * 2 + (e & 1) < lk;
        const float p = live ? ex2(fmaf(s[n][e], scale_log2, nl[r])) : 0.f;
        ds[e] = p * (dp[n][e] - dl[r]);
      }
      const tf32x3::A dsa = tf32x3::acc_to_a(ds);
#pragma unroll
      for (int d = 0; d < DH / 8; ++d) {
        const tf32x3::B kb = tf32x3::load_b_rows_k<BK>(ks, n * 8, d * 8, g, t);
        tf32x3::mma3(part[d], dsa, kb);
      }
    }
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] += part[d][e];
    }

    named_barrier_sync(1 + group, kGroupThreads);  // the group is done with this stage
    if (tid == 0 && i + kStages < mine) issue(i + kStages);
  }

  // Group 1 hands its partial dQ to the thread of group 0 that holds the same rows and
  // columns; group 0 adds it and stores.
  __syncthreads();  // both groups are done with the ring, which now holds the hand-over
  float* merge = reinterpret_cast<float*>(smem + L::kRing) + tid;
  if (group == 1) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) merge[(d * 4 + e) * kGroupThreads] = acc[d][e];
    }
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] += merge[(d * 4 + e) * kGroupThreads];
  }
  float* out = dq + (size_t)bh * lq * DH;
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < lq) {
      *reinterpret_cast<float2*>(out + (size_t)r0 * DH + col) = make_float2(acc[d][0] * scale, acc[d][1] * scale);
    }
    if (r0 + 8 < lq) {
      *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * DH + col) =
          make_float2(acc[d][2] * scale, acc[d][3] * scale);
    }
  }
}

// dK/dV, fp32: one CTA of two groups per (64 keys, batch*head, column slice). K and V arrive
// once; Q, dO, lse and delta tiles of BQ q rows stream through each group's ring.
template <int DH>
struct DkvF32Layout {
  // Column slices of dK and dV, one CTA each (grid z): every slice computes S^T and dP^T over
  // all of Dh again, but a thread holds DC / 2 floats each of dK and dV (64 at Dh 128, with
  // one slice, and ptxas spills).
  static constexpr int kSlices = DH >= 128 ? 2 : 1;
  static constexpr int DC = DH / kSlices;  // dK and dV columns a CTA owns
  static constexpr int BQ = DH >= 64 ? 32 : 64;  // q rows a ring tile
  static constexpr int kStages = DH >= 64 ? 2 : 3;
  static constexpr int kKTile = kRows * DH * 4;  // K or V, loaded once
  static constexpr int kQTile = BQ * DH * 4;     // Q or dO
  // lse or delta of a tile, as a box of BQ + 4 floats from a 16-byte aligned start, as the
  // bf16 kernel reads them
  static constexpr int kRowBox = BQ + 4;
  static constexpr int kRows4 = (kRowBox * 4 + 127) / 128 * 128;
  static constexpr int kStage = (2 * kQTile + 2 * kRows4 + 1023) / 1024 * 1024;
  static constexpr int kRing = 2 * kKTile;
  static constexpr int kBars = kRing + kGroups * kStages * kStage;
  static constexpr int kBytes = kBars + (1 + kGroups * kStages) * 8;
  static constexpr int kMerge = DC;  // floats a thread of group 1 hands to group 0 (dK, dV)
  static_assert(DC % 32 == 0, "a slice is whole column blocks of the tiles");
  static_assert(kMerge * kGroupThreads * 4 <= kGroups * kStages * kStage,
                "merge buffer fits in the ring");
};

template <int DH>
__global__ void __launch_bounds__(kGroups * kGroupThreads) flash_bwd_dkv_tf32x3_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap lse_map, const __grid_constant__ CUtensorMap delta_map,
    float* __restrict__ dk, float* __restrict__ dv, int lq, int lk, float scale) {
  using L = DkvF32Layout<DH>;
  constexpr int BQ = L::BQ;
  constexpr int DC = L::DC;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const float* ks = reinterpret_cast<const float*>(smem);
  const float* vs = reinterpret_cast<const float*>(smem + L::kKTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);  // K/V, then [group][stage]

  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kRows;
  const int col0 = blockIdx.z * DC;  // the slice's first column
  const int group = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int m0 = (tid / 32) * 16;  // the warp's 16 keys of the CTA's 64
  const int c0 = key0 + m0 + g;    // this thread's keys: c0, c0 + 8
  const int n_tiles = (lq + BQ - 1) / BQ;
  const int mine = (n_tiles - group + kGroups - 1) / kGroups;  // this group's q tiles
  const float scale_log2 = scale * kLog2e;
  uint64_t* full = bars + 1 + group * kStages;
  uint8_t* ring = smem + L::kRing + group * kStages * L::kStage;

  auto issue = [&](int i) {  // this group's q tile i into stage i % kStages
    uint8_t* stage = ring + (i % kStages) * L::kStage;
    uint64_t* bar = &full[i % kStages];
    const int q0 = (group + kGroups * i) * BQ;
    mbar_expect_tx(bar, 2 * L::kQTile + 2 * L::kRowBox * 4);
    tma_load_tile_f32<BQ, DH>(reinterpret_cast<float*>(stage), &q_map, bar, q0, bh);
    tma_load_tile_f32<BQ, DH>(reinterpret_cast<float*>(stage + L::kQTile), &do_map, bar, q0, bh);
    // lse and delta as flat (bh * lq) rows from the 4-float boundary at or below the tile's
    // first row; values of the next head (or zeros) past lq are kept out by P = 0 below.
    const int row0 = (bh * lq + q0) & ~3;
    tma_load_1d(stage + 2 * L::kQTile, &lse_map, bar, row0);
    tma_load_1d(stage + 2 * L::kQTile + L::kRows4, &delta_map, bar, row0);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + kGroups * kStages; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (group == 0) {
      mbar_expect_tx(&bars[0], 2 * L::kKTile);
      tma_load_tile_f32<kRows, DH>(reinterpret_cast<float*>(smem), &k_map, &bars[0], key0, bh);
      tma_load_tile_f32<kRows, DH>(reinterpret_cast<float*>(smem + L::kKTile), &v_map, &bars[0], key0, bh);
    }
    for (int i = 0; i < kStages && i < mine; ++i) issue(i);
  }

  float dk_acc[DC / 8][4];
  float dv_acc[DC / 8][4];
#pragma unroll
  for (int d = 0; d < DC / 8; ++d) {
    dk_acc[d][0] = dk_acc[d][1] = dk_acc[d][2] = dk_acc[d][3] = 0.f;
    dv_acc[d][0] = dv_acc[d][1] = dv_acc[d][2] = dv_acc[d][3] = 0.f;
  }
  mbar_wait(&bars[0], 0);
  tf32x3::A held[kHoldA<DH> ? 2 * DH / 8 : 1];  // K's, then V's, with kHoldA
  if constexpr (kHoldA<DH>) {
#pragma unroll
    for (int c = 0; c < DH / 8; ++c) {
      held[c] = tf32x3::load_a<kRows>(ks, m0, c * 8, g, t);
      held[DH / 8 + c] = tf32x3::load_a<kRows>(vs, m0, c * 8, g, t);
    }
  }
  auto a_frag = [&](int j, int c) {  // k-step c of K (j 0) or V (j 1)
    if constexpr (kHoldA<DH>) {
      return held[j * DH / 8 + c];
    } else {
      return tf32x3::load_a<kRows>(j ? vs : ks, m0, c * 8, g, t);
    }
  };

  for (int i = 0; i < mine; ++i) {
    const int q0 = (group + kGroups * i) * BQ;
    const uint8_t* stage = ring + (i % kStages) * L::kStage;
    const float* qs = reinterpret_cast<const float*>(stage);
    const float* dos = reinterpret_cast<const float*>(stage + L::kQTile);
    const int skip = (bh * lq + q0) & 3;  // rows of the box before the tile's first
    const float* lse_s = reinterpret_cast<const float*>(stage + 2 * L::kQTile) + skip;
    const float* delta_s = reinterpret_cast<const float*>(stage + 2 * L::kQTile + L::kRows4) + skip;
    mbar_wait(&full[i % kStages], (i / kStages) & 1);

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys and the tile's BQ q rows.
    float st[BQ / 8][4], dpt[BQ / 8][4];
    scores<DH, BQ>(st, dpt, a_frag, qs, dos, g, t);

    // P^T = 2^(s c - lse log2 e), 0 for q rows past lq; dS^T = P^T (dP^T - delta). Each is the
    // A operand of its product, 8 q rows a k-step: dV += P^T dO, dK += dS^T Q, over the
    // slice's columns (its column blocks of the Q and dO tiles).
    const float* qs_c = qs + (col0 / 32) * BQ * 32;
    const float* dos_c = dos + (col0 / 32) * BQ * 32;
    const bool ragged = q0 + BQ > lq;
    float dv_part[DC / 8][4], dk_part[DC / 8][4];  // this tile's P^T dO and dS^T Q
#pragma unroll
    for (int d = 0; d < DC / 8; ++d) {
      dv_part[d][0] = dv_part[d][1] = dv_part[d][2] = dv_part[d][3] = 0.f;
      dk_part[d][0] = dk_part[d][1] = dk_part[d][2] = dk_part[d][3] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + t * 2 + j;
        const float nl = -lse_s[col] * kLog2e;
        const float dl = delta_s[col];
        const bool live = !ragged || q0 + col < lq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + j;
          p[e] = live ? ex2(fmaf(st[n][e], scale_log2, nl)) : 0.f;
          ds[e] = p[e] * (dpt[n][e] - dl);
        }
      }
      const tf32x3::A pa = tf32x3::acc_to_a(p);
      const tf32x3::A dsa = tf32x3::acc_to_a(ds);
#pragma unroll
      for (int d = 0; d < DC / 8; ++d) {
        const tf32x3::B ob = tf32x3::load_b_rows_k<BQ>(dos_c, n * 8, d * 8, g, t);
        const tf32x3::B qb = tf32x3::load_b_rows_k<BQ>(qs_c, n * 8, d * 8, g, t);
        tf32x3::mma3(dv_part[d], pa, ob);
        tf32x3::mma3(dk_part[d], dsa, qb);
      }
    }
#pragma unroll
    for (int d = 0; d < DC / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv_acc[d][e] += dv_part[d][e];
        dk_acc[d][e] += dk_part[d][e];
      }
    }

    named_barrier_sync(1 + group, kGroupThreads);  // the group is done with this stage
    if (tid == 0 && i + kStages < mine) issue(i + kStages);
  }

  // Group 1 hands its partial dK and dV to the thread of group 0 that holds the same keys
  // and columns; group 0 adds them and stores.
  __syncthreads();
  float* merge = reinterpret_cast<float*>(smem + L::kRing) + tid;
  if (group == 1) {
#pragma unroll
    for (int d = 0; d < DC / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        merge[(d * 4 + e) * kGroupThreads] = dk_acc[d][e];
        merge[(DC / 2 + d * 4 + e) * kGroupThreads] = dv_acc[d][e];
      }
    }
  }
  __syncthreads();
  if (group == 1) return;
#pragma unroll
  for (int d = 0; d < DC / 8; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[d][e] += merge[(d * 4 + e) * kGroupThreads];
      dv_acc[d][e] += merge[(DC / 2 + d * 4 + e) * kGroupThreads];
    }
  }
  const size_t koff = (size_t)bh * lk * DH + col0;
#pragma unroll
  for (int d = 0; d < DC / 8; ++d) {
    const int col = d * 8 + t * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = c0 + 8 * r;
      if (key < lk) {
        *reinterpret_cast<float2*>(dk + koff + (size_t)key * DH + col) =
            make_float2(dk_acc[d][2 * r] * scale, dk_acc[d][2 * r + 1] * scale);
        *reinterpret_cast<float2*>(dv + koff + (size_t)key * DH + col) =
            make_float2(dv_acc[d][2 * r], dv_acc[d][2 * r + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dq, or dk and dv
  int bh, lq, lk;
  float scale;
  cudaStream_t stream;
};

template <int DH>
int launch_dq(int is_bf16, const Args& a) {
  if (is_bf16) {
    using L = DqLayout<DH>;
    CUtensorMap q_map, k_map, v_map, do_map;
    if (!tile_map(&q_map, a.q, a.bh, a.lq, DH, kRows) || !tile_map(&do_map, a.dout, a.bh, a.lq, DH, kRows) ||
        !tile_map(&k_map, a.k, a.bh, a.lk, DH, kRows) || !tile_map(&v_map, a.v, a.bh, a.lk, DH, kRows)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int kSmem = L::kBytes + 1024;  // + the slack align_1024 takes
    const cudaError_t err =
        cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.lq + kRows - 1) / kRows, a.bh);
    flash_bwd_dq_bf16_kernel<DH><<<grid, kGroups * kGroupThreads, kSmem, a.stream>>>(
        q_map, k_map, v_map, do_map, a.lse, a.delta, static_cast<bf16*>(a.out0), a.lq, a.lk, a.scale);
  } else {
    using L = DqF32Layout<DH>;
    CUtensorMap q_map, k_map, v_map, do_map;
    if (!tile_map_f32(&q_map, a.q, a.bh, a.lq, DH, kRows) || !tile_map_f32(&do_map, a.dout, a.bh, a.lq, DH, kRows) ||
        !tile_map_f32(&k_map, a.k, a.bh, a.lk, DH, L::BK) || !tile_map_f32(&v_map, a.v, a.bh, a.lk, DH, L::BK)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int kSmem = L::kBytes + 1024;  // + the slack align_1024 takes
    const cudaError_t err =
        cudaFuncSetAttribute(flash_bwd_dq_tf32x3_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.lq + kRows - 1) / kRows, a.bh);
    flash_bwd_dq_tf32x3_kernel<DH><<<grid, kGroups * kGroupThreads, kSmem, a.stream>>>(
        q_map, k_map, v_map, do_map, a.lse, a.delta, static_cast<float*>(a.out0), a.lq, a.lk, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dkv(int is_bf16, const Args& a) {
  if (is_bf16) {
    using L = DkvLayout<DH>;
    CUtensorMap q_map, k_map, v_map, do_map, lse_map, delta_map;
    const size_t rows = (size_t)a.bh * a.lq;
    if (!tile_map(&q_map, a.q, a.bh, a.lq, DH, L::BQ) ||
        !tile_map(&do_map, a.dout, a.bh, a.lq, DH, L::BQ) || !tile_map(&k_map, a.k, a.bh, a.lk, DH, kRows) ||
        !tile_map(&v_map, a.v, a.bh, a.lk, DH, kRows) || !row_map(&lse_map, a.lse, rows, L::kRowBox) ||
        !row_map(&delta_map, a.delta, rows, L::kRowBox)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int kSmem = L::kBytes + 1024;  // + the slack align_1024 takes
    const cudaError_t err =
        cudaFuncSetAttribute(flash_bwd_dkv_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.lk + kRows - 1) / kRows, a.bh);
    flash_bwd_dkv_bf16_kernel<DH><<<grid, kGroups * kGroupThreads, kSmem, a.stream>>>(
        q_map, k_map, v_map, do_map, lse_map, delta_map, static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1),
        a.lq, a.lk, a.scale);
  } else {
    using L = DkvF32Layout<DH>;
    CUtensorMap q_map, k_map, v_map, do_map, lse_map, delta_map;
    const size_t rows = (size_t)a.bh * a.lq;
    if (!tile_map_f32(&q_map, a.q, a.bh, a.lq, DH, L::BQ) || !tile_map_f32(&do_map, a.dout, a.bh, a.lq, DH, L::BQ) ||
        !tile_map_f32(&k_map, a.k, a.bh, a.lk, DH, kRows) || !tile_map_f32(&v_map, a.v, a.bh, a.lk, DH, kRows) ||
        !row_map(&lse_map, a.lse, rows, L::kRowBox) || !row_map(&delta_map, a.delta, rows, L::kRowBox)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    constexpr int kSmem = L::kBytes + 1024;  // + the slack align_1024 takes
    const cudaError_t err =
        cudaFuncSetAttribute(flash_bwd_dkv_tf32x3_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.lk + kRows - 1) / kRows, a.bh, L::kSlices);
    flash_bwd_dkv_tf32x3_kernel<DH><<<grid, kGroups * kGroupThreads, kSmem, a.stream>>>(
        q_map, k_map, v_map, do_map, lse_map, delta_map, static_cast<float*>(a.out0), static_cast<float*>(a.out1),
        a.lq, a.lk, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int (*L32)(int, const Args&), int (*L64)(int, const Args&), int (*L128)(int, const Args&)>
int dispatch(int dh, int is_bf16, const Args& a) {
  if (a.bh <= 0 || a.bh > 65535 || a.lq <= 0 || a.lk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dh) {
    case 32:
      return L32(is_bf16, a);
    case 64:
      return L64(is_bf16, a);
    case 128:
      return L128(is_bf16, a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Both entry points launch on `stream` and return their CUDA error (0 on success), or
// cudaErrorInvalidValue for sizes or a head dimension the kernels do not take. The bf16
// kernels need scale > 0 (their wrapper maps any other scale onto one: negated or zero K).
// q and dout: (bh, lq, dh); k and v: (bh, lk, dh); all contiguous, 16-byte aligned and of one
// dtype (is_bf16 = 1: bfloat16, 0: float32); lse and delta: (bh, lq) float32. The outputs have
// the shape and dtype of their inputs.
extern "C" int cips_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dq, int bh, int lq, int lk, int dh,
                                           int is_bf16, float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, bh, lq, lk, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<launch_dq<32>, launch_dq<64>, launch_dq<128>>(dh, is_bf16, a);
}

extern "C" int cips_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, int bh,
                                            int lq, int lk, int dh, int is_bf16, float scale,
                                            void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               dk, dv, bh, lq, lk, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<launch_dkv<32>, launch_dkv<64>, launch_dkv<128>>(dh, is_bf16, a);
}

// Writes to *bytes the dynamic shared memory that the bf16 dQ kernel launches with at head
// dimension dh (ptxas reports only static shared memory). Returns a CUDA error code.
extern "C" int cips_flash_attention_bwd_dq_smem(int dh, void* bytes) {
  int* out = static_cast<int*>(bytes);
  if (dh == 32) *out = DqLayout<32>::kBytes + 1024;
  else if (dh == 64) *out = DqLayout<64>::kBytes + 1024;
  else if (dh == 128) *out = DqLayout<128>::kBytes + 1024;
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}
