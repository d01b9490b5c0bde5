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
// exponentials about equally at Dh 32, and by the products at larger Dh.
//
// What the designs do about that. Blocks run in no order on a GPU, so the TPU's sequential
// grid axis becomes a loop inside the block, and each output tile has one owner. S, P, dP
// and dS stay in registers: nothing of size L^2 touches memory.
//   dQ (bf16): one block of 4 warps per (64 q rows, batch*head) on mma.sync m16n8k16; each
//         warp owns 16 q rows and loops over all key tiles. Q and dO stay in registers as A
//         fragments; K and V stream through shared memory row-major (the B operand of Q K^T
//         and dO V^T) and K also transposed (the B operand of dS K). Rows are padded by 8
//         elements, which makes the 32-bit fragment loads free of bank conflicts; at Dh 128
//         the key tile is 32 (else 64). wgmma and TMA are later work for this kernel.
//   dK/dV (bf16): one CTA of two warpgroups per (64 keys, batch*head). It computes
//         S^T = K Q^T and dP^T = V dO^T, as the TPU kernel does, so P^T and dS^T come out
//         as accumulators that are already register A operands of P^T dO and dS^T Q.
//         - Tensor cores: all four products are wgmma (m64nNk16, fp32 accumulators). K and
//           V arrive once by TMA and are the shared-memory A of S^T and dP^T; the B of
//           P^T dO and dS^T Q is the same swizzled Q or dO tile read with wgmma's transpose
//           bit, so nothing is transposed by hand.
//         - Memory latency: Q, dO, lse and delta tiles (64 q rows; 32 at Dh 128) stream
//           through a ring of 3 stages (2 at Dh 128) per warpgroup, filled by TMA and
//           completed on mbarriers, so the next tiles load while this one is multiplied.
//         - Exponentials: p = 2^(s c - lse log2 e) with c = scale log2 e, one FFMA and one
//           ex2 per score.
//         - Warps in flight: the two warpgroups split the q loop (even and odd tiles) and
//           sum their dK/dV partials in shared memory before the one store; no atomics. At
//           the flagship shape: 288 CTAs of 8 warps, twice the warps of one group a CTA.
// Any L: rows past L read as zeros, and P is set to 0 explicitly for keys past lk (dQ) and
// q rows past lq (dK/dV), so neither padded lse/delta values nor padded rows add anything.
// fp32 inputs take plain-FMA kernels of the same structure (one row per thread), so the fp32
// path is not rounded through TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kWarps = 4;
constexpr int kRows = kWarps * 16;  // q rows (dQ) or keys (dK/dV) owned by a block
constexpr int kThreads = kWarps * 32;

template <int DH>
constexpr int kLoopTile = DH >= 128 ? 32 : 64;  // keys (dQ) or q rows (dK/dV) per smem tile

// Copies rows [r0, r0 + ROWS) of a (len, DH) bf16 matrix to shared memory: row-major with
// row stride DH + 8 into `rm`, and transposed with row stride ROWS + 8 into `tr` when it is
// not null. Rows past `len` are zero.
template <int ROWS, int DH>
__device__ __forceinline__ void load_tile(const bf16* src, int r0, int len, bf16* rm, bf16* tr) {
  for (int i = threadIdx.x; i < ROWS * DH / 8; i += kThreads) {
    const int row = i / (DH / 8);
    const int col = (i % (DH / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < len) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * DH + col);
    *reinterpret_cast<uint4*>(rm + row * (DH + 8) + col) = val;
    if (tr != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[(col + j) * (ROWS + 8) + row] = e[j];
    }
  }
}

// A fragments of rows r and r + 8 of a (len, DH) bf16 matrix over the whole head dimension;
// zero for rows past len.
template <int DH>
__device__ __forceinline__ void load_a_frags(const bf16* src, int r, int len, int t,
                                             uint32_t (&f)[DH / 16][4]) {
#pragma unroll
  for (int c = 0; c < DH / 16; ++c) {
    const int col = c * 16 + t * 2;
    f[c][0] = r < len ? load_u32(src + (size_t)r * DH + col) : 0u;
    f[c][1] = r + 8 < len ? load_u32(src + (size_t)(r + 8) * DH + col) : 0u;
    f[c][2] = r < len ? load_u32(src + (size_t)r * DH + col + 8) : 0u;
    f[c][3] = r + 8 < len ? load_u32(src + (size_t)(r + 8) * DH + col + 8) : 0u;
  }
}

// acc = A M^T for a 16 x DH A (fragments in registers) and the first NCH * 8 rows of M,
// stored row-major with stride DH + 8 in shared memory: acc[n] is the 16 x 8 tile of the
// columns n*8 .. n*8 + 7 (rows of M).
template <int DH, int NCH>
__device__ __forceinline__ void mma_abt(const uint32_t (&a)[DH / 16][4], const bf16* m, int g,
                                        int t, float (&acc)[NCH][4]) {
#pragma unroll
  for (int n = 0; n < NCH; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    const bf16* row = m + (n * 8 + g) * (DH + 8) + t * 2;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const uint32_t b[2] = {load_u32(row + c * 16), load_u32(row + c * 16 + 8)};
      mma_16816(acc[n], a[c], b);
    }
  }
}

// acc += A N for a 16 x (KS * 16) A (fragments in registers) and N of shape (KS * 16) x DH,
// stored transposed (N^T, DH rows of stride `stride`) in shared memory.
template <int DH, int KS>
__device__ __forceinline__ void mma_ab(const uint32_t (&a)[KS][4], const bf16* nt, int stride,
                                       int g, int t, float (&acc)[DH / 8][4]) {
#pragma unroll
  for (int c = 0; c < KS; ++c) {
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      const bf16* row = nt + (d * 8 + g) * stride + c * 16 + t * 2;
      const uint32_t b[2] = {load_u32(row), load_u32(row + 8)};
      mma_16816(acc[d], a[c], b);
    }
  }
}

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

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int lq, int lk, float scale) {
  constexpr int BK = kLoopTile<DH>;
  constexpr int kTStride = BK + 8;
  __shared__ __align__(16) bf16 ks[BK * (DH + 8)];
  __shared__ __align__(16) bf16 vs[BK * (DH + 8)];
  __shared__ __align__(16) bf16 kts[DH * kTStride];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = blockIdx.x * kRows + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const size_t qoff = (size_t)bh * lq * DH;
  const size_t koff = (size_t)bh * lk * DH;

  uint32_t qf[DH / 16][4];
  uint32_t df[DH / 16][4];
  load_a_frags<DH>(q + qoff, r0, lq, t, qf);
  load_a_frags<DH>(dout + qoff, r0, lq, t, df);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    lse_r[i] = r < lq ? lse[(size_t)bh * lq + r] : 0.f;
    delta_r[i] = r < lq ? delta[(size_t)bh * lq + r] : 0.f;
  }
  float acc[DH / 8][4];
#pragma unroll
  for (int d = 0; d < DH / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<BK, DH>(k + koff, k0, lk, ks, kts);
    load_tile<BK, DH>(v + koff, k0, lk, vs, nullptr);
    __syncthreads();

    float s[BK / 8][4];
    float dp[BK / 8][4];
    mma_abt<DH, BK / 8>(qf, ks, g, t, s);   // Q K^T
    mma_abt<DH, BK / 8>(df, vs, g, t, dp);  // dO V^T
    uint32_t dsf[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t * 2 + (e & 1);
        const float p = key < lk ? __expf(s[n][e] * scale - lse_r[e >> 1]) : 0.f;
        ds[e] = p * (dp[n][e] - delta_r[e >> 1]);
      }
      to_a_frag(dsf, n, ds);
    }
    mma_ab<DH, BK / 16>(dsf, kts, kTStride, g, t, acc);  // dQ += dS K
  }
  store_rows<DH>(dq + qoff, acc, scale, r0, lq, t);
}

// dK/dV, bf16: one CTA of two warpgroups per (64 keys, batch*head); see the note at the top.
constexpr int kGroups = 2;  // warpgroups per CTA; group w takes q tiles w, w + 2, ...
constexpr int kGroupThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

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

// fp32: one row per thread (a q row for dQ, a key for dK/dV), plain FMAs, the other side in
// shared-memory tiles of 32 rows (every thread reads the same row, so the reads broadcast).
constexpr int kF32Rows = 64;
constexpr int kF32Tile = 32;

template <int DH>
__global__ void __launch_bounds__(kF32Rows) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int lq, int lk, float scale) {
  __shared__ float ks[kF32Tile][DH];
  __shared__ float vs[kF32Tile][DH];
  const int bh = blockIdx.y;
  const int row = blockIdx.x * kF32Rows + threadIdx.x;
  const bool valid = row < lq;
  const float* kb = k + (size_t)bh * lk * DH;
  const float* vb = v + (size_t)bh * lk * DH;
  const size_t roff = ((size_t)bh * lq + row) * DH;

  float qr[DH], dr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = valid ? q[roff + d] : 0.f;
    dr[d] = valid ? dout[roff + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse_r = valid ? lse[(size_t)bh * lq + row] : 0.f;
  const float delta_r = valid ? delta[(size_t)bh * lq + row] : 0.f;

  for (int k0 = 0; k0 < lk; k0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * DH; i += kF32Rows) {
      const int r = i / DH;
      const int c = i % DH;
      const bool ok = k0 + r < lk;
      ks[r][c] = ok ? kb[(size_t)(k0 + r) * DH + c] : 0.f;
      vs[r][c] = ok ? vb[(size_t)(k0 + r) * DH + c] : 0.f;
    }
    __syncthreads();
    const int n = min(kF32Tile, lk - k0);  // keys past lk are skipped: P = 0
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qr[d], ks[j][d], s);
        dp = fmaf(dr[d], vs[j][d], dp);
      }
      const float ds = expf(s * scale - lse_r) * (dp - delta_r);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[roff + d] = acc[d] * scale;
  }
}

template <int DH>
__global__ void __launch_bounds__(kF32Rows) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int lq,
    int lk, float scale) {
  __shared__ float qs[kF32Tile][DH];
  __shared__ float dos[kF32Tile][DH];
  __shared__ float lse_s[kF32Tile];
  __shared__ float delta_s[kF32Tile];
  const int bh = blockIdx.y;
  const int key = blockIdx.x * kF32Rows + threadIdx.x;
  const bool valid = key < lk;
  const float* qb = q + (size_t)bh * lq * DH;
  const float* db = dout + (size_t)bh * lq * DH;
  const size_t koff = ((size_t)bh * lk + key) * DH;

  float kr[DH], vr[DH], dk_acc[DH], dv_acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    kr[d] = valid ? k[koff + d] : 0.f;
    vr[d] = valid ? v[koff + d] : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  for (int q0 = 0; q0 < lq; q0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * DH; i += kF32Rows) {
      const int r = i / DH;
      const int c = i % DH;
      const bool ok = q0 + r < lq;
      qs[r][c] = ok ? qb[(size_t)(q0 + r) * DH + c] : 0.f;
      dos[r][c] = ok ? db[(size_t)(q0 + r) * DH + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32Tile; i += kF32Rows) {
      const bool ok = q0 + i < lq;
      lse_s[i] = ok ? lse[(size_t)bh * lq + q0 + i] : 0.f;
      delta_s[i] = ok ? delta[(size_t)bh * lq + q0 + i] : 0.f;
    }
    __syncthreads();
    const int n = min(kF32Tile, lq - q0);  // q rows past lq are skipped: P = 0
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(kr[d], qs[j][d], s);
        dp = fmaf(vr[d], dos[j][d], dp);
      }
      const float p = expf(s * scale - lse_s[j]);
      const float ds = p * (dp - delta_s[j]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        dv_acc[d] = fmaf(p, dos[j][d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, qs[j][d], dk_acc[d]);
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[koff + d] = dk_acc[d] * scale;
      dv[koff + d] = dv_acc[d];
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
    const dim3 grid((a.lq + kRows - 1) / kRows, a.bh);
    flash_bwd_dq_bf16_kernel<DH><<<grid, kThreads, 0, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
        static_cast<bf16*>(a.out0), a.lq, a.lk, a.scale);
  } else {
    const dim3 grid((a.lq + kF32Rows - 1) / kF32Rows, a.bh);
    flash_bwd_dq_f32_kernel<DH><<<grid, kF32Rows, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.out0), a.lq, a.lk, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dkv(int is_bf16, const Args& a) {
  if (is_bf16) {
    using L = DkvLayout<DH>;
    CUtensorMap q_map, k_map, v_map, do_map, lse_map, delta_map;
    const size_t rows = (size_t)a.bh * a.lq;
    if (!(a.scale > 0.f) || !tile_map(&q_map, a.q, a.bh, a.lq, DH, L::BQ) ||
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
    const dim3 grid((a.lk + kF32Rows - 1) / kF32Rows, a.bh);
    flash_bwd_dkv_f32_kernel<DH><<<grid, kF32Rows, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.lq, a.lk, a.scale);
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
// cudaErrorInvalidValue for sizes or a head dimension the kernels do not take (bf16 dK/dV
// also needs scale > 0). q and dout:
// (bh, lq, dh); k and v: (bh, lk, dh); all contiguous, 16-byte aligned and of one dtype
// (is_bf16 = 1: bfloat16, 0: float32); lse and delta: (bh, lq) float32. The outputs have
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
