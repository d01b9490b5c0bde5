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
// Any Lq and Lk, Dh 32/64/128. fp32 inputs take a plain-FMA kernel (one q row per thread),
// so the fp32 path stays exact fp32 and is not rounded through TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper_sm90.cuh"
#include "mma_bf16.cuh"

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

// fp32: one q row per thread, plain FMAs, K/V tiles of 32 keys in shared memory
// (every thread reads the same key, so the reads broadcast).
template <int DH>
__global__ void __launch_bounds__(kBlockQ) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int lq, int lk, float scale) {
  constexpr int kTile = 32;
  __shared__ float ks[kTile][DH];
  __shared__ float vs[kTile][DH];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBlockQ + tid;
  const float* kb = k + (size_t)bh * lk * DH;
  const float* vb = v + (size_t)bh * lk * DH;

  float qr[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = row < lq ? q[((size_t)bh * lq + row) * DH + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kTile) {
    __syncthreads();
    for (int i = tid; i < kTile * DH; i += kBlockQ) {
      const int r = i / DH;
      const int c = i % DH;
      const bool ok = k0 + r < lk;
      ks[r][c] = ok ? kb[(size_t)(k0 + r) * DH + c] : 0.f;
      vs[r][c] = ok ? vb[(size_t)(k0 + r) * DH + c] : 0.f;
    }
    __syncthreads();
    const int valid = min(kTile, lk - k0);

    float s[kTile];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], ks[j][d], dot);
      s[j] = j < valid ? dot * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = expf(s[j] - m);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
  }

  if (row < lq) {
    l = fmaxf(l, 1e-30f);
    float* orow = out + ((size_t)bh * lq + row) * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) orow[d] = acc[d] / l;
    lse[(size_t)bh * lq + row] = m + logf(l);
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
int launch(int is_bf16, const void* q, const void* k, const void* v, void* out, float* lse, int bh, int lq,
           int lk, float scale, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<DH>(q, k, v, out, lse, bh, lq, lk, scale, stream);
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_f32_kernel<DH><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, lq, lk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the forward on `stream` and returns its CUDA error (0 on success), or
// cudaErrorInvalidValue for sizes or a head dimension the kernels do not take. The bf16
// kernel needs scale > 0, the row max being taken before the scale (its wrapper maps any
// other scale onto one: negated or zero K). q: (bh, lq, dh), k and v:
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
