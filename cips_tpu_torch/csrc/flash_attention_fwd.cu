// Flash-attention forward for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces the Pallas TPU kernel cips_tpu/ops/pallas/flash_attention.py:_flash_kernel,
// launched by _flash_forward. Same math: online-softmax attention over (B*H, L, Dh)
// q, k, v; scores s = scale * q k^T in fp32; running max m, denominator l and an fp32
// output accumulator; P is rounded to the input dtype before P.V; out = acc / max(l, 1e-30)
// in the input dtype; lse = m + log(max(l, 1e-30)) in fp32, shape (B*H, Lq), kept as the
// residual the backward kernels read.
//
// What bounds it on an H100 SXM. At the flagship's attention level (B=1, H=4, L=2304,
// Dh=32) the two products are 4*B*H*L^2*Dh = 2.72 GFLOP: 2.75 us at 989 TFLOP/s bf16.
// q, k, v, out and lse are 2.4 MB: 0.72 us at 3.35 TB/s. So it is compute-bound, and
// the 21.2 M exponentials (one per score) on the special-function units may set the
// real limit before the tensor cores do.
//
// What the design does about that. The bf16 kernel runs both products on the tensor
// cores (mma.sync m16n8k16, fp32 accumulation) and keeps the scores, P and the running
// state in registers: nothing of size L^2 touches memory. One block of 4 warps per
// (batch*head, 64-row q tile); each warp owns 16 q rows. K and V stream through shared
// memory 64 keys at a time (V stored transposed so both operands load as 32-bit pairs);
// a loop over the k tiles inside the block replaces the TPU's sequential grid axis.
// At the flagship shape that is 4 heads x 36 tiles = 144 blocks, about one wave on
// 132 SMs. The ragged last tile is masked (keys to -inf, rows not stored), so any L
// works. fp32 inputs take a plain-FMA kernel with the same structure (one q row per
// thread), so the fp32 path stays exact fp32 and is not rounded through TF32.
// wgmma, TMA and warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <cmath>

namespace {

constexpr int kBlockQ = 64;  // q rows per block
constexpr int kBlockK = 64;  // keys per shared-memory tile (bf16 kernel)
constexpr int kWarps = kBlockQ / 16;
constexpr float kNegInf = -1e30f;  // initial running max, as in the TPU kernel

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  uint32_t bits;
  memcpy(&bits, &v, sizeof(bits));
  return bits;
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a * b on the tensor cores: a is a 16x16 row-major bf16 tile, b a 16x8 bf16 tile
// (column-major), c a 16x8 fp32 tile, in the fragment layouts of the PTX ISA.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int lq, int lk, float scale) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kKStride = DH + 8;       // padded K row (bf16): conflict-free fragment loads
  constexpr int kVStride = kBlockK + 8;  // padded V^T row (bf16)
  constexpr int kQChunks = DH / 16;      // k-steps of the q k^T product
  constexpr int kDChunks = DH / 8;       // 8-wide column groups of the output
  constexpr int kSChunks = kBlockK / 8;  // 8-wide column groups of the scores
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vts[DH * kVStride];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row within an 8-row group
  const int t = lane % 4;  // thread within the quad that shares a row
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g;  // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;
  const __nv_bfloat16* qb = q + (size_t)bh * lq * DH;
  const __nv_bfloat16* kb = k + (size_t)bh * lk * DH;
  const __nv_bfloat16* vb = v + (size_t)bh * lk * DH;

  // q as A fragments for the whole head dimension, zero for rows past lq.
  uint32_t qf[kQChunks][4];
#pragma unroll
  for (int c = 0; c < kQChunks; ++c) {
    const int col = c * 16 + t * 2;
    qf[c][0] = r0 < lq ? load_u32(qb + (size_t)r0 * DH + col) : 0u;
    qf[c][1] = r1 < lq ? load_u32(qb + (size_t)r1 * DH + col) : 0u;
    qf[c][2] = r0 < lq ? load_u32(qb + (size_t)r0 * DH + col + 8) : 0u;
    qf[c][3] = r1 < lq ? load_u32(qb + (size_t)r1 * DH + col + 8) : 0u;
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // partial row sums over this thread's columns
  float acc[kDChunks][4];
#pragma unroll
  for (int d = 0; d < kDChunks; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockK * DH / 8; i += kThreads) {
      const int row = i / (DH / 8);
      const int col = (i % (DH / 8)) * 8;
      const int key = k0 + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < lk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)key * DH + col);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)key * DH + col);
      }
      *reinterpret_cast<uint4*>(ks + row * kKStride + col) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vts[(col + j) * kVStride + row] = ve[j];
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 keys.
    float s[kSChunks][4];
#pragma unroll
    for (int n = 0; n < kSChunks; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = ks + (n * 8 + g) * kKStride + t * 2;
#pragma unroll
      for (int c = 0; c < kQChunks; ++c) {
        const uint32_t bf[2] = {load_u32(krow + c * 16), load_u32(krow + c * 16 + 8)};
        mma_16816(s[n], qf[c], bf);
      }
    }

    // Scale, mask keys past lk, and update the running max across the quad.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kSChunks; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t * 2 + (e & 1);
        const float val = key < lk ? s[n][e] * scale : -INFINITY;
        s[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = __expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int d = 0; d < kDChunks; ++d) {
        acc[d][2 * i] *= alpha;
        acc[d][2 * i + 1] *= alpha;
      }
    }

    // p = exp(s - m): the row sums take fp32 p, the product takes p rounded to bf16.
    // The score accumulators of keys [16c, 16c + 16) are the A fragment of k-step c.
    uint32_t pf[kBlockK / 16][4];
#pragma unroll
    for (int n = 0; n < kSChunks; ++n) {
      const float p0 = __expf(s[n][0] - m[0]);
      const float p1 = __expf(s[n][1] - m[0]);
      const float p2 = __expf(s[n][2] - m[1]);
      const float p3 = __expf(s[n][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[n / 2][(n % 2) * 2] = pack_bf16x2(p0, p1);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16x2(p2, p3);
    }

    // acc += p v
#pragma unroll
    for (int c = 0; c < kBlockK / 16; ++c) {
#pragma unroll
      for (int d = 0; d < kDChunks; ++d) {
        const __nv_bfloat16* vrow = vts + (d * 8 + g) * kVStride + c * 16 + t * 2;
        const uint32_t bf[2] = {load_u32(vrow), load_u32(vrow + 8)};
        mma_16816(acc[d], pf[c], bf);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
  }
  __nv_bfloat16* ob = out + (size_t)bh * lq * DH;
#pragma unroll
  for (int d = 0; d < kDChunks; ++d) {
    const int col = d * 8 + t * 2;
    if (r0 < lq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)r0 * DH + col) =
          pack_bf16x2(acc[d][0] / l[0], acc[d][1] / l[0]);
    }
    if (r1 < lq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)r1 * DH + col) =
          pack_bf16x2(acc[d][2] / l[1], acc[d][3] / l[1]);
    }
  }
  if (t == 0) {
    if (r0 < lq) lse[(size_t)bh * lq + r0] = m[0] + logf(l[0]);
    if (r1 < lq) lse[(size_t)bh * lq + r1] = m[1] + logf(l[1]);
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
void launch(int is_bf16, const void* q, const void* k, const void* v, void* out, float* lse,
            int bh, int lq, int lk, float scale, cudaStream_t stream) {
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  if (is_bf16) {
    using bf = __nv_bfloat16;
    flash_fwd_bf16_kernel<DH><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<bf*>(out), lse, lq, lk, scale);
  } else {
    flash_fwd_f32_kernel<DH><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), lse, lq, lk, scale);
  }
}

}  // namespace

// Launches the forward on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for sizes or a head dimension the kernels do not take.
// q: (bh, lq, dh), k and v: (bh, lk, dh), out: (bh, lq, dh), all contiguous, 16-byte
// aligned and of one dtype (is_bf16 = 1: bfloat16, 0: float32); lse: (bh, lq) float32.
extern "C" int cips_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                        void* lse, int bh, int lq, int lk, int dh, int is_bf16,
                                        float scale, void* stream) {
  if (bh <= 0 || bh > 65535 || lq <= 0 || lk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (dh) {
    case 32:
      launch<32>(is_bf16, q, k, v, out, lse_f, bh, lq, lk, scale, s);
      break;
    case 64:
      launch<64>(is_bf16, q, k, v, out, lse_f, bh, lq, lk, scale, s);
      break;
    case 128:
      launch<128>(is_bf16, q, k, v, out, lse_f, bh, lq, lk, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
