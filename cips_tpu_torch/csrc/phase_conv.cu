// Phase-structured packed 3-D k3 convolution for Hopper (sm_90a), and its probe variants,
// bound to PyTorch through ctypes.
//
// Replaces the Pallas TPU kernels
//   cips_tpu/ops/pallas/phase_conv.py:_kernel (launched by phase_conv_apply),
//   scripts/probe_pallas_dot.py:k_dot4d, k_dot2d, k_sel,
//   scripts/probe_pallas_bisect.py:_kernel (MODE nosel, sel, full),
//   scripts/debug_pallas_stages.py:_kernel (STAGE 1, 2, 3, >= 4),
// as one kernel whose variants are template parameters, plus two elementwise kernels.
//
// The function. x is a space-to-depth packed volume (B, Z, Y, X, pc), channels last,
// pc = 8C, phase-major: channel q*C + c holds input phase q = (qz*2 + qy)*2 + qx. With
// Wp = pack_conv_kernel_phase(w), (2, 2, 2, pc, pc), the packed k3 conv is
//   out[cell] = sum_{k in {0,1}^3} x'[cell + k] . Wp[k],   x'[i][q*C + c] = x[i - q][q*C + c],
// zero outside the volume, fp32 accumulation, out in x's dtype. On the TPU the shift of
// phase group q by q per axis costs three materialised x-shifted copies of the padded input
// and a lane select per axis. Here it is only an address: for output cell (z, y, x), tap
// (kz, ky, kx) and input channel q*C + c the A operand reads
//   x[b, z + kz - qz, y + ky - qy, x + kx - qx, q*C + c],
// and a read that falls outside the volume is a zero-filled copy. Variants:
//   kFull     the function above (phase_conv_apply; bisect full; stages >= 4);
//   kNoShift  every group reads x[cell + k - 1] (bisect nosel);
//   kOneTap   tap (0, 0, 0) only: x'[cell] . Wp[0, 0, 0] (stages 3);
//   kDot      out = sum_{k < 8} x[cell] . W[k], W (8, pc, pc), no shift (probe dot4d, dot2d);
//   kShift    out = x'[cell], no products (bisect sel; stages 2);
//   kCopy     out = x (stages 1);
//   kSelect   out = x on even channels, ((x * 2) * 0.5) * 3 rounded to x's dtype at each
//             step on odd channels (probe sel).
//
// What bounds it on an H100 SXM. At (8, 48, 64, 48, 128) bf16 (C = 16, the flagship's
// level-0 conv, packed (2, 2, 2)), the function's work is 2*27*C^2 per full-grid voxel, 1.305e11
// operations: 0.1319 ms at 989 TFLOP/s. Reading x and writing out once is 6.04e8 bytes:
// 0.1803 ms at 3.35 TB/s. So the function is bound by memory, at 0.1803 ms. At pc = 256
// (C = 32) it is bound by operations: 5.22e11, 0.5277 ms. Run densely over all 8 taps and
// all pc x pc weights, as the TPU kernel and this one do, the work is 2*8*cells*pc^2 =
// 3.09e11 operations at pc = 128 (0.3127 ms): 2.37x the function's.
//
// What the design does about that. An implicit GEMM: M = output cells (the flattened
// b, z, y, x index, any Z, Y, X; the ragged last tile is masked), N = 128 output
// channels a block (pc = 256 takes two N blocks), K = 8 taps x pc input channels in chunks
// of 32. A block of 8 warps computes 128 cells x 128 channels; its A rows come straight
// from x by cp.async (16 bytes each, zero-filled where the shifted cell leaves the
// volume), so x' is never materialised and the phase shift costs one address computation
// per 16 bytes. Wp streams through shared memory one (tap, K chunk) at a time (Wp is
// 32 KB a tap at pc 128 and 128 KB at pc 256, too large to keep whole), double-buffered
// against the products. bf16 runs on the tensor cores (mma.sync m16n8k16, fp32
// accumulators, operands by ldmatrix); fp32 runs on plain FMAs (no TF32), as the flash
// fp32 kernels do. The epilogue rounds to x's dtype and stores channels last. All
// offsets are 64-bit. The N blocks of one cell tile are neighbours in launch order, so
// the second can find its A rows in L2.
// Left for later work: skipping the 37 of 64 (q, p) weight blocks that are zero in Wp
// (the 2.37x above), wgmma, TMA and a persistent tile loop. Each block still reads all of
// Wp (256 KB at pc 128) from L2, so larger cell tiles would cut L2 traffic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

enum Variant : int { kFull = 0, kNoShift = 1, kOneTap = 2, kDot = 3, kShift = 4, kCopy = 5, kSelect = 6 };

constexpr int kPhases = 8;

// Products over how many taps each variant sums.
__host__ __device__ constexpr int taps_of(int v) { return (v == kFull || v == kNoShift || v == kDot) ? 8 : 1; }

// The offset along one axis of the cell that tap k reads for input phase bit q.
template <int V>
__device__ __forceinline__ int axis_shift(int k, int q) {
  if (V == kFull) return k - q;
  if (V == kNoShift) return k - 1;
  if (V == kOneTap || V == kShift) return -q;
  return 0;  // kDot, kCopy
}

struct Geometry {
  long long cells;  // b * z * y * x
  int z, y, x, pc, c;
};

// A cell's coordinates within its volume; ``valid`` is false past the last cell.
struct Cell {
  int z, y, x;
  bool valid;
};

__device__ __forceinline__ Cell decode(long long m, const Geometry& g) {
  Cell cell;
  cell.valid = m < g.cells;
  const long long mm = cell.valid ? m : 0;
  cell.x = static_cast<int>(mm % g.x);
  const long long t = mm / g.x;
  cell.y = static_cast<int>(t % g.y);
  cell.z = static_cast<int>((t / g.y) % g.z);
  return cell;
}

// Element offset, relative to cell m's own channel ci, of the value that tap
// (kz, ky, kx) reads for channel ci; false if it lies outside the volume.
template <int V>
__device__ __forceinline__ bool source(const Cell& cell, int kz, int ky, int kx, int ci, const Geometry& g,
                                       long long* delta) {
  const int q = ci / g.c;
  const int dz = axis_shift<V>(kz, q >> 2), dy = axis_shift<V>(ky, (q >> 1) & 1), dx = axis_shift<V>(kx, q & 1);
  const bool inside = cell.valid && static_cast<unsigned>(cell.z + dz) < static_cast<unsigned>(g.z) &&
                      static_cast<unsigned>(cell.y + dy) < static_cast<unsigned>(g.y) &&
                      static_cast<unsigned>(cell.x + dx) < static_cast<unsigned>(g.x);
  *delta = ((static_cast<long long>(dz) * g.y + dy) * g.x + dx) * g.pc;
  return inside;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = fill ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// ---- bf16: tensor cores --------------------------------------------------------------------

constexpr int kBM = 128;             // cells a block
constexpr int kBN = 128;             // output channels a block
constexpr int kBK = 32;              // input channels a K chunk
constexpr int kThreads = 256;        // 8 warps: 2 along M (64 cells) x 4 along N (32 channels)
constexpr int kAStride = kBK + 8;    // padded A row (bf16): 80 bytes, conflict-free ldmatrix
constexpr int kBStride = kBN + 8;    // padded B row (bf16): 272 bytes
constexpr int kARows = kThreads / 4; // A rows one pass of the block loads (4 16-byte chunks a row)
constexpr int kBRows = kThreads / 16;

template <int V>
__global__ void __launch_bounds__(kThreads) phase_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                                                   const __nv_bfloat16* __restrict__ w,
                                                                   __nv_bfloat16* __restrict__ out, Geometry g) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kBM * kAStride];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kBK * kBStride];

  const int n_tiles = g.pc / kBN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  // This thread's A rows (kBM / kARows of them) and its 16-byte chunk within a row.
  constexpr int kRowsPerThread = kBM / kARows;
  const int a_col = (tid % 4) * 8;
  Cell cells[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) cells[i] = decode(m0 + tid / 4 + i * kARows, g);

  const int chunks = g.pc / kBK;
  const int steps = taps_of(V) * chunks;

  auto load = [&](int buf, int step) {
    const int tap = step / chunks;
    const int c0 = (step % chunks) * kBK;
    const int kz = tap >> 2, ky = (tap >> 1) & 1, kx = tap & 1;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = tid / 4 + i * kARows;
      const int ci = c0 + a_col;
      long long delta;
      const bool inside = source<V>(cells[i], kz, ky, kx, ci, g, &delta);
      const __nv_bfloat16* src = inside ? x + (m0 + row) * g.pc + delta + ci : x;
      cp_async16(&as[buf][row * kAStride + a_col], src, inside);
    }
#pragma unroll
    for (int i = 0; i < kBK / kBRows; ++i) {
      const int kr = tid / 16 + i * kBRows;
      const int nc = (tid % 16) * 8;
      cp_async16(&bs[buf][kr * kBStride + nc], w + (static_cast<long long>(tap) * g.pc + c0 + kr) * g.pc + n0 + nc,
                 true);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      load(buf ^ 1, step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], &as[buf][(wm + mi * 16 + (lane & 15)) * kAStride + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &bs[buf][(kk + (lane & 15)) * kBStride + wn + nj * 16 + (lane >> 4) * 8]);
        b[nj * 2][0] = r[0];
        b[nj * 2][1] = r[1];
        b[nj * 2 + 1][0] = r[2];
        b[nj * 2 + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();  // the next iteration's load overwrites this buffer
  }

  const int gr = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm + mi * 16 + gr + half * 8;
      if (m >= g.cells) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + ni * 8 + t * 2;
        *reinterpret_cast<uint32_t*>(out + m * g.pc + n) =
            pack_bf16x2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
      }
    }
  }
}

// ---- fp32: plain FMAs ----------------------------------------------------------------------

constexpr int kFM = 64;   // cells a block
constexpr int kFN = 128;  // output channels a block
constexpr int kFK = 16;   // input channels a K chunk
// 256 threads as 16 x 16; each computes 4 cells x 8 channels.

template <int V>
__global__ void __launch_bounds__(256) phase_conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                                                             float* __restrict__ out, Geometry g) {
  __shared__ __align__(16) float as[kFK][kFM + 4];  // transposed: K major
  __shared__ __align__(16) float bs[kFK][kFN];

  const int n_tiles = g.pc / kFN;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * kFM;
  const int n0 = (blockIdx.x % n_tiles) * kFN;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;

  const int a_row = tid / 4, a_col = (tid % 4) * 4;  // one float4 of A a thread per chunk
  const Cell cell = decode(m0 + a_row, g);
  const int chunks = g.pc / kFK;
  const int steps = taps_of(V) * chunks;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int tap = step / chunks;
    const int c0 = (step % chunks) * kFK;
    const int kz = tap >> 2, ky = (tap >> 1) & 1, kx = tap & 1;
    const int ci = c0 + a_col;
    long long delta;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (source<V>(cell, kz, ky, kx, ci, g, &delta))
      av = *reinterpret_cast<const float4*>(x + (m0 + a_row) * g.pc + delta + ci);
    as[a_col + 0][a_row] = av.x;
    as[a_col + 1][a_row] = av.y;
    as[a_col + 2][a_row] = av.z;
    as[a_col + 3][a_row] = av.w;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256;  // 512 float4 of B
      const int kr = idx / 32, nc = (idx % 32) * 4;
      *reinterpret_cast<float4*>(&bs[kr][nc]) =
          *reinterpret_cast<const float4*>(w + (static_cast<long long>(tap) * g.pc + c0 + kr) * g.pc + n0 + nc);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[k][tr * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tc * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[k][tc * 8 + 4]);
      const float av4[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av4[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + tr * 4 + i;
    if (m >= g.cells) continue;
    float* o = out + m * g.pc + n0 + tc * 8;
    *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// ---- shift, copy and select: one 16-byte vector a thread -----------------------------------

template <int V, typename T>
__global__ void __launch_bounds__(256) phase_gather_kernel(const T* __restrict__ x, T* __restrict__ out, Geometry g) {
  constexpr int kVec = 16 / sizeof(T);
  const long long vectors = g.cells * g.pc / kVec;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < vectors;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = v * kVec;
    uint4 value = make_uint4(0u, 0u, 0u, 0u);
    if (V == kCopy) {
      value = *reinterpret_cast<const uint4*>(x + e);
    } else {
      const long long m = e / g.pc;
      const int ci = static_cast<int>(e % g.pc);
      long long delta;
      if (source<V>(decode(m, g), 0, 0, 0, ci, g, &delta)) value = *reinterpret_cast<const uint4*>(x + e + delta);
    }
    *reinterpret_cast<uint4*>(out + e) = value;
  }
}

__device__ __forceinline__ float odd_lane(float v) { return ((v * 2.f) * 0.5f) * 3.f; }

__device__ __forceinline__ __nv_bfloat16 odd_lane(__nv_bfloat16 v) {
  // rounded to bf16 after each product, as the TPU probe's bf16 arithmetic is
  const __nv_bfloat16 t = __float2bfloat16_rn(__bfloat162float(v) * 2.f);
  const __nv_bfloat16 u = __float2bfloat16_rn(__bfloat162float(t) * 0.5f);
  return __float2bfloat16_rn(__bfloat162float(u) * 3.f);
}

template <typename T>
__global__ void __launch_bounds__(256) lane_select_kernel(const T* __restrict__ x, T* __restrict__ out,
                                                          long long vectors) {
  constexpr int kVec = 16 / sizeof(T);  // even: channel parity is the position's parity
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < vectors;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    uint4 raw = *reinterpret_cast<const uint4*>(x + v * kVec);
    T* lanes = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 1; j < kVec; j += 2) lanes[j] = odd_lane(lanes[j]);
    *reinterpret_cast<uint4*>(out + v * kVec) = raw;
  }
}

int elementwise_blocks(long long vectors) {
  const long long blocks = (vectors + 255) / 256;
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

template <int V>
void launch_gemm(bool bf16, const void* x, const void* w, void* out, const Geometry& g, cudaStream_t s) {
  if (bf16) {
    const long long blocks = (g.cells + kBM - 1) / kBM * (g.pc / kBN);
    phase_conv_bf16_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
        g);
  } else {
    const long long blocks = (g.cells + kFM - 1) / kFM * (g.pc / kFN);
    phase_conv_f32_kernel<V><<<static_cast<unsigned>(blocks), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), g);
  }
}

template <int V>
void launch_gather(bool bf16, const void* x, void* out, const Geometry& g, cudaStream_t s) {
  const int blocks = elementwise_blocks(g.cells * g.pc / (bf16 ? 8 : 4));
  if (bf16)
    phase_gather_kernel<V, __nv_bfloat16><<<blocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                                 static_cast<__nv_bfloat16*>(out), g);
  else
    phase_gather_kernel<V, float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out), g);
}

}  // namespace

// x, out (b, z, y, xdim, pc) contiguous, 16-byte aligned; w (8, pc, pc) for the variants
// with products, unused otherwise. pc a multiple of 128. Returns a CUDA error code.
extern "C" int cips_phase_conv(const void* x, const void* w, void* out, int variant, int is_bf16, int b, int z,
                               int y, int xdim, int pc, void* stream) {
  if (b <= 0 || z <= 0 || y <= 0 || xdim <= 0 || pc <= 0 || pc % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{static_cast<long long>(b) * z * y * xdim, z, y, xdim, pc, pc / kPhases};
  if ((g.cells + kFM - 1) / kFM * (pc / kFN) > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (variant) {
    case kFull:
      launch_gemm<kFull>(bf16, x, w, out, g, s);
      break;
    case kNoShift:
      launch_gemm<kNoShift>(bf16, x, w, out, g, s);
      break;
    case kOneTap:
      launch_gemm<kOneTap>(bf16, x, w, out, g, s);
      break;
    case kDot:
      launch_gemm<kDot>(bf16, x, w, out, g, s);
      break;
    case kShift:
      launch_gather<kShift>(bf16, x, out, g, s);
      break;
    case kCopy:
      launch_gather<kCopy>(bf16, x, out, g, s);
      break;
    case kSelect: {
      const long long vectors = g.cells * pc / (bf16 ? 8 : 4);
      if (bf16)
        lane_select_kernel<__nv_bfloat16><<<elementwise_blocks(vectors), 256, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), vectors);
      else
        lane_select_kernel<float><<<elementwise_blocks(vectors), 256, 0, s>>>(static_cast<const float*>(x),
                                                                             static_cast<float*>(out), vectors);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
