// Phase-structured packed 3-D k3 convolution for Hopper (sm_90a), and its probe variants,
// bound to PyTorch through ctypes: the C entry point cips_phase_conv and the kernels of every
// variant that has no Hopper design of its own.
//
// Replaces the Pallas TPU kernels
//   cips_tpu/ops/pallas/phase_conv.py:_kernel (launched by phase_conv_apply),
//   scripts/probe_pallas_dot.py:k_dot4d, k_dot2d, k_sel,
//   scripts/probe_pallas_bisect.py:_kernel (MODE nosel, sel, full),
//   scripts/debug_pallas_stages.py:_kernel (STAGE 1, 2, 3, >= 4).
// Which file holds each variant's kernel:
//   phase_conv.cu (here)  shift and select, both dtypes;
//   phase_conv_sm90.cu    bf16 full, noshift, one_tap and dot (TMA + wgmma); copy, both
//                         dtypes (1-D bulk copies through shared memory);
//   phase_conv_tf32.cu    fp32 full, noshift, one_tap and dot (one 3xTF32 kernel, TMA + wgmma,
//                         the variant a template parameter).
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
// and a read that falls outside the volume is zero. Variants:
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
// all pc x pc weights, as the kernels do, the work is 2*8*cells*pc^2 = 3.09e11 operations at
// pc = 128 (0.3127 ms): 2.37x the function's.
//
// Not tried in the bf16 full kernel: skipping the 37 of 64 (q, p) weight blocks that are zero
// in Wp (the 2.37x above), which needs N split by output phase group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Variant : int { kFull = 0, kNoShift = 1, kOneTap = 2, kDot = 3, kShift = 4, kCopy = 5, kSelect = 6 };

constexpr int kPhases = 8;

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

// Element offset, relative to cell m's own channel ci, of the value that `shift` reads for
// channel ci, x[cell - q] for its phase group q; false if it lies outside the volume.
__device__ __forceinline__ bool source(const Cell& cell, int ci, const Geometry& g, long long* delta) {
  const int q = ci / g.c;
  const int dz = -(q >> 2), dy = -((q >> 1) & 1), dx = -(q & 1);
  const bool inside = cell.valid && static_cast<unsigned>(cell.z + dz) < static_cast<unsigned>(g.z) &&
                      static_cast<unsigned>(cell.y + dy) < static_cast<unsigned>(g.y) &&
                      static_cast<unsigned>(cell.x + dx) < static_cast<unsigned>(g.x);
  *delta = ((static_cast<long long>(dz) * g.y + dy) * g.x + dx) * g.pc;
  return inside;
}

// ---- shift and select: one 16-byte vector a thread ------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) phase_gather_kernel(const T* __restrict__ x, T* __restrict__ out, Geometry g) {
  constexpr int kVec = 16 / sizeof(T);
  const long long vectors = g.cells * g.pc / kVec;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; v < vectors;
       v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = v * kVec;
    const long long m = e / g.pc;
    const int ci = static_cast<int>(e % g.pc);
    uint4 value = make_uint4(0u, 0u, 0u, 0u);
    long long delta;
    if (source(decode(m, g), ci, g, &delta)) value = *reinterpret_cast<const uint4*>(x + e + delta);
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

void launch_gather(bool bf16, const void* x, void* out, const Geometry& g, cudaStream_t s) {
  const int blocks = elementwise_blocks(g.cells * g.pc / (bf16 ? 8 : 4));
  if (bf16)
    phase_gather_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                              static_cast<__nv_bfloat16*>(out), g);
  else
    phase_gather_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), static_cast<float*>(out), g);
}

}  // namespace

// The bf16 dot, noshift, full and one_tap kernels and the copy kernel (phase_conv_sm90.cu); each
// returns a CUDA error code.
int phase_conv_dot_sm90(const void* x, const void* w, void* out, long long cells, int pc, cudaStream_t stream);
int phase_conv_full_sm90(const void* x, const void* wp, void* out, int b, int z, int y, int xdim, int pc,
                         cudaStream_t stream);
int phase_conv_noshift_sm90(const void* x, const void* wp, void* out, int b, int z, int y, int xdim, int pc,
                            cudaStream_t stream);
int phase_conv_one_tap_sm90(const void* x, const void* wp, void* out, int b, int z, int y, int xdim, int pc,
                            cudaStream_t stream);
int phase_conv_copy_sm90(const void* x, void* out, long long bytes, cudaStream_t stream);
// The fp32 full, noshift, one_tap and dot kernels (phase_conv_tf32.cu), by variant code.
int phase_conv_tf32(int variant, const void* x, const void* w, void* out, int b, int z, int y, int xdim, int pc,
                    cudaStream_t stream);

// x, out (b, z, y, xdim, pc) contiguous, 16-byte aligned; w (8, pc, pc) for the variants
// with products, unused otherwise. pc a multiple of 128; the bf16 dot and one_tap take pc 128
// or 256.
// Returns a CUDA error code.
extern "C" int cips_phase_conv(const void* x, const void* w, void* out, int variant, int is_bf16, int b, int z,
                               int y, int xdim, int pc, void* stream) {
  if (b <= 0 || z <= 0 || y <= 0 || xdim <= 0 || pc <= 0 || pc % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{static_cast<long long>(b) * z * y * xdim, z, y, xdim, pc, pc / kPhases};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0;
  switch (variant) {
    case kFull:
      return bf16 ? phase_conv_full_sm90(x, w, out, b, z, y, xdim, pc, s)
                  : phase_conv_tf32(variant, x, w, out, b, z, y, xdim, pc, s);
    case kNoShift:
      return bf16 ? phase_conv_noshift_sm90(x, w, out, b, z, y, xdim, pc, s)
                  : phase_conv_tf32(variant, x, w, out, b, z, y, xdim, pc, s);
    case kOneTap:
      return bf16 ? phase_conv_one_tap_sm90(x, w, out, b, z, y, xdim, pc, s)
                  : phase_conv_tf32(variant, x, w, out, b, z, y, xdim, pc, s);
    case kDot:
      return bf16 ? phase_conv_dot_sm90(x, w, out, g.cells, pc, s)
                  : phase_conv_tf32(variant, x, w, out, b, z, y, xdim, pc, s);
    case kShift:
      launch_gather(bf16, x, out, g, s);
      break;
    case kCopy:
      return phase_conv_copy_sm90(x, out, g.cells * pc * (bf16 ? 2 : 4), s);
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
