// The fp32 `full`, `noshift`, `one_tap` and `dot` variants of the phase conv for Hopper (sm_90a):
// one kernel template over the variant, 3xTF32 products on the tensor cores (wgmma with the A
// operand in registers), TMA halo boxes and TMA weight stages on mbarriers, persistent CTAs (one
// an SM) of a producer warpgroup and two consumer warpgroups. Launched by cips_phase_conv
// (phase_conv.cu) for fp32 x, with the variant codes kFull, kNoShift, kOneTap and kDot.
//
// Replaces the Pallas TPU kernels, in fp32:
//   cips_tpu/ops/pallas/phase_conv.py:_kernel          (full; also scripts/probe_pallas_bisect.py
//                                                       MODE full, scripts/debug_pallas_stages.py
//                                                       stage >= 4)
//   scripts/probe_pallas_bisect.py:_kernel, MODE nosel (noshift)
//   scripts/debug_pallas_stages.py:_kernel, STAGE 3    (one_tap)
//   scripts/probe_pallas_dot.py:k_dot4d, k_dot2d       (dot)
// and the FMA kernel that ran every fp32 variant before it (phase_conv_f32_kernel, 64 x 128
// tiles on plain FMAs).
//
// The function (phase_conv.cu's header): out[cell] = sum over the variant's taps k and input
// channels ci of x[cell + shift(k, q(ci)), ci] . W[k][ci][:], zero outside the volume, fp32.
//
// What bounds it on an H100 SXM. fp32-grade products on the tensor cores are 3xTF32: each
// product three times at the TF32 rate (989 / 2 TFLOP/s). At (8, 48, 64, 48, 128) the full
// function's 1.305e11 operations take 0.7915 ms so, its bytes (x read, out written once,
// 1.21e9) 0.3606 ms: bound by operations. Run densely over 8 taps x pc^2, as here (the kernel
// takes any Wp, so it cannot skip pack_conv_kernel_phase's 37 zero blocks of 64), 3.09e11
// operations take 1.876 ms. one_tap (one tap, 3.87e10 operations, 0.235 ms) and dot (summed
// weights, the same count) are bound by their bytes, 0.3607 ms.
//
// The design: an implicit GEMM, M = output cells, N = BN output channels, K = taps x pc input
// channels.
//   Tile: (8 x, 8 y, 2 z) cells by BN = 128 channels; consumer warpgroup w takes z plane w, one
//   m64 block. The output-channel blocks of one cell tile are adjacent in tile order, so the
//   second finds the halo boxes in L2. When the grid would leave SMs idle, BN halves, to 32 at
//   least: at (1, 8, 16, 8, 128) 8 tiles become 32.
//   A (x): for each 32-channel chunk, one TMA halo box of the tile's cells and every shift the
//   variant reads, 32 channels in 128-byte rows, 128-byte swizzled (full (10, 10, 4) cells,
//   noshift and one_tap (9, 9, 3), dot (8, 8, 2)), zeros outside the volume (negative
//   coordinates too), so x is never padded and a ragged Z, Y or X costs nothing. Each thread
//   reads its A fragment of a k-step (8 channels) from the box with plain shared-memory loads at
//   the row of its cell's shifted neighbour: a shift is a row offset, any row, no 8-row
//   alignment (a wgmma descriptor would need one). The 8 rows a warp's load reads are
//   consecutive, so the swizzle spreads them over all banks. The thread splits each value into
//   big and small tf32 parts in registers (tf32x3::split, integer rounding); the products take
//   them as wgmma's register A operand. The next stage's fragments load while this stage's
//   products run.
//   B (W): tf32 wgmma reads B from shared memory K-major only (no transpose bit), and W[k] lies
//   (ci, co), co contiguous. So a prep kernel, launched first on the same stream, writes a
//   K-major split copy, big and small parts of W[k] as (co, ci) (2 x taps x pc^2 floats, 1 MB at
//   pc 128, in stream-ordered memory: cudaMallocAsync before, cudaFreeAsync after, because the
//   entry point takes no scratch pointer). A B stage is one (tap, 32-channel chunk): its big and
//   small (BN, 32) tiles, 128-byte swizzled, by two TMA copies, through a ring of 96 KB.
//   Products: per stage, 4 k-steps x 3 wgmma m64nBNk8 (A_big B_small, A_small B_big, A_big
//   B_big: OpMultiplyAddFastF32's order) chained in the accumulator `part`; then the warpgroup
//   waits for them and adds `part` to the running sum `run` by fp32 adds. The tensor cores
//   truncate inside a chained sum, so no sum of more than one 32-channel chunk of one tap stays
//   in them (the fp32 flash kernels' lesson; the rounding model is
//   ops/phase_conv.py:phase_conv_tf32x3_reference). While one warpgroup waits and adds, the
//   other's products run.
//   Registers: at BN 128, `part`, `run` and two stages of A fragments take 192 a thread, more
//   than the 168 that ptxas gives a CTA of this size (it spilled). So the producer is a whole
//   warpgroup that hands its registers to the consumers (setmaxnreg: 40 and 232).
//   Loads: box outer, taps inner (the box of a chunk serves every tap); the producer thread
//   issues them in that order through a ring of 2 (full), 4 (noshift, one_tap) or 8 (dot) boxes.
//   Output: each thread stores its accumulator pairs straight from registers, 8 bytes a store
//   (each warp store writes whole 32-byte sectors), masked past the volume.
//   L2 reads per tile at pc 128, full: 4 boxes of 51,200 bytes and the split column slab
//   (8 taps x 128 x 128 channels x 8 bytes, 1 MB): 9.7 GB of B and 1.9 GB of A a call at
//   (8, 48, 64, 48, 128).
// Timing copies (cips_tpu_torch/scripts/time_phase_f32.py; NVIDIA H100 80GB HBM3 at 700.00 W,
// full at (8, 48, 64, 48, 128), device time): this kernel 2.43 ms; without products 0.94, so the
// products and their waits hold it, not the loads (without halo loads 2.34, without weight loads
// 2.42, without stores 2.34); mma.sync m16n8k8 for wgmma 4.63; N tiles of 64 (no setmaxnreg
// needed) 3.59; A loaded after the products 2.53; 8 stages chained in the tensor cores 2.36
// (1.2e-6 of max|out| against 4.5e-7).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace sm90;

enum Variant : int { kFull = 0, kNoShift = 1, kOneTap = 2, kDot = 3 };

constexpr int kConsumers = 2;                    // consumer warpgroups a CTA
constexpr int kThreads = (kConsumers + 1) * 128;  // and one producer warpgroup
// Registers a thread after setmaxnreg: the producer's hand theirs to the consumers (40 x 128 +
// 232 x 256 = 168 x 384, the most ptxas gives a 384-thread CTA at launch).
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kReleases = kConsumers * 4;        // arrivals that hand a stage back: one a warp
constexpr int kChunk = 32;                       // input channels a box row and a B stage: 128 bytes
constexpr int kSteps = kChunk / 8;               // wgmma k-steps a B stage
constexpr int kTX = 8, kTY = 8, kTZ = 2;         // output cells a tile along x, y, z
constexpr int kSmemBudget = 232448 - 1024;       // a block's shared memory, less align_1024's slack
constexpr int kBRing = 98304;                    // bytes of B stages
constexpr int kChainStages = 1;                  // B stages chained in the tensor cores before an fp32 add
constexpr int kMaxN = 128;                       // output channels a tile

__host__ __device__ constexpr int taps_of(int v) { return v == kOneTap ? 1 : 8; }
// How far the cells a variant reads reach past the tile along each axis, and where its box starts.
__host__ __device__ constexpr int span_of(int v) { return v == kFull ? 2 : v == kDot ? 0 : 1; }
__host__ __device__ constexpr int origin_of(int v) { return v == kDot ? 0 : -1; }

// The offset along one axis of the cell that tap k reads for input phase bit q.
template <int V>
__device__ __forceinline__ int axis_shift(int k, int q) {
  if (V == kFull) return k - q;
  if (V == kNoShift) return k - 1;
  if (V == kOneTap) return -q;
  return 0;  // kDot
}

template <int V, int BN>
struct Layout {
  static constexpr int kBX = kTX + span_of(V), kBY = kTY + span_of(V), kBZ = kTZ + span_of(V);
  static constexpr int kBoxBytes = kBX * kBY * kBZ * 128;        // one halo box: 128 bytes a cell
  static constexpr int kABox = (kBoxBytes + 1023) / 1024 * 1024;  // its stage, 1024-byte aligned
  static constexpr int kBHalf = BN * 128;                          // one split part of a B stage
  static constexpr int kBStage = 2 * kBHalf;
  static constexpr int kBStages = kBRing / kBStage < 8 ? kBRing / kBStage : 8;
  static constexpr int kAStages = (kSmemBudget - 256 - kBStages * kBStage) / kABox;
  static constexpr int kB = kAStages * kABox;  // the B ring, after the A ring
  static constexpr int kBars = kB + kBStages * kBStage;
  static constexpr int kBytes = kBars + 2 * (kAStages + kBStages) * 8;
  static_assert(kAStages >= 2 && kBytes <= kSmemBudget, "the rings do not fit in shared memory");
};

int sm_count() {
  int device = 0, count = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 132;
  return count;
}

struct Volume {
  int pc, z, y, x;
  int tiles_x, tiles_y, tiles_z, n_blocks;  // n_blocks = pc / BN output-channel blocks
};

struct Tile {
  int b, z0, y0, x0, n0;
};

// Tile t: output-channel block t % n_blocks of cell tile t / n_blocks.
template <int BN>
__device__ __forceinline__ Tile tile_of(int t, const Volume& v) {
  Tile tile;
  tile.n0 = (t % v.n_blocks) * BN;
  int c = t / v.n_blocks;
  tile.x0 = (c % v.tiles_x) * kTX;
  c /= v.tiles_x;
  tile.y0 = (c % v.tiles_y) * kTY;
  c /= v.tiles_y;
  tile.z0 = (c % v.tiles_z) * kTZ;
  tile.b = c / v.tiles_z;
  return tile;
}

// Float offset of channel 4 u + t of row r in a tile of 128-byte rows with TMA's 128-byte
// swizzle (16-byte unit u of row r lies at unit u ^ (r % 8)).
__device__ __forceinline__ int swizzled(int r, int u, int t) { return r * 32 + ((u ^ (r & 7)) << 2) + t; }

// K-major descriptor of k-step s (8 tf32 channels, 32 bytes) of a (rows, 32) fp32 tile of
// 128-byte swizzled rows.
__device__ __forceinline__ uint64_t desc_b(const uint8_t* tile, int s) {
  return make_desc(smem_u32(tile) + s * 32, 16, 1024, 128);
}

// d (+)= A B for an m64nNk8 tf32 step: A from registers (mma.sync's m16n8k8 A layout, warp w
// rows 16 w .. 16 w + 15), B from shared memory read K-major. scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t desc_b,
                                           int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_tf32: N is 32, 64 or 128");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
          "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
          "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
          "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
          "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
          "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
          "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
          "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]),
          "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]),
          "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

// The split copy of the weights: ws[part][tap][co][ci] = part (0 big, 1 small) of
// tf32x3::split(w[tap][ci][co]), K-major for the B operand. One 32 x 32 block a CTA, transposed
// through shared memory.
__global__ void __launch_bounds__(256) split_weights_kernel(const float* __restrict__ w, float* __restrict__ ws,
                                                            int pc, int taps) {
  __shared__ float block[32][33];
  const int co0 = blockIdx.x * 32, ci0 = blockIdx.y * 32, tap = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) block[i][tx] = w[(static_cast<size_t>(tap) * pc + ci0 + i) * pc + co0 + tx];
  __syncthreads();
  const size_t part = static_cast<size_t>(taps) * pc * pc;
  for (int i = ty; i < 32; i += 8) {
    uint32_t big, small;
    tf32x3::split(block[tx][i], big, small);
    const size_t o = (static_cast<size_t>(tap) * pc + co0 + i) * pc + ci0 + tx;
    ws[o] = __uint_as_float(big);
    ws[part + o] = __uint_as_float(small);
  }
}

template <int V, int BN>
__global__ void __launch_bounds__(kThreads, 1) tf32x3_kernel(const __grid_constant__ CUtensorMap x_map,
                                                             const __grid_constant__ CUtensorMap w_map,
                                                             float* __restrict__ out, Volume v, int n_tiles) {
  using L = Layout<V, BN>;
  constexpr int kTaps = taps_of(V);
  constexpr int kO = origin_of(V);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty_a = full_a + L::kAStages;
  uint64_t* full_b = empty_a + L::kAStages;
  uint64_t* empty_b = full_b + L::kBStages;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int chunks = v.pc / kChunk;
  const int block = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kAStages; ++i) {
      mbar_init(&full_a[i], 1);
      mbar_init(&empty_a[i], kReleases);
    }
    for (int i = 0; i < L::kBStages; ++i) {
      mbar_init(&full_b[i], 1);
      mbar_init(&empty_b[i], kReleases);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {  // the producer: one thread issues every load, in consumption order
      int ja = 0, jb = 0;  // halo boxes and B stages issued so far
      for (int t = block; t < n_tiles; t += grid) {
        const Tile tile = tile_of<BN>(t, v);
        for (int cb = 0; cb < chunks; ++cb, ++ja) {
          const int sa = ja % L::kAStages;
          if (ja >= L::kAStages) mbar_wait(&empty_a[sa], (ja / L::kAStages - 1) & 1);
          mbar_expect_tx(&full_a[sa], L::kBoxBytes);
          tma_load_5d(smem + sa * L::kABox, &x_map, &full_a[sa], cb * kChunk, tile.x0 + kO, tile.y0 + kO,
                      tile.z0 + kO, tile.b);
          for (int tap = 0; tap < kTaps; ++tap, ++jb) {
            const int sb = jb % L::kBStages;
            if (jb >= L::kBStages) mbar_wait(&empty_b[sb], (jb / L::kBStages - 1) & 1);
            mbar_expect_tx(&full_b[sb], L::kBStage);
            uint8_t* dst = smem + L::kB + sb * L::kBStage;
            tma_load_3d(dst, &w_map, &full_b[sb], cb * kChunk, tile.n0, tap);                   // big
            tma_load_3d(dst + L::kBHalf, &w_map, &full_b[sb], cb * kChunk, tile.n0, kTaps + tap);  // small
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const float groups_per_step = 64.f / v.pc;  // k-step k (8 channels) lies in phase group k / (pc / 64)
  // This thread's A fragments of stage (cb, tap) from the box of chunk cb: rows g and g + 8 of
  // warp `warp` of the m64 block are cells (g, 2 warp) and (g, 2 warp + 1) of z plane wg, read
  // at their neighbour for each k-step's phase group, one box row further along y for the second.
  auto load_a = [&](tf32x3::A(&a)[kSteps], const float* box, int cb, int tap) {
    const int kz = tap >> 2, ky = (tap >> 1) & 1, kx = tap & 1;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int q = static_cast<int>((4 * cb + s + 0.5f) * groups_per_step);
      const int dz = axis_shift<V>(kz, q >> 2), dy = axis_shift<V>(ky, (q >> 1) & 1), dx = axis_shift<V>(kx, q & 1);
      const int r0 = (g + dx - kO) + L::kBX * ((2 * warp + dy - kO) + L::kBY * (wg + dz - kO));
      const int r1 = r0 + L::kBX;
      a[s] = tf32x3::split_a(box[swizzled(r0, 2 * s, t4)], box[swizzled(r1, 2 * s, t4)],
                             box[swizzled(r0, 2 * s + 1, t4)], box[swizzled(r1, 2 * s + 1, t4)]);
    }
  };
  auto wait_box = [&](int j) {  // the CTA's j-th halo box, once it has landed
    mbar_wait(&full_a[j % L::kAStages], (j / L::kAStages) & 1);
    return reinterpret_cast<const float*>(smem + (j % L::kAStages) * L::kABox);
  };

  float run[BN / 8][4], part[BN / 8][4];
  int ja = 0, jb = 0;  // halo boxes and B stages consumed so far
  for (int t = block; t < n_tiles; t += grid) {
    const Tile tile = tile_of<BN>(t, v);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) run[n][0] = run[n][1] = run[n][2] = run[n][3] = 0.f;
    const int stages = chunks * kTaps;  // (chunk, tap), box outer: the box of a chunk serves every tap
    int chain = 0;                      // B stages summed in `part` so far
    const float* box = wait_box(ja);
    tf32x3::A a[kSteps], next[kSteps];
    load_a(a, box, 0, 0);
#pragma unroll 1
    for (int st = 0; st < stages; ++st, ++jb) {
      const int cb = st / kTaps, tap = st % kTaps;
      const int sb = jb % L::kBStages;
      mbar_wait(&full_b[sb], (jb / L::kBStages) & 1);
      const uint8_t* big = smem + L::kB + sb * L::kBStage;
      const uint8_t* small = big + L::kBHalf;
      fence_operand(part);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        wgmma_tf32<BN>(part, a[s].big, desc_b(small, s), chain == 0 && s == 0 ? 0 : 1);
        wgmma_tf32<BN>(part, a[s].small, desc_b(big, s), 1);
        wgmma_tf32<BN>(part, a[s].big, desc_b(big, s), 1);
      }
      wgmma_commit();
      const bool more = st + 1 < stages;
      if (more && tap == kTaps - 1) box = wait_box(ja + cb + 1);
      if (more) load_a(next, box, (st + 1) / kTaps, (st + 1) % kTaps);  // under the products
      wgmma_wait_all();
      fence_operand(part);
      if (lane == 0) {
        mbar_arrive(&empty_b[sb]);
        if (tap == kTaps - 1) mbar_arrive(&empty_a[(ja + cb) % L::kAStages]);  // the chunk's last stage
      }
      if (++chain == kChainStages || !more) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) run[n][e] += part[n][e];
        }
        chain = 0;
      }
      if (more) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s) a[s] = next[s];
      }
    }
    ja += chunks;

    // Epilogue: rows g and g + 8 of the warp (cells (g, 2 warp + h) of z plane wg), columns
    // 8 n + 2 t4 and the next, straight from the accumulators; cells past the volume are skipped.
    const int x = tile.x0 + g, z = tile.z0 + wg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = tile.y0 + 2 * warp + h;
      if (x < v.x && y < v.y && z < v.z) {
        float* o = out + (((static_cast<long long>(tile.b) * v.z + z) * v.y + y) * v.x + x) * v.pc + tile.n0 + 2 * t4;
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
          *reinterpret_cast<float2*>(o + 8 * n) = make_float2(run[n][2 * h], run[n][2 * h + 1]);
      }
    }
  }
}

// Map of a contiguous channels-last fp32 volume (b, z, y, x, c) whose boxes are (32 channels,
// bx, by, bz, 1): one 128-byte row a cell, x fastest, 128-byte swizzled. Cells outside the
// volume, at negative coordinates too, read as zeros. False on failure.
bool volume_map(CUtensorMap* map, const void* base, int b, int z, int y, int x, int c, int bx, int by, int bz) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(x), static_cast<cuuint64_t>(y),
                              static_cast<cuuint64_t>(z), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 4;
  const cuuint64_t strides[4] = {row, row * x, row * x * y, row * x * y * z};
  const cuuint32_t box[5] = {32, static_cast<cuuint32_t>(bx), static_cast<cuuint32_t>(by),
                             static_cast<cuuint32_t>(bz), 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of the split weights (slabs = 2 x taps, pc output, pc input channels) whose boxes are
// (32 input, bn output channels) of one slab, 128-byte swizzled: a K-major B tile.
bool weight_map(CUtensorMap* map, const void* ws, int slabs, int pc, int bn) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(pc), static_cast<cuuint64_t>(pc),
                              static_cast<cuuint64_t>(slabs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pc) * 4, static_cast<cuuint64_t>(pc) * pc * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(bn), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ws), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long cell_tiles(int b, int z, int y, int xdim) {
  return static_cast<long long>(b) * ((z + kTZ - 1) / kTZ) * ((y + kTY - 1) / kTY) * ((xdim + kTX - 1) / kTX);
}

// BN: kMaxN, halved (to 32 at least) while the grid would leave SMs idle.
int n_tile(int b, int z, int y, int xdim, int pc) {
  int bn = kMaxN;
  while (bn > 32 && cell_tiles(b, z, y, xdim) * (pc / bn) < sm_count()) bn /= 2;
  return bn;
}

// The dynamic shared memory the kernel of variant V launches with at N tiles of bn channels
// (+ the slack align_1024 takes).
template <int V>
int smem_bytes(int bn) {
  return (bn == 128 ? Layout<V, 128>::kBytes : bn == 64 ? Layout<V, 64>::kBytes : Layout<V, 32>::kBytes) + 1024;
}

template <int V, int BN>
int launch(const void* x, const float* ws, void* out, int b, int z, int y, int xdim, int pc, cudaStream_t stream) {
  using L = Layout<V, BN>;
  const Volume v{pc, z, y, xdim, (xdim + kTX - 1) / kTX, (y + kTY - 1) / kTY, (z + kTZ - 1) / kTZ, pc / BN};
  const long long n_tiles = cell_tiles(b, z, y, xdim) * v.n_blocks;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  if (!volume_map(&x_map, x, b, z, y, xdim, pc, L::kBX, L::kBY, L::kBZ) ||
      !weight_map(&w_map, ws, 2 * taps_of(V), pc, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes<V>(BN);
  const cudaError_t err = cudaFuncSetAttribute(tf32x3_kernel<V, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_tiles < sm_count() ? static_cast<int>(n_tiles) : sm_count();
  tf32x3_kernel<V, BN><<<grid, kThreads, smem, stream>>>(x_map, w_map, static_cast<float*>(out), v,
                                                          static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The split weights in stream-ordered memory, then the conv, then the memory handed back.
template <int V>
int launch_variant(const void* x, const void* w, void* out, int b, int z, int y, int xdim, int pc,
                   cudaStream_t stream) {
  constexpr int kTaps = taps_of(V);
  float* ws = nullptr;
  cudaError_t err = cudaMallocAsync(reinterpret_cast<void**>(&ws),
                                    2 * static_cast<size_t>(kTaps) * pc * pc * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_weights_kernel<<<dim3(pc / 32, pc / 32, kTaps), 256, 0, stream>>>(static_cast<const float*>(w), ws, pc,
                                                                          kTaps);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc == 0) {
    const int bn = n_tile(b, z, y, xdim, pc);
    if (bn == 128) rc = launch<V, 128>(x, ws, out, b, z, y, xdim, pc, stream);
    if (bn == 64) rc = launch<V, 64>(x, ws, out, b, z, y, xdim, pc, stream);
    if (bn == 32) rc = launch<V, 32>(x, ws, out, b, z, y, xdim, pc, stream);
  }
  err = cudaFreeAsync(ws, stream);
  return rc != 0 ? rc : static_cast<int>(err);
}

}  // namespace

// The fp32 product variants (see the header): variant is cips_phase_conv's code (0 full,
// 1 noshift, 2 one_tap, 3 dot); x, out (b, z, y, xdim, pc) fp32, contiguous, 16-byte aligned;
// w (8, pc, pc) fp32; pc a multiple of 128. Returns a CUDA error code.
int phase_conv_tf32(int variant, const void* x, const void* w, void* out, int b, int z, int y, int xdim, int pc,
                    cudaStream_t stream) {
  if (b <= 0 || z <= 0 || y <= 0 || xdim <= 0 || pc <= 0 || pc % 128 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case kFull:
      return launch_variant<kFull>(x, w, out, b, z, y, xdim, pc, stream);
    case kNoShift:
      return launch_variant<kNoShift>(x, w, out, b, z, y, xdim, pc, stream);
    case kOneTap:
      return launch_variant<kOneTap>(x, w, out, b, z, y, xdim, pc, stream);
    case kDot:
      return launch_variant<kDot>(x, w, out, b, z, y, xdim, pc, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Writes to *bytes the dynamic shared memory that the fp32 kernel of `variant` (0 full,
// 1 noshift, 2 one_tap, 3 dot) launches with at N tiles of `bn` output channels (128, 64 or
// 32). Returns a CUDA error code.
extern "C" int cips_phase_conv_tf32_smem(int variant, int bn, void* bytes) {
  if (variant < kFull || variant > kDot || (bn != 128 && bn != 64 && bn != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<int*>(bytes) = variant == kFull    ? smem_bytes<kFull>(bn)
                              : variant == kNoShift ? smem_bytes<kNoShift>(bn)
                              : variant == kOneTap  ? smem_bytes<kOneTap>(bn)
                                                    : smem_bytes<kDot>(bn);
  return 0;
}
