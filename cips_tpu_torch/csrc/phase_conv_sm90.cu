// The bf16 `dot` and `noshift` variants of the phase conv for Hopper (sm_90a): TMA tile loads
// that complete on mbarriers, wgmma on 128-byte-swizzled shared-memory tiles, persistent CTAs
// (one an SM) of one producer warp and two consumer warpgroups. Launched by cips_phase_conv
// (phase_conv.cu, variant codes kDot and kNoShift) for bf16; fp32 and the other variants stay
// in phase_conv.cu.
//
// Replaces the Pallas TPU kernels
//   scripts/probe_pallas_dot.py:k_dot4d, k_dot2d       (dot)
//   scripts/probe_pallas_bisect.py:_kernel, MODE nosel (noshift)
//
// dot: out = sum_{k<8} x . W[k]; x (cells, pc) channels last, W (8, pc, pc), out bf16.
//   What bounds it on an H100 SXM. The function is x . S with S = sum_k W[k]: 2 cells pc^2
//   operations, 3.87e10 at (8, 48, 64, 48, 128), 0.039 ms at 989 TFLOP/s, while reading x and
//   W and writing out once is 6.04e8 bytes, 0.180 ms at 3.35 TB/s. So it is bound by memory:
//   one streaming GEMM, K = N = pc, and not the 8 dense taps the mma.sync kernel ran.
//   The design. One launch. Each CTA sums S in fp32 from W (which stays in L2) in its
//   prologue, while the producer's first x tiles already load, rounds S once to bf16 and
//   keeps it in shared memory as the MN-major wgmma B operand (the transpose bit): 32 KB at
//   pc 128, 128 KB at pc 256. Tiles of 32 KB of x (128 cells at pc 128, 64 at pc 256) stream
//   through a TMA ring of 6 stages at pc 128, 3 at pc 256; wgmma m64n128k16 from shared
//   memory, the two consumer warpgroups on the two 64-cell halves (pc 128) or the two
//   128-channel halves (pc 256) of a tile. Once both have read a stage it holds their output:
//   each rounds its accumulators to bf16 into two swizzled (64, 64) boxes there and one
//   thread TMA-stores them (rows past the last cell are clipped); the stage goes back to the
//   producer when the store has read it, one tile later. pc 128 or 256: S must fit in shared
//   memory beside the ring. Tried and not kept: two accumulator sets, so that a tile's
//   epilogue runs under the next tile's products; slower, clearly at pc 256, in one call.
//   Rounding: x . bf16(S) with fp32 accumulation, out rounded to bf16. S is rounded once where
//   the probe rounds nothing but its inputs; the plain model of this
//   (ops/phase_conv.py:dot_rounded_reference) is 3.2e-3 of max|out| from the fp32 sum over
//   the 8 products at (1, 4, 4, 8, 128) and 3.3e-3 at pc 256, inside half of the 1e-2 limit,
//   so S is not carried as a (hi, lo) pair (K = 2 pc, twice the products).
//
// noshift: out[c] = sum_{k in {0,1}^3} x[c + k - 1] . Wp[k], zero outside the volume,
//   Wp (2, 2, 2, pc, pc).
//   What bounds it. 2 * 8 cells pc^2 operations: 3.09e11 at (8, 48, 64, 48, 128), 0.313 ms at
//   989 TFLOP/s, against 0.180 ms of bytes: bound by the products.
//   The design: an implicit GEMM whose shift is a TMA coordinate. A CTA tile is 256 output
//   cells, an (8 x, 8 y, 4 z) box of one batch, by 128 output channels; consumer warpgroup w
//   takes z planes 2 w and 2 w + 1, one m64 block each. x is a rank-5 tensor map
//   (pc, X, Y, Z, B). For each x tap kx and 64-channel block the producer loads one halo box
//   (64, 8, 9, 5) at (c0, x0 + kx - 1, y0 - 1, z0 - 1, b): 360 rows of 128 bytes, zeros where
//   it leaves the volume, at negative coordinates too, so neither the -1 shift nor a ragged
//   Z, Y or X costs anything and x is never padded. The four (kz, ky) taps all read that box:
//   for the block of plane p, tap (kz, ky) starts at row 8 ky + 72 (p + kz), a multiple of 8
//   rows and so a valid descriptor start in the 128-byte swizzle. The x shift is the second
//   box (a one-row shift would break the swizzle's phase). Wp[k] streams as (64 input x 128
//   output channels) MN-major B tiles through a second TMA ring of 6. One commit group a tap;
//   the tap before goes back to the producer as soon as wgmma_wait<1> says it was read.
//   L2 reads per tile: 2 (pc / 64) halo boxes of 46,080 bytes and Wp's (pc, 128) column slab
//   for the 8 taps (8 x 256 pc bytes): 446,464 bytes, 1,744 a cell, at pc 128; 2.06 GB a call
//   at (8, 48, 64, 48, 128), where the mma.sync kernel read 4.83 GB (each 128 cells read its
//   A rows 8 times and all 256 KB of Wp). At pc 256, 8.23 GB against 19.3 GB: each tile is
//   one of two 128-channel output blocks, adjacent in tile order so that the second finds its
//   halo boxes in L2. Any pc that is a multiple of 128.
//   Output: each warpgroup rounds one m64 block (a z plane of 8 x 8 cells) at a time into a
//   16 KB swizzled staging tile that one thread TMA-stores as a (64, 8, 8, 1, 1) box of a
//   rank-5 map over out, clipped past the volume. The first version stored straight from the
//   accumulators, 4 bytes a store; a timing-only copy without any stores showed that those
//   stores held the kernel back, and staging them made it faster than the k2 cuDNN conv
//   (PERF.md §6). The staging tiles cost the Wp ring two of its 8 stages.
//   Tried in bring-up and not kept, each timed beside the design of its day in one call: Wp
//   multicast to a 2-CTA cluster (half the Wp reads, but twice as slow as built, for reasons
//   not found), and warpgroup 1 started two taps after warpgroup 0 so that the epilogues
//   interleave (no gain). A first (16, 8, 2) tile reads a halo of 432 rows for 256 cells
//   against 360 for this one.
//   Left for `full`, which still runs the mma.sync kernel: with a 32-byte box per phase group
//   (16 channels) each wgmma k-step can carry its own shift.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kConsumers = 2;                        // consumer warpgroups a CTA
constexpr int kThreads = kConsumers * 128 + 32;      // and one producer warp
constexpr int kReleases = kConsumers * 4;            // arrivals that hand a stage back: one a warp

int sm_count() {
  int device = 0, count = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 132;
  return count;
}

// ---- dot ------------------------------------------------------------------------------------

template <int PC>
struct DotLayout {
  static constexpr int kRows = 16384 / PC;      // cells a tile: 128 at pc 128, 64 at pc 256
  static constexpr int kTile = kRows * PC * 2;  // one x tile, 32 KB; after its products, the output tile
  static constexpr int kRing = PC * PC * 2;     // after S
  static constexpr int kStages = (232448 - 1024 - 64 - kRing) / kTile;  // 6 at pc 128, 3 at pc 256
  static constexpr int kBars = kRing + kStages * kTile;
  static constexpr int kBytes = kBars + 2 * kStages * 8;
};

template <int PC>
__global__ void __launch_bounds__(kThreads, 1) dot_kernel(const __grid_constant__ CUtensorMap x_map,
                                                          const __grid_constant__ CUtensorMap out_map,
                                                          const bf16* __restrict__ w, int n_tiles) {
  using L = DotLayout<PC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + L::kStages;
  const int wg = threadIdx.x / 128;  // 0, 1: consumers; kConsumers: the producer warp
  const int tid = threadIdx.x % 128;
  const int block = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);
  const int mine = block < n_tiles ? (n_tiles - 1 - block) / grid + 1 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);  // each warpgroup's storing thread, once its store has read it
    }
    fence_barrier_init();
  }
  __syncthreads();

  const bool producer = wg == kConsumers && tid == 0;
  auto issue = [&](int i) {  // this CTA's tile i into stage i % kStages
    const int st = i % L::kStages;
    bf16* dst = reinterpret_cast<bf16*>(smem + L::kRing + st * L::kTile);
    mbar_expect_tx(&full[st], L::kTile);
#pragma unroll
    for (int cb = 0; cb < PC / 64; ++cb) {
      tma_load_3d(dst + cb * L::kRows * 64, &x_map, &full[st], cb * 64, (block + i * grid) * L::kRows, 0);
    }
  };
  if (producer) {
    for (int i = 0; i < L::kStages && i < mine; ++i) issue(i);
  }

  // S = sum_k W[k] in fp32, rounded to bf16, as the MN-major B tile: column block n / 64 of
  // (PC rows, 64 columns), row k, 16-byte chunk (n % 64) / 8 swizzled with k % 8.
  for (int v = threadIdx.x; v < PC * PC / 8; v += kThreads) {
    const int k = v / (PC / 8), n = (v % (PC / 8)) * 8;
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const uint4 raw = *reinterpret_cast<const uint4*>(w + (static_cast<size_t>(t) * PC + k) * PC + n);
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum[j] += __bfloat162float(e[j]);
    }
    const uint4 packed = make_uint4(pack_bf16x2(sum[0], sum[1]), pack_bf16x2(sum[2], sum[3]),
                                    pack_bf16x2(sum[4], sum[5]), pack_bf16x2(sum[6], sum[7]));
    *reinterpret_cast<uint4*>(smem + (n / 64) * PC * 128 + k * 128 + ((((n % 64) / 8) ^ (k % 8)) * 16)) = packed;
  }
  fence_proxy_async();  // S is read by wgmma, through the async proxy
  __syncthreads();

  if (wg == kConsumers) {
    if (producer) {
      for (int i = L::kStages; i < mine; ++i) {
        mbar_wait(&empty[i % L::kStages], (i / L::kStages - 1) & 1);
        issue(i);
      }
    }
    return;
  }

  // pc 128: this warpgroup takes rows 64 wg .. 64 wg + 63 of a tile, every column;
  // pc 256: every row of a tile, columns 128 wg .. 128 wg + 127.
  const int row0 = PC == 128 ? 64 * wg : 0;
  const int col0 = PC == 128 ? 0 : 128 * wg;
  const bf16* s_tile = reinterpret_cast<const bf16*>(smem) + col0 * PC;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;

  float acc[16][4];

  for (int i = 0; i < mine; ++i) {
    const int st = i % L::kStages;
    uint8_t* stage = smem + L::kRing + st * L::kTile;
    mbar_wait(&full[st], (i / L::kStages) & 1);
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < PC / 16; ++c) {
      wgmma_ss<128, 1>(acc, desc_k_major<L::kRows, PC>(reinterpret_cast<const bf16*>(stage) + row0 * 64, c),
                       desc_mn_major<PC, 128>(s_tile, c), c > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operand(acc);

    // Epilogue. Once both warpgroups have read the stage it holds their output: this
    // warpgroup's (64, 128) tile at 16 KB x wg, two swizzled (64 rows, 64 columns) boxes.
    named_barrier_sync(1, kConsumers * 128);
    uint8_t* out_tile = stage + wg * 16384;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        *reinterpret_cast<uint32_t*>(out_tile + (n / 8) * 8192 + r * 128 + (((n % 8) ^ (r % 8)) * 16) + q * 4) =
            pack_bf16x2(acc[n][2 * h], acc[n][2 * h + 1]);
      }
    }
    fence_proxy_async();
    named_barrier_sync(2 + wg, 128);
    if (tid == 0) {
      const int m0 = (block + i * grid) * L::kRows + row0;
      tma_store_3d(&out_map, out_tile, col0, m0, 0);
      tma_store_3d(&out_map, out_tile + 8192, col0 + 64, m0, 0);
      bulk_commit();
      if (i > 0) {  // the tile before's store has read its stage: hand it back
        bulk_wait_read<1>();
        mbar_arrive(&empty[(i - 1) % L::kStages]);
      }
    }
  }
  if (tid == 0) bulk_wait_all();
}

template <int PC>
int launch_dot(const void* x, const void* w, void* out, long long cells, cudaStream_t stream) {
  using L = DotLayout<PC>;
  CUtensorMap x_map, out_map;
  const int rows = static_cast<int>(cells);
  if (!tile_map(&x_map, x, 1, rows, PC, L::kRows) || !tile_map(&out_map, out, 1, rows, PC, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = L::kBytes + 1024;  // + the slack align_1024 takes
  const cudaError_t err =
      cudaFuncSetAttribute(dot_kernel<PC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = static_cast<int>((cells + L::kRows - 1) / L::kRows);
  const int grid = n_tiles < sm_count() ? n_tiles : sm_count();
  dot_kernel<PC><<<grid, kThreads, kSmem, stream>>>(x_map, out_map, static_cast<const bf16*>(w), n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---- noshift --------------------------------------------------------------------------------

constexpr int kTX = 8, kTY = 8, kTZ = 4;               // output cells a tile along x, y, z
constexpr int kPlaneRows = kTX * (kTY + 1);            // rows of one z plane of a halo box
constexpr int kHaloRows = kPlaneRows * (kTZ + 1);      // 360 cells of one halo box
constexpr int kABox = kHaloRows * 128;                 // 46,080 bytes: 64 channels of it
constexpr int kBTile = 64 * 128 * 2;                   // Wp[k][64 input][128 output channels]
constexpr int kOutBlock = 64 * 128 * 2;               // one m64 block's output, two (64, 64) boxes
constexpr int kAStages = 2, kBStages = 6;
constexpr int kNsB = kAStages * kABox;                 // the B ring, after the A ring
constexpr int kNsOut = kNsB + kBStages * kBTile;       // each warpgroup's output staging tile
constexpr int kNsBars = kNsOut + kConsumers * kOutBlock;
constexpr int kNsBytes = kNsBars + 2 * (kAStages + kBStages) * 8;

struct Tile {
  int b, z0, y0, x0, n0;
};

struct Volume {
  int pc;
  int tiles_x, tiles_y, tiles_z, n_blocks;  // n_blocks = pc / 128 output-channel blocks
};

// Tile t: output-channel block t % n_blocks of cell tile t / n_blocks, so the blocks of one
// cell tile run side by side and the second finds the halo boxes in L2.
__device__ __forceinline__ Tile tile_of(int t, const Volume& v) {
  Tile tile;
  tile.n0 = (t % v.n_blocks) * 128;
  int c = t / v.n_blocks;
  tile.x0 = (c % v.tiles_x) * kTX;
  c /= v.tiles_x;
  tile.y0 = (c % v.tiles_y) * kTY;
  c /= v.tiles_y;
  tile.z0 = (c % v.tiles_z) * kTZ;
  tile.b = c / v.tiles_z;
  return tile;
}

__global__ void __launch_bounds__(kThreads, 1) noshift_kernel(const __grid_constant__ CUtensorMap x_map,
                                                              const __grid_constant__ CUtensorMap w_map,
                                                              const __grid_constant__ CUtensorMap out_map, Volume v,
                                                              int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + kNsBars);
  uint64_t* empty_a = full_a + kAStages;
  uint64_t* full_b = empty_a + kAStages;
  uint64_t* empty_b = full_b + kBStages;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int blocks = v.pc / 64;  // 64-channel blocks of the reduction
  const int block = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kAStages; ++i) {
      mbar_init(&full_a[i], 1);
      mbar_init(&empty_a[i], kReleases);
    }
    for (int i = 0; i < kBStages; ++i) {
      mbar_init(&full_b[i], 1);
      mbar_init(&empty_b[i], kReleases);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    if (tid == 0) {  // the producer: one thread issues every load, in consumption order
      int ja = 0, jb = 0;  // halo boxes and Wp tiles issued so far
      for (int t = block; t < n_tiles; t += grid) {
        const Tile tile = tile_of(t, v);
        for (int kx = 0; kx < 2; ++kx) {
          for (int cb = 0; cb < blocks; ++cb, ++ja) {
            const int sa = ja % kAStages;
            if (ja >= kAStages) mbar_wait(&empty_a[sa], (ja / kAStages - 1) & 1);
            mbar_expect_tx(&full_a[sa], kABox);
            tma_load_5d(smem + sa * kABox, &x_map, &full_a[sa], cb * 64, tile.x0 + kx - 1, tile.y0 - 1,
                        tile.z0 - 1, tile.b);
            for (int kzy = 0; kzy < 4; ++kzy, ++jb) {
              const int sb = jb % kBStages;
              if (jb >= kBStages) mbar_wait(&empty_b[sb], (jb / kBStages - 1) & 1);
              mbar_expect_tx(&full_b[sb], kBTile);
              const int tap = (kzy >> 1) * 4 + (kzy & 1) * 2 + kx;  // Wp[kz][ky][kx]
              bf16* dst = reinterpret_cast<bf16*>(smem + kNsB + sb * kBTile);
              tma_load_3d(dst, &w_map, &full_b[sb], tile.n0, cb * 64, tap);
              tma_load_3d(dst + 64 * 64, &w_map, &full_b[sb], tile.n0 + 64, cb * 64, tap);
            }
          }
        }
      }
    }
  } else {
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
    uint8_t* staging = smem + kNsOut + wg * kOutBlock;
    float acc[2][16][4];  // the two z planes 2 wg and 2 wg + 1 of the tile, 64 cells each
    int ja = 0, jb = 0;   // halo boxes and Wp tiles consumed so far
    for (int t = block; t < n_tiles; t += grid) {
      const Tile tile = tile_of(t, v);
      for (int kx = 0; kx < 2; ++kx) {
        for (int cb = 0; cb < blocks; ++cb, ++ja) {
          const int sa = ja % kAStages;
          mbar_wait(&full_a[sa], (ja / kAStages) & 1);
          const bf16* box = reinterpret_cast<const bf16*>(smem + sa * kABox);
          for (int kzy = 0; kzy < 4; ++kzy, ++jb) {
            const int kz = kzy >> 1, ky = kzy & 1;
            const int sb = jb % kBStages;
            const bool first = kx == 0 && cb == 0 && kzy == 0;
            mbar_wait(&full_b[sb], (jb / kBStages) & 1);
            const bf16* wt = reinterpret_cast<const bf16*>(smem + kNsB + sb * kBTile);
            fence_operand(acc[0]);
            fence_operand(acc[1]);
            wgmma_fence();
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const bf16* rows = box + (kTX * ky + kPlaneRows * (2 * wg + i + kz)) * 64;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                wgmma_ss<128, 1>(acc[i], desc_k_major<kHaloRows, 64>(rows, c), desc_mn_major<64, 128>(wt, c),
                                 first && c == 0 ? 0 : 1);
              }
            }
            wgmma_commit();
            wgmma_wait<1>();  // the tap before this one has been read
            if (!first && lane == 0) {
              mbar_arrive(&empty_b[(jb - 1) % kBStages]);
              if (kzy == 0) mbar_arrive(&empty_a[(ja - 1) % kAStages]);  // its box's last tap
            }
          }
        }
      }
      wgmma_wait_all();
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      if (lane == 0) {
        mbar_arrive(&empty_b[(jb - 1) % kBStages]);
        mbar_arrive(&empty_a[(ja - 1) % kAStages]);
      }

      // Epilogue: each m64 block (one z plane of 8 x 8 cells) goes through this warpgroup's
      // swizzled staging tile and one TMA store, which clips cells past the volume.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (tid == 0) bulk_wait_read<0>();  // the store before has read the staging tile
        named_barrier_sync(1 + wg, 128);
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + g + 8 * h;
            *reinterpret_cast<uint32_t*>(staging + (n / 8) * 8192 + r * 128 + (((n % 8) ^ (r % 8)) * 16) + qd * 4) =
                pack_bf16x2(acc[i][n][2 * h], acc[i][n][2 * h + 1]);
          }
        }
        fence_proxy_async();
        named_barrier_sync(1 + wg, 128);
        if (tid == 0) {
          const int z = tile.z0 + 2 * wg + i;
          tma_store_5d(&out_map, staging, tile.n0, tile.x0, tile.y0, z, tile.b);
          tma_store_5d(&out_map, staging + 8192, tile.n0 + 64, tile.x0, tile.y0, z, tile.b);
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait_all();
  }
}

}  // namespace

// The bf16 dot variant (see the header): x, out (cells, pc), w (8, pc, pc); pc 128 or 256.
int phase_conv_dot_sm90(const void* x, const void* w, void* out, long long cells, int pc, cudaStream_t stream) {
  if (cells <= 0 || cells > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (pc == 128) return launch_dot<128>(x, w, out, cells, stream);
  if (pc == 256) return launch_dot<256>(x, w, out, cells, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The bf16 noshift variant (see the header): x, out (b, z, y, xdim, pc), wp (2, 2, 2, pc, pc);
// pc a multiple of 128.
int phase_conv_noshift_sm90(const void* x, const void* wp, void* out, int b, int z, int y, int xdim, int pc,
                            cudaStream_t stream) {
  if (pc % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Volume v{pc, (xdim + kTX - 1) / kTX, (y + kTY - 1) / kTY, (z + kTZ - 1) / kTZ, pc / 128};
  const long long n_tiles = static_cast<long long>(b) * v.tiles_z * v.tiles_y * v.tiles_x * v.n_blocks;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map, out_map;
  if (!tile_map_5d(&x_map, x, b, z, y, xdim, pc, kTX, kTY + 1, kTZ + 1) || !tile_map(&w_map, wp, 8, pc, pc, 64) ||
      !tile_map_5d(&out_map, out, b, z, y, xdim, pc, kTX, kTY, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = kNsBytes + 1024;  // + the slack align_1024 takes
  const cudaError_t err = cudaFuncSetAttribute(noshift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_tiles < sm_count() ? static_cast<int>(n_tiles) : sm_count();
  noshift_kernel<<<grid, kThreads, kSmem, stream>>>(x_map, w_map, out_map, v, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// Writes to *bytes the dynamic shared memory that the bf16 kernel of `variant` (cips_phase_conv's
// code: 3 dot, 1 noshift) launches with at `pc` (ptxas reports only static shared memory).
// Returns a CUDA error code.
extern "C" int cips_phase_conv_smem(int variant, int pc, void* bytes) {
  int* out = static_cast<int*>(bytes);
  if (variant == 3 && pc == 128) *out = DotLayout<128>::kBytes + 1024;
  else if (variant == 3 && pc == 256) *out = DotLayout<256>::kBytes + 1024;
  else if (variant == 1 && pc % 128 == 0 && pc > 0) *out = kNsBytes + 1024;
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}
