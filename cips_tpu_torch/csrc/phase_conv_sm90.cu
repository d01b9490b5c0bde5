// The bf16 `dot`, `noshift`, `full` and `one_tap` variants of the phase conv for Hopper (sm_90a):
// TMA tile loads that complete on mbarriers, wgmma on swizzled shared-memory tiles,
// persistent CTAs (one an SM) of one producer warp and two consumer warpgroups; and `copy`, in
// any dtype, as 1-D bulk copies through shared memory. Launched by cips_phase_conv
// (phase_conv.cu, variant codes kDot, kNoShift, kFull, kOneTap and kCopy); the fp32 products
// are in phase_conv_tf32.cu, shift and select in phase_conv.cu.
//
// Replaces the Pallas TPU kernels
//   scripts/probe_pallas_dot.py:k_dot4d, k_dot2d       (dot)
//   scripts/probe_pallas_bisect.py:_kernel, MODE nosel (noshift)
//   cips_tpu/ops/pallas/phase_conv.py:_kernel          (full; also bisect MODE full and
//                                                       scripts/debug_pallas_stages.py stage >= 4)
//   scripts/debug_pallas_stages.py:_kernel, STAGE 3    (one_tap), STAGE 1 (copy)
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
//
// full: out[c] = sum_{k in {0,1}^3} x'[c + k] . Wp[k], where the channels of phase group q
//   (q = (qz 2 + qy) 2 + qx, pc / 8 channels each) read x[c + k - q], zero outside the volume.
//   What bounds it. The function is 1.305e11 operations at (8, 48, 64, 48, 128) and bound by
//   its bytes (0.180 ms); run densely over 8 taps x pc^2, as here, it is noshift's 3.09e11
//   operations (0.313 ms): bound by the products it issues.
//   The design: noshift's mainloop with a shift per phase group. k - q is -1, 0 or +1 on each
//   axis, so the halo box grows to (64, 8, 10, 6): 480 rows, 61,440 bytes. The y and z shifts
//   stay descriptor offsets inside it, 8 (dy + 1) + 80 (p + dz + 1) rows, multiples of 8. The
//   x shift takes three boxes, at x0 - 1, x0 and x0 + 1. A wgmma k-step is 16 channels, one
//   phase group at pc 128 and half of one at pc 256, so each k-step's A descriptor starts at
//   its own (box, row offset). Three boxes beside a Wp ring and the staging tiles do not fit
//   in 227 KB (3 x 61,440 + 32 KB of staging leaves less than one 16 KB Wp stage), so the
//   boxes go through a ring of 2 in (64-channel block, x shift) order. Box dx serves the
//   k-steps whose group has qx = kx - dx: for each (kz, ky) 2 of the block's 4 k-steps at
//   dx = -1 and +1, all 4 at dx = 0 (pc 128 and 256). Each box's schedule is computed once
//   and packed in one register (BoxSteps). Wp streams by k-step, (16 input x 128 output
//   channels) MN-major, 4 KB, one TMA copy each through a rank-4 map whose 64-column block is
//   a dimension of its own (kstep_map), in stages of 4 consecutive k-steps of a box (a box
//   serves 4 n, a multiple of 4): a ring of 4 stages of 16 KB, each k-step loaded once a
//   tile, and one commit group of 8 wgmma a stage, as noshift's. Products stay dense (no
//   k-step is ever all zero: per axis, tap 0 lacks only the (q, p) = (1, 1) block and tap 1
//   only (0, 0)); the epilogue is noshift's. L2 reads per tile at pc 128: 6 halo boxes and 8
//   taps of Wp's (128, 128) slab, 630,784 bytes, 2,464 a cell: 2.91 GB a call at
//   (8, 48, 64, 48, 128), against noshift's 2.06 and 4.83 for the mma.sync kernel that ran
//   full before (11.6 GB at pc 256, against 8.23 and 19.3). Any pc that is a multiple of 128;
//   a 64-channel block that lies in one phase group (pc >= 512) skips the box no k-step of it
//   reads.
//   Tried in bring-up (PERF.md): stages of one (box, kz, ky), 2 or 4 k-steps, with the
//   invalid steps skipped by a branch around the wgmma, which ptxas serialized (C7520,
//   "WG.AR in divergent path"); stages of 2 k-steps with each step's (tap, c) found by
//   divisions per step, slower still. cips_tpu_torch/scripts/time_full_kernel.py times this
//   kernel beside noshift and beside copies of it with one thing changed: stages of 2 k-steps
//   and two 2 KB copies a Wp k-step are both slower; a copy without the products (loads and
//   barriers only) takes 0.64-0.80x noshift's whole time, so the load side (6 halo boxes
//   and 64 Wp copies a tile) is what keeps full above noshift. A second producer warp, one
//   for the boxes and one for Wp, did not help (scratch copy, one call).
//
// one_tap: out[c] = x'[c] . Wp[0, 0, 0], the channels of phase group q reading x[c - q]: full
//   restricted to tap (0, 0, 0).
//   What bounds it. 2 cells pc^2 operations (3.87e10 at (8, 48, 64, 48, 128), 0.039 ms) against
//   x read and out written once, 6.04e8 bytes (0.180 ms): bound by memory, at pc 256 too.
//   The design: noshift's tile and epilogue, halo boxes at (y0 - 1, z0 - 1), the weights
//   resident. The shift is -q, in {-1, 0} on each axis, so a box of (8, 9, 5) cells serves the
//   y and z shifts as row offsets 8 (1 - qy) + 72 (p + 1 - qz), multiples of 8 rows, and the x
//   shift takes a box at x0 - qx. A box is one phase group's pc / 8 channels: (16, 8, 9, 5) in
//   32-byte swizzled rows at pc 128, (32, 8, 9, 5) in 64-byte rows at pc 256, 8 a tile, each
//   serving its group's pc / 128 k-steps, so no box byte goes unread; one commit group of 2
//   or 4 wgmma a warpgroup a box, the same for every box, no branch. Wp[0, 0, 0]'s (pc, 128)
//   column slab, 32 KB at pc 128 and 64 KB at pc 256, is loaded once and stays in shared
//   memory for the CTA's life; the rest holds the staging tiles and a halo ring of 13 boxes
//   (5 at pc 256). At pc 256 each tile is one of the two 128-channel output blocks, adjacent
//   in tile order so that the second finds the boxes in L2; the grid is even, so a CTA meets
//   one block only and keeps its slab. L2 reads per tile (256 cells): 360 cells x pc x 2
//   bytes of boxes, 1.41x the tile's own input: 424 MB a call at (8, 48, 64, 48, 128), 1.70 GB
//   at pc 256 (both output blocks). pc 128 or 256.
//   Tried in bring-up (time_stage_kernels and phase 9 of chip_smoke.py, PERF.md): noshift's
//   (64, 8, 9, 5) box, two a 64-channel block at x0 and x0 - 1, each serving the block's two
//   k-steps with that qx and leaving half of its bytes unread (2.8x the input read from L2, a
//   ring of 3): 0.252-0.261 ms at (8, 48, 64, 48, 128) against 0.228-0.231 for this design,
//   0.062-0.063 against 0.059-0.060 at batch 2, and at pc 256 (8 boxes a tile, 3.39 GB a
//   call) 0.634 against 0.445-0.451, where a copy of it without products still took 0.59.
//   Replaces an mma.sync kernel (a 2-stage cp.async ring of 32-channel chunks, CTAs of 128
//   cells, 4-byte stores).
//
// copy: out = x, bytes in any dtype.
//   What bounds it: x read and out written once, 2 n bytes at 3.35 TB/s.
//   The design: persistent CTAs, kCopyCtasPerSm an SM, of one thread. Chunk i of CTA b is
//   chunk b + i grid of the buffer; the thread keeps kCopyStages chunks of kCopyStage bytes
//   loading through a ring of shared-memory stages by 1-D cp.async.bulk, each on an mbarrier
//   with its byte count, stores each stage back by cp.async.bulk as soon as it lands, and
//   reloads a stage once cp.async.bulk.wait_group.read says its store has read it. The data
//   never passes through registers; the last chunk takes the remainder (bytes are a multiple
//   of 256: cells x pc x the element size, pc a multiple of 128).
//   Tuned on an H100 (time_stage_kernels): 2 CTAs an SM of 2 stages of 16 KB beat stages of 8
//   or 32 KB, rings of 3 or 4, 1, 3 or 4 CTAs an SM, L2 evict-first hints, one contiguous
//   range a CTA, and register copies with 4 or 8 16-byte loads in flight a thread; all of them
//   stayed 1-6 % above x.clone(), which the profiler records as a copy-engine memcpy (Memcpy
//   DtoD), not a kernel.

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

// The epilogue of noshift and full: each m64 block of a consumer warpgroup's accumulators (one
// z plane of 8 x 8 cells) goes through the warpgroup's swizzled staging tile and one TMA store,
// which clips cells past the volume.
__device__ __forceinline__ void store_planes(float (&acc)[2][16][4], uint8_t* staging, const CUtensorMap* out_map,
                                             const Tile& tile, int wg, int tid) {
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
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
      tma_store_5d(out_map, staging, tile.n0, tile.x0, tile.y0, z, tile.b);
      tma_store_5d(out_map, staging + 8192, tile.n0 + 64, tile.x0, tile.y0, z, tile.b);
      bulk_commit();
    }
  }
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
    const int lane = tid % 32;
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

      store_planes(acc, staging, &out_map, tile, wg, tid);
    }
    if (tid == 0) bulk_wait_all();
  }
}

// ---- full -----------------------------------------------------------------------------------

constexpr int kFullPlaneRows = kTX * (kTY + 2);              // rows of one z plane of a full halo box
constexpr int kFullHaloRows = kFullPlaneRows * (kTZ + 2);    // 480 cells of one halo box
constexpr int kFullABox = kFullHaloRows * 128;               // 61,440 bytes: 64 channels of it
constexpr int kKStep = 16 * 128 * 2;                         // Wp[k][16 input][128 output channels]
constexpr int kStageSteps = 4;                               // k-steps a Wp stage: a box serves 4 n
constexpr int kFullBStage = kStageSteps * kKStep;
constexpr int kFullAStages = 2, kFullBStages = 65536 / kFullBStage;
constexpr int kFullB = kFullAStages * kFullABox;             // the B ring, after the A ring
constexpr int kFullOut = kFullB + kFullBStages * kFullBStage;
constexpr int kFullBars = kFullOut + kConsumers * kOutBlock;
constexpr int kFullBytes = kFullBars + 2 * (kFullAStages + kFullBStages) * 8;

// The k-steps that the box of 64-channel block cb at x shift dx serves, for each (kz, ky): the
// step's 16 channels lie in phase group q = channels / (pc / 8), which reads x[cell + k - q],
// so the box serves tap kx = qx + dx where that is 0 or 1. Computed once a box and packed 5
// bits a k-step (c, qy, qz, kx), so that the per-step work is shifts and masks.
struct BoxSteps {
  int n;         // k-steps for each (kz, ky), 0 to 4
  uint32_t bits;  // step j: c at 5 j, qy at 5 j + 2, qz at 5 j + 3, kx at 5 j + 4
};

__device__ __forceinline__ BoxSteps box_steps(int cb, int dx, int pc) {
  BoxSteps b{0, 0u};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int q = (cb * 64 + c * 16) / (pc / 8);
    const int kx = (q & 1) + dx;
    if (kx == 0 || kx == 1) {
      b.bits |= static_cast<uint32_t>(c | ((q >> 1) & 1) << 2 | (q >> 2) << 3 | kx << 4) << (5 * b.n);
      ++b.n;
    }
  }
  return b;
}

// Walks a box's 4 n k-steps, (kz, ky) major.
struct StepWalk {
  int kzy = 0, j = 0;
  __device__ __forceinline__ uint32_t step(const BoxSteps& b) const { return b.bits >> (5 * j) & 31u; }
  __device__ __forceinline__ void next(const BoxSteps& b) {
    if (++j == b.n) {
      j = 0;
      ++kzy;
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1) full_kernel(const __grid_constant__ CUtensorMap x_map,
                                                           const __grid_constant__ CUtensorMap w_map,
                                                           const __grid_constant__ CUtensorMap out_map, Volume v,
                                                           int n_tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + kFullBars);
  uint64_t* empty_a = full_a + kFullAStages;
  uint64_t* full_b = empty_a + kFullAStages;
  uint64_t* empty_b = full_b + kFullBStages;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int blocks = v.pc / 64;  // 64-channel blocks of the reduction
  const int block = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kFullAStages; ++i) {
      mbar_init(&full_a[i], 1);
      mbar_init(&empty_a[i], kReleases);
    }
    for (int i = 0; i < kFullBStages; ++i) {
      mbar_init(&full_b[i], 1);
      mbar_init(&empty_b[i], kReleases);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    if (tid == 0) {  // the producer: one thread issues every load, in consumption order
      int ja = 0, jb = 0;  // halo boxes and Wp stages issued so far
      for (int t = block; t < n_tiles; t += grid) {
        const Tile tile = tile_of(t, v);
        for (int cb = 0; cb < blocks; ++cb) {
          for (int dx = -1; dx <= 1; ++dx) {
            const BoxSteps steps = box_steps(cb, dx, v.pc);
            if (steps.n == 0) continue;
            const int sa = ja % kFullAStages;
            if (ja >= kFullAStages) mbar_wait(&empty_a[sa], (ja / kFullAStages - 1) & 1);
            mbar_expect_tx(&full_a[sa], kFullABox);
            tma_load_5d(smem + sa * kFullABox, &x_map, &full_a[sa], cb * 64, tile.x0 + dx, tile.y0 - 1, tile.z0 - 1,
                        tile.b);
            ++ja;
            StepWalk walk;
            for (int s = 0; s < 4 * steps.n; s += kStageSteps, ++jb) {
              const int sb = jb % kFullBStages;
              if (jb >= kFullBStages) mbar_wait(&empty_b[sb], (jb / kFullBStages - 1) & 1);
              mbar_expect_tx(&full_b[sb], kFullBStage);
              bf16* dst = reinterpret_cast<bf16*>(smem + kFullB + sb * kFullBStage);
              for (int h = 0; h < kStageSteps; ++h, dst += kKStep / 2, walk.next(steps)) {
                const uint32_t k = walk.step(steps);
                const int ch = cb * 64 + static_cast<int>(k & 3u) * 16;
                const int tap = walk.kzy * 2 + static_cast<int>(k >> 4);  // Wp[kz][ky][kx]
                tma_load_4d(dst, &w_map, &full_b[sb], 0, ch, tile.n0 / 64, tap);
              }
            }
          }
        }
      }
    }
  } else {
    const int lane = tid % 32;
    uint8_t* staging = smem + kFullOut + wg * kOutBlock;
    float acc[2][16][4];  // the two z planes 2 wg and 2 wg + 1 of the tile, 64 cells each
    int ja = 0, jb = 0;   // halo boxes and Wp stages consumed so far
    for (int t = block; t < n_tiles; t += grid) {
      const Tile tile = tile_of(t, v);
      bool first = true;  // the tile's first stage
      for (int cb = 0; cb < blocks; ++cb) {
        for (int dx = -1; dx <= 1; ++dx) {
          const BoxSteps steps = box_steps(cb, dx, v.pc);
          if (steps.n == 0) continue;
          const int sa = ja % kFullAStages;
          mbar_wait(&full_a[sa], (ja / kFullAStages) & 1);
          const bf16* box = reinterpret_cast<const bf16*>(smem + sa * kFullABox);
          StepWalk walk;
          for (int s = 0; s < 4 * steps.n; s += kStageSteps, ++jb) {
            // Each k-step's A descriptor: group q of its channels reads y + ky - qy and
            // z + kz - qz, whole rows of 8 and planes of 80 cells into the box (valid starts).
            uint64_t da[kStageSteps][2];
#pragma unroll
            for (int h = 0; h < kStageSteps; ++h, walk.next(steps)) {
              const uint32_t k = walk.step(steps);
              const int dy = (walk.kzy & 1) - static_cast<int>(k >> 2 & 1u);
              const int dz = (walk.kzy >> 1) - static_cast<int>(k >> 3 & 1u);
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                da[h][i] = desc_k_major<kFullHaloRows, 64>(
                    box + (kTX * (dy + 1) + kFullPlaneRows * (2 * wg + i + dz + 1)) * 64, static_cast<int>(k & 3u));
              }
            }
            const int sb = jb % kFullBStages;
            mbar_wait(&full_b[sb], (jb / kFullBStages) & 1);
            const bf16* wt = reinterpret_cast<const bf16*>(smem + kFullB + sb * kFullBStage);
            fence_operand(acc[0]);
            fence_operand(acc[1]);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < kStageSteps; ++h) {
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                wgmma_ss<128, 1>(acc[i], da[h][i], desc_mn_major<16, 128>(wt + h * (kKStep / 2), 0),
                                 first && h == 0 ? 0 : 1);
              }
            }
            wgmma_commit();
            wgmma_wait<1>();  // the stage before this one has been read
            if (!first && lane == 0) {
              mbar_arrive(&empty_b[(jb - 1) % kFullBStages]);
              if (s == 0) mbar_arrive(&empty_a[(ja - 1) % kFullAStages]);  // its box's last stage
            }
            first = false;
          }
          ++ja;
        }
      }
      wgmma_wait_all();
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      if (lane == 0) {
        mbar_arrive(&empty_b[(jb - 1) % kFullBStages]);
        mbar_arrive(&empty_a[(ja - 1) % kFullAStages]);
      }

      store_planes(acc, staging, &out_map, tile, wg, tid);
    }
    if (tid == 0) bulk_wait_all();
  }
}

// ---- one_tap --------------------------------------------------------------------------------

// A box is one phase group's pc / 8 channels at x0 - qx: (16, 8, 9, 5) in 32-byte swizzled rows
// at pc 128, (32, 8, 9, 5) in 64-byte rows at pc 256. It serves the group's pc / 128 k-steps,
// so no box byte goes unread.
template <int PC>
struct OneTapLayout {
  static constexpr int kBoxC = PC / 8;                    // channels a box
  static constexpr int kSteps = kBoxC / 16;               // k-steps a box
  static constexpr int kBox = (kHaloRows * kBoxC * 2 + 1023) / 1024 * 1024;  // 12,288 / 23,552 bytes
  static constexpr int kSlab = PC * 128 * 2;              // Wp[0, 0, 0][:, n0 .. n0 + 127], resident
  static constexpr int kStages = (232448 - 1024 - 64 - kSlab - kConsumers * kOutBlock) / kBox;  // 13 / 5
  static constexpr int kOut = kSlab + kStages * kBox;     // each warpgroup's output staging tile
  static constexpr int kBars = kOut + kConsumers * kOutBlock;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8;
};

template <int PC>
__global__ void __launch_bounds__(kThreads, 1) one_tap_kernel(const __grid_constant__ CUtensorMap x_map,
                                                              const __grid_constant__ CUtensorMap w_map,
                                                              const __grid_constant__ CUtensorMap out_map, Volume v,
                                                              int n_tiles) {
  using L = OneTapLayout<PC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* ring = smem + L::kSlab;
  uint64_t* full_a = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty_a = full_a + L::kStages;
  uint64_t* slab_bar = empty_a + L::kStages;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int block = static_cast<int>(blockIdx.x), grid = static_cast<int>(gridDim.x);

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::kStages; ++i) {
      mbar_init(&full_a[i], 1);
      mbar_init(&empty_a[i], kReleases);
    }
    mbar_init(slab_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    if (tid == 0) {  // the producer: the slab once, then every halo box in consumption order
      // grid is a multiple of n_blocks, so every tile of this CTA has output block block % n_blocks
      const int n0 = (block % v.n_blocks) * 128;
      mbar_expect_tx(slab_bar, L::kSlab);
      for (int cb = 0; cb < PC / 64; ++cb) {
        bf16* dst = reinterpret_cast<bf16*>(smem) + cb * 64 * 128;
        tma_load_3d(dst, &w_map, slab_bar, n0, cb * 64, 0);
        tma_load_3d(dst + 64 * 64, &w_map, slab_bar, n0 + 64, cb * 64, 0);
      }
      int ja = 0;  // halo boxes issued so far
      for (int t = block; t < n_tiles; t += grid) {
        const Tile tile = tile_of(t, v);
        for (int q = 0; q < 8; ++q, ++ja) {  // phase group q's box
          const int sa = ja % L::kStages;
          if (ja >= L::kStages) mbar_wait(&empty_a[sa], (ja / L::kStages - 1) & 1);
          mbar_expect_tx(&full_a[sa], kHaloRows * L::kBoxC * 2);
          tma_load_5d(ring + sa * L::kBox, &x_map, &full_a[sa], q * L::kBoxC, tile.x0 - (q & 1), tile.y0 - 1,
                      tile.z0 - 1, tile.b);
        }
      }
    }
  } else {
    const int lane = tid % 32;
    uint8_t* staging = smem + L::kOut + wg * kOutBlock;
    float acc[2][16][4];  // the two z planes 2 wg and 2 wg + 1 of the tile, 64 cells each
    int ja = 0;           // halo boxes consumed so far
    mbar_wait(slab_bar, 0);
    for (int t = block; t < n_tiles; t += grid) {
      const Tile tile = tile_of(t, v);
#pragma unroll 1
      for (int q = 0; q < 8; ++q, ++ja) {  // phase group q's box
        const int sa = ja % L::kStages;
        mbar_wait(&full_a[sa], (ja / L::kStages) & 1);
        // the group reads y - qy and z - qz: whole rows of 8 and planes of 72 cells into the
        // box, which starts at (y0 - 1, z0 - 1)
        const int qy = (q >> 1) & 1, qz = q >> 2;
        const bf16* rows0 = reinterpret_cast<const bf16*>(ring + sa * L::kBox);
        const bf16* slab = reinterpret_cast<const bf16*>(smem);
        fence_operand(acc[0]);
        fence_operand(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < L::kSteps; ++j) {
          const int bs = q * L::kSteps + j;  // the k-step in the slab, 16 rows each
          const uint64_t db = desc_mn_major<64, 128>(slab + (bs >> 2) * 64 * 128, bs & 3);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const bf16* rows = rows0 + (kTX * (1 - qy) + kPlaneRows * (2 * wg + p + 1 - qz)) * L::kBoxC;
            wgmma_ss<128, 1>(acc[p], desc_k_major<kHaloRows, L::kBoxC>(rows, j), db, q == 0 && j == 0 ? 0 : 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the box before this one has been read
        if (q > 0 && lane == 0) mbar_arrive(&empty_a[(ja - 1) % L::kStages]);
      }
      wgmma_wait_all();
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      if (lane == 0) mbar_arrive(&empty_a[(ja - 1) % L::kStages]);

      store_planes(acc, staging, &out_map, tile, wg, tid);
    }
    if (tid == 0) bulk_wait_all();
  }
}

template <int PC>
int launch_one_tap(const void* x, const void* wp, void* out, int b, int z, int y, int xdim, cudaStream_t stream) {
  using L = OneTapLayout<PC>;
  const Volume v{PC, (xdim + kTX - 1) / kTX, (y + kTY - 1) / kTY, (z + kTZ - 1) / kTZ, PC / 128};
  const long long n_tiles = static_cast<long long>(b) * v.tiles_z * v.tiles_y * v.tiles_x * v.n_blocks;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map, out_map;
  if (!tile_map_5d(&x_map, x, b, z, y, xdim, PC, kTX, kTY + 1, kTZ + 1, L::kBoxC) ||
      !tile_map(&w_map, wp, 8, PC, PC, 64) || !tile_map_5d(&out_map, out, b, z, y, xdim, PC, kTX, kTY, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = L::kBytes + 1024;  // + the slack align_1024 takes
  const cudaError_t err =
      cudaFuncSetAttribute(one_tap_kernel<PC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a multiple of n_blocks, so that each CTA keeps one output block's slab (n_tiles is one)
  const int grid = n_tiles < sm_count() ? static_cast<int>(n_tiles) : sm_count() / v.n_blocks * v.n_blocks;
  one_tap_kernel<PC><<<grid, kThreads, kSmem, stream>>>(x_map, w_map, out_map, v, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// ---- copy -----------------------------------------------------------------------------------

constexpr int kCopyStage = 16384;     // bytes a chunk
constexpr int kCopyStages = 2;        // chunks a CTA keeps in flight
constexpr int kCopyCtasPerSm = 2;
constexpr int kCopyBytes = kCopyStages * kCopyStage + kCopyStages * 8;

// One elected thread a CTA; chunk i of this CTA is chunk block + i grid of the buffer.
__global__ void __launch_bounds__(32) copy_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                                                  long long bytes) {
  extern __shared__ __align__(128) uint8_t copy_smem[];
  if (threadIdx.x != 0) return;
  uint64_t* landed = reinterpret_cast<uint64_t*>(copy_smem + kCopyStages * kCopyStage);
  const long long block = blockIdx.x, grid = gridDim.x;
  const long long chunks = (bytes + kCopyStage - 1) / kCopyStage;
  const long long mine = block < chunks ? (chunks - 1 - block) / grid + 1 : 0;
  for (int i = 0; i < kCopyStages; ++i) mbar_init(&landed[i], 1);
  fence_barrier_init();
  auto offset = [&](long long i) { return (block + i * grid) * kCopyStage; };  // of this CTA's chunk i
  auto chunk_bytes = [&](long long off) {  // the last chunk takes the remainder, a multiple of 256
    return static_cast<uint32_t>(bytes - off < kCopyStage ? bytes - off : kCopyStage);
  };
  auto load = [&](long long i) {  // this CTA's chunk i into stage i % kCopyStages
    const int st = static_cast<int>(i % kCopyStages);
    const long long off = offset(i);
    const uint32_t n = chunk_bytes(off);
    mbar_expect_tx(&landed[st], n);
    bulk_load(copy_smem + st * kCopyStage, x + off, n, &landed[st]);
  };
  for (long long i = 0; i < kCopyStages && i < mine; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int st = static_cast<int>(i % kCopyStages);
    const long long off = offset(i);
    mbar_wait(&landed[st], static_cast<uint32_t>(i / kCopyStages) & 1);
    bulk_store(out + off, copy_smem + st * kCopyStage, chunk_bytes(off));
    bulk_commit();
    // The stage of chunk i - 1 takes chunk i - 1 + kCopyStages once its store has read it: the
    // store of chunk i stays in flight meanwhile, and kCopyStages - 1 loads.
    if (i >= 1 && i - 1 + kCopyStages < mine) {
      bulk_wait_read<1>();
      load(i - 1 + kCopyStages);
    }
  }
  bulk_wait_all();
}

// Map of Wp (8 taps, pc input, pc output channels) whose box is one wgmma k-step of B: 16 input
// channels by 128 output channels, as two 64-column blocks one after the other (the column
// block is a dimension of its own, between the input channel and the tap), 128-byte swizzled.
bool kstep_map(CUtensorMap* map, const void* wp, int pc) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(pc) * 2;
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(pc), static_cast<cuuint64_t>(pc / 64), 8};
  const cuuint64_t strides[3] = {row, 128, row * pc};
  const cuuint32_t box[4] = {64, 16, 2, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(wp), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// The bf16 full variant (see the header): x, out (b, z, y, xdim, pc), wp (2, 2, 2, pc, pc);
// pc a multiple of 128.
int phase_conv_full_sm90(const void* x, const void* wp, void* out, int b, int z, int y, int xdim, int pc,
                         cudaStream_t stream) {
  if (pc % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Volume v{pc, (xdim + kTX - 1) / kTX, (y + kTY - 1) / kTY, (z + kTZ - 1) / kTZ, pc / 128};
  const long long n_tiles = static_cast<long long>(b) * v.tiles_z * v.tiles_y * v.tiles_x * v.n_blocks;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map, out_map;
  if (!tile_map_5d(&x_map, x, b, z, y, xdim, pc, kTX, kTY + 2, kTZ + 2) || !kstep_map(&w_map, wp, pc) ||
      !tile_map_5d(&out_map, out, b, z, y, xdim, pc, kTX, kTY, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = kFullBytes + 1024;  // + the slack align_1024 takes
  const cudaError_t err = cudaFuncSetAttribute(full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = n_tiles < sm_count() ? static_cast<int>(n_tiles) : sm_count();
  full_kernel<<<grid, kThreads, kSmem, stream>>>(x_map, w_map, out_map, v, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The bf16 one_tap variant (see the header): x, out (b, z, y, xdim, pc), wp (2, 2, 2, pc, pc), of
// which only Wp[0, 0, 0] is read; pc 128 or 256.
int phase_conv_one_tap_sm90(const void* x, const void* wp, void* out, int b, int z, int y, int xdim, int pc,
                            cudaStream_t stream) {
  if (pc == 128) return launch_one_tap<128>(x, wp, out, b, z, y, xdim, stream);
  if (pc == 256) return launch_one_tap<256>(x, wp, out, b, z, y, xdim, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The copy variant (see the header), any dtype: `bytes` of x to out, a multiple of 16, both
// 16-byte aligned.
int phase_conv_copy_sm90(const void* x, void* out, long long bytes, cudaStream_t stream) {
  if (bytes <= 0 || bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kCopyBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (bytes + kCopyStage - 1) / kCopyStage;
  const int ctas = sm_count() * kCopyCtasPerSm;
  copy_kernel<<<chunks < ctas ? static_cast<int>(chunks) : ctas, 32, kCopyBytes, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), bytes);
  return static_cast<int>(cudaGetLastError());
}

// Writes to *bytes the dynamic shared memory that the kernel of `variant` (cips_phase_conv's
// code: 3 dot, 1 noshift, 0 full, 2 one_tap, bf16; 5 copy) launches with at `pc` (ptxas reports
// only static shared memory). Returns a CUDA error code.
extern "C" int cips_phase_conv_smem(int variant, int pc, void* bytes) {
  int* out = static_cast<int*>(bytes);
  if (variant == 3 && pc == 128) *out = DotLayout<128>::kBytes + 1024;
  else if (variant == 3 && pc == 256) *out = DotLayout<256>::kBytes + 1024;
  else if (variant == 1 && pc % 128 == 0 && pc > 0) *out = kNsBytes + 1024;
  else if (variant == 0 && pc % 128 == 0 && pc > 0) *out = kFullBytes + 1024;
  else if (variant == 2 && pc == 128) *out = OneTapLayout<128>::kBytes + 1024;
  else if (variant == 2 && pc == 256) *out = OneTapLayout<256>::kBytes + 1024;
  else if (variant == 5 && pc % 128 == 0 && pc > 0) *out = kCopyBytes;
  else return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}
