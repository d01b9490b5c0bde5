// Hopper (sm_90a) building blocks of the flash-attention forward, dQ and dK/dV kernels and of
// the phase conv's dot, noshift, full, one_tap and copy kernels: TMA tile loads that complete on
// mbarriers and TMA tile stores, 1-D bulk copies, warpgroup matrix products (wgmma) on swizzled
// shared-memory tiles, and the host-side tensor maps that describe those tiles. Inline PTX only
// (no CuTe), so a file that includes this header builds in seconds.
//
// Tiles. A (ROWS, DH) bf16 tile lies in shared memory as TMA writes it with the swizzle of
// its row width: rows of S = min(2 DH, 128) bytes (SWIZZLE_32B at DH 16, SWIZZLE_64B at DH
// 32, SWIZZLE_128B at DH 64 and 128); at DH 128 as two column blocks of (ROWS, 64), one after
// the other. Every tile starts on a 1024-byte boundary. One tile serves both ways a product reads it:
//   K-major (the product sums over DH, e.g. the B operand of Q K^T): k-step c of 16 columns
//     is column block c / (S / 32), plus (c % (S / 32)) * 32 bytes inside the swizzled row;
//     8-row groups lie 8 S bytes apart (the descriptor's stride offset, SBO);
//   MN-major (the product sums over the rows, e.g. the B operand of P V, read with wgmma's
//     transpose bit): k-step c of 16 rows starts 16 S bytes further; SBO is 8 S bytes and
//     the leading offset (LBO) is the distance between column blocks, ROWS * S bytes.
// Accumulators are float[N / 8][4]. In an m64nNk16 product, warp w of the warpgroup owns
// rows 16 w .. 16 w + 15 and d[n] is its 16 x 8 tile of columns 8n .. 8n + 7, in the layout
// of mma.sync's C tile (mma_bf16.cuh). The register A operand has mma.sync's A layout, so
// to_a_frag turns two accumulator tiles into one k-step of the next product's A.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

// Row width in bytes of a swizzled (ROWS, DH) tile, and the swizzle of that width.
template <int DH>
constexpr int kRowBytes = DH >= 64 ? 128 : 2 * DH;

template <int ROWS, int DH>
constexpr int kTileBytes = ROWS * DH * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Dynamic shared memory rounded up to the 1024 bytes that a 128-byte swizzle needs (the
// launcher asks for 1024 bytes more than the kernel uses).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// ---- mbarriers and TMA -------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes barrier initialisation visible to the async proxy (TMA) before first use.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions in the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// One plain arrival (a consumer handing a ring stage back to the producer).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier has completed the phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The box at (c0, c1, c2) of a rank-3 tensor map into shared memory, completing on `bar`.
// Elements outside the tensor arrive as zeros and count as transaction bytes all the same.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// The box at (c0, .., c3) of a rank-4 tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The box at (c0, .., c4) of a rank-5 tensor map (tile_map_5d). Coordinates may be negative:
// what lies outside the tensor arrives as zeros, so a shifted window needs no padded copy.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// The shared-memory box `src` to (c0, c1, c2) of a rank-3 tensor map; elements outside the
// tensor are not written. Completes in the issuing thread's bulk group (bulk_commit, bulk_wait*).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

// The shared-memory box `src` to (c0, .., c4) of a rank-5 tensor map; cells outside the
// tensor are not written.
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, const void* src, int c0, int c1, int c2, int c3,
                                             int c4) {
  asm volatile("cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global `src` into shared
// `dst`, completing on `bar` as that many transaction bytes: a 1-D bulk copy, no tensor map.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// `bytes` (a multiple of 16) from shared `src` to global `dst`, in the issuing thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// Waits until at most N of this thread's bulk groups still read their shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until every bulk group of this thread has completed (its writes are done).
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Makes this thread's plain shared-memory writes visible to the async proxy (wgmma operands,
// TMA stores); the threads then synchronise before the async reader starts.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + ROWS) of head `bh` of a (bh, len, DH) tensor described by `map`
// (tile_map below) into the swizzled tile `dst`: one box per column block.
template <int ROWS, int DH>
__device__ __forceinline__ void tma_load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar, int row0, int bh) {
  constexpr int kCols = kRowBytes<DH> / 2;
#pragma unroll
  for (int b = 0; b < DH / kCols; ++b) tma_load_3d(dst + b * ROWS * kCols, map, bar, b * kCols, row0, bh);
}

// Rows [row0, row0 + ROWS) of head `bh` of a (bh, len, DH) fp32 tensor described by `map`
// (tile_map_f32 below) into `dst`: one box of 32 columns (128-byte rows, 128-byte swizzle) per
// column block, the layout of mma_tf32.cuh's tiles.
template <int ROWS, int DH>
__device__ __forceinline__ void tma_load_tile_f32(float* dst, const CUtensorMap* map, uint64_t* bar, int row0,
                                                  int bh) {
#pragma unroll
  for (int b = 0; b < DH / 32; ++b) tma_load_3d(dst + b * ROWS * 32, map, bar, b * 32, row0, bh);
}

// Synchronises the `count` threads that use named barrier `id` (1-15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x on the special-function unit (-inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma ---------------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte offsets, swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;  // 128B, 64B, 32B swizzle
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// k-step c (16 columns) of a (ROWS, DH) tile read K-major.
template <int ROWS, int DH>
__device__ __forceinline__ uint64_t desc_k_major(const bf16* tile, int c) {
  constexpr int S = kRowBytes<DH>;
  constexpr int kSteps = S / 32;  // k-steps per column block
  return make_desc(smem_u32(tile) + (c / kSteps) * ROWS * S + (c % kSteps) * 32, 16, 8 * S, S);
}

// k-step c (16 rows) of a (ROWS, DH) tile read MN-major (with the transpose bit).
template <int ROWS, int DH>
__device__ __forceinline__ uint64_t desc_mn_major(const bf16* tile, int c) {
  constexpr int S = kRowBytes<DH>;
  return make_desc(smem_u32(tile) + c * 16 * S, ROWS * S, 8 * S, S);
}

// Orders register accesses before the products that follow. The .aligned wgmma instructions
// need every warp converged, so the warp is first reconverged: the mbarrier spin loops and
// the one thread that issues TMA loads may leave it split.
__device__ __forceinline__ void wgmma_fence() {
  __syncwarp();
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// Waits until at most N of the warp's committed product groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across wgmma_wait_all or
// wgmma_fence: the registers are live in the asynchronous product in between.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
  }
}

// d (+)= A B for an m64nNk16 step: A from registers (mma.sync A layout), B from shared memory
// read MN-major (the transpose bit: B's rows are the reduction axis). scale_d = 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_rs: N is 32, 64 or 128");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
          "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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

// d (+)= A B for an m64nNk16 step, both operands from shared memory. A is read K-major; B is
// read K-major (TRANS_B = 0: d += A B^T for a B tile whose rows are N) or MN-major (TRANS_B = 1,
// wgmma's transpose bit: d += A B for a B tile whose rows are the reduction axis).
template <int N, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N is 32, 64 or 128");
  static_assert(TRANS_B == 0 || TRANS_B == 1, "wgmma_ss: TRANS_B is 0 or 1");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
          "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]),
          "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]),
          "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
          "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
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
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
  }
}

// ---- host: tensor maps ------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; it is fetched through the runtime, so the
// library needs no -lcuda at link time. Null if the driver does not have it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    return err == cudaSuccess && status == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// Map of a contiguous (bh, len, dh) bf16 tensor whose boxes are (box_rows, one column block)
// of one head, swizzled as the tiles above. Rows past len read as zeros. False on failure.
inline bool tile_map(CUtensorMap* map, const void* base, int bh, int len, int dh, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int row_bytes = dh >= 64 ? 128 : 64;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2, static_cast<cuuint64_t>(len) * dh * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(row_bytes / 2), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of a contiguous (bh, len, dh) fp32 tensor whose boxes are (box_rows, 32 columns) of one
// head: rows of 128 bytes with SWIZZLE_128B (tma_load_tile_f32). Rows past len read as zeros.
// False on failure.
inline bool tile_map_f32(CUtensorMap* map, const void* base, int bh, int len, int dh, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 4, static_cast<cuuint64_t>(len) * dh * 4};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of a contiguous channels-last bf16 volume (b, z, y, x, c), c a multiple of 64, whose
// boxes are (box_c channels, box_x, box_y, box_z, 1): one row of 2 box_c bytes a cell, x
// fastest, then y, then z, swizzled as the tiles above (box_c 64, 32 or 16: rows of 128, 64
// or 32 bytes). So a box of R cells is the K-major (R, box_c) tile of those cells, and with
// box_x a multiple of 8 a shift of whole y or z rows inside it is a multiple of 8 rows, a valid
// descriptor start. Cells outside the volume, at negative coordinates too, read as zeros.
// False on failure.
inline bool tile_map_5d(CUtensorMap* map, const void* base, int b, int z, int y, int x, int c, int box_x,
                        int box_y, int box_z, int box_c = 64) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(x), static_cast<cuuint64_t>(y),
                              static_cast<cuuint64_t>(z), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(c) * 2;
  const cuuint64_t strides[4] = {row, row * x, row * x * y, row * x * y * z};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(box_c), static_cast<cuuint32_t>(box_x),
                             static_cast<cuuint32_t>(box_y), static_cast<cuuint32_t>(box_z), 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_c == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                : box_c == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of n contiguous floats read in boxes of `box` elements; elements past n read as zeros.
// A box must start on 16 bytes (a multiple of 4 floats): a misaligned one is an illegal
// instruction, so callers round the first element down and skip the extra ones.
inline bool row_map(CUtensorMap* map, const void* base, size_t n, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};  // not read at rank 1
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(base), dims, strides, boxes, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
