// Tensor-core helpers shared by the flash-attention and phase conv kernels (sm_90a): bf16
// packing and the mma.sync m16n8k16 product, in the fragment layouts of the PTX ISA.
//
// With g = lane / 4 and t = lane % 4, a thread holds
//   A (16x16, row-major): a[0] = (g, 2t..2t+1), a[1] = (g+8, 2t..), a[2] = (g, 2t+8..),
//                         a[3] = (g+8, 2t+8..);
//   B (16x8, k x n):      b[0] = (k 2t..2t+1, n g), b[1] = (k 2t+8..2t+9, n g);
//   C (16x8, fp32):       c[0..1] = (g, 2t..2t+1), c[2..3] = (g+8, 2t..2t+1).
// So the C tiles of two adjacent 8-column groups n = 2c, 2c+1 are exactly the A fragment of
// k-step c of a following product: `to_a_frag` repacks them without touching shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  uint32_t bits;
  memcpy(&bits, &v, sizeof(bits));
  return bits;
}

// c += a * b on the tensor cores: a is a 16x16 row-major bf16 tile, b a 16x8 bf16 tile
// (column-major), c a 16x8 fp32 tile.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rounds the C tile of 8-column group n (values x[0..3]) to bf16 into its place in the A
// fragments of the next product (k-step n / 2).
__device__ __forceinline__ void to_a_frag(uint32_t a[][4], int n, const float x[4]) {
  a[n / 2][(n % 2) * 2] = pack_bf16x2(x[0], x[1]);
  a[n / 2][(n % 2) * 2 + 1] = pack_bf16x2(x[2], x[3]);
}
