// fp32-grade products on the tensor cores (sm_80 and later, used on sm_90a): 3xTF32 on
// mma.sync m16n8k8, and the fragment loads from fp32 tiles that TMA writes with a 128-byte
// swizzle (tile_map_f32 and tma_load_tile_f32 in hopper_sm90.cuh).
//
// 3xTF32. A tf32 value keeps fp32's exponent and 10 of its 23 mantissa bits. Each fp32 operand
// x is split into big = rna(x) and small = rna(x - big), rna rounding to nearest (ties away
// from zero) on the 13 low mantissa bits, as cvt.rna.tf32.f32 does; x - big is exact, and
// big + small carries about 22 of x's 24 significand bits. A product of two tf32 values is exact
// in fp32, so a b = a_b b_b + a_b b_s + a_s b_b (+ a_s b_s, under 2^-22 relative, dropped),
// accumulated in fp32: three mma.sync passes at the TF32 rate give fp32-grade products
// (CUTLASS's OpMultiplyAddFastF32, which PyTorch's fp32 memory-efficient attention uses).
// The two small terms are issued before the big one, in OpMultiplyAddFastF32's order.
//
// Fragments of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 8, row-major): a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4), a[3] = (g + 8, t + 4);
//   B (8 x 8, k x n):      b[0] = (k t, n g), b[1] = (k t + 4, n g);
//   C (16 x 8, fp32):      c[0..1] = (g, 2t..2t+1), c[2..3] = (g + 8, 2t..2t+1).
// The order of the reduction is free, so a C tile serves as the A fragment of a next product
// with its 8 columns taken in the order (0, 2, 4, 6, 1, 3, 5, 7): (c[0], c[2], c[1], c[3]) are
// the A columns t and t + 4 of C columns 2t and 2t + 1 (acc_to_a), and that product's B fragment
// reads rows 2t and 2t + 1 of its k-step (load_b_rows_k). No shuffle, no trip through memory.
//
// Tiles. An fp32 (ROWS, DH) tile lies in shared memory as column blocks of 32 floats, each
// ROWS rows of 128 bytes, one after the other; in each 1024-byte group of 8 rows the 16-byte
// unit u of row r lies at unit u ^ (r % 8) (TMA's SWIZZLE_128B). Both ways a fragment reads a
// tile are then free of bank conflicts: 8 rows g at 4 columns t, and 8 rows 2t, 2t + 1 at 8
// columns g.

#pragma once

#include <stdint.h>

namespace tf32x3 {

// An operand split into its big and small tf32 parts (bits of .b32 registers).
struct A {
  uint32_t big[4], small[4];
};
struct B {
  uint32_t big[2], small[2];
};

// rna(x) to tf32: the bits of cvt.rna.tf32.f32(x) for finite x (half of the last tf32 place
// added to the magnitude, the 13 low bits cleared), in two integer instructions: with
// cvt.rna.tf32.f32 instead, the dQ and dK/dV kernels took 1.2-1.3x as long on an NVIDIA H100
// 80GB HBM3 at 700.00 W (scripts/time_flash_f32.py, copy "cvt.rna split").
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// The A fragment of the elements (x0, x1, x2, x3) in the order a[0..3].
__device__ __forceinline__ A split_a(float x0, float x1, float x2, float x3) {
  A a;
  split(x0, a.big[0], a.small[0]);
  split(x1, a.big[1], a.small[1]);
  split(x2, a.big[2], a.small[2]);
  split(x3, a.big[3], a.small[3]);
  return a;
}

// The C tile c as the A fragment of a next product (its columns reordered, see the top).
__device__ __forceinline__ A acc_to_a(const float (&c)[4]) { return split_a(c[0], c[2], c[1], c[3]); }

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small terms, then the big one.
__device__ __forceinline__ void mma3(float (&c)[4], const A& a, const B& b) {
  mma(c, a.big, b.small);
  mma(c, a.small, b.big);
  mma(c, a.big, b.big);
}

// Float offset of element (r8 + rl, c8 + cl) of an fp32 tile of ROWS rows (layout above): r8
// and c8 are multiples of 8 (known when the loops are unrolled), rl and cl under 8 (the lane's
// part), so rl is the row's place in its swizzle group and c8 / 4 + cl / 4 the 16-byte unit.
template <int ROWS>
__device__ __forceinline__ int at(int r8, int rl, int c8, int cl) {
  return (c8 / 32) * ROWS * 32 + (r8 + rl) * 32 + (((c8 / 4) % 8 + cl / 4) ^ rl) * 4 + cl % 4;
}

// A fragment of rows m0 .. m0 + 15 and columns k0 .. k0 + 7 of tile x (m0, k0 multiples of 8).
template <int ROWS>
__device__ __forceinline__ A load_a(const float* x, int m0, int k0, int g, int t) {
  return split_a(x[at<ROWS>(m0, g, k0, t)], x[at<ROWS>(m0 + 8, g, k0, t)], x[at<ROWS>(m0, g, k0, t + 4)],
                 x[at<ROWS>(m0 + 8, g, k0, t + 4)]);
}

// B fragment of a tile whose rows are the product's n and columns its k (the B of X Y^T, Y
// the tile): B[k][n] = y[n0 + n][k0 + k].
template <int ROWS>
__device__ __forceinline__ B load_b_rows_n(const float* y, int n0, int k0, int g, int t) {
  B b;
  split(y[at<ROWS>(n0, g, k0, t)], b.big[0], b.small[0]);
  split(y[at<ROWS>(n0, g, k0, t + 4)], b.big[1], b.small[1]);
  return b;
}

// B fragment of a tile whose rows are the product's k and columns its n (the B of X Y), for
// an A made by acc_to_a: k rows 2t and 2t + 1 of the k-step at k0.
template <int ROWS>
__device__ __forceinline__ B load_b_rows_k(const float* y, int k0, int n0, int g, int t) {
  B b;
  split(y[at<ROWS>(k0, 2 * t, n0, g)], b.big[0], b.small[0]);
  split(y[at<ROWS>(k0, 2 * t + 1, n0, g)], b.big[1], b.small[1]);
  return b;
}

}  // namespace tf32x3
