// 3xTF32: fp32 products on the TF32 tensor cores, shared by K2
// (ssam_mxu.cu, mma.sync; ssam_mxu_tc.cu, wgmma) and K3's channel path
// (ssam_wgrad_tc.cu, wgmma).
//
// TF32 keeps 10 mantissa bits, about three digits. For fp32 parity each
// operand is split, big = tf32(a) and small = tf32(a - big), and big*big +
// big*small + small*big is accumulated in fp32; the dropped small*small
// term is about 2^-22 of the product (2^-20 with the truncating split).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ssam {

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// The split by truncation, for operands the tensor core reads from shared
// memory: big = a with the 13 low mantissa bits cleared, small = a - big
// (exact in fp32); the tensor core reads small's own top 19 bits, within
// 2^-10 of it. Two integer/float operations instead of two conversions.
__device__ __forceinline__ void split_tf32_trunc(uint32_t a, uint32_t& big,
                                                 uint32_t& small) {
  big = a & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(a) - __uint_as_float(big));
}

// d += a * b on one m16n8k8 tile: TF32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32 on one k-step. The tensor core's fp32 accumulation truncates, so
// a long chain of big*big sums drifts: each step's big*big product starts
// from zero and is added to acc with a round-to-nearest fp32 add, while
// the two small cross terms, about 2^-11 of it, accumulate in the tensor
// core in cor. The result is acc + cor.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], float (&cor)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  float hi[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(hi, ab, bb);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += hi[i];
  mma_tf32(cor, as, bb);
  mma_tf32(cor, ab, bs);
}

// Whether v is inf or nan (its exponent bits all set): a tile whose sums
// hold one met a non-finite input, which the Toeplitz zeros spread.
__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

}  // namespace ssam
