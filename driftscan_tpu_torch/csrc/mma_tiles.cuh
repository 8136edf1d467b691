// Warp-level tensor-core products (mma.sync) and cp.async staging, shared by
// the projection sandwich (K15a, sandwich.cu), the Legendre stages of the
// forward and inverse SHT (K3+K5, legendre_sht.cu; K14, legendre_synth.cu)
// and the Fisher trace (K15b, fisher_trace.cu).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k*"), with
// g = lane / 4 and t = lane % 4, A (16 x K) row-major, B (K x 8), C (16 x 8):
//   float64 m16n8k4:  a0 = A[g][t], a1 = A[g + 8][t]; b0 = B[t][g]
//   tf32    m16n8k8:  a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
//                     a3 = A[g + 8][t + 4]; b0 = B[t][g], b1 = B[t + 4][g]
//   both:             c0, c1 = C[g][2t], C[g][2t + 1];
//                     c2, c3 = C[g + 8][2t], C[g + 8][2t + 1]

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// d (16 x 8) += a (16 x 4) b (4 x 8) in float64 on the tensor cores
// (IEEE double products and sums, as the CUDA cores give them).
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], double a0, double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's result, in two integer instructions where the
// cvt runs on the slower conversion unit.
__device__ __forceinline__ uint32_t tf32_round(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// 3xTF32 (x y = xb yb + xb ys + xs yb, the xs ys term dropped) needs each
// operand as big + small, both rounded to tf32 (the tensor cores would
// otherwise truncate them): big = rna(x), small = rna(x - big), the
// difference exact in float32 and below 2^-11 |x|.  The pair carries x to
// 2^-22 |x| without bias, the dropped term is below 2^-22 |x y|.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_round(__float_as_uint(x));
  small = tf32_round(__float_as_uint(x - __uint_as_float(big)));
}

// d (16 x 8, f32) += a (16 x 8, tf32) b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32_16x8x8(float (&d)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, f32) = a (16 x 8, tf32) b (8 x 8, tf32), from zero
__device__ __forceinline__ void mma_tf32_16x8x8_zero(float (&d)[4], const uint32_t (&a)[4],
                                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; with
// valid == false the destination is filled with zeros and nothing is read.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(BYTES), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mma
