// Split TF32 on the tensor cores: f32 products from mma.sync.m16n8k8.tf32,
// shared by B3 (lstm_cell.cu) and B6 (ssd.cu).
//
// Plain TF32 keeps 10 mantissa bits, about three decimal digits. Each f32
// operand is split as a = a_hi + a_lo, both TF32 (a_hi rounded to nearest,
// a_lo the rest, rounded), and a b takes three products, lo.hi + hi.lo +
// hi.hi (lo.lo is below f32's last bit), which gives f32 accuracy.
//
// Fragments of one m16n8k8 product, g = lane / 4, t = lane % 4:
// A (m16 x k8, row): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3]
// (g + 8, t + 4); B (k8 x n8, col): b[0] (t, g), b[1] (t + 4, g);
// accumulator d[0..1] (g, 2t..2t+1), d[2..3] (g + 8, 2t..2t+1).
//
// The tensor cores round their sums toward zero, an error that grows with
// every product added into a long-lived sum (B6 passed its 1e-4 bar at the
// long-memory extreme that way), so each group of one or two k-steps'
// products is summed from zero and added to d by the CUDA cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero as cvt.rna.tf32.f32 does, in two integer operations (finite v)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32: hi rounded to nearest, lo the rest, rounded
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float v) {
  const uint32_t hi = to_tf32(v);
  return {hi, to_tf32(v - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b over one k-step in split TF32, the small terms first, summed
// from zero and added to d by the CUDA cores
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     Split b0, Split b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  mma(t, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma(t, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// d += a0 b0 + a1 b1, two k-steps, likewise: six products summed from zero
__device__ __forceinline__ void mma6(float (&d)[4], const Split (&a0)[4],
                                     Split b00, Split b01,
                                     const Split (&a1)[4], Split b10,
                                     Split b11) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, a0[0].lo, a0[1].lo, a0[2].lo, a0[3].lo, b00.hi, b01.hi);
  mma(t, a1[0].lo, a1[1].lo, a1[2].lo, a1[3].lo, b10.hi, b11.hi);
  mma(t, a0[0].hi, a0[1].hi, a0[2].hi, a0[3].hi, b00.lo, b01.lo);
  mma(t, a1[0].hi, a1[1].hi, a1[2].hi, a1[3].hi, b10.lo, b11.lo);
  mma(t, a0[0].hi, a0[1].hi, a0[2].hi, a0[3].hi, b00.hi, b01.hi);
  mma(t, a1[0].hi, a1[1].hi, a1[2].hi, a1[3].hi, b10.hi, b11.hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

}  // namespace tf32
