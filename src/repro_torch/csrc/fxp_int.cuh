// Exact int32 fixed-point primitives shared by the port's CUDA kernels.
//
// The reference's integer semantics (DESIGN.md §4) are two's-complement
// int32 arithmetic that wraps, as XLA's int32 ops and
// dot_general(..., preferred_element_type=int32) do. Signed overflow and a
// left shift of a negative value are undefined in C++17, so every product,
// sum and left shift here goes through uint32_t and is cast back. A right
// shift of a signed int32 is arithmetic in nvcc. Nothing goes through
// fp16, TF32 or float.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "error_string.cuh"

namespace repro {

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_mul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// v << s for 0 <= s < 32, wrapping like jax.lax.shift_left.
__device__ __forceinline__ int32_t shift_left(int32_t v, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << s);
}

__device__ __forceinline__ int32_t saturate(int32_t q, int32_t lo,
                                            int32_t hi) {
  return q < lo ? lo : (q > hi ? hi : q);
}

// The round-half-even arithmetic right shift by s in [0, 32), its
// constants formed once (make_rshift). With q0 = v >> s and rem the low s
// bits of v, round half even adds one iff rem > half, or rem == half and q0
// is odd, i.e. iff rem + (q0 & 1) > half; rem + 1 <= 2^s cannot wrap in
// uint32_t. For s = 0 the threshold 1 is never passed (rem = 0). B1 forms
// its shifts once a thread and passes them in: with the shift as an int,
// nvcc kept a branch and the mask per call in B1's unrolled loop (203
// instructions a (window, step, unit) against 123, 18% slower on an H100).
struct RShift {
  int s;
  uint32_t mask, thresh;
};

__host__ __device__ inline RShift make_rshift(int s) {
  return {s, (1u << s) - 1u, s > 0 ? 1u << (s - 1) : 1u};
}

// fxp_requant_int (quant/fixedpoint.py) for a right shift: round half
// even, then saturate to [lo, hi]. The one rounding rule of the port.
__device__ __forceinline__ int32_t requant(int32_t v, RShift sh, int32_t lo,
                                           int32_t hi) {
  const int32_t q0 = v >> sh.s;
  const uint32_t rem = static_cast<uint32_t>(v) & sh.mask;
  return saturate(
      q0 + ((rem + (static_cast<uint32_t>(q0) & 1u)) > sh.thresh ? 1 : 0), lo,
      hi);
}

// fxp_requant_int with the shift already formed: shift >= 0 as above,
// shift < 0 an exact left shift, then the saturate. |shift| < 32 (the
// wrappers check it).
__device__ __forceinline__ int32_t requant(int32_t v, int shift, int32_t lo,
                                           int32_t hi) {
  if (shift >= 0) return requant(v, make_rshift(shift), lo, hi);
  return saturate(shift_left(v, -shift), lo, hi);
}

}  // namespace repro
