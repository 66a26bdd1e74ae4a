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

// fxp_requant_int (quant/fixedpoint.py) with the shift already formed:
// shift > 0 is a round-half-even arithmetic right shift, shift < 0 an exact
// left shift, then a saturate to [lo, hi]. |shift| < 32 (the wrappers
// check it).
__device__ __forceinline__ int32_t requant(int32_t v, int shift, int32_t lo,
                                           int32_t hi) {
  int32_t q = v;
  if (shift > 0) {
    const int32_t q0 = v >> shift;
    const int32_t rem = wrap_sub(v, shift_left(q0, shift));
    const int32_t half = static_cast<int32_t>(1u << (shift - 1));
    const bool inc = rem > half || (rem == half && (q0 & 1));
    q = wrap_add(q0, inc ? 1 : 0);
  } else if (shift < 0) {
    q = shift_left(v, -shift);
  }
  return q < lo ? lo : (q > hi ? hi : q);
}

}  // namespace repro
