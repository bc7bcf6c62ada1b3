// F_p arithmetic on canonical uint32 values in [0, p), p = 2^26 - 5, shared
// by the port's kernels.  A product of two elements is < 2^52, so a uint64
// sum of up to 2048 of them (plus a partial < p) stays below 2^64.
//
// Everything here has internal linkage: each kernel source compiles into
// its own shared library and carries its own copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 67108859ull;

__device__ __forceinline__ uint32_t addp(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return s >= kP ? s - (uint32_t)kP : s;
}

__device__ __forceinline__ uint32_t subp(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (uint32_t)kP - b;
}

__device__ __forceinline__ uint32_t mulp(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) % kP);
}

// ghat(z) = sum_t coeffs[t] z^t by Horner, lowest degree first.
__device__ __forceinline__ uint32_t horner(const int32_t* __restrict__ coeffs,
                                           int degree, uint32_t z) {
  uint32_t g = (uint32_t)coeffs[degree];
  for (int t = degree - 1; t >= 0; --t)
    g = addp(mulp(g, z), (uint32_t)coeffs[t]);
  return g;
}

}  // namespace
