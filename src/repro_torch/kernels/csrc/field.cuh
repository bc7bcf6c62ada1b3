// F_p arithmetic on canonical uint32 values in [0, p), p = 2^26 - 5, shared
// by the port's kernels.  A product of two elements is < 2^52, so a uint64
// sum of up to 4096 of them stays below 2^64 (kNoReduceTerms, reduced with
// reduce_p) and a sum of up to 64 below 2^58 (kNoReduce58Terms, reduced
// with the cheaper reduce_p58).
//
// reduce_p replaces the 64-bit `% p` (a long subroutine on the CUDA cores)
// with the pseudo-Mersenne form: 2^26 = 5 (mod p), so
//   x -> (x mod 2^26) + 5 * (x >> 26)
// leaves x below 2^41 after one fold of a uint64, below 2^27 after a
// second (done in 32 bits), below 2^26 + 5 after a third, and one
// conditional subtract lands in [0, p).  kernels/plan.py holds a numpy copy
// that the CPU tests check against `%`.
//
// Everything here has internal linkage: each kernel source compiles into
// its own shared library and carries its own copy.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 67108859ull;
constexpr uint32_t kMask26 = (1u << 26) - 1u;
constexpr int kNoReduceTerms = 4096;   // products < 2^52 a uint64 sum holds
constexpr int kNoReduce58Terms = 64;   // products a sum below 2^58 holds

__device__ __forceinline__ uint32_t reduce_p(uint64_t x) {
  const uint64_t y = (x & kMask26) + 5ull * (x >> 26);          // < 2^41
  const uint32_t z = ((uint32_t)y & kMask26) + 5u * (uint32_t)(y >> 26);
  const uint32_t v = (z & kMask26) + 5u * (z >> 26);            // < 2^26 + 5
  return v >= (uint32_t)kP ? v - (uint32_t)kP : v;
}

// (hi, lo) += a * b for 32-bit a, b through PTX's carry chain.  ptxas
// emits the same IMAD.WIDE.U32 as for a uint64 sum, but on an H100 the
// gradient kernel ran faster written this way (coded_gradient_matrix at
// C = 10: 2.33 against 2.79 ms with uint64 sums; PERF.md).
__device__ __forceinline__ void mac_wide(uint32_t& lo, uint32_t& hi,
                                         uint32_t a, uint32_t b) {
  asm("mad.lo.cc.u32 %0, %2, %3, %0;\n\tmadc.hi.u32 %1, %2, %3, %1;"
      : "+r"(lo), "+r"(hi) : "r"(a), "r"(b));
}

__device__ __forceinline__ uint64_t wide(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

// reduce_p for x < 2^58 (a sum of at most kNoReduce58Terms products):
// x >> 26 fits 32 bits and two folds land below 2p.  Wrong, with no error,
// for larger x: callers bound their term counts by kNoReduce58Terms.
__device__ __forceinline__ uint32_t reduce_p58(uint64_t x) {
  const uint64_t y = ((uint32_t)x & kMask26) + 5ull * (uint32_t)(x >> 26);
  const uint32_t z = ((uint32_t)y & kMask26) + 5u * (uint32_t)(y >> 26);
  return z >= (uint32_t)kP ? z - (uint32_t)kP : z;
}

__device__ __forceinline__ uint32_t addp(uint32_t a, uint32_t b) {
  uint32_t s = a + b;
  return s >= kP ? s - (uint32_t)kP : s;
}

__device__ __forceinline__ uint32_t subp(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (uint32_t)kP - b;
}

__device__ __forceinline__ uint32_t mulp(uint32_t a, uint32_t b) {
  return reduce_p((uint64_t)a * b);
}

// Sums V = 2^v values over a warp with V - 1 + 5 - v shuffles instead of
// 5 V: at offset 16, 8, ... each lane keeps half of its values and adds
// its partner's copy of that half.  Each value is < p, so every sum of 32
// fits 32 bits.  Returns the full sum of value multi_sum_index<V>(lane);
// the 32 / V lanes that share an index all hold it.
template <int V>
__device__ __forceinline__ uint32_t multi_warp_sum(uint32_t (&v)[V], int lane) {
  int off = 16;
#pragma unroll
  for (int half = V / 2; half >= 1; half /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const uint32_t send = upper ? v[k] : v[k + half];
      const uint32_t keep = upper ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  uint32_t r = v[0];
  for (; off > 0; off /= 2) r += __shfl_xor_sync(0xffffffffu, r, off);
  return r;
}

template <int V>
__device__ __forceinline__ int multi_sum_index(int lane) {
  int idx = 0;
#pragma unroll
  for (int half = V / 2, off = 16; half >= 1; half /= 2, off /= 2)
    if (lane & off) idx += half;
  return idx;
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
