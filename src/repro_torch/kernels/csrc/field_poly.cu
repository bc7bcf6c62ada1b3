// Elementwise polynomial evaluation over F_p, p = 2^26 - 5:
//   out[i] = sum_t coeffs[t] z[i]^t     (Horner, lowest degree first)
//
// Replaces the TPU kernel `poly_eval` (src/repro/kernels/field_poly.py),
// which runs Horner on 4096-element VMEM blocks in 13-bit-limb int32
// arithmetic.  Here one thread evaluates one element with 64-bit products
// (< 2^52) reduced mod p at every step; the coefficients are read through
// the cache, since every thread reads the same r + 1 of them.
//
// Bound on an H100: 8 bytes per element (one int32 read, one written) over
// 3.35 TB/s; r multiplies and adds per element are far below the integer
// rate.  Neighbouring threads touch neighbouring elements, so the loads and
// stores coalesce.

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
poly_eval_kernel(const int32_t* __restrict__ z,
                 const int32_t* __restrict__ coeffs, int degree,
                 int32_t* __restrict__ out, int64_t L) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < L) out[i] = (int32_t)horner(coeffs, degree, (uint32_t)z[i]);
}

}  // namespace

// z and out (L,) and coeffs (degree + 1,) are contiguous int32; z and
// coeffs in [0, p); L >= 1.  Returns the launch's cudaGetLastError().
extern "C" int repro_poly_eval(const void* z, const void* coeffs, int degree,
                               void* out, int64_t L, void* stream) {
  const unsigned blocks = (unsigned)((L + kThreads - 1) / kThreads);
  poly_eval_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(coeffs),
      degree, static_cast<int32_t*>(out), L);
  return static_cast<int>(cudaGetLastError());
}
