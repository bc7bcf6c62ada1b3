// Elementwise polynomial evaluation over F_p, p = 2^26 - 5:
//   out[i] = sum_t coeffs[t] z[i]^t     (Horner, lowest degree first)
//
// Replaces the TPU kernel `poly_eval` (src/repro/kernels/field_poly.py),
// which runs Horner on 4096-element VMEM blocks in 13-bit-limb int32
// arithmetic.
//
// Bound on an H100: 8 bytes per element (one int32 read, one written) over
// 3.35 TB/s (2^26 elements: 0.160 ms); r multiply-adds per element.  The
// first version (one thread per element, the coefficients re-read from
// global memory and a full reduce_p every step) reached 60% of that bound
// at degree 1 and 28% at degree 7 on an H100 (PERF.md): one 4-byte load in
// flight a thread is ~8 KB an SM, short of the ~40 KB Little's law asks,
// and ~20 instructions a Horner step made degree 7 issue-bound.  Here:
//   - long inputs (more than one wave of one element a thread): a
//     grid-stride loop over one full wave of blocks (kernels/plan.py
//     poly_launch: SMs x 8 blocks of 256 threads, which __launch_bounds__
//     keeps resident), each thread with the loads of kEpt = 8 elements of
//     a 2048-element chunk in flight (coalesced 4-byte words: any
//     alignment, any length), the coefficients staged once a block in
//     shared memory;
//   - short inputs (one step's z, 45,100 elements: a launch and a round
//     trip, far above the 0.1 us bound): one thread an element over as
//     many blocks as that takes, the coefficients read through the cache.
//     Every version that gave such an input fewer blocks, or 8 elements'
//     code a thread, took 1.6-2.2 us against 1.3 (PERF.md);
//   - both: a lazy step: g in [0, 2p) times z < p plus a coefficient is
//     below 2^54, so after one 64-bit shift two folds in 32 bits leave g
//     below 2p again (kernels/plan.py horner_lazy models it); one
//     conditional subtract at the end lands in [0, p).  ~7 instructions a
//     step.

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEpt = 8;                // elements a thread has in flight
constexpr int kMaxDegree = 63;         // coefficients in static smem

// g * z + c reduced to [0, 2p) for g < 2p and z, c < p: the sum is below
// 2^54, so x >> 26 < 2^28 and the first fold stays below 2^31.
__device__ __forceinline__ uint32_t horner_step(uint32_t g, uint32_t z,
                                                uint32_t c) {
  const uint64_t x = (uint64_t)g * z + c;
  const uint32_t y = ((uint32_t)x & kMask26) + 5u * (uint32_t)(x >> 26);
  return (y & kMask26) + 5u * (y >> 26);
}

__device__ __forceinline__ uint32_t lazy_done(uint32_t g) {
  return g >= (uint32_t)kP ? g - (uint32_t)kP : g;
}

// One thread an element (short inputs: blocks * kThreads >= L).
__global__ void __launch_bounds__(kThreads)
poly_eval_short(const int32_t* __restrict__ z,
                const int32_t* __restrict__ coeffs, int degree,
                int32_t* __restrict__ out, int64_t L) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= L) return;
  const uint32_t zi = (uint32_t)__ldg(z + i);
  uint32_t g = (uint32_t)__ldg(coeffs + degree);
  for (int t = degree - 1; t >= 0; --t)
    g = horner_step(g, zi, (uint32_t)__ldg(coeffs + t));
  out[i] = (int32_t)lazy_done(g);
}

// The grid-stride kernel (long inputs): chunks of kEpt * kThreads.
__global__ void __launch_bounds__(kThreads, 8)
poly_eval_long(const int32_t* __restrict__ z,
               const int32_t* __restrict__ coeffs, int degree,
               int32_t* __restrict__ out, int64_t L) {
  __shared__ uint32_t cs[kMaxDegree + 1];
  for (int t = threadIdx.x; t <= degree; t += kThreads) cs[t] = coeffs[t];
  __syncthreads();
  constexpr int64_t kChunk = (int64_t)kThreads * kEpt;
  for (int64_t i0 = (int64_t)blockIdx.x * kChunk + threadIdx.x; i0 < L;
       i0 += (int64_t)gridDim.x * kChunk) {
    uint32_t zv[kEpt], g[kEpt];
#pragma unroll
    for (int u = 0; u < kEpt; ++u) {
      const int64_t i = i0 + u * kThreads;
      zv[u] = i < L ? (uint32_t)__ldg(z + i) : 0u;
      g[u] = cs[degree];
    }
    for (int t = degree - 1; t >= 0; --t) {
      const uint32_t c = cs[t];
#pragma unroll
      for (int u = 0; u < kEpt; ++u) g[u] = horner_step(g[u], zv[u], c);
    }
#pragma unroll
    for (int u = 0; u < kEpt; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < L) out[i] = (int32_t)lazy_done(g[u]);
    }
  }
}

}  // namespace

// z and out (L,) and coeffs (degree + 1,) are contiguous int32; z and
// coeffs in [0, p); L >= 1, 0 <= degree <= 63; `ept` and `blocks` from
// kernels/plan.py poly_launch: ept 1 runs poly_eval_short on blocks
// covering L, ept 8 poly_eval_long.  Returns the launch's
// cudaGetLastError().
extern "C" int repro_poly_eval(const void* z, const void* coeffs, int degree,
                               void* out, int64_t L, int ept, int blocks,
                               void* stream) {
  if (L < 1 || degree < 0 || degree > kMaxDegree || blocks < 1 ||
      (ept != 1 && ept != kEpt) ||
      (ept == 1 && (int64_t)blocks * kThreads < L))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto kern = ept == 1 ? &poly_eval_short : &poly_eval_long;
  kern<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(coeffs),
      degree, static_cast<int32_t*>(out), L);
  return static_cast<int>(cudaGetLastError());
}
