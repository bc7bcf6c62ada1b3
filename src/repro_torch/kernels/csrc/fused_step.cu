// One COPML Phase 3+4 step (post model-encode) over F_p, p = 2^26 - 5.
//
// Replaces the TPU kernel `fused_step` (src/repro/kernels/fused_step.py).
// On the TPU one pallas_call walks a sequential (client, row block) grid:
// f accumulates over row blocks in VMEM, `common` over clients, and the
// protocol epilogue runs at the last grid step.  Hopper runs blocks in
// parallel and in no order, so the step is two kernels:
//
//   coded_grad_kernel    (coded_gradient.cuh) grid (row blocks, clients).
//                        A block stages its (bm, d) slice of X~[n] in
//                        shared memory ONCE and uses it for both z = X~ W~
//                        and f[n] += X~^T ghat(z); reduced partials go to a
//                        uint64 (N, d, C) accumulator by integer atomicAdd.
//   fused_epilogue_kernel  one thread per model element (j, c):
//                          f = acc mod p (written out), common =
//                          sum_n dfull[n] * (f[n] + adv_off[n]); then for
//                          every holder h: xtg, grad, * q_eta, + radd; the
//                          masked open c = sum_h rvec[h] * c_sh[h], its low
//                          k1 bits minus r0sh, * inv(2^k1), w' = wsh - delta.
//
// Bound on an H100: reading X~ once (N * m * d * 4 bytes, 554 MB at the
// paper's cifar10_case2 shape) over 3.35 TB/s, ~0.17 ms; the MACs (2 per
// X~ element and class) are far below the integer rate.  Every sum is of
// canonical values < p and products < 2^52, bounded well inside uint64.

#include "coded_gradient.cuh"

namespace {

constexpr int kEpiThreads = 256;

__global__ void __launch_bounds__(kEpiThreads)
fused_epilogue_kernel(const unsigned long long* __restrict__ facc,
                      const int32_t* __restrict__ adv_off,
                      const int32_t* __restrict__ dfull,
                      const int32_t* __restrict__ rvec,
                      const int32_t* __restrict__ base,
                      const int32_t* __restrict__ xty,
                      const int32_t* __restrict__ wsh,
                      const int32_t* __restrict__ radd,
                      const int32_t* __restrict__ r0sh,
                      int32_t* __restrict__ f_out, int32_t* __restrict__ w_out,
                      int N, int64_t L, uint32_t q_eta, uint32_t inv2k1,
                      int k1) {
  const int64_t e = (int64_t)blockIdx.x * kEpiThreads + threadIdx.x;
  if (e >= L) return;

  uint64_t common = 0;                      // N <= 1024 terms < 2^52
  for (int n = 0; n < N; ++n) {
    const uint32_t f = (uint32_t)(facc[n * L + e] % kP);
    f_out[n * L + e] = (int32_t)f;
    common += (uint64_t)addp(f, (uint32_t)adv_off[n]) * (uint32_t)dfull[n];
  }
  const uint32_t com = (uint32_t)(common % kP);

  uint64_t copen = 0;
  for (int h = 0; h < N; ++h) {
    const uint32_t xtg = addp((uint32_t)base[h * L + e], com);
    const uint32_t scaled = mulp(subp(xtg, (uint32_t)xty[h * L + e]), q_eta);
    const uint32_t c_sh = addp(scaled, (uint32_t)radd[h * L + e]);
    copen += (uint64_t)(uint32_t)rvec[h] * c_sh;
  }
  const uint32_t c0 = (uint32_t)(copen % kP) & ((1u << k1) - 1u);

  for (int h = 0; h < N; ++h) {
    const uint32_t xtg = addp((uint32_t)base[h * L + e], com);
    const uint32_t scaled = mulp(subp(xtg, (uint32_t)xty[h * L + e]), q_eta);
    const uint32_t a0 = subp(c0, (uint32_t)r0sh[h * L + e]);
    const uint32_t delta = mulp(subp(scaled, a0), inv2k1);
    w_out[h * L + e] = (int32_t)subp((uint32_t)wsh[h * L + e], delta);
  }
}

}  // namespace

// facc must be a zeroed (N, d, C) uint64 buffer; every other operand is
// contiguous int32 in [0, p) (see src/repro_torch/kernels/fused_step.py).
// Returns cudaGetLastError() after both launches (0 = success).
extern "C" int repro_fused_step(const void* x, const void* w,
                                const void* coeffs, int degree,
                                const void* adv_off, const void* dfull,
                                const void* rvec, const void* base,
                                const void* xty, const void* wsh,
                                const void* radd, const void* r0sh,
                                void* facc, void* f_out, void* w_out, int N,
                                int m, int d, int C, int bm, int64_t q_eta,
                                int64_t inv2k1, int k1, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_coded_grad(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(coeffs), degree,
      static_cast<unsigned long long*>(facc), N, m, d, C, bm, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t L = (int64_t)d * C;
  const unsigned epi_blocks = (unsigned)((L + kEpiThreads - 1) / kEpiThreads);
  fused_epilogue_kernel<<<epi_blocks, kEpiThreads, 0, s>>>(
      static_cast<const unsigned long long*>(facc),
      static_cast<const int32_t*>(adv_off), static_cast<const int32_t*>(dfull),
      static_cast<const int32_t*>(rvec), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(xty), static_cast<const int32_t*>(wsh),
      static_cast<const int32_t*>(radd), static_cast<const int32_t*>(r0sh),
      static_cast<int32_t*>(f_out), static_cast<int32_t*>(w_out), N, L,
      (uint32_t)q_eta, (uint32_t)inv2k1, k1);
  return static_cast<int>(cudaGetLastError());
}
