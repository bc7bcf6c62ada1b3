// One COPML Phase 3+4 step (post model-encode) over F_p, p = 2^26 - 5.
//
// Replaces the TPU kernel `fused_step` (src/repro/kernels/fused_step.py).
// On the TPU one pallas_call walks a sequential (client, row block) grid:
// f accumulates over row blocks in VMEM, `common` over clients, and the
// protocol epilogue runs at the last grid step.  Hopper runs blocks in
// parallel and in no order, so the step is two kernels:
//
//   coded_grad_kernel    (coded_gradient.cuh) persistent CTAs walk strips
//                        of X~ slices through a ring filled by
//                        cp.async.bulk; each slice is used for both
//                        z = X~ W~ and f[n] += X~^T ghat(z); partials go to a
//                        uint64 (N, d, C) accumulator once per client a
//                        strip touches.
//   fused_epilogue_kernel  a block per 32 model elements, 8 warps over the
//                          N clients / holders (coalesced rows of the (N, L)
//                          operands, shared-memory sums across warps):
//                          f = acc mod p (written out), common =
//                          sum_n dfull[n] * (f[n] + adv_off[n]); for every
//                          holder h: xtg, grad, * q_eta, + radd; the masked
//                          open c = sum_h rvec[h] * c_sh[h], its low k1 bits
//                          minus r0sh, * inv(2^k1), w' = wsh - delta.
//
// Past d ~ 58 K one row of X~ no longer fits a block's shared memory, and
// the step takes one of two routes (kernels/plan.py gradient_route): the
// cluster route, repro_fused_step_cluster, where cluster_grad_kernel
// (coded_gradient_cluster.cuh) spreads each row over a thread-block
// cluster and reads X~ once, then the same epilogue; or, past the
// cluster's reach, the wide route: the gradient f comes from modmatmul's
// row-dot and column-sum kernels and poly_eval as int32 values < p, and
// repro_fused_epilogue runs the same epilogue on it (the int32 instance,
// which reads f and writes no copy).
//
// Bound on an H100: reading X~ once (N * m * d * 4 bytes, 554 MB at the
// paper's cifar10_case2 shape) over 3.35 TB/s, ~0.17 ms; the epilogue's
// ~6 MB add ~2 us.  Every sum is of canonical values < p and products
// < 2^52, bounded well inside uint64, and reduced with reduce_p.

#include "coded_gradient_cluster.cuh"

namespace {

constexpr int kEpiLanes = 32;
constexpr int kEpiWarps = 8;

// f[n] mod p from the gradient kernel's uint64 accumulator, or as it is
// from the wide route's int32 gradient (already < p).
__device__ __forceinline__ uint32_t grad_at(const unsigned long long* f,
                                            int64_t i) {
  return reduce_p(f[i]);
}
__device__ __forceinline__ uint32_t grad_at(const int32_t* f, int64_t i) {
  return (uint32_t)f[i];
}

// F = unsigned long long: facc is the accumulator, f_out gets f mod p;
// F = int32_t: facc is f itself and f_out is unused.
template <typename F>
__global__ void __launch_bounds__(kEpiLanes * kEpiWarps)
fused_epilogue_kernel(const F* __restrict__ facc,
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
  __shared__ uint32_t red[kEpiWarps][kEpiLanes];
  const int lane = threadIdx.x % kEpiLanes, warp = threadIdx.x / kEpiLanes;
  const int64_t e = (int64_t)blockIdx.x * kEpiLanes + lane;
  const bool ok = e < L;

  // common = sum_n dfull[n] * (f[n] + adv_off[n]); N / 8 <= 128 terms a warp
  uint64_t common = 0;
  if (ok) {
    for (int n = warp; n < N; n += kEpiWarps) {
      const uint32_t f = grad_at(facc, n * L + e);
      if (sizeof(F) == 8) f_out[n * L + e] = (int32_t)f;
      common += (uint64_t)addp(f, (uint32_t)adv_off[n]) * (uint32_t)dfull[n];
    }
  }
  red[warp][lane] = reduce_p(common);
  __syncthreads();
  uint32_t sum = 0;
#pragma unroll
  for (int w = 0; w < kEpiWarps; ++w) sum += red[w][lane];   // < 8p
  const uint32_t com = reduce_p(sum);
  __syncthreads();

  uint64_t copen = 0;
  if (ok) {
    for (int h = warp; h < N; h += kEpiWarps) {
      const uint32_t xtg = addp((uint32_t)base[h * L + e], com);
      const uint32_t scaled = mulp(subp(xtg, (uint32_t)xty[h * L + e]), q_eta);
      const uint32_t c_sh = addp(scaled, (uint32_t)radd[h * L + e]);
      copen += (uint64_t)(uint32_t)rvec[h] * c_sh;
    }
  }
  red[warp][lane] = reduce_p(copen);
  __syncthreads();
  sum = 0;
#pragma unroll
  for (int w = 0; w < kEpiWarps; ++w) sum += red[w][lane];
  const uint32_t c0 = reduce_p(sum) & ((1u << k1) - 1u);

  if (ok) {
    for (int h = warp; h < N; h += kEpiWarps) {
      const uint32_t xtg = addp((uint32_t)base[h * L + e], com);
      const uint32_t scaled = mulp(subp(xtg, (uint32_t)xty[h * L + e]), q_eta);
      const uint32_t a0 = subp(c0, (uint32_t)r0sh[h * L + e]);
      const uint32_t delta = mulp(subp(scaled, a0), inv2k1);
      w_out[h * L + e] = (int32_t)subp((uint32_t)wsh[h * L + e], delta);
    }
  }
}

// The epilogue on the gradient kernels' uint64 accumulator: f = facc mod p
// into f_out, then the step.  Returns cudaGetLastError().
int launch_epilogue(void* facc, const void* adv_off, const void* dfull,
                    const void* rvec, const void* base, const void* xty,
                    const void* wsh, const void* radd, const void* r0sh,
                    void* f_out, void* w_out, int N, int d, int C,
                    int64_t q_eta, int64_t inv2k1, int k1, cudaStream_t s) {
  const int64_t L = (int64_t)d * C;
  const unsigned epi_blocks = (unsigned)((L + kEpiLanes - 1) / kEpiLanes);
  fused_epilogue_kernel<unsigned long long>
      <<<epi_blocks, kEpiLanes * kEpiWarps, 0, s>>>(
      static_cast<const unsigned long long*>(facc),
      static_cast<const int32_t*>(adv_off), static_cast<const int32_t*>(dfull),
      static_cast<const int32_t*>(rvec), static_cast<const int32_t*>(base),
      static_cast<const int32_t*>(xty), static_cast<const int32_t*>(wsh),
      static_cast<const int32_t*>(radd), static_cast<const int32_t*>(r0sh),
      static_cast<int32_t*>(f_out), static_cast<int32_t*>(w_out), N, L,
      (uint32_t)q_eta, (uint32_t)inv2k1, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Resident CTAs of the gradient kernel's (ept, C) instance at `smem` bytes
// (coded_gradient.cuh grad_slots), into *slots.  Returns a cudaError_t.
extern "C" int repro_fused_step_slots(int ept, int C, int64_t smem,
                                      int* slots) {
  return static_cast<int>(grad_slots(ept, C, (size_t)smem, slots));
}

// facc must be a zeroed (N, d, C) uint64 buffer; every other operand is
// contiguous int32 in [0, p) (see src/repro_torch/kernels/fused_step.py);
// w is W~ class-major (N, C, d); bm, stages, mode, ept, sbytes, smem, run
// and ctas are kernels/coded_gradient.py launch_args'.  Returns
// cudaGetLastError() after both launches (0 = success).
extern "C" int repro_fused_step(const void* x, const void* w,
                                const void* coeffs, int degree,
                                const void* adv_off, const void* dfull,
                                const void* rvec, const void* base,
                                const void* xty, const void* wsh,
                                const void* radd, const void* r0sh,
                                void* facc, void* f_out, void* w_out, int N,
                                int m, int d, int C, int bm, int stages,
                                int mode, int ept, int64_t sbytes,
                                int64_t smem, int run, int ctas,
                                int64_t q_eta, int64_t inv2k1, int k1,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const GradArgs ga{static_cast<const int32_t*>(x),
                    static_cast<const int32_t*>(w),
                    static_cast<const int32_t*>(coeffs),
                    static_cast<unsigned long long*>(facc),
                    degree, N, m, d, C, bm, stages, mode, sbytes, run};
  cudaError_t err = launch_coded_grad(ga, ept, (size_t)smem, ctas, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_epilogue(facc, adv_off, dfull, rvec, base, xty, wsh, radd,
                         r0sh, f_out, w_out, N, d, C, q_eta, inv2k1, k1, s);
}

// Resident clusters of k CTAs of the cluster kernel's ept instance (C = 1) at
// `smem` bytes (coded_gradient_cluster.cuh cluster_slots), into *clusters.
extern "C" int repro_fused_step_cluster_slots(int ept, int C, int64_t smem,
                                              int k, int* clusters) {
  return static_cast<int>(cluster_slots(ept, C, (size_t)smem, k, clusters));
}

// The same step with the gradient on cluster_grad_kernel; operands as
// repro_fused_step's, and bm, stages, mode, ept, k, cw, slot, smem, run and
// clusters kernels/coded_gradient.py cluster_args'.  Returns
// cudaGetLastError() after both launches (0 = success).
extern "C" int repro_fused_step_cluster(
    const void* x, const void* w, const void* coeffs, int degree,
    const void* adv_off, const void* dfull, const void* rvec,
    const void* base, const void* xty, const void* wsh, const void* radd,
    const void* r0sh, void* facc, void* f_out, void* w_out, int N, int m,
    int d, int C, int bm, int stages, int mode, int ept, int k, int cw,
    int64_t slot, int64_t smem, int run, int clusters, int64_t q_eta,
    int64_t inv2k1, int k1, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ClusterArgs ga{static_cast<const int32_t*>(x),
                       static_cast<const int32_t*>(w),
                       static_cast<const int32_t*>(coeffs),
                       static_cast<unsigned long long*>(facc),
                       degree, N, m, d, bm, stages, mode, k, cw, slot, run};
  if (C != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_cluster_grad(ga, ept, (size_t)smem, clusters, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_epilogue(facc, adv_off, dfull, rvec, base, xty, wsh, radd,
                         r0sh, f_out, w_out, N, d, C, q_eta, inv2k1, k1, s);
}

// The epilogue alone, on a gradient f (N, d, C) of int32 values < p that
// the wide route computed; the other operands as repro_fused_step's.
// Refused unless 1 <= N <= 1024, d, C >= 1 and 0 < k1 < 26.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int repro_fused_epilogue(const void* f, const void* adv_off,
                                    const void* dfull, const void* rvec,
                                    const void* base, const void* xty,
                                    const void* wsh, const void* radd,
                                    const void* r0sh, void* w_out, int N,
                                    int d, int C, int64_t q_eta,
                                    int64_t inv2k1, int k1, void* stream) {
  if (N < 1 || N > 1024 || d < 1 || C < 1 || k1 < 1 || k1 > 25)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t L = (int64_t)d * C;
  const unsigned epi_blocks = (unsigned)((L + kEpiLanes - 1) / kEpiLanes);
  fused_epilogue_kernel<int32_t>
      <<<epi_blocks, kEpiLanes * kEpiWarps, 0,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f), static_cast<const int32_t*>(adv_off),
      static_cast<const int32_t*>(dfull), static_cast<const int32_t*>(rvec),
      static_cast<const int32_t*>(base), static_cast<const int32_t*>(xty),
      static_cast<const int32_t*>(wsh), static_cast<const int32_t*>(radd),
      static_cast<const int32_t*>(r0sh), nullptr,
      static_cast<int32_t*>(w_out), N, L, (uint32_t)q_eta, (uint32_t)inv2k1,
      k1);
  return static_cast<int>(cudaGetLastError());
}
