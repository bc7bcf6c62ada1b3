// The coded gradient over F_p, p = 2^26 - 5:
//   f[n] = X~[n]^T ghat(X~[n] W~[n])   x (N, m, d), W~ (N, d, C) -> (N, d, C)
//
// Replaces the TPU kernels `coded_gradient`, `coded_gradient_batched` and
// `coded_gradient_matrix` (src/repro/kernels/coded_gradient.py).  The
// gradient is coded_grad_kernel (coded_gradient.cuh, the same body the
// fused step runs: a persistent ring of bulk-copied X~ slices) into a
// uint64 accumulator, then reduce_kernel writes acc mod p as int32.  The
// three entries of kernels/coded_gradient.py are views of this one launch:
// the vector model is C = 1, the single client N = 1.
//
// Bound on an H100: reading X~ once, N * m * d * 4 bytes over 3.35 TB/s
// (554 MB, ~0.17 ms at cifar10_case2, for C = 1 and C = 10 alike); the
// MACs, 2 per X~ element and class, are far below the integer rate.

#include "coded_gradient_cluster.cuh"

namespace {

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const unsigned long long* __restrict__ facc,
              int32_t* __restrict__ f_out, int64_t L) {
  const int64_t e = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (e < L) f_out[e] = (int32_t)reduce_p(facc[e]);
}

}  // namespace

// Resident CTAs of the gradient kernel's (ept, C) instance at `smem` bytes
// (coded_gradient.cuh grad_slots), into *slots.  Returns a cudaError_t.
extern "C" int repro_coded_gradient_slots(int ept, int C, int64_t smem,
                                          int* slots) {
  return static_cast<int>(grad_slots(ept, C, (size_t)smem, slots));
}

// facc must be a zeroed (N, d, C) uint64 buffer; x (N, m, d), w (N, C, d)
// (W~ class-major) and coeffs (degree + 1,) are contiguous int32 in
// [0, p); m >= 1.  bm, stages, mode, ept, sbytes, smem, run and ctas are
// kernels/coded_gradient.py launch_args'.  Returns cudaGetLastError()
// after both launches (0 = success).
extern "C" int repro_coded_gradient(const void* x, const void* w,
                                    const void* coeffs, int degree,
                                    void* facc, void* f_out, int N, int m,
                                    int d, int C, int bm, int stages,
                                    int mode, int ept, int64_t sbytes,
                                    int64_t smem, int run, int ctas,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const GradArgs ga{static_cast<const int32_t*>(x),
                    static_cast<const int32_t*>(w),
                    static_cast<const int32_t*>(coeffs),
                    static_cast<unsigned long long*>(facc),
                    degree, N, m, d, C, bm, stages, mode, sbytes, run};
  cudaError_t err = launch_coded_grad(ga, ept, (size_t)smem, ctas, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t L = (int64_t)N * d * C;
  const unsigned blocks = (unsigned)((L + kReduceThreads - 1) / kReduceThreads);
  reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      static_cast<const unsigned long long*>(facc),
      static_cast<int32_t*>(f_out), L);
  return static_cast<int>(cudaGetLastError());
}

// Resident clusters of k CTAs of the cluster kernel's ept instance (C = 1) at
// `smem` bytes (coded_gradient_cluster.cuh cluster_slots), into *clusters.
extern "C" int repro_coded_gradient_cluster_slots(int ept, int C, int64_t smem,
                                                  int k, int* clusters) {
  return static_cast<int>(cluster_slots(ept, C, (size_t)smem, k, clusters));
}

// The same gradient on cluster_grad_kernel: facc, x, w, coeffs and f_out
// as repro_coded_gradient's; bm, stages, mode, ept, k, cw, slot, smem, run
// and clusters are kernels/coded_gradient.py cluster_args'.  Returns
// cudaGetLastError() after both launches (0 = success).
extern "C" int repro_coded_gradient_cluster(
    const void* x, const void* w, const void* coeffs, int degree, void* facc,
    void* f_out, int N, int m, int d, int C, int bm, int stages, int mode,
    int ept, int k, int cw, int64_t slot, int64_t smem, int run, int clusters,
    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const ClusterArgs ga{static_cast<const int32_t*>(x),
                       static_cast<const int32_t*>(w),
                       static_cast<const int32_t*>(coeffs),
                       static_cast<unsigned long long*>(facc),
                       degree, N, m, d, bm, stages, mode, k, cw, slot, run};
  if (C != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_cluster_grad(ga, ept, (size_t)smem, clusters, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t L = (int64_t)N * d * C;
  const unsigned blocks = (unsigned)((L + kReduceThreads - 1) / kReduceThreads);
  reduce_kernel<<<blocks, kReduceThreads, 0, s>>>(
      static_cast<const unsigned long long*>(facc),
      static_cast<int32_t*>(f_out), L);
  return static_cast<int>(cudaGetLastError());
}
