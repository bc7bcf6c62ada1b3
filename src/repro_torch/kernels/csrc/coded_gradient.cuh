// The coded gradient f[n] = X~[n]^T ghat(X~[n] W~[n]) over F_p, accumulated
// into a uint64 (N, d, C) buffer.  Shared by the coded-gradient kernels
// (coded_gradient.cu) and the fused COPML step (fused_step.cu).
//
// coded_grad_kernel, grid (row blocks, clients).  A block stages its
// (bm, d) slice of X~[n] in shared memory ONCE and uses it for both
// products:
//   z = X~_blk @ W~[n]        one warp per (row, class) output; each lane
//                             reduces its uint64 sum every 2048 products
//   g = ghat(z)               Horner in registers, lane 0
//   f[n] += X~_blk^T g        one thread per (j, c), a sum of bm <= 64
//                             products < 2^52
// The block's partials, reduced below p, go into the accumulator with
// integer atomicAdd: exact and independent of block order.  Ragged m is
// masked (the last block has fewer rows), never padded.  The accumulator
// holds at most ceil(m / bm) partials < p per element: below 2^64 for any
// m < 2^37.

#pragma once

#include "field.cuh"

namespace {

constexpr int kGradThreads = 256;

__global__ void __launch_bounds__(kGradThreads)
coded_grad_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                  const int32_t* __restrict__ coeffs, int degree,
                  unsigned long long* __restrict__ facc, int m, int d, int C,
                  int bm) {
  extern __shared__ uint32_t smem[];
  uint32_t* xs = smem;                      // (bm, d) slice of X~[n]
  uint32_t* gs = smem + (int64_t)bm * d;    // (bm, C) ghat(z)

  const int n = blockIdx.y;
  const int r0 = blockIdx.x * bm;
  const int rows = min(bm, m - r0);
  const int32_t* xb = x + ((int64_t)n * m + r0) * d;
  const int32_t* wn = w + (int64_t)n * d * C;
  const int total = rows * d;
  for (int e = threadIdx.x; e < total; e += kGradThreads) xs[e] = (uint32_t)xb[e];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int kWarps = kGradThreads / 32;
  for (int o = warp; o < rows * C; o += kWarps) {
    const int i = o / C, cc = o % C;
    const uint32_t* xrow = xs + (int64_t)i * d;
    uint64_t acc = 0;
    int terms = 0;
    for (int j = lane; j < d; j += 32) {
      acc += (uint64_t)xrow[j] * (uint32_t)wn[(int64_t)j * C + cc];
      if (++terms == 2048) { acc %= kP; terms = 0; }
    }
    acc %= kP;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, (unsigned long long)acc, off);
    if (lane == 0) gs[i * C + cc] = horner(coeffs, degree, (uint32_t)(acc % kP));
  }
  __syncthreads();

  unsigned long long* fn = facc + (int64_t)n * d * C;
  for (int e = threadIdx.x; e < d * C; e += kGradThreads) {
    const int j = e / C, cc = e % C;
    uint64_t acc = 0;
    for (int i = 0; i < rows; ++i)
      acc += (uint64_t)xs[(int64_t)i * d + j] * gs[i * C + cc];
    atomicAdd(fn + e, (unsigned long long)(acc % kP));
  }
}

// Launch coded_grad_kernel on a zeroed facc; x (N, m, d), w (N, d, C),
// contiguous int32 in [0, p); bm <= 64 rows per block.
cudaError_t launch_coded_grad(const int32_t* x, const int32_t* w,
                              const int32_t* coeffs, int degree,
                              unsigned long long* facc, int N, int m, int d,
                              int C, int bm, cudaStream_t s) {
  const size_t smem = ((size_t)bm * d + (size_t)bm * C) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      coded_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((m + bm - 1) / bm, N);
  coded_grad_kernel<<<grid, kGradThreads, smem, s>>>(x, w, coeffs, degree,
                                                     facc, m, d, C, bm);
  return cudaGetLastError();
}

}  // namespace
