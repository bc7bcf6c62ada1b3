// Field GEMM over F_p, p = 2^26 - 5:  C[b] = (A[b] @ B[b]) mod p.
//
// Replaces the TPU kernels `modmatmul` / `modmatmul_batched`
// (src/repro/kernels/modmatmul.py), which split operands into 7-bit limbs
// and run 16 exact f32 products on the MXU.  Hopper has 64-bit integer
// multiply-add on its CUDA cores, so this first version is exact the simple
// way: every product of two field elements is < 2^52, accumulated in
// uint64 and reduced mod p every 2048 terms (2048 * 2^52 + p < 2^64).
//
// Tiling: a block of 256 threads owns a BM x BN output tile and walks K in
// BK = 16 slices staged through shared memory; each thread keeps a TM x TN
// register tile of uint64 accumulators.  Rows and columns of a thread's
// tile are strided by the thread grid, so neighbouring threads store
// neighbouring columns.  Three tile shapes cover the path's GEMMs:
//   M <= 16  (reconstruct rows, decode rows)    16 x 256
//   N <= 16  (X^T y, one column per class)     256 x 16
//   else     (Shamir share, LCC encode)         64 x 64
// Operands are addressed through strides (batch, row, column), so a
// transposed or broadcast view is read in place; each tile load walks the
// operand's unit-stride axis across neighbouring threads.  Ragged M/N/K
// edges are masked, never padded: the share GEMM has K = 7 and N = 27.7M.
//
// Bound on an H100: the path's GEMMs have K <= 17 except X^T y, so they
// move ~4 bytes per output and per input element with a few MACs each --
// memory-bound (bytes / 3.35 TB/s).  int8-limb tensor-core MMA is the
// later redesign for GEMMs with a long K.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = 67108859ull;
constexpr int kThreads = 256;
constexpr int kBK = 16;
constexpr int kReduceTiles = 2048 / kBK;

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
modmatmul_kernel(const int32_t* __restrict__ a, int64_t sab, int64_t sam,
                 int64_t sak, const int32_t* __restrict__ b, int64_t sbb,
                 int64_t sbk, int64_t sbn, int32_t* __restrict__ c, int M,
                 int N, int K) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  static_assert(TX * TY == kThreads, "tile shape must use 256 threads");
  __shared__ uint32_t As[kBK][BM];
  __shared__ uint32_t Bs[kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int64_t bz = blockIdx.z;
  a += bz * sab;
  b += bz * sbb;
  c += bz * (int64_t)M * N;

  const bool a_m_fast = (sam == 1);
  const bool b_n_fast = (sbn == 1) || (sbk != 1);

  uint64_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  int tiles = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      int mm, kk;
      if (a_m_fast) { mm = e % BM; kk = e / BM; }
      else          { kk = e % kBK; mm = e / kBK; }
      const int gm = m0 + mm, gk = k0 + kk;
      As[kk][mm] = (gm < M && gk < K) ? (uint32_t)a[gm * sam + gk * sak] : 0u;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      int kk, nn;
      if (b_n_fast) { nn = e % BN; kk = e / BN; }
      else          { kk = e % kBK; nn = e / kBK; }
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? (uint32_t)b[gk * sbk + gn * sbn] : 0u;
    }
    __syncthreads();
    const int kmax = min(kBK, K - k0);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      if (kk < kmax) {
        uint32_t av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * TY];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += (uint64_t)av[i] * bv[j];
      }
    }
    __syncthreads();
    if (++tiles == kReduceTiles) {
      tiles = 0;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] %= kP;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gm < M && gn < N) c[(int64_t)gm * N + gn] = (int32_t)(acc[i][j] % kP);
    }
  }
}

template <int BM, int BN, int TM, int TN>
void launch(const int32_t* a, int64_t sab, int64_t sam, int64_t sak,
            const int32_t* b, int64_t sbb, int64_t sbk, int64_t sbn,
            int32_t* c, int batch, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  modmatmul_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      a, sab, sam, sak, b, sbb, sbk, sbn, c, M, N, K);
}

}  // namespace

// C (batch, M, N) int32 contiguous = A (batch, M, K) @ B (batch, K, N) mod p,
// with A and B int32 in [0, p) addressed by element strides.  Returns the
// launch's cudaGetLastError() as an int (0 = success).
extern "C" int repro_modmatmul(const void* a, int64_t sab, int64_t sam,
                               int64_t sak, const void* b, int64_t sbb,
                               int64_t sbk, int64_t sbn, void* c, int batch,
                               int M, int N, int K, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int32_t*>(a);
  auto pb = static_cast<const int32_t*>(b);
  auto pc = static_cast<int32_t*>(c);
  if (M <= 16)
    launch<16, 256, 2, 8>(pa, sab, sam, sak, pb, sbb, sbk, sbn, pc, batch, M,
                          N, K, s);
  else if (N <= 16)
    launch<256, 16, 8, 2>(pa, sab, sam, sak, pb, sbb, sbk, sbn, pc, batch, M,
                          N, K, s);
  else
    launch<64, 64, 4, 4>(pa, sab, sam, sak, pb, sbb, sbk, sbn, pc, batch, M,
                         N, K, s);
  return static_cast<int>(cudaGetLastError());
}
