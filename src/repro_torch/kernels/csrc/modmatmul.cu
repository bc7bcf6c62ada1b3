// Field GEMM over F_p, p = 2^26 - 5:  C[b] = (A[b] @ B[b]) mod p.
//
// Replaces the TPU kernels `modmatmul` / `modmatmul_batched`
// (src/repro/kernels/modmatmul.py), which split operands into 7-bit limbs
// and run 16 exact f32 products on the MXU.  Hopper has 64-bit integer
// multiply-add on its CUDA cores, so both kernels here are exact the simple
// way: every product of two field elements is < 2^52, summed in uint64 and
// reduced with reduce_p (field.cuh), never with a 64-bit `%`.
//
// Bound on an H100: every GEMM of the main path except X^T y has M <= 64
// and K <= 64 with N in the millions, so it moves ~4 bytes per element of B
// and of C for at most 64 MACs an output: memory-bound, bytes over
// 3.35 TB/s (share X (50,7)@(7,27.7M): 1.89 ms; reconstruct coded X
// (1,8)@(8,138.6M): 1.49 ms).  At K = 17 the MACs alone (two IMADs each at
// 64 a clock per SM) take ~0.3 ms against a 0.22 ms bytes bound, so the MAC
// and the reduction must be cheap.
//
// thin_kernel (M <= 64, 1 <= K <= 64, B's columns unit stride; the launcher
// in kernels/modmatmul.py picks it, its instance and its grid through
// kernels/plan.py gemm_path and thin_launch, and this file only checks
// them against the kernel's bounds).  A
// block stages all of A[b] in shared memory.  Each thread owns COLS columns
// of B strided by the block's width, so a warp's 4-byte loads and stores are
// whole 128-byte lines whatever the row alignment (rows of these B start 8
// or 12 bytes off a 16-byte boundary, so 16-byte vectors are out).  It
// issues all K * COLS loads of its columns before it uses one, then walks
// the M output rows with A read as a shared-memory broadcast; K <= 64
// (kNoReduce58Terms) products sum below 2^58, so each output takes one
// reduce_p58.  KMAX is K itself for the main path's large GEMMs (K = 7
// share, 8 reconstruct, 17 LCC encode) and a bucket (16, 24, 32, 48, 64)
// for every other K, with A and B zero-padded to it, so the MAC loop has no
// guard (a guard on k < K in the unrolled loop made the K = 17 encode much
// slower on an H100); MACs are field.cuh's mac_wide.
// The block syncs after each output row: its warps then write one row at a
// time, and the card's writes stay inside one row's window of DRAM pages
// instead of spreading over all M rows (on an H100 the (50,7)@(7,27.7M)
// share went from 5.75 to 2.57 ms with that and the unguarded MACs).  The grid
// strides over N; the batch is gridDim.y (A's batch stride may be 0); at a
// narrow N the M rows are split in groups over gridDim.z.
//
// tiled_kernel (every other call: X^T y with K = 9019, transposed or
// strided B).  A block of 256 threads owns a BM x BN output tile and walks
// K in BK = 16 slices staged through shared memory; each thread keeps a
// TM x TN register tile of uint64 sums, reduced every 2048 terms.  Operands
// are read through their strides; ragged edges are masked, never padded.

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;
constexpr int kReduceTiles = 2048 / kBK;
constexpr int kThinThreads = 256;
constexpr int kThinMaxM = 64;

template <int KMAX, int COLS>
__global__ void __launch_bounds__(kThinThreads)
thin_kernel(const int32_t* __restrict__ a, int64_t sab, int64_t sam,
            int64_t sak, const int32_t* __restrict__ b, int64_t sbb,
            int64_t sbk, int32_t* __restrict__ c, int M, int N, int K,
            int rows_per_group) {
  constexpr int KS = (KMAX + 3) / 4 * 4;         // A's row stride in smem
  __shared__ __align__(16) uint32_t As[kThinMaxM * KS];
  const int64_t bz = blockIdx.y;
  a += bz * sab;
  b += bz * sbb;
  c += bz * (int64_t)M * N;
  // rows [i0, i1) of the output: all M, or a group when N is too narrow to
  // give every SM its own columns
  const int i0 = blockIdx.z * rows_per_group;
  const int i1 = min(M, i0 + rows_per_group);
  for (int e = threadIdx.x; e < M * KS; e += kThinThreads) {
    const int i = e / KS, k = e % KS;
    As[e] = k < K ? (uint32_t)a[i * sam + k * sak] : 0u;
  }
  __syncthreads();

  constexpr int kCols = kThinThreads * COLS;
  const int64_t step = (int64_t)gridDim.x * kCols;
  for (int64_t base = (int64_t)blockIdx.x * kCols; base < N; base += step) {
    const int64_t n0 = base + threadIdx.x;
    uint32_t bv[COLS][KMAX];                     // zero past K and N
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int64_t n = n0 + j * kThinThreads;
#pragma unroll
      for (int k = 0; k < KMAX; ++k)
        bv[j][k] = (k < K && n < N) ? (uint32_t)__ldg(b + k * sbk + n) : 0u;
    }
    for (int i = i0; i < i1; ++i) {
      uint32_t av[KS];
      const uint4* ar = reinterpret_cast<const uint4*>(As + i * KS);
#pragma unroll
      for (int q = 0; q < KS / 4; ++q) {
        const uint4 v = ar[q];
        av[4 * q] = v.x; av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) mac_wide(lo, hi, av[k], bv[j][k]);
        const int64_t n = n0 + j * kThinThreads;
        if (n < N)
          c[(int64_t)i * N + n] =
              (int32_t)reduce_p58(wide(lo, hi));       // < 64 * 2^52
      }
      __syncthreads();                           // one output row at a time
    }
  }
}

template <int KMAX, int COLS>
cudaError_t launch_thin(const int32_t* a, int64_t sab, int64_t sam,
                        int64_t sak, const int32_t* b, int64_t sbb,
                        int64_t sbk, int32_t* c, int batch, int M, int N,
                        int K, int gx, int groups, int rpg,
                        cudaStream_t stream) {
  thin_kernel<KMAX, COLS>
      <<<dim3(gx, batch, groups), kThinThreads, 0, stream>>>(
          a, sab, sam, sak, b, sbb, sbk, c, M, N, K, rpg);
  return cudaGetLastError();
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const int32_t* __restrict__ a, int64_t sab, int64_t sam,
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
        for (int j = 0; j < TN; ++j) acc[i][j] = reduce_p(acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gm < M && gn < N) c[(int64_t)gm * N + gn] = (int32_t)reduce_p(acc[i][j]);
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_tiled(const int32_t* a, int64_t sab, int64_t sam,
                         int64_t sak, const int32_t* b, int64_t sbb,
                         int64_t sbk, int64_t sbn, int32_t* c, int batch,
                         int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  tiled_kernel<BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      a, sab, sam, sak, b, sbb, sbk, sbn, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// C (batch, M, N) int32 contiguous = A (batch, M, K) @ B (batch, K, N) mod p,
// with A and B int32 in [0, p) addressed by element strides.  kmax > 0
// takes thin_kernel's (kmax, cols) instance on a (gx, batch, groups) grid
// of rpg rows a group, all from kernels/plan.py thin_launch; it is refused
// unless that instance exists, K <= kmax, M <= 64, B's columns are unit
// stride and the groups cover M.  kmax = 0 takes the tiled kernel.
// Returns the launch's cudaGetLastError() as an int (0 = success).
extern "C" int repro_modmatmul(const void* a, int64_t sab, int64_t sam,
                               int64_t sak, const void* b, int64_t sbb,
                               int64_t sbk, int64_t sbn, void* c, int batch,
                               int M, int N, int K, int kmax, int cols,
                               int gx, int groups, int rpg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int32_t*>(a);
  auto pb = static_cast<const int32_t*>(b);
  auto pc = static_cast<int32_t*>(c);
  if (kmax > 0) {
    if (M > kThinMaxM || K < 1 || K > kmax || kmax > kNoReduce58Terms ||
        (sbn != 1 && N != 1) || gx < 1 || groups < 1 || groups > 65535 ||
        rpg < 1 || (int64_t)rpg * groups < M)
      return static_cast<int>(cudaErrorInvalidValue);
    // the instances kernels/plan.py THIN_KMAX names
#define THIN(KMAX, COLS)                                                   \
  if (kmax == KMAX && cols == COLS)                                        \
    return static_cast<int>(launch_thin<KMAX, COLS>(                       \
        pa, sab, sam, sak, pb, sbb, sbk, pc, batch, M, N, K, gx, groups,   \
        rpg, s));
    THIN(7, 4) THIN(8, 4) THIN(16, 4) THIN(17, 2) THIN(24, 2) THIN(32, 2)
    THIN(48, 1) THIN(64, 1)
#undef THIN
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (M <= 16)
    err = launch_tiled<16, 256, 2, 8>(pa, sab, sam, sak, pb, sbb, sbk, sbn,
                                      pc, batch, M, N, K, s);
  else if (N <= 16)
    err = launch_tiled<256, 16, 8, 2>(pa, sab, sam, sak, pb, sbb, sbk, sbn,
                                      pc, batch, M, N, K, s);
  else
    err = launch_tiled<64, 64, 4, 4>(pa, sab, sam, sak, pb, sbb, sbk, sbn,
                                     pc, batch, M, N, K, s);
  return static_cast<int>(err);
}
