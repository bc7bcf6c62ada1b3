// Field GEMM over F_p, p = 2^26 - 5:  C[b] = (A[b] @ B[b]) mod p.
//
// Replaces the TPU kernels `modmatmul` / `modmatmul_batched`
// (src/repro/kernels/modmatmul.py), which split operands into 7-bit limbs
// and run 16 exact f32 products on the MXU.  Hopper has 64-bit integer
// multiply-add on its CUDA cores, so every kernel here is exact the simple
// way: every product of two field elements is < 2^52, summed in uint64 and
// reduced with reduce_p (field.cuh), never with a 64-bit `%`.
//
// Three kernels, one for each kind of GEMM the port runs; kernels/plan.py
// gemm_path picks one from the shapes and strides.
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
// colsum_kernel (A's M-stride 1 and N <= 16, when the thin path does not
// take the GEMM: X^T y, whose A is the transposed view of the contiguous
// (batch, K = m, M = d) shares, so out[b, :, c] = sum_k X[b, k, :] y[b, k, c]
// is a column sum of X weighted by y).  It reads X once, 5.54 GB at
// cifar10_case2 (1.65 ms at 3.35 TB/s), for 2 IMADs per element and
// class: bytes-bound at N = 1, near the IMAD rate at N = 10 and 16.  The
// work is cut into warp tasks (batch, 32 consecutive columns, a split of
// kc rows of K); kernels/plan.py colsum_launch sizes the splits to give
// the card ~16 waves of tasks and keeps kc <= kNoReduceTerms.  Lane l owns
// column 32 g + l and keeps its N sums as carry-chained uint64 (mac_wide):
// at most kc products, so one reduce_p at the end.  A warp stages 32 rows
// of B in shared memory (lane l loads row l), then issues the loads of up
// to 32 rows of its columns at once -- whole 128-byte lines a row, 4-byte
// words, so rows 4, 8 or 12 bytes off a 16-byte line need no peel -- and
// reads B's rows back as 16-byte broadcasts, N padded to the instance's
// CMAX with zeros.  Each split writes its (batch, M, N) partials < p; a
// second kernel sums the splits in uint64 and reduces (splits = 1 writes
// the output directly).  The gradient body (coded_gradient.cuh) streams
// the same layout, but its ring holds 8 rows of X at d = 3073 and its
// register mode stops at d * C <= 4096 partials: X^T y at C = 10 would take
// its shared-memory mode, at 7% of its bound (PERF.md), and modmatmul's
// library would carry the gradient kernel; a split-K GEMV keeps any N <= 16
// in registers at any M.
//
// tiled_kernel (every other call: a contiguous or strided A with K > 64,
// N > 16, transposed or strided B).  A block of 256 threads owns a BM x BN
// output tile and walks K in BK = 16 slices staged through shared memory;
// each thread keeps a TM x TN register tile of uint64 sums, reduced every
// 2048 terms.  Operands are read through their strides; ragged edges are
// masked, never padded.

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

constexpr int kColsumWarps = 8;              // warp tasks a CTA
constexpr int kColsumThreads = 32 * kColsumWarps;
constexpr int kColsumRows = 32;              // rows of B a warp stages
constexpr int kColsumMaxN = 16;

// The MACs of XB rows of a lane's column: xv[r] times row r of the staged
// B (CS words a row, CMAX of them classes), read as 16-byte broadcasts.
template <int CMAX, int CS, int XB>
__device__ __forceinline__ void colsum_macs(const uint32_t (&xv)[XB],
                                            const uint32_t* ys,
                                            uint32_t (&lo)[CMAX],
                                            uint32_t (&hi)[CMAX]) {
  static_assert(XB * CS % 4 == 0, "rows of B must fill 16-byte words");
  const uint4* yq = reinterpret_cast<const uint4*>(ys);
#pragma unroll
  for (int q = 0; q < XB * CS / 4; ++q) {
    const uint4 v = yq[q];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (4 * q + e) / CS, c = (4 * q + e) % CS;
      if (c < CMAX) mac_wide(lo[c], hi[c], xv[r], w[e]);
    }
  }
}

// Loads rows [r0, r0 + XB) of a lane's column (x points at row 0 of its
// 32-row block); rows at or past `rows` read as zero unless FULL.
template <int XB, bool FULL>
__device__ __forceinline__ void colsum_loads(uint32_t (&xv)[XB],
                                             const int32_t* x, int64_t sak,
                                             int r0, int rows) {
#pragma unroll
  for (int r = 0; r < XB; ++r)
    xv[r] = (FULL || r0 + r < rows) ? (uint32_t)__ldg(x + (r0 + r) * sak)
                                    : 0u;
}

template <int CMAX, int XB, bool FULL>
__device__ __forceinline__ void colsum_block(const int32_t* x, int64_t sak,
                                             const uint32_t (&yl)[CMAX],
                                             uint32_t* ys, int lane, int rows,
                                             uint32_t (&lo)[CMAX],
                                             uint32_t (&hi)[CMAX]) {
  constexpr int CS = CMAX <= 2 ? CMAX : (CMAX + 3) / 4 * 4;
  uint32_t xv[XB];
  colsum_loads<XB, FULL>(xv, x, sak, 0, rows);   // in flight with B's rows
  __syncwarp();                                  // the last block's reads
#pragma unroll
  for (int c = 0; c < CMAX; ++c) ys[lane * CS + c] = yl[c];
#pragma unroll
  for (int c = CMAX; c < CS; ++c) ys[lane * CS + c] = 0u;   // padding
  __syncwarp();
  colsum_macs<CMAX, CS, XB>(xv, ys, lo, hi);
#pragma unroll
  for (int r0 = XB; r0 < kColsumRows; r0 += XB) {
    colsum_loads<XB, FULL>(xv, x, sak, r0, rows);
    colsum_macs<CMAX, CS, XB>(xv, ys + r0 * CS, lo, hi);
  }
}

// One warp task a warp: batch bz, columns [32 g, 32 g + 32), rows
// [s kc, s kc + kc) of K; its N partials (< p) of each column go to
// dst[s, bz, col, :].  Lanes past M re-read column M - 1 (no extra lines)
// and write nothing.
template <int CMAX>
__global__ void __launch_bounds__(kColsumThreads)
colsum_kernel(const int32_t* __restrict__ a, int64_t sab, int64_t sak,
              const int32_t* __restrict__ b, int64_t sbb, int64_t sbk,
              int64_t sbn, uint32_t* __restrict__ dst, int batch, int M,
              int N, int K, int kc, int splits) {
  constexpr int CS = CMAX <= 2 ? CMAX : (CMAX + 3) / 4 * 4;
  constexpr int XB = CMAX <= 2 ? 32 : CMAX <= 4 ? 16 : 8;
  __shared__ __align__(16) uint32_t ys_all[kColsumWarps][kColsumRows * CS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (M + 31) / 32;
  const int64_t task = (int64_t)blockIdx.x * kColsumWarps + warp;
  if (task >= (int64_t)batch * groups * splits) return;
  const int g = (int)(task % groups);
  const int s = (int)(task / groups % splits);
  const int bz = (int)(task / ((int64_t)groups * splits));
  const int col = g * 32 + lane;
  const int k0 = s * kc, k1 = min(K, k0 + kc);
  const int32_t* x = a + bz * sab + min(col, M - 1);
  const int32_t* y = b + bz * sbb;
  uint32_t* ys = ys_all[warp];

  uint32_t lo[CMAX], hi[CMAX];                 // <= kc <= 4096 products
#pragma unroll
  for (int c = 0; c < CMAX; ++c) lo[c] = hi[c] = 0;
  for (int kb = k0; kb < k1; kb += kColsumRows) {
    const int rows = min(kColsumRows, k1 - kb);
    uint32_t yl[CMAX];                           // lane l: row kb + l of B
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      yl[c] = (lane < rows && c < N)
                  ? (uint32_t)__ldg(y + (kb + lane) * sbk + c * sbn) : 0u;
    const int32_t* xb = x + kb * sak;
    if (rows == kColsumRows)
      colsum_block<CMAX, XB, true>(xb, sak, yl, ys, lane, rows, lo, hi);
    else
      colsum_block<CMAX, XB, false>(xb, sak, yl, ys, lane, rows, lo, hi);
  }
  if (col < M) {
    uint32_t* d = dst + (((int64_t)s * batch + bz) * M + col) * N;
#pragma unroll
    for (int c = 0; c < CMAX; ++c)
      if (c < N) d[c] = reduce_p(wide(lo[c], hi[c]));
  }
}

// out[e] = (sum over the splits of part[s, e]) mod p: splits values < p
// summed in uint64.
__global__ void __launch_bounds__(kThreads)
colsum_combine(const uint32_t* __restrict__ part, int32_t* __restrict__ out,
               int64_t L, int splits) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= L) return;
  uint64_t sum = 0;
  for (int s = 0; s < splits; ++s) sum += part[s * L + e];
  out[e] = (int32_t)reduce_p(sum);
}

template <int CMAX>
cudaError_t launch_colsum(const int32_t* a, int64_t sab, int64_t sak,
                          const int32_t* b, int64_t sbb, int64_t sbk,
                          int64_t sbn, int32_t* c, uint32_t* part, int batch,
                          int M, int N, int K, int kc, int splits, int ctas,
                          cudaStream_t stream) {
  uint32_t* dst = splits > 1 ? part : reinterpret_cast<uint32_t*>(c);
  colsum_kernel<CMAX><<<ctas, kColsumThreads, 0, stream>>>(
      a, sab, sak, b, sbb, sbk, sbn, dst, batch, M, N, K, kc, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t L = (int64_t)batch * M * N;
  colsum_combine<<<(unsigned)((L + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(part, c, L, splits);
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

// The same product on colsum_kernel's (cmax) instance, as kernels/plan.py
// colsum_launch decided: splits of kc rows of K over ctas CTAs of 8 warp
// tasks.  part is a (splits, batch, M, N) int32 scratch (unused when
// splits = 1).  Refused unless A's M-stride is 1, 1 <= N <=
// cmax, kc <= kNoReduceTerms (one reduce_p a lane) and the splits and CTAs
// cover K and the tasks exactly.  Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int repro_modmatmul_colsum(const void* a, int64_t sab, int64_t sam,
                                      int64_t sak, const void* b, int64_t sbb,
                                      int64_t sbk, int64_t sbn, void* c,
                                      void* part, int batch, int M, int N,
                                      int K, int cmax, int kc, int splits,
                                      int ctas, void* stream) {
  const int64_t tasks = (int64_t)batch * ((M + 31) / 32) * splits;
  if (sam != 1 || batch < 1 || M < 1 || K < 1 || N < 1 ||
      N > cmax || cmax > kColsumMaxN || kc < 1 || kc > kNoReduceTerms ||
      splits < 1 || (int64_t)splits * kc < K ||
      (int64_t)(splits - 1) * kc >= K || ctas < 1 ||
      (int64_t)ctas * kColsumWarps < tasks ||
      (int64_t)(ctas - 1) * kColsumWarps >= tasks ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int32_t*>(a);
  auto pb = static_cast<const int32_t*>(b);
  auto pc = static_cast<int32_t*>(c);
  auto pp = static_cast<uint32_t*>(part);
  // the instances kernels/plan.py COLSUM_CMAX names
#define COLSUM(CMAX)                                                        \
  if (cmax == CMAX)                                                         \
    return static_cast<int>(launch_colsum<CMAX>(                            \
        pa, sab, sak, pb, sbb, sbk, sbn, pc, pp, batch, M, N, K, kc, splits, \
        ctas, s));
  COLSUM(1) COLSUM(2) COLSUM(4) COLSUM(8) COLSUM(10) COLSUM(16)
#undef COLSUM
  return static_cast<int>(cudaErrorInvalidValue);
}
