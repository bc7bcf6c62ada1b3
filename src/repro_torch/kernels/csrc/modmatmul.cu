// Field GEMM over F_p, p = 2^26 - 5:  C[b] = (A[b] @ B[b]) mod p.
//
// Replaces the TPU kernels `modmatmul` / `modmatmul_batched`
// (src/repro/kernels/modmatmul.py), which split operands into 7-bit limbs
// and run 16 exact f32 products on the MXU.  Hopper has 64-bit integer
// multiply-add on its CUDA cores, so every kernel here is exact the simple
// way: every product of two field elements is < 2^52, summed in uint64 and
// reduced with reduce_p (field.cuh), never with a 64-bit `%`.
//
// Five kernels, one for each kind of GEMM the port runs; kernels/plan.py
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
// rowdot_kernel (A's K-stride 1 and N <= 16, when the thin and column-sum
// paths do not take the GEMM: the MPC baseline's Z = X W, a contiguous
// (16, 3006, 3073) share tensor times (16, 3073, C'), C' = 1 or 10).  It
// reads A once, 591 MB at cifar10_case2 (0.177 ms at 3.35 TB/s), for 2
// IMADs per element and class: bytes-bound at C' = 1, near the IMAD rate
// at C' = 10.  A GEMV a row: a CTA stages B[b] class-major in shared memory
// (12 KB at C' = 1, 123 KB at C' = 10; in chunks of K past a block's
// shared memory) and walks a strip of rows of one batch (kernels/plan.py
// rowdot_launch deals the resident CTAs evenly over the batches); each warp
// sums RB rows at once, its lanes on consecutive columns with 4-byte loads
// of 16 words a lane in flight -- rows 4, 8 or 12 bytes off a 16-byte line
// need no peel -- and each staged word of B serves RB MACs.  A lane sums at
// most kch / 32 <= kNoReduceTerms products, reduces once with reduce_p, and
// a multi-value butterfly (field.cuh multi_warp_sum) sums the warp's
// RB x CMAX values.  A chunk of K past the first adds into the output.
// When M x batch would leave the card idle (a sharded rank's serving scores
// (B, 3073) @ (3073, 13): one CTA walked all of K at B = 1), kernels/plan.py
// rowdot_launch also cuts K over gridDim.z into splits of ks rows (a
// multiple of 32): each split writes (batch, M, N) partials < p and
// colsum_combine sums them, as for the split-K kernel.
//
// splitk_kernel (M <= 128, K > 64 and B's columns unit stride, when no path
// above takes it: serving's (B, 3073) @ (3073, 50) scores, B <= 128).  So
// few output tiles would leave one or two CTAs to walk all of K, so K is
// cut in splits of kc rows (kernels/plan.py splitk_launch: enough splits
// for ~2 CTAs an SM, 49 of 64 rows at K = 3073).  A CTA stages its (M, 64) slab
// of A in shared memory (32 KB at M = 128), each thread keeps 64 rows of
// one column of B in registers (coalesced loads) and walks its row group's
// outputs with A read as a 16-byte broadcast: 64 products < 2^58, one
// reduce_p58 an output a pass, added mod p across the split's passes.  Each
// split writes (splits, batch, M, N) partials < p; colsum_combine sums them
// and reduces once.
//
// tiled_kernel (every other call: N > 16 with M > 128, or a strided B with
// K > 64).  A block of 256 threads owns a BM x BN output tile and walks K
// in BK = 16 slices staged through shared memory, rows padded by two words
// so that a K-contiguous operand's stores (16 consecutive threads on one
// column) fall in 32 banks; each thread keeps a TM x TN register tile of
// uint64 sums, reduced every 2048 terms.  Operands are read through their
// strides; ragged edges are masked, never padded.

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;
constexpr int kReduceTiles = 2048 / kBK;
constexpr int kPad = 2;        // tiled rows: 16 k x 2 m of a warp, 32 banks
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

constexpr int kRowdotThreads = 512;
constexpr int kRowdotWarps = kRowdotThreads / 32;
constexpr int kRowdotMaxN = 16;
constexpr int kRowdotMaxChunk = 32 * kNoReduceTerms;   // kch / 32 terms
constexpr int kSmemMax = 232448;                       // a block's, H100

constexpr int pow2_at_least(int x) {
  int v = 1;
  while (v < x) v *= 2;
  return v;
}

// rowdot_kernel's register shape for an instance: RB rows a warp (so a
// staged word of B serves RB MACs); U 32-column steps of loads a loop step,
// RB * U words a lane: 16 issued after a step's few MACs at CMAX <= 2, or
// 8 prefetched a step ahead (PF) while the MACs of CMAX > 2 classes run
// (on an H100 the prefetch took Z = X W at C = 10 from 0.49 to 0.43 ms and
// at C = 1 from 0.21-0.24 to 0.25 ms); V values of the butterfly (RB *
// CMAX padded to a power of two).
template <int CMAX>
struct RowdotShape {
  static constexpr int RB = CMAX <= 2 ? 4 : CMAX <= 10 ? 2 : 1;
  static constexpr bool PF = CMAX > 2;
  static constexpr int U = (PF ? 8 : 16) / RB;
  static constexpr int V = pow2_at_least(RB * CMAX);
  static_assert(V <= 32, "a warp's butterfly sums at most 32 values");
};

// Words j, j + 32, ..., j + 32 (U - 1) of RB rows (zero past kn or a row
// past the strip).
template <int U, int RB>
__device__ __forceinline__ void rowdot_loads(uint32_t (&xv)[U][RB],
                                             const int32_t* const (&xr)[RB],
                                             const bool (&ok)[RB], int j,
                                             int kn) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int r = 0; r < RB; ++r)
      xv[u][r] = (ok[r] && j + 32 * u < kn)
                     ? (uint32_t)__ldg(xr[r] + j + 32 * u) : 0u;
}

// Rows [blockIdx.x * run, + run) of batch blockIdx.y (with SPLIT, rows
// [blockIdx.z * ks, + ks) of K into c's split blockIdx.z; an instance of
// its own, as the split's arithmetic cost the unsplit kernel 8 registers
// and 45% of its time at CMAX = 10 on an H100); B[b] staged class-major as
// bs[c * kch + k], classes past N zero.
template <int CMAX, bool SPLIT>
__global__ void __launch_bounds__(kRowdotThreads)
rowdot_kernel(const int32_t* __restrict__ a, int64_t sab, int64_t sam,
              const int32_t* __restrict__ b, int64_t sbb, int64_t sbk,
              int64_t sbn, int32_t* __restrict__ c, int M, int N, int K,
              int kch, int run, int ks) {
  constexpr int RB = RowdotShape<CMAX>::RB;
  constexpr int U = RowdotShape<CMAX>::U;
  constexpr int V = RowdotShape<CMAX>::V;
  constexpr bool PF = RowdotShape<CMAX>::PF;
  extern __shared__ __align__(16) uint32_t bs[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t bz = blockIdx.y;
  const int r0 = blockIdx.x * run, r1 = min(M, r0 + run);
  const int32_t* ab = a + bz * sab;
  const int32_t* bb = b + bz * sbb;
  int32_t* cb = c + bz * M * N;
  if (SPLIT) {              // this split's rows of K, as a GEMM of its own
    const int64_t klo = (int64_t)blockIdx.z * ks;
    ab += klo;
    bb += klo * sbk;
    cb += (int64_t)blockIdx.z * gridDim.y * M * N;
    K = (int)min((int64_t)K - klo, (int64_t)ks);
  }

  for (int k0 = 0; k0 < K; k0 += kch) {
    const int kn = min(kch, K - k0);
    __syncthreads();                             // the last chunk's reads
    for (int e = threadIdx.x; e < CMAX * kn; e += kRowdotThreads) {
      const int k = e / CMAX, cl = e % CMAX;
      bs[cl * kch + k] =
          cl < N ? (uint32_t)__ldg(bb + (int64_t)(k0 + k) * sbk + cl * sbn)
                 : 0u;
    }
    __syncthreads();
    for (int i0 = r0 + warp * RB; i0 < r1; i0 += kRowdotWarps * RB) {
      const int32_t* xr[RB];
      bool ok[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        ok[r] = i0 + r < r1;
        xr[r] = ab + (int64_t)(ok[r] ? i0 + r : i0) * sam + k0;
      }
      uint32_t lo[RB][CMAX], hi[RB][CMAX];       // <= kch / 32 products
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int cl = 0; cl < CMAX; ++cl) lo[r][cl] = hi[r][cl] = 0;
      uint32_t xv[U][RB], xn[U][RB];
      rowdot_loads<U, RB>(xv, xr, ok, lane, kn);
      for (int j = lane; j < kn; j += 32 * U) {
        if (PF) rowdot_loads<U, RB>(xn, xr, ok, j + 32 * U, kn);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int jj = j + 32 * u;
          if (jj < kn) {
#pragma unroll
            for (int cl = 0; cl < CMAX; ++cl) {
              const uint32_t w = bs[cl * kch + jj];
#pragma unroll
              for (int r = 0; r < RB; ++r)
                mac_wide(lo[r][cl], hi[r][cl], xv[u][r], w);
            }
          }
        }
        if (PF) {
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int r = 0; r < RB; ++r) xv[u][r] = xn[u][r];
        } else {
          rowdot_loads<U, RB>(xv, xr, ok, j + 32 * U, kn);
        }
      }
      uint32_t v[V];
#pragma unroll
      for (int q = RB * CMAX; q < V; ++q) v[q] = 0u;
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int cl = 0; cl < CMAX; ++cl)
          v[r * CMAX + cl] = reduce_p(wide(lo[r][cl], hi[r][cl]));
      const uint32_t sum = multi_warp_sum<V>(v, lane);     // < 32 p
      const int idx = multi_sum_index<V>(lane);
      const int i = i0 + idx / CMAX, cl = idx % CMAX;
      if (lane % (32 / V) == 0 && idx < RB * CMAX && i < r1 && cl < N) {
        int32_t* o = cb + (int64_t)i * N + cl;
        const uint32_t z = reduce_p(sum);
        *o = (int32_t)(k0 == 0 ? z : addp((uint32_t)*o, z));
      }
    }
  }
}

// Opens rowdot_kernel<CMAX>'s dynamic shared memory to at least `smem`
// bytes.  The attribute costs host time, so it is set only when an
// instance needs more than it was opened to (one card per process).
template <int CMAX>
cudaError_t open_rowdot(size_t smem) {
  static size_t opened = 0;
  if (smem <= opened) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      rowdot_kernel<CMAX, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(rowdot_kernel<CMAX, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess) opened = smem;
  return err;
}

template <int CMAX>
cudaError_t launch_rowdot(const int32_t* a, int64_t sab, int64_t sam,
                          const int32_t* b, int64_t sbb, int64_t sbk,
                          int64_t sbn, int32_t* c, uint32_t* part, int batch,
                          int M, int N, int K, int kch, int run, int cpb,
                          int splits, int ks, size_t smem,
                          cudaStream_t stream) {
  cudaError_t err = open_rowdot<CMAX>(smem);
  if (err != cudaSuccess) return err;
  if (splits == 1) {
    rowdot_kernel<CMAX, false><<<dim3(cpb, batch), kRowdotThreads, smem,
                                 stream>>>(a, sab, sam, b, sbb, sbk, sbn, c,
                                           M, N, K, kch, run, ks);
    return cudaGetLastError();
  }
  rowdot_kernel<CMAX, true>
      <<<dim3(cpb, batch, splits), kRowdotThreads, smem, stream>>>(
      a, sab, sam, b, sbb, sbk, sbn, reinterpret_cast<int32_t*>(part), M, N,
      K, kch, run, ks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t L = (int64_t)batch * M * N;
  colsum_combine<<<(unsigned)((L + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(part, c, L, splits);
  return cudaGetLastError();
}

// SMs x resident CTAs of rowdot_kernel<CMAX> at `smem` bytes.
template <int CMAX>
cudaError_t rowdot_slots(size_t smem, int* slots) {
  cudaError_t err = open_rowdot<CMAX>(smem);
  if (err != cudaSuccess) return err;
  int occ = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, rowdot_kernel<CMAX, false>, kRowdotThreads, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *slots = sms * occ;
  return err;
}

constexpr int kSplitkThreads = 256;
constexpr int kSplitkMaxM = 128;
constexpr int kSplitkSub = kNoReduce58Terms;   // rows of K a pass

// Split s = blockIdx.x / gx of K (rows [s kc, s kc + kc)), columns
// [(blockIdx.x % gx) bn, + bn) of batch blockIdx.y; blockDim.x = bn * row
// groups.  Its partials (< p) go to dst[s, b, :, columns].
__global__ void __launch_bounds__(kSplitkThreads)
splitk_kernel(const int32_t* __restrict__ a, int64_t sab, int64_t sam,
              int64_t sak, const int32_t* __restrict__ b, int64_t sbb,
              int64_t sbk, int64_t sbn, uint32_t* __restrict__ dst,
              int batch, int M, int N, int K, int kc, int bn, int gx) {
  __shared__ __align__(16) uint32_t As[kSplitkMaxM * kSplitkSub];
  const int tid = threadIdx.x, groups = blockDim.x / bn;
  const int s = blockIdx.x / gx;
  const int col = (blockIdx.x % gx) * bn + tid % bn, rg = tid / bn;
  const bool live = col < N;
  const int64_t bz = blockIdx.y;
  const int k_lo = s * kc, k_hi = min(K, k_lo + kc);
  a += bz * sab;
  b += bz * sbb;
  dst += ((int64_t)s * batch + bz) * M * N;

  for (int k0 = k_lo; k0 < k_hi; k0 += kSplitkSub) {
    const int kn = min(kSplitkSub, k_hi - k0);
    uint32_t bv[kSplitkSub];                     // zero past kn and N
#pragma unroll
    for (int k = 0; k < kSplitkSub; ++k)
      bv[k] = (live && k < kn)
                  ? (uint32_t)__ldg(b + (int64_t)(k0 + k) * sbk + col * sbn)
                  : 0u;
    __syncthreads();                             // the last pass's reads
    for (int e = tid; e < M * kSplitkSub; e += blockDim.x) {
      const int i = e / kSplitkSub, k = e % kSplitkSub;
      As[e] = k < kn ? (uint32_t)a[i * sam + (int64_t)(k0 + k) * sak] : 0u;
    }
    __syncthreads();
    if (!live) continue;
    for (int i = rg; i < M; i += groups) {
      const uint4* ar = reinterpret_cast<const uint4*>(As + i * kSplitkSub);
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int q = 0; q < kSplitkSub / 4; ++q) {
        const uint4 v = ar[q];
        mac_wide(lo, hi, v.x, bv[4 * q]);
        mac_wide(lo, hi, v.y, bv[4 * q + 1]);
        mac_wide(lo, hi, v.z, bv[4 * q + 2]);
        mac_wide(lo, hi, v.w, bv[4 * q + 3]);
      }
      const uint32_t z = reduce_p58(wide(lo, hi));  // < 64 * 2^52
      uint32_t* o = dst + (int64_t)i * N + col;
      *o = k0 == k_lo ? z : addp(*o, z);
    }
  }
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
  __shared__ uint32_t As[kBK][BM + kPad];
  __shared__ uint32_t Bs[kBK][BN + kPad];

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

// The same product on rowdot_kernel's (cmax) instance, as kernels/plan.py
// rowdot_launch decided: B staged kch rows of K at a time in smem bytes,
// strips of run rows, cpb CTAs a batch, K cut into splits of ks rows; part
// is a (splits, batch, M, N) int32 scratch (unused when splits = 1) that
// colsum_combine sums into c.  Refused unless A's K-stride is 1,
// 1 <= N <= cmax, kch covers at most kRowdotMaxChunk rows (a lane's
// kch / 32 <= kNoReduceTerms products) and fits smem, and the strips cover
// M and the splits K exactly.  Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int repro_modmatmul_rowdot(const void* a, int64_t sab, int64_t sam,
                                      int64_t sak, const void* b, int64_t sbb,
                                      int64_t sbk, int64_t sbn, void* c,
                                      void* part, int batch, int M, int N,
                                      int K, int cmax, int kch, int run,
                                      int cpb, int splits, int ks,
                                      int64_t smem, void* stream) {
  if (sak != 1 || batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1 ||
      N > cmax || cmax > kRowdotMaxN || kch < 1 || kch > ks ||
      kch > kRowdotMaxChunk || smem < (int64_t)4 * cmax * kch ||
      smem > kSmemMax || run < 1 || cpb < 1 || (int64_t)run * cpb < M ||
      (int64_t)run * (cpb - 1) >= M || splits < 1 || splits > 65535 ||
      ks < 1 || (int64_t)splits * ks < K || (int64_t)(splits - 1) * ks >= K ||
      (splits > 1 && (ks % 32 != 0 || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const int32_t*>(a);
  auto pb = static_cast<const int32_t*>(b);
  auto pc = static_cast<int32_t*>(c);
  auto pp = static_cast<uint32_t*>(part);
  // the instances kernels/plan.py ROWDOT_CMAX names
#define ROWDOT(CMAX)                                                        \
  if (cmax == CMAX)                                                         \
    return static_cast<int>(launch_rowdot<CMAX>(                            \
        pa, sab, sam, pb, sbb, sbk, sbn, pc, pp, batch, M, N, K, kch, run,  \
        cpb, splits, ks, (size_t)smem, s));
  ROWDOT(1) ROWDOT(2) ROWDOT(4) ROWDOT(8) ROWDOT(10) ROWDOT(16)
#undef ROWDOT
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident CTAs of rowdot_kernel's (cmax) instance at smem bytes of
// dynamic shared memory, SMs x CTAs an SM, into *slots;
// kernels/plan.py rowdot_launch deals them over the batches.
extern "C" int repro_modmatmul_rowdot_slots(int cmax, int64_t smem,
                                            int* slots) {
  if (smem < 0 || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
#define ROWDOT(CMAX)                                                        \
  if (cmax == CMAX)                                                         \
    return static_cast<int>(rowdot_slots<CMAX>((size_t)smem, slots));
  ROWDOT(1) ROWDOT(2) ROWDOT(4) ROWDOT(8) ROWDOT(10) ROWDOT(16)
#undef ROWDOT
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same product on splitk_kernel, as kernels/plan.py splitk_launch
// decided: splits of kc rows of K, gx column blocks of bn columns, bn * rg
// threads a CTA; part is a (splits, batch, M, N) int32 scratch (unused
// when splits = 1) that colsum_combine sums into c.  Refused unless
// 1 <= M <= 128, bn is a multiple of 32 with bn * rg <= 256, the column
// blocks cover N and the splits cover K exactly, with kc <= kNoReduceTerms.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int repro_modmatmul_splitk(const void* a, int64_t sab, int64_t sam,
                                      int64_t sak, const void* b, int64_t sbb,
                                      int64_t sbk, int64_t sbn, void* c,
                                      void* part, int batch, int M, int N,
                                      int K, int bn, int rg, int gx, int kc,
                                      int splits, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || M > kSplitkMaxM || K < 1 ||
      N < 1 || bn < 32 || bn % 32 != 0 || rg < 1 ||
      bn * rg > kSplitkThreads || gx < 1 || (int64_t)gx * bn < N ||
      (int64_t)(gx - 1) * bn >= N || kc < 1 || kc > kNoReduceTerms ||
      splits < 1 || (int64_t)splits * kc < K ||
      (int64_t)(splits - 1) * kc >= K ||
      (int64_t)gx * splits > 0x7fffffff || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  uint32_t* dst = splits > 1 ? static_cast<uint32_t*>(part)
                             : static_cast<uint32_t*>(c);
  splitk_kernel<<<dim3(gx * splits, batch), bn * rg, 0, s>>>(
      static_cast<const int32_t*>(a), sab, sam, sak,
      static_cast<const int32_t*>(b), sbb, sbk, sbn, dst, batch, M, N, K, kc,
      bn, gx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t L = (int64_t)batch * M * N;
  colsum_combine<<<(unsigned)((L + kThreads - 1) / kThreads), kThreads, 0,
                   s>>>(static_cast<const uint32_t*>(part),
                        static_cast<int32_t*>(c), L, splits);
  return static_cast<int>(cudaGetLastError());
}
