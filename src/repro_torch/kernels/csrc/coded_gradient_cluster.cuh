// The coded gradient f[n] = X~[n]^T ghat(X~[n] w~[n]) of a (d,) model on
// thread-block clusters, for d past the widest row of X~ one block's shared
// memory holds (kernels/plan.py max_d: 58,004).  Shared by the
// coded-gradient kernels (coded_gradient.cu) and the fused COPML step
// (fused_step.cu), which both run it where kernels/plan.py gradient_route
// says "cluster" (C = 1; a (d, C) model takes the wide route: on an H100 a
// cluster kernel with C classes ran 6x slower than it at C = 10, PERF.md).
//
// Replaces, past that d, the gradient body of the TPU kernels `fused_step`
// (src/repro/kernels/fused_step.py) and `coded_gradient[_batched]`
// (src/repro/kernels/coded_gradient.py), which touch X~ exactly once at any
// d by chunking the contraction over d in VMEM.
//
// Bound on an H100: reading X~ once, N * m * d * 4 bytes over 3.35 TB/s
// (2.045 GB, 0.61 ms at N = 50, m = 156, d = 65,536); 4 IMADs an element of
// X~ are far below the integer rate.
//
// A cluster of k CTAs (cudaLaunchKernelEx with a cluster dimension; k = 16
// only after cudaFuncAttributeNonPortableClusterSizeAllowed) shares every
// row: rank r holds columns [r cw, min(d, (r+1) cw)), cw a multiple of 4
// words.  The clusters are persistent, one strip of consecutive slices
// (bm rows of one client) each, and the k ranks of a cluster walk the same
// strip in step.  kernels/plan.py cluster_plan decides k, cw, bm, the ring
// depth and the accumulator mode; cluster_slots reports the resident
// clusters the strip split needs (cudaOccupancyMaxActiveClusters).
//   copies   A row's segment is contiguous but rows are not, so a ring
//            stage takes one cp.async.bulk per row segment on the stage's
//            mbarrier, and w~[n]'s segment (read by every row of pass 1:
//            from global memory its loads' latency would set the pace)
//            goes into a buffer of its own.  Each segment is
//            rounded out to 16-byte ends
//            inside its tensor (its view sits at that offset in its slot);
//            words outside the tensor's 16-byte-aligned span go by plain
//            loads.  At odd d every row starts only 4-byte aligned, so
//            tensor maps (d % 4 == 0) are not used.
//   pass 1   z's partial over the rank's own columns in blocks of 8, 4, 2
//            or 1 rows (each staged word of w~ serves a block's rows; a
//            lane sums ceil(cw / 16 / 32) products, one reduce_p), summed
//            over the 16 warps and reduced: one value < p a row.  Thread q
//            stores them into rank q's shared memory (distributed shared
//            memory) and arrives on rank q's mbarrier for the slice's
//            parity (release at cluster scope; k arrivals complete it).
//   ghat     after its mbarrier's wait (acquire at cluster scope) each CTA
//            sums the k partials (< k p < 2^30), reduces once and
//            evaluates ghat on its own copy.
//   pipeline slice t's wait comes one pass 2 after its arrivals:
//            iteration t waits for slice t's partials, evaluates ghat(t),
//            runs pass 1 of slice t + 1 and sends it, then pass 2 of slice
//            t, so the exchange's latency hides behind pass 2 and a rank
//            that runs late stalls the others less.  The partial buffers
//            are double-buffered by slice parity: a rank writes slice
//            t + 1's partials only after slice t's wait, which needs every
//            rank's slice-t arrivals, sent after it read slice t - 1's.
//   producer a 17th warp issues every copy, so no compute thread waits on
//            the copy engine: ring stages on full / empty mbarriers,
//            up to `stages` slices ahead (three: slices t and t + 1
//            resident, t + 2 in flight; two where three do not fit), and
//            w~[n]'s segment into one of two buffers when the strip enters
//            a client.
//   pass 2   f[n] += X~^T g on the rank's columns, in reg mode (the raw
//            uint64 sums of a thread's ept columns across the strip,
//            reduced every 4095 rows) or smem mode (reduced uint32
//            partials, a slice's bm <= 64 products by reduce_p58), added to
//            the uint64 accumulator when the strip leaves a client.
//   exit     a last cluster barrier: no CTA leaves while a peer may still
//            touch its shared memory.  A wait that never ends traps
//            (bar_wait, bar_wait_cluster).
// Every sum is exact mod p, so f equals the body's and the wide route's bit
// for bit.

#pragma once

#include <cooperative_groups.h>

#include "coded_gradient.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kClusterPortable = 8;
constexpr int kClusterMax = 16;

struct ClusterArgs {
  const int32_t* x;            // (N, m, d)
  const int32_t* w;            // w~: (N, d)
  const int32_t* coeffs;       // (degree + 1,)
  unsigned long long* facc;    // (N, d), zeroed
  int degree, N, m, d, bm, stages, mode;
  int k, cw;                   // cluster size, columns a rank owns
  int64_t slot;                // one row segment in a stage (plan.slot_bytes)
  int run;                     // slices in a cluster's strip (plan.strip_run)
};

// Pass 1 of RB rows: lane sums over the warp's columns [j0, j1) of the
// rank's segment, w~'s segment in shared memory, reduced once with
// reduce_p, summed over the warp, left in zs[(r0 + i) * 16 + warp].
template <int RB>
__device__ __forceinline__ void cluster_pass1(const uint32_t* (&xr)[RB],
                                              const uint32_t* ws, uint32_t* zs,
                                              int r0, int j0, int j1, int warp,
                                              int lane) {
  uint32_t lo[RB] = {}, hi[RB] = {};
  for (int j = j0 + lane; j < j1; j += 32) {
    const uint32_t wv = ws[j];
#pragma unroll
    for (int r = 0; r < RB; ++r) mac_wide(lo[r], hi[r], xr[r][j], wv);
  }
  uint32_t v[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) v[r] = reduce_p(wide(lo[r], hi[r]));
  const uint32_t sum = multi_warp_sum<RB>(v, lane);
  constexpr int kSpan = 32 / RB;                 // lanes per value
  if (lane % kSpan == 0)
    zs[(r0 + multi_sum_index<RB>(lane)) * kGradWarps + warp] = reduce_p(sum);
}

constexpr int kClusterThreads = kGradThreads + 32;   // + the producer warp
constexpr int kClusterBarBytes = 128;                // its 2 S + 6 mbarriers

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 512 compute threads' barrier (named barrier 1; the producer warp
// does not take part).
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kGradThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Arrive on rank `rank`'s copy of the mbarrier `bar`, releasing this
// thread's earlier stores to the cluster.
__device__ __forceinline__ void bar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(remote) : "memory");
}

// bar_wait with cluster-scope acquire: peers' stores released by their
// arrivals are visible after it.  Traps rather than hang.
__device__ __forceinline__ void bar_wait_cluster(uint64_t* bar,
                                                 uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

template <int EPT>
__global__ void __launch_bounds__(kClusterThreads)
cluster_grad_kernel(ClusterArgs ga) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = ga.k, rank = (int)cluster.block_rank();
  const int d = ga.d, m = ga.m, bm = ga.bm, S = ga.stages;
  const int c0r = rank * ga.cw;                  // this rank's first column
  const int wr = min(ga.cw, d - c0r);            // and its width (>= 1)
  const int64_t slot = ga.slot, sbytes = slot * bm;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // stage landed
  uint64_t* empty = full + S;                    // stage consumed
  uint64_t* wfull = empty + S;                   // w~ buffer landed (2)
  uint64_t* wempty = wfull + 2;                  // w~ buffer consumed (2)
  uint64_t* zfull = wempty + 2;                  // k ranks' partials (2)
  unsigned char* ring = smem + kClusterBarBytes;
  unsigned char* wbuf = ring + S * sbytes;       // two w~ segments
  uint32_t* zs = reinterpret_cast<uint32_t*>(wbuf + 2 * slot);  // (bm, 16)
  uint32_t* gs = zs + bm * kGradWarps;           // (bm,) ghat(z)
  uint32_t* zx = gs + bm;                        // [2][k][bm] partials
  uint32_t* part = zx + 2 * k * bm;              // (wr,), smem mode

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int spb = (m + bm - 1) / bm;
  const int64_t total = (int64_t)ga.N * spb;
  // this cluster's strip: slices [s0, s0 + cnt)
  const int64_t s0 = (int64_t)(blockIdx.x / k) * ga.run;
  const int cnt = (int)(total - s0 < ga.run ? total - s0 : ga.run);
  const uintptr_t xb = reinterpret_cast<uintptr_t>(ga.x);
  const uintptr_t xe = xb + (uintptr_t)ga.N * m * d * 4;
  const uintptr_t wb = reinterpret_cast<uintptr_t>(ga.w);
  const uintptr_t we = wb + (uintptr_t)ga.N * d * 4;
  const int64_t step = (int64_t)d * 4;           // bytes between rows

  if (tid == 0) {
    for (int b = 0; b < 2 * S + 4; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&full[b])) : "memory");
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_u32(&zfull[b])), "r"(k) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __shared__ int32_t coeffs[kMaxDegree + 1];
  for (int t = tid; t <= ga.degree; t += kClusterThreads)
    coeffs[t] = ga.coeffs[t];
  if (EPT == 0)
    for (int j = tid; j < wr; j += kClusterThreads) part[j] = 0;
  __syncthreads();
  cluster_sync_all();                            // peers' zfull initialised

  // local slice t: its client, row count, and its first row's segment
  auto slice = [&](int t, int* n, int* rows) -> uintptr_t {
    const int64_t s = s0 + t;
    *n = (int)(s / spb);
    const int r0 = (int)(s % spb) * bm;
    *rows = min(bm, m - r0);
    return xb + (((uintptr_t)*n * m + r0) * d + c0r) * 4;
  };
  // w~[n]'s segment: its first byte in global memory
  auto wseg = [&](int n) -> uintptr_t {
    return wb + ((uintptr_t)n * d + c0r) * 4;
  };

  if (warp == kGradWarps) {                      // the producer warp
    if (lane != 0) return;
    // a segment [as, as + 4 wr) of the tensor [tb, te) into `dst`,
    // rounded out to 16-byte ends inside the tensor: the words outside its
    // 16-byte-aligned span by plain loads (bulk false; returns the bytes
    // left for the bulk copy), or the bulk copies
    auto copy_seg = [&](unsigned char* dst, uintptr_t as, uintptr_t tb,
                        uintptr_t te, uint64_t* bar, bool bulk) -> uint32_t {
      const uintptr_t ae = as + (uintptr_t)wr * 4;
      const uintptr_t g0 = as & ~(uintptr_t)15;
      const uintptr_t inlo = (tb + 15) & ~(uintptr_t)15;
      const uintptr_t inhi = te & ~(uintptr_t)15;
      const uintptr_t ce = (ae + 15) & ~(uintptr_t)15;
      uintptr_t lo = g0 > inlo ? g0 : inlo;
      uintptr_t hi = ce < inhi ? ce : inhi;
      if (hi <= lo) lo = hi = ae;                // all words by plain loads
      const uint32_t body = (uint32_t)(hi - lo);
      if (!bulk) {
        for (uintptr_t a = as; a < lo && a < ae; a += 4)
          *reinterpret_cast<uint32_t*>(dst + (a - g0)) =
              *reinterpret_cast<const uint32_t*>(a);
        for (uintptr_t a = hi > as ? hi : as; a < ae; a += 4)
          *reinterpret_cast<uint32_t*>(dst + (a - g0)) =
              *reinterpret_cast<const uint32_t*>(a);
        return body;
      }
      for (uint32_t off = 0; off < body; off += kCopyChunk)
        bulk_copy(dst + (lo - g0) + off,
                  reinterpret_cast<const void*>(lo + off),
                  body - off < kCopyChunk ? body - off : kCopyChunk, bar);
      return 0;
    };
    int nprev = -1, ci = 0;                      // clients entered so far
    for (int t = 0; t < cnt; ++t) {
      int n, rows;
      const uintptr_t a0 = slice(t, &n, &rows);
      if (n != nprev) {                          // w~[n] into buffer ci & 1
        const int b = ci & 1;
        if (ci >= 2) bar_wait(&wempty[b], (uint32_t)(((ci - 2) >> 1) & 1));
        unsigned char* dst = wbuf + b * slot;
        bar_arrive_tx(&wfull[b], copy_seg(dst, wseg(n), wb, we, nullptr,
                                          false));
        copy_seg(dst, wseg(n), wb, we, &wfull[b], true);
        nprev = n;
        ++ci;
      }
      const int st = t % S;
      if (t >= S) bar_wait(&empty[st], (uint32_t)((t / S - 1) & 1));
      unsigned char* stage = ring + st * sbytes;
      uint32_t bytes = 0;
      for (int i = 0; i < rows; ++i)
        bytes += copy_seg(stage + i * slot, a0 + (uintptr_t)(i * step), xb,
                          xe, nullptr, false);
      bar_arrive_tx(&full[st], bytes);
      for (int i = 0; i < rows; ++i)
        copy_seg(stage + i * slot, a0 + (uintptr_t)(i * step), xb, xe,
                 &full[st], true);
    }
    return;
  }

  // row i of the slice in stage st, whose first row's segment starts at a0
  auto xrow = [&](int st, uintptr_t a0, int i) -> const uint32_t* {
    return reinterpret_cast<const uint32_t*>(
        ring + st * sbytes + i * slot + ((a0 + (uintptr_t)(i * step)) & 15));
  };

  // pass 1 of local slice t, its partials into every rank, remote arrivals
  const int dq = (wr + kGradWarps - 1) / kGradWarps;
  const int j0 = warp * dq, j1 = min(wr, j0 + dq);
  int ci = -1;                                   // client index in the strip
  auto front = [&](int t) {
    int n, rows, np = -1, rp;
    const uintptr_t a0 = slice(t, &n, &rows);
    if (t > 0) slice(t - 1, &np, &rp);
    if (n != np) {
      ++ci;
      bar_wait(&wfull[ci & 1], (uint32_t)((ci >> 1) & 1));
    }
    const int st = t % S;
    bar_wait(&full[st], (uint32_t)((t / S) & 1));
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(
        wbuf + (ci & 1) * slot + (wseg(n) & 15));
    for (int r0 = 0; r0 < rows;) {
      const int rem = rows - r0;
      if (rem >= 8) {
        const uint32_t* xr[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) xr[r] = xrow(st, a0, r0 + r);
        cluster_pass1<8>(xr, ws, zs, r0, j0, j1, warp, lane);
        r0 += 8;
      } else if (rem >= 4) {
        const uint32_t* xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xr[r] = xrow(st, a0, r0 + r);
        cluster_pass1<4>(xr, ws, zs, r0, j0, j1, warp, lane);
        r0 += 4;
      } else if (rem >= 2) {
        const uint32_t* xr[2] = {xrow(st, a0, r0), xrow(st, a0, r0 + 1)};
        cluster_pass1<2>(xr, ws, zs, r0, j0, j1, warp, lane);
        r0 += 2;
      } else {
        const uint32_t* xr[1] = {xrow(st, a0, r0)};
        cluster_pass1<1>(xr, ws, zs, r0, j0, j1, warp, lane);
        r0 += 1;
      }
    }
    compute_sync();
    int nn = -1, rn;
    if (t + 1 < cnt) slice(t + 1, &nn, &rn);
    if (tid == 0 && nn != n) bar_arrive(&wempty[ci & 1]);  // w~ consumed
    uint32_t* zp = zx + (t & 1) * k * bm + rank * bm;
    for (int i = tid; i < rows; i += kGradThreads) {
      uint32_t z = 0;
#pragma unroll
      for (int q = 0; q < kGradWarps; ++q) z += zs[i * kGradWarps + q];
      zp[i] = reduce_p(z);
    }
    compute_sync();
    if (tid < k) {                               // thread q serves rank q
      uint32_t* dst = cluster.map_shared_rank(zp, tid);
      for (int i = 0; i < rows; ++i) dst[i] = zp[i];
      bar_arrive_remote(&zfull[t & 1], tid);
    }
  };

  // reg mode: thread tid keeps columns tid + j * kGradThreads of the rank
  constexpr int R = EPT > 0 ? EPT : 1;
  uint32_t lo[R], hi[R];
#pragma unroll
  for (int j = 0; j < R; ++j) lo[j] = hi[j] = 0;
  int terms = 0;

  front(0);
  for (int t = 0; t < cnt; ++t) {
    int n, rows;
    const uintptr_t a0 = slice(t, &n, &rows);
    const int st = t % S;
    bar_wait_cluster(&zfull[t & 1], (uint32_t)((t >> 1) & 1));
    const uint32_t* zp = zx + (t & 1) * k * bm;
    for (int i = tid; i < rows; i += kGradThreads) {
      uint32_t z = 0;                            // < k p < 2^30
      for (int q = 0; q < k; ++q) z += zp[q * bm + i];
      gs[i] = horner(coeffs, ga.degree, reduce_p(z));
    }
    compute_sync();
    if (t + 1 < cnt) front(t + 1);

    // pass 2: f[n] += X~^T g over the rank's columns
    unsigned long long* fn = ga.facc + (int64_t)n * d + c0r;
    if (EPT > 0) {
      if (terms + rows >= kNoReduceTerms) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          lo[j] = reduce_p(wide(lo[j], hi[j]));
          hi[j] = 0;
        }
        terms = 1;
      }
      terms += rows;
      for (int i = 0; i < rows; ++i) {
        const uint32_t* xr = xrow(st, a0, i);
        const uint32_t g = gs[i];
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (tid + j * kGradThreads < wr)
            mac_wide(lo[j], hi[j], xr[tid + j * kGradThreads], g);
      }
    } else {
      for (int j = tid; j < wr; j += kGradThreads) {
        uint32_t slo = 0, shi = 0;
        for (int i = 0; i < rows; ++i)           // rows <= 64 products
          mac_wide(slo, shi, xrow(st, a0, i)[j], gs[i]);
        part[j] = addp(part[j], reduce_p58(wide(slo, shi)));
      }
    }

    // the strip leaves client n: its partials go to the accumulator
    if (t + 1 == cnt || (s0 + t + 1) / spb != n) {
      if (EPT > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (tid + j * kGradThreads < wr)
            atomicAdd(fn + tid + j * kGradThreads,
                      (unsigned long long)reduce_p(wide(lo[j], hi[j])));
          lo[j] = hi[j] = 0;
        }
        terms = 0;
      } else {
        for (int j = tid; j < wr; j += kGradThreads) {
          atomicAdd(fn + j, (unsigned long long)part[j]);
          part[j] = 0;
        }
      }
    }
    compute_sync();                              // stage t and gs consumed
    if (tid == 0) bar_arrive(&empty[st]);
  }
  cluster_sync_all();                            // peers done with our smem
}

using ClusterKernel = void (*)(ClusterArgs);

// The instance for `ept` register partials a thread (0: smem mode), or
// null.
inline ClusterKernel cluster_kernel(int ept) {
  switch (ept) {
    case 0: return &cluster_grad_kernel<0>;
    case 1: return &cluster_grad_kernel<1>;
    case 2: return &cluster_grad_kernel<2>;
    case 4: return &cluster_grad_kernel<4>;
    case 8: return &cluster_grad_kernel<8>;
    default: return nullptr;
  }
}

// Opens an instance's dynamic shared memory to `smem` bytes and, for a
// cluster of more than 8 CTAs, the non-portable cluster sizes.  Set again
// only when an instance's size changes (one card per process).
inline cudaError_t open_cluster(ClusterKernel kern, size_t smem, int k) {
  static ClusterKernel kerns[10];
  static size_t sizes[10];
  static bool nonport_ok[10];
  int i = 0;
  while (i < 10 && kerns[i] != nullptr && kerns[i] != kern) ++i;
  if (i == 10) return cudaErrorInvalidValue;
  const bool nonport = k > kClusterPortable;
  if (kerns[i] == kern && sizes[i] == smem && (nonport_ok[i] || !nonport))
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && nonport)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    kerns[i] = kern;
    sizes[i] = smem;
    nonport_ok[i] = nonport_ok[i] || nonport;
  }
  return err;
}

inline cudaLaunchConfig_t cluster_config(int k, unsigned grid, size_t smem,
                                         cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of k CTAs of the ept instance (C = 1) resident on the card at
// `smem` bytes (cudaOccupancyMaxActiveClusters: a GPC holds only whole
// clusters).  kernels/plan.py strip_run cuts the slices into that many
// strips.
inline cudaError_t cluster_slots(int ept, int C, size_t smem, int k,
                                 int* clusters) {
  const ClusterKernel kern = cluster_kernel(ept);
  if (kern == nullptr || C != 1 || k < 1 || k > kClusterMax)
    return cudaErrorInvalidValue;
  cudaError_t err = open_cluster(kern, smem, k);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(k, (unsigned)k, smem, 0, attr);
  err = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  if (err == cudaSuccess && *clusters < 1) return cudaErrorInvalidConfiguration;
  return err;
}

// Launch cluster_grad_kernel on a zeroed facc as kernels/coded_gradient.py
// cluster_args decided (plan.cluster_plan and plan.strip_run).  x (N, m, d)
// and w (N, d) contiguous int32 in [0, p), m >= 1.  Refuses a launch whose
// parameters break the kernel's bounds or do not fit its layout; a cluster
// launch the card refuses returns its error (no other route).
cudaError_t launch_cluster_grad(const ClusterArgs& ga, int ept, size_t smem,
                                int clusters, cudaStream_t s) {
  const int64_t total = (int64_t)ga.N * ((ga.m + ga.bm - 1) / ga.bm);
  // barriers, the ring, two w~ segments, z partials, ghat(z), the ranks'
  // partials twice, smem-mode partials
  const int64_t layout = kClusterBarBytes + ((int64_t)ga.stages * ga.bm + 2) *
                         ga.slot + (int64_t)4 * ga.bm * (kGradWarps + 1) +
                         (int64_t)8 * ga.k * ga.bm +
                         (ga.mode == kModeSmem ? 4 * (int64_t)ga.cw : 0);
  if (ga.k < 2 || ga.k > kClusterMax || (ga.k & (ga.k - 1)) != 0 ||
      ga.cw < 4 || ga.cw % 4 != 0 || (int64_t)ga.cw * ga.k < ga.d ||
      (int64_t)ga.cw * (ga.k - 1) >= ga.d || ga.bm < 1 ||
      ga.bm > kNoReduce58Terms || ga.stages < 2 || ga.stages > 3 ||
      ga.degree < 0 || ga.degree > kMaxDegree ||
      (ga.mode != kModeReg && ga.mode != kModeSmem) ||
      (ga.mode == kModeReg) != (ept > 0) ||
      (int64_t)ept * kGradThreads < (ga.mode == kModeReg ? ga.cw : 0) ||
      ((int64_t)(ga.cw + kGradWarps - 1) / kGradWarps + 31) / 32 >=
          kNoReduceTerms ||
      ga.slot % 16 != 0 || ga.slot < (int64_t)4 * ga.cw + kCopySlack ||
      (int64_t)smem < layout || ga.run < 1 || clusters < 1 ||
      (int64_t)clusters * ga.run < total ||
      (int64_t)(clusters - 1) * ga.run >= total ||
      (int64_t)clusters * ga.k > 0x7fffffff)
    return cudaErrorInvalidValue;
  const ClusterKernel kern = cluster_kernel(ept);
  if (kern == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = open_cluster(kern, smem, ga.k);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(ga.k, (unsigned)(clusters * ga.k), smem, s, attr);
  return cudaLaunchKernelEx(&cfg, kern, ga);
}

}  // namespace
