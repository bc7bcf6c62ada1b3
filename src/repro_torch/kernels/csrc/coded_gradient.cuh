// The coded gradient f[n] = X~[n]^T ghat(X~[n] W~[n]) over F_p, summed into
// a zeroed uint64 (N, d, C) accumulator.  Shared by the coded-gradient
// kernels (coded_gradient.cu) and the fused COPML step (fused_step.cu).
//
// Replaces the gradient body of the TPU kernels `fused_step`
// (src/repro/kernels/fused_step.py) and `coded_gradient[_batched|_matrix]`
// (src/repro/kernels/coded_gradient.py), which walk a sequential
// (client, row block) grid and keep f in VMEM.
//
// Bound on an H100: reading X~ once, N * m * d * 4 bytes over 3.35 TB/s
// (554 MB, 0.166 ms at cifar10_case2, for C = 1 and C = 10 alike); the
// MACs, 2 per X~ element and class, are far below the integer rate.
//
// coded_grad_kernel is persistent, 512 threads, one CTA per resident slot:
// the N * ceil(m / bm) slices of bm rows, client-major, are cut into one
// strip of consecutive slices per CTA, so a strip covers one or two clients.
// The launcher (kernels/coded_gradient.py) decides every launch parameter
// from kernels/plan.py -- slice height, ring depth and stage size, shared
// memory, accumulator mode, strip length and grid -- and this file only
// checks that they fit its layout; grad_slots reports the resident CTAs
// the strip split needs.
//   ring     A slice of client n, rows r0..r0+bm, is ONE contiguous span of
//            X~.  Thread 0 fills a ring of `stages` shared-memory slices
//            one slice ahead with cp.async.bulk (completion on an
//            mbarrier), so ~100 KB per SM stay in flight while the CTA
//            computes (copies alone run at 0.20 ms, 84% of the bound).
//            Bulk copies need 16-byte aligned addresses and sizes, and at
//            d = 3073 odd clients start 8 bytes off (m * d * 4 = 8 mod 16):
//            the copy rounds the span out to 16-byte boundaries inside the
//            tensor and the slice's view sits at the span's offset in its
//            stage.  Only the tensor's first and last slices can have words
//            outside that (ragged ends), which thread 0 copies with plain
//            loads; nothing reads outside X~.
//   pass 1   z = X~ W~ with W~ class-major (C, d): warp q takes columns
//            [q dq, (q+1) dq) of every row, and a lane keeps 8 rows (C = 1)
//            or 4 rows x 4 classes of sums, so each W~ word it loads serves
//            8 or 16 MACs.  A lane sums ceil(ceil(d / 16) / 32) products:
//            up to ~114 at the widest d, past reduce_p58's 64, so it
//            reduces once with the full reduce_p (the launch checks the
//            count against kNoReduceTerms), and a multi-value butterfly
//            sums its 8 or 16 values over the warp in 9 or 16 shuffles.
//   ghat     Horner on rows * C threads, coefficients in shared memory.
//   pass 2   f[n] += X~^T g, by mode (kernels/plan.py gradient_plan):
//            reg     (d * C <= 4096) each thread keeps the raw uint64 sums
//                    of its ept elements in registers across the strip,
//                    reduced only every 4095 rows, and adds them to the
//                    accumulator when the strip leaves a client: ~(S + N) d
//                    atomics a step instead of one per slice and element;
//            smem    reduced uint32 partials of (d, C) in shared memory,
//                    added to the accumulator when the strip leaves a client;
//            atomic  one atomicAdd per slice and element, reduced first.
//            A slice's sum per element is of bm <= kNoReduce58Terms
//            products, so smem and atomic reduce it with reduce_p58.
// Ragged m is masked (the last slice of a client has fewer rows), never
// padded.  The accumulator holds a few partials < p per element.

#pragma once

#include "field.cuh"

namespace {

constexpr int kGradThreads = 512;
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kMaxDegree = 63;         // ghat's coefficients sit in smem
constexpr int kBarBytes = 64;          // mbarriers, at the front of smem
constexpr int kCopySlack = 32;         // a span rounded out to 16 bytes
constexpr uint32_t kCopyChunk = 16384; // bytes per cp.async.bulk
constexpr int kMaxStages = 2;

enum GradMode { kModeReg = 0, kModeSmem = 1, kModeAtomic = 2 };

struct GradArgs {
  const int32_t* x;            // (N, m, d)
  const int32_t* w;            // W~ class-major: (N, C, d)
  const int32_t* coeffs;       // (degree + 1,)
  unsigned long long* facc;    // (N, d, C), zeroed
  int degree, N, m, d, C, bm, stages, mode;
  int64_t sbytes;              // one ring stage (plan.stage_bytes)
  int run;                     // slices in a CTA's strip (plan.strip_run)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of `parity` to complete; a copy that never lands
// traps (the launch reports an error) instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Pass 1 of one slice: lane sums of RB rows x CB classes over the warp's
// column chunk (ceil(d / 16 / 32) < kNoReduceTerms products each), reduced
// once with reduce_p, summed over the warp, and left in zs[(i, c, warp)].
// Rows and classes past the slice are summed as zeros, so every shuffle is
// uniform.
template <int RB, int CB>
__device__ __forceinline__ void pass1_block(const uint32_t* xs,
                                            const int32_t* wn, uint32_t* zs,
                                            int rows, int d, int C, int dq,
                                            int warp, int lane) {
  const int j0 = warp * dq, j1 = min(d, j0 + dq);
  for (int r0 = 0; r0 < rows; r0 += RB) {
    for (int c0 = 0; c0 < C; c0 += CB) {
      uint32_t lo[RB][CB] = {}, hi[RB][CB] = {};
      for (int j = j0 + lane; j < j1; j += 32) {
        uint32_t xv[RB], wv[CB];
#pragma unroll
        for (int u = 0; u < CB; ++u)
          wv[u] = c0 + u < C ? (uint32_t)__ldg(wn + (int64_t)(c0 + u) * d + j)
                             : 0u;
#pragma unroll
        for (int r = 0; r < RB; ++r)
          xv[r] = r0 + r < rows ? xs[(int64_t)(r0 + r) * d + j] : 0u;
#pragma unroll
        for (int r = 0; r < RB; ++r)
#pragma unroll
          for (int u = 0; u < CB; ++u) mac_wide(lo[r][u], hi[r][u], xv[r], wv[u]);
      }
      uint32_t v[RB * CB];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int u = 0; u < CB; ++u)
          v[r * CB + u] = reduce_p(wide(lo[r][u], hi[r][u]));
      const uint32_t sum = multi_warp_sum<RB * CB>(v, lane);
      const int idx = multi_sum_index<RB * CB>(lane);
      const int r = r0 + idx / CB, c = c0 + idx % CB;
      constexpr int kSpan = 32 / (RB * CB);       // lanes per value
      if (lane % kSpan == 0 && r < rows && c < C)
        zs[(r * C + c) * kGradWarps + warp] = reduce_p(sum);
    }
  }
}

template <int EPT, bool C1>
__global__ void __launch_bounds__(kGradThreads)
coded_grad_kernel(GradArgs ga) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = ga.C, d = ga.d, m = ga.m, bm = ga.bm, stages = ga.stages;
  const int L = d * C;
  const int64_t sbytes = ga.sbytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  uint32_t* zs = reinterpret_cast<uint32_t*>(ring + stages * sbytes);
  uint32_t* gs = zs + bm * C * kGradWarps;       // (bm, C) ghat(z)
  uint32_t* part = gs + bm * C;                  // (d, C), smem mode

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int spb = (m + bm - 1) / bm;
  const int64_t total = (int64_t)ga.N * spb;
  // this CTA's strip: slices [s0, s0 + cnt)
  const int64_t s0 = (int64_t)blockIdx.x * ga.run;
  const int cnt = (int)(total - s0 < ga.run ? total - s0 : ga.run);
  const uintptr_t xb = reinterpret_cast<uintptr_t>(ga.x);
  const uintptr_t xe = xb + (uintptr_t)ga.N * m * d * 4;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&bars[st])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __shared__ int32_t coeffs[kMaxDegree + 1];      // off the ghat critical path
  for (int t = tid; t <= ga.degree; t += kGradThreads) coeffs[t] = ga.coeffs[t];
  if (ga.mode == kModeSmem)
    for (int j = tid; j < d; j += kGradThreads)
      for (int c = 0; c < C; ++c) part[j * C + c] = 0;
  __syncthreads();

  // the span of local slice t: its first byte and its row count
  auto span = [&](int t, int* n, int* rows) -> uintptr_t {
    const int64_t s = s0 + t;
    *n = (int)(s / spb);
    const int r0 = (int)(s % spb) * bm;
    *rows = min(bm, m - r0);
    return xb + (((uintptr_t)*n * m + r0) * d) * 4;
  };

  // thread 0 starts the copy of local slice t into stage t % stages
  auto issue = [&](int t) {
    if (tid != 0 || t >= cnt) return;
    int n, rows;
    const uintptr_t as = span(t, &n, &rows);
    const uintptr_t ae = as + (uintptr_t)rows * d * 4;
    const uintptr_t g0 = as & ~(uintptr_t)15;
    const uintptr_t inlo = (xb + 15) & ~(uintptr_t)15;
    const uintptr_t inhi = xe & ~(uintptr_t)15;
    uintptr_t lo = g0 > inlo ? g0 : inlo;
    uintptr_t hi = ((ae + 15) & ~(uintptr_t)15) < inhi
                       ? ((ae + 15) & ~(uintptr_t)15) : inhi;
    if (hi <= lo) lo = hi = ae;                  // all words by plain loads
    const int st = t % stages;
    unsigned char* stage = ring + st * sbytes;
    for (uintptr_t a = as; a < lo && a < ae; a += 4)
      *reinterpret_cast<uint32_t*>(stage + (a - g0)) =
          *reinterpret_cast<const uint32_t*>(a);
    for (uintptr_t a = hi > as ? hi : as; a < ae; a += 4)
      *reinterpret_cast<uint32_t*>(stage + (a - g0)) =
          *reinterpret_cast<const uint32_t*>(a);
    const uint32_t body = (uint32_t)(hi - lo);
    bar_arrive_tx(&bars[st], body);
    for (uint32_t off = 0; off < body; off += kCopyChunk)
      bulk_copy(stage + (lo - g0) + off, reinterpret_cast<const void*>(lo + off),
                body - off < kCopyChunk ? body - off : kCopyChunk, &bars[st]);
  };

  // reg mode: element e = tid + j * kGradThreads of (d, C) is column
  // xo[j] and class go[j] (for C = 1 simply column e)
  constexpr int R = EPT > 0 ? EPT : 1;
  uint32_t lo[R], hi[R];                         // its uint64 sum
  int xo[R], go[R];
  bool ok[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int e = tid + j * kGradThreads;
    ok[j] = EPT > 0 && e < L;
    xo[j] = ok[j] ? (C1 ? e : e / C) : 0;
    go[j] = ok[j] && !C1 ? e % C : 0;
    lo[j] = hi[j] = 0;
  }
  int terms = 0;

  for (int t = 0; t < stages - 1; ++t) issue(t);
  for (int t = 0; t < cnt; ++t) {
    issue(t + stages - 1);
    int n, rows;
    const uintptr_t as = span(t, &n, &rows);
    const int st = t % stages;
    bar_wait(&bars[st], (uint32_t)((t / stages) & 1));
    const uint32_t* xs =
        reinterpret_cast<const uint32_t*>(ring + st * sbytes + (as & 15));
    const int32_t* wn = ga.w + (int64_t)n * L;  // W~[n] class-major (C, d)

    // pass 1: z = X~ W~.  Warp q takes columns [q dq, (q+1) dq) of every
    // row; a lane keeps an 8-row (C = 1) or 4-row x 4-class block of sums,
    // so each W~ word it loads serves 8 (or 16) MACs.
    const int dq = (d + kGradWarps - 1) / kGradWarps;
    if (C1) pass1_block<8, 1>(xs, wn, zs, rows, d, C, dq, warp, lane);
    else    pass1_block<4, 4>(xs, wn, zs, rows, d, C, dq, warp, lane);
    __syncthreads();

    // ghat(z) on rows * C threads; 16 partials < p
    for (int o = tid; o < rows * C; o += kGradThreads) {
      uint32_t z = 0;
#pragma unroll
      for (int q = 0; q < kGradWarps; ++q) z += zs[o * kGradWarps + q];
      gs[o] = horner(coeffs, ga.degree, reduce_p(z));
    }
    __syncthreads();

    // pass 2: f[n] += X~^T g
    unsigned long long* fn = ga.facc + (int64_t)n * L;
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
        const uint32_t* xr = xs + (int64_t)i * d;
        const uint32_t* gr = gs + i * C;
        const uint32_t g1 = C1 ? gr[0] : 0u;
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (ok[j]) mac_wide(lo[j], hi[j], xr[xo[j]], C1 ? g1 : gr[go[j]]);
      }
    } else {
      // a thread per column j of X~, four classes at a time
      for (int j = tid; j < d; j += kGradThreads) {
        for (int c0 = 0; c0 < C; c0 += 4) {
          uint32_t slo[4] = {0, 0, 0, 0}, shi[4] = {0, 0, 0, 0};
          for (int i = 0; i < rows; ++i) {        // rows <= 64 products
            const uint32_t xv = xs[(int64_t)i * d + j];
            const uint32_t* gr = gs + i * C + c0;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c0 + u < C) mac_wide(slo[u], shi[u], xv, gr[u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (c0 + u < C) {
              const int e = j * C + c0 + u;
              const uint32_t v = reduce_p58(wide(slo[u], shi[u]));
              if (ga.mode == kModeSmem) part[e] = addp(part[e], v);
              else atomicAdd(fn + e, (unsigned long long)v);
            }
          }
        }
      }
    }

    // the strip leaves client n: its partials go to the accumulator
    if (t + 1 == cnt || (s0 + t + 1) / spb != n) {
      if (EPT > 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (ok[j]) atomicAdd(fn + tid + j * kGradThreads,
                               (unsigned long long)reduce_p(wide(lo[j], hi[j])));
          lo[j] = hi[j] = 0;
        }
        terms = 0;
      } else if (ga.mode == kModeSmem) {
        for (int j = tid; j < d; j += kGradThreads)
          for (int c = 0; c < C; ++c) {
            atomicAdd(fn + j * C + c, (unsigned long long)part[j * C + c]);
            part[j * C + c] = 0;
          }
      }
    }
    __syncthreads();                             // frees the stage and gs
  }
}

using GradKernel = void (*)(GradArgs);

template <int EPT>
GradKernel grad_instance(bool c1) {
  return c1 ? &coded_grad_kernel<EPT, true> : &coded_grad_kernel<EPT, false>;
}

// The instance for `ept` register partials a thread (0: smem or atomic
// mode) and C == 1, or null.
inline GradKernel grad_kernel(int ept, bool c1) {
  switch (ept) {
    case 0: return grad_instance<0>(c1);
    case 1: return grad_instance<1>(c1);
    case 2: return grad_instance<2>(c1);
    case 4: return grad_instance<4>(c1);
    case 8: return grad_instance<8>(c1);
    default: return nullptr;
  }
}

// Opens an instance's dynamic shared memory to `smem` bytes.  The
// attribute costs host time on every step, so it is set again only when an
// instance's size changes (one card per process).
inline cudaError_t open_smem(GradKernel kern, size_t smem) {
  static GradKernel kerns[10];
  static size_t sizes[10];
  int i = 0;
  while (i < 10 && kerns[i] != nullptr && kerns[i] != kern) ++i;
  if (i == 10) return cudaErrorInvalidValue;
  if (kerns[i] == kern && sizes[i] == smem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    kerns[i] = kern;
    sizes[i] = smem;
  }
  return err;
}

// CTAs of the (ept, C) instance resident on the card at `smem` bytes of
// dynamic shared memory: SMs x blocks per SM.  kernels/plan.py strip_run
// cuts the slices into that many strips.
inline cudaError_t grad_slots(int ept, int C, size_t smem, int* slots) {
  const GradKernel kern = grad_kernel(ept, C == 1);
  if (kern == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = open_smem(kern, smem);
  if (err != cudaSuccess) return err;
  int occ = 0, sms = 0, dev = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                      kGradThreads, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *slots = sms * occ;
  return err;
}

// Launch coded_grad_kernel on a zeroed facc as kernels/coded_gradient.py
// launch_args decided: bm, stages, mode and ept from plan.gradient_plan,
// ga.sbytes and smem from its layout, ga.run and ctas from plan.strip_run.
// x (N, m, d) and w (N, C, d) contiguous int32 in [0, p), m >= 1.  Refuses
// a launch whose parameters break the kernel's bounds or do not fit its
// shared-memory layout.
cudaError_t launch_coded_grad(const GradArgs& ga, int ept, size_t smem,
                              int ctas, cudaStream_t s) {
  const int64_t L = (int64_t)ga.d * ga.C;
  const int64_t total = (int64_t)ga.N * ((ga.m + ga.bm - 1) / ga.bm);
  // the layout: barriers, the ring, z partials, ghat(z), smem-mode partials
  const int64_t layout = kBarBytes + ga.stages * ga.sbytes +
                         (int64_t)4 * ga.bm * ga.C * (kGradWarps + 1) +
                         (ga.mode == kModeSmem ? 4 * L : 0);
  if (ga.bm < 1 || ga.bm > kNoReduce58Terms || ga.stages < 1 ||
      ga.stages > kMaxStages || ga.degree < 0 || ga.degree > kMaxDegree ||
      ga.mode < kModeReg || ga.mode > kModeAtomic ||
      (ga.mode == kModeReg) != (ept > 0) ||
      (int64_t)ept * kGradThreads < (ga.mode == kModeReg ? L : 0) ||
      ((int64_t)(ga.d + kGradWarps - 1) / kGradWarps + 31) / 32 >=
          kNoReduceTerms ||
      ga.sbytes % 16 != 0 ||
      ga.sbytes < (int64_t)4 * ga.bm * ga.d + kCopySlack ||
      (int64_t)smem < layout || ga.run < 1 || ctas < 1 ||
      (int64_t)ctas * ga.run < total || (int64_t)(ctas - 1) * ga.run >= total)
    return cudaErrorInvalidValue;
  const GradKernel kern = grad_kernel(ept, ga.C == 1);
  if (kern == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = open_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)ctas, kGradThreads, smem, s>>>(ga);
  return cudaGetLastError();
}

}  // namespace
