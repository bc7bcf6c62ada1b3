// JAX's legacy threefry2x32 stream, one launch a draw:
//   randint: out[r, i] = minval + (word i of row r's stream) mod span, int32
//   bits32:  out[i]    = word i of the key's stream, zero-extended to int64
//
// Replaces no TPU kernel: the JAX package draws with `jax.random`, which
// XLA lowers itself.  It exists because core/random.py's plain version
// computes the stream as ~180 int64 torch ops a draw (20 rounds of add,
// rotate and xor, each a launch, and the reductions): on the card those
// launches would set the pace of a COPML step (1,092 of 1,118).  Here a
// draw is one launch in native uint32 arithmetic, bit for bit the plain
// version's words.
//
// The legacy layout hashes counters iota(n) as two halves: pair q < h,
// h = ceil(n / 2), hashes (q, q + h) and gives words q and h + q; for odd n
// the last pair's second counter is the zero pad and its word is dropped.
//
// The draw is bound by its operations, by a little (the floor is derived
// beside kernels/threefry.py ALU_OPS_PAIR).  So each thread keeps kPairs
// independent hashes in flight (their rounds interleave, hiding the
// add-rotate-xor chain's latency), a block takes 256 * kPairs consecutive
// pairs a turn (each store coalesced), and a grid-stride loop over at most
// a few waves of blocks covers any length with 64-bit indices.  The modulo
// by a runtime span takes constants computed on the host: a mask for a
// power of two, else magic = floor(2^32 / span), whose multiply-high
// quotient is exact or one short, so one conditional subtract finishes it
// (no hardware divide).
//
// Keys ride in the launch's parameters (no copy to the card): row r of a
// launch reads its words from keys.w[r] by blockIdx.y.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 4;             // counter pairs a thread has in flight
constexpr int kMaxRows = 64;          // keys one launch carries
constexpr uint32_t kParity = 0x1BD11BDAu;

// what a launch writes (kernels/threefry.py BITS, POW2, MAGIC, MAGIC_HI)
enum Mode { kBits = 0, kPow2 = 1, kMagic = 2, kMagicHi = 3 };

struct Keys {
  uint32_t w[kMaxRows][4];            // lo k0, lo k1, hi k0, hi k1 a row
};

struct Draw {
  void* out;                          // (rows, n): int32, or int64 for kBits
  int64_t n;                          // words a row
  int64_t h;                          // counter pairs a row, ceil(n / 2)
  uint32_t span;                      // randint: maxval - minval, >= 1
  uint32_t magic;                     // floor(2^32 / span) where not 2^k
  uint32_t mult;                      // (2^16 % span)^2 mod 2^32 % span
  uint32_t minval;                    // int32 minval's bits
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, on kPairs counter pairs at once.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t (&x0)[kPairs],
                                         uint32_t (&x1)[kPairs]) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    x0[u] += ks[0];
    x1[u] += ks[1];
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        x0[u] += x1[u];
        x1[u] = rotl(x1[u], kRot[i % 2][j]) ^ x0[u];
      }
    }
    const uint32_t a = ks[(i + 1) % 3], b = ks[(i + 2) % 3] + i + 1;
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      x0[u] += a;
      x1[u] += b;
    }
  }
}

// w mod span.
template <int M>
__device__ __forceinline__ uint32_t reduce(uint32_t w, const Draw& d) {
  if (M == kPow2) return w & (d.span - 1u);
  const uint32_t r = w - __umulhi(w, d.magic) * d.span;
  return r >= d.span ? r - d.span : r;
}

// randint's offset: the lo word mod span, or with a nonzero multiplier
// (hi mod span * mult + lo mod span) mod span in wrapping uint32, as
// jax.random.randint combines its two draws.
template <int M>
__device__ __forceinline__ uint32_t offset(uint32_t lo, uint32_t hi,
                                          const Draw& d) {
  if (M != kMagicHi) return reduce<M>(lo, d);
  return reduce<M>(reduce<M>(hi, d) * d.mult + reduce<M>(lo, d), d);
}

template <int M>
__device__ __forceinline__ void put(const Draw& d, int64_t at, uint32_t lo,
                                    uint32_t hi) {
  if (M == kBits)
    static_cast<int64_t*>(d.out)[at] = static_cast<int64_t>(lo);
  else
    static_cast<int32_t*>(d.out)[at] =
        static_cast<int32_t>(offset<M>(lo, hi, d) + d.minval);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
threefry_kernel(const __grid_constant__ Keys keys,
                const __grid_constant__ Draw d) {
  const uint32_t* k = keys.w[blockIdx.y];
  const int64_t n = d.n, h = d.h, row = (int64_t)blockIdx.y * n;
  constexpr int64_t kChunk = (int64_t)kThreads * kPairs;
  for (int64_t q0 = (int64_t)blockIdx.x * kChunk + threadIdx.x; q0 < h;
       q0 += (int64_t)gridDim.x * kChunk) {
    uint32_t a[kPairs], b[kPairs], ha[kPairs], hb[kPairs];
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int64_t q = q0 + u * kThreads;
      a[u] = static_cast<uint32_t>(q);
      b[u] = q + h < n ? static_cast<uint32_t>(q + h) : 0u;  // odd pad
      ha[u] = a[u];
      hb[u] = b[u];
    }
    threefry(k[0], k[1], a, b);
    if (M == kMagicHi) threefry(k[2], k[3], ha, hb);
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int64_t q = q0 + u * kThreads;
      if (q >= h) break;
      put<M>(d, row + q, a[u], ha[u]);
      if (q + h < n) put<M>(d, row + h + q, b[u], hb[u]);
    }
  }
}

}  // namespace

// words: rows * 4 uint32 (lo k0, lo k1, hi k0, hi k1 a row); out: (rows, n)
// contiguous, int32 (modes 1-3) or int64 (mode 0), on the current device;
// rows >= 1, n >= 1; span >= 1, a power of two for mode 1 and not for
// modes 2-3, magic = floor(2^32 / span) there; `blocks` a row from
// kernels/threefry.py grid.  A launch carries at most 64 rows, so more
// rows take one launch each 64.  Returns the first nonzero
// cudaGetLastError(), else 0.
extern "C" int repro_threefry(const uint32_t* words, int rows, int mode,
                              void* out, int64_t n, uint32_t span,
                              uint32_t magic, uint32_t mult, int32_t minval,
                              int blocks, void* stream) {
  if (rows < 1 || n < 1 || blocks < 1 || mode < kBits || mode > kMagicHi ||
      span < 1u || (mode == kPow2 && (span & (span - 1u))) ||
      (mode >= kMagic && (span < 3u || magic == 0u)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t elem = mode == kBits ? sizeof(int64_t) : sizeof(int32_t);
  for (int r0 = 0; r0 < rows; r0 += kMaxRows) {
    const int nr = rows - r0 < kMaxRows ? rows - r0 : kMaxRows;
    Keys keys;
    for (int r = 0; r < nr; ++r)
      for (int j = 0; j < 4; ++j) keys.w[r][j] = words[4 * (r0 + r) + j];
    const Draw d{static_cast<char*>(out) + (size_t)r0 * n * elem, n,
                 (n + 1) / 2, span, magic, mult,
                 static_cast<uint32_t>(minval)};
    const dim3 grid(blocks, nr);
    switch (mode) {
      case kBits: threefry_kernel<kBits><<<grid, kThreads, 0, s>>>(keys, d);
        break;
      case kPow2: threefry_kernel<kPow2><<<grid, kThreads, 0, s>>>(keys, d);
        break;
      case kMagic:
        threefry_kernel<kMagic><<<grid, kThreads, 0, s>>>(keys, d);
        break;
      default:
        threefry_kernel<kMagicHi><<<grid, kThreads, 0, s>>>(keys, d);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
