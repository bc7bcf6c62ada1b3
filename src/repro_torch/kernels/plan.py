"""The launchers' host-side choices, as pure functions of shapes and strides.

Every launch parameter of the CUDA kernels is decided here, once, and
passed to csrc/ by the launchers (csrc/ only checks them against the
kernels' bounds), so the CPU tests reach the code that decides:

- `gemm_path` / `thin_launch` / `colsum_launch` / `rowdot_launch` /
  `splitk_launch`: which modmatmul kernel a GEMM takes, the thin kernel's
  instance (`THIN_KMAX`) and grid, the column-sum kernel's instance
  (`COLSUM_CMAX`), K splits and grid, the row-dot kernel's instance, K
  chunk, shared memory, row strips and K splits, and the split-K
  kernel's column block, row groups and K splits;
- `gradient_plan`, `stage_bytes`, `strip_run`: the gradient kernel's
  accumulator mode, slice height, ring depth and stage size, shared
  memory, and the strips its CTAs walk;
- `cluster_plan`, `cluster_smem`, `slot_bytes`: the cluster gradient
  kernel's cluster size, column slice, accumulator mode, slice height,
  ring depth and shared memory;
- `gradient_route`: whether a coded gradient takes the gradient kernel
  ("body"), past the widest d whose row of X~ fits its shared memory the
  cluster kernel ("cluster", C = 1), or the wide route of three field
  kernels ("wide");
- `poly_launch`: poly_eval's kernel (one thread an element, or
  grid-stride) and its blocks.

It also holds numpy models of device code the CPU cannot run:
`reduce_p` / `reduce_p58` (csrc/field.cuh's reductions mod p),
`pass1_terms` (the products a lane of the gradient kernel's pass 1 sums
before its one reduce), `slice_copy` (the 16-byte peel of each slice's
bulk copy), `colsum_model` (the column-sum kernel's lane sums and the
combine of its K splits), `rowdot_model` (the row-dot kernel's lanes,
chunks and K splits), `horner_lazy` (poly_eval's lazy Horner step),
`cluster_model` (the cluster kernel's per-rank partials, their sum across
the cluster and pass 2), and `wide_model` / `epilogue_model` (the wide
route's three kernels, and csrc/fused_step.cu's epilogue).
"""

from __future__ import annotations

import functools

import numpy as np

P = 67108859                        # 2^26 - 5
MASK26 = (1 << 26) - 1
NO_REDUCE_TERMS = 4096              # products < 2^52 that a uint64 sum holds
NO_REDUCE58_TERMS = 64              # ... that a sum below 2^58 holds

SMEM_MAX = 232448                   # an H100 block's dynamic shared memory
THIN_MAX_M = 64
THIN_MAX_K = NO_REDUCE58_TERMS      # one reduce_p58 an output
THIN_THREADS = 256
# (KMAX, COLS) of csrc/modmatmul.cu's thin_kernel instances, in order: K
# itself for the main path's large GEMMs (7 share, 8 reconstruct, 17 LCC
# encode), zero-padded buckets for every other K; COLS * KMAX <= 64
# registers of B a thread
THIN_KMAX = ((7, 4), (8, 4), (16, 4), (17, 2), (24, 2), (32, 2), (48, 1),
             (64, 1))
COLSUM_MAX_N = 16
# csrc/modmatmul.cu colsum_kernel instances (N padded to the first that
# holds it): N itself for X^T y at C = 1 and at a 10-class objective
COLSUM_CMAX = (1, 2, 4, 8, 10, 16)
COLSUM_WARPS = 8                    # warp tasks a CTA
COLSUM_ROWS = 32                    # rows of B a warp stages at once
COLSUM_TASKS_PER_SM = 1024          # ~16 waves of 64 resident warps
ROWDOT_MAX_N = 16
ROWDOT_CMAX = COLSUM_CMAX           # csrc/modmatmul.cu rowdot_kernel instances
ROWDOT_WARPS = 16                   # csrc/modmatmul.cu kRowdotWarps
ROWDOT_MAX_CHUNK = 32 * NO_REDUCE_TERMS   # a lane sums chunk / 32 products
SPLITK_MAX_M = 128
SPLITK_SUB = NO_REDUCE58_TERMS      # rows of K a pass: one reduce_p58
SPLITK_MAX_KC = NO_REDUCE_TERMS
SPLITK_THREADS = 256
SPLITK_BN = (32, 64, 128, 256)      # columns of B a CTA owns
SPLITK_CTAS_PER_SM = 2

GRAD_THREADS = 512
GRAD_WARPS = GRAD_THREADS // 32
REG_EPT = (1, 2, 4, 8)              # register partials a thread may keep
MAX_BM = NO_REDUCE58_TERMS          # pass 2 sums a slice with reduce_p58
MAX_DEGREE = 63                     # ghat's coefficients: static smem
GRAD_STATIC = 4 * (MAX_DEGREE + 1)  # static shared memory of the kernel
BAR_BYTES = 64                      # the ring's mbarriers, at the front
COPY_SLACK = 32                     # a slice rounded out to 16-byte ends

# the cluster gradient kernel (csrc/coded_gradient_cluster.cuh): its
# cluster sizes, 16 after NonPortableClusterSizeAllowed
CLUSTER_SIZES = (2, 4, 8, 16)
CLUSTER_BAR_BYTES = 128             # its mbarriers, at the front

POLY_THREADS = 256
POLY_EPT = 8                        # elements a poly_eval thread has in flight
POLY_BLOCKS_PER_SM = 8              # csrc/field_poly.cu __launch_bounds__


def reduce_p58(x) -> np.ndarray:
    """x mod p for uint64 x < 2^58 by two folds and one conditional
    subtract (csrc/field.cuh reduce_p58)."""
    x = np.asarray(x, dtype=np.uint64)
    assert (x < np.uint64(1 << 58)).all()
    y = (x & np.uint64(MASK26)) + np.uint64(5) * (x >> np.uint64(26))
    z = (y & np.uint64(MASK26)) + np.uint64(5) * (y >> np.uint64(26))
    assert (z < np.uint64(2 * P)).all()
    return np.where(z >= np.uint64(P), z - np.uint64(P), z)


def reduce_p(x) -> np.ndarray:
    """x mod p for uint64 x by three pseudo-Mersenne folds (2^26 = 5 mod
    p) and one conditional subtract, exactly as csrc/field.cuh does it."""
    x = np.asarray(x, dtype=np.uint64)
    y = (x & np.uint64(MASK26)) + np.uint64(5) * (x >> np.uint64(26))
    y32 = y.astype(np.uint32)                                   # y < 2^41
    z = (y32 & np.uint32(MASK26)) + np.uint32(5) * (
        y >> np.uint64(26)).astype(np.uint32)
    v = (z & np.uint32(MASK26)) + np.uint32(5) * (z >> np.uint32(26))
    return np.where(v >= np.uint32(P), v - np.uint32(P), v).astype(np.uint64)


# ---------------------------------------------------------------- modmatmul

def gemm_path(m: int, k: int, b_col_stride: int, n: int = 2,
              a_m_stride: int | None = None,
              a_k_stride: int | None = None) -> str:
    """The csrc/modmatmul.cu kernel of a (m, k) @ (k, n) GEMM, the first
    of these that takes it:

    "thin"    thin_kernel (A staged whole, columns of B in registers) when
              M <= 64, 1 <= K <= 64 and B's columns are unit stride;
    "colsum"  colsum_kernel (a split-K column sum of A's rows) when A's
              M-stride is 1 and N <= 16: X^T y, whose A is the transposed
              view of the shares;
    "rowdot"  rowdot_kernel (a GEMV a row of A, B staged in shared memory)
              when A's K-stride is 1 and N <= 16: the MPC baseline's
              Z = X W;
    "splitk"  splitk_kernel (K cut over CTAs, partials combined) when
              M <= 128, K > 64 and B's columns are unit stride: serving's
              (B, d) @ (d, N C') scores;
    "tiled"   the BM x BN tile kernel (any strides) for the rest."""
    unit = b_col_stride == 1 or n == 1
    if m <= THIN_MAX_M and 1 <= k <= THIN_MAX_K and unit:
        return "thin"
    if a_m_stride == 1 and 1 <= n <= COLSUM_MAX_N:
        return "colsum"
    if a_k_stride == 1 and 1 <= n <= ROWDOT_MAX_N:
        return "rowdot"
    if m <= SPLITK_MAX_M and k > THIN_MAX_K and unit:
        return "splitk"
    return "tiled"


@functools.lru_cache(maxsize=None)
def thin_launch(m: int, n: int, k: int, batch: int, sms: int) -> dict:
    """How csrc/modmatmul.cu's thin_kernel runs a (batch, m, k) @ (batch,
    k, n) GEMM on a card of `sms` SMs:

    kmax, cols  its instance: the first of THIN_KMAX with K <= KMAX (A and
                B zero-padded to KMAX), and the columns a thread holds;
    gx          blocks over N (the kernel strides over the rest): enough
                for N, at most ~16 blocks per SM over the batch;
    groups, rpg the M output rows split into `groups` of `rpg` rows over
                gridDim.z when the column blocks alone give the card fewer
                than ~2 blocks per SM (the per-step GEMMs with N = 3073)."""
    if not 1 <= k <= THIN_MAX_K:
        raise ValueError(f"thin GEMM takes 1 <= K <= {THIN_MAX_K}, got {k}")
    kmax, cols = next((km, c) for km, c in THIN_KMAX if k <= km)
    gx = min(-(-n // (cols * THIN_THREADS)), -(-(sms * 16) // batch))
    groups = min(m, max(1, -(-(2 * sms) // (gx * batch))))
    rpg = -(-m // groups)
    return dict(kmax=kmax, cols=cols, gx=gx, groups=-(-m // rpg), rpg=rpg)


@functools.lru_cache(maxsize=None)
def colsum_launch(m: int, n: int, k: int, batch: int, sms: int) -> dict:
    """How csrc/modmatmul.cu's colsum_kernel runs a (batch, m, k) @ (batch,
    k, n) GEMM on a card of `sms` SMs.  A warp task is (batch, 32
    consecutive columns, one split of K):

    cmax    its instance: the first of COLSUM_CMAX with N <= CMAX;
    kc      rows of K a split (a multiple of COLSUM_ROWS), at most
            NO_REDUCE_TERMS: a lane sums kc products before its one reduce;
    splits  ceil(K / kc): enough for ~COLSUM_TASKS_PER_SM tasks an SM
            (whole waves to within a few percent), at most one a 32-row
            block of K;
    ctas    CTAs of COLSUM_WARPS tasks."""
    if not 1 <= n <= COLSUM_MAX_N or k < 1 or m < 1 or batch < 1:
        raise ValueError(f"colsum GEMM takes 1 <= N <= {COLSUM_MAX_N}, "
                         f"K, M, batch >= 1; got N={n}, K={k}, M={m}, "
                         f"batch={batch}")
    cmax = next(c for c in COLSUM_CMAX if n <= c)
    per_split = batch * -(-m // 32)
    blocks = -(-k // COLSUM_ROWS)
    want = -(-(COLSUM_TASKS_PER_SM * sms) // per_split)
    splits = min(blocks, max(want, -(-k // NO_REDUCE_TERMS)))
    kc = -(-blocks // splits) * COLSUM_ROWS
    splits = -(-k // kc)
    return dict(cmax=cmax, kc=kc, splits=splits,
                ctas=-(-(per_split * splits) // COLSUM_WARPS))


@functools.lru_cache(maxsize=None)
def rowdot_shape(n: int, k: int) -> dict:
    """rowdot_kernel's instance and shared memory for N columns of B and
    K: cmax (the first of ROWDOT_CMAX with N <= CMAX), kch (the rows of K
    whose B it stages at once, class-major: all of K when 4 cmax K bytes
    fit a block's shared memory; a lane then sums at most kch / 32
    products, <= NO_REDUCE_TERMS) and smem (4 cmax kch bytes)."""
    if not 1 <= n <= ROWDOT_MAX_N or k < 1:
        raise ValueError(f"rowdot GEMM takes 1 <= N <= {ROWDOT_MAX_N}, "
                         f"K >= 1; got N={n}, K={k}")
    cmax = next(c for c in ROWDOT_CMAX if n <= c)
    kch = min(k, SMEM_MAX // (4 * cmax), ROWDOT_MAX_CHUNK)
    return dict(cmax=cmax, kch=kch, smem=4 * cmax * kch)


def rowdot_rows(cmax: int) -> int:
    """Rows a rowdot_kernel CTA sums at once: ROWDOT_WARPS warps of RB
    rows (csrc/modmatmul.cu RowdotShape: 4 at CMAX <= 2, 2 at <= 10, else
    1)."""
    return ROWDOT_WARPS * (4 if cmax <= 2 else 2 if cmax <= 10 else 1)


@functools.lru_cache(maxsize=None)
def rowdot_launch(m: int, n: int, k: int, batch: int, slots: int) -> dict:
    """How csrc/modmatmul.cu's rowdot_kernel runs a (batch, m, k) @
    (batch, k, n) GEMM when `slots` of its CTAs fit the card at once
    (SMs x CTAs an SM, from the kernel's occupancy at rowdot_shape's
    shared memory): rowdot_shape's cmax, and

    run     rows of one batch a CTA walks (its strip): the `slots` CTAs
            are dealt evenly over the batches and a strip never crosses
            one, so each CTA stages B[b] once a chunk of K;
    cpb     CTAs a batch (gridDim.x; the batch is gridDim.y);
    splits  K cut over gridDim.z, when M x batch leaves the card idle:
            the strips shrink to the fewest that keep every warp of a CTA
            busy (rowdot_rows rows each), and K is cut into splits of ks
            rows (a multiple of 32) so that strips x batch x splits fills
            about `slots` CTAs.  Each split writes (batch, M, N) partials
            < p that colsum_combine sums; splits = 1 (ks = K) writes the
            output directly;
    ks      rows of K a split;
    kch     rows of K whose B a CTA stages at once (rowdot_shape's, at
            most ks), and smem its 4 cmax kch bytes."""
    if m < 1 or batch < 1 or slots < 1:
        raise ValueError(f"rowdot GEMM takes M, batch, slots >= 1; got "
                         f"M={m}, batch={batch}, slots={slots}")
    shape = rowdot_shape(n, k)
    strips = -(-m // rowdot_rows(shape["cmax"]))
    splits = min(-(-k // 32), slots // (strips * batch))
    if splits <= 1:
        cpb = min(m, max(1, slots // batch))
        run = -(-m // cpb)
        return dict(shape, run=run, cpb=-(-m // run), splits=1, ks=k)
    ks = -(-(-(-k // 32)) // splits) * 32
    kch = min(shape["kch"], ks)
    run = -(-m // strips)
    return dict(shape, kch=kch, smem=4 * shape["cmax"] * kch, run=run,
                cpb=-(-m // run), splits=-(-k // ks), ks=ks)


@functools.lru_cache(maxsize=None)
def splitk_launch(m: int, n: int, k: int, batch: int, sms: int) -> dict:
    """How csrc/modmatmul.cu's splitk_kernel runs a (batch, m, k) @ (batch,
    k, n) GEMM on a card of `sms` SMs:

    bn      columns of B a CTA owns (the first of SPLITK_BN that holds N,
            at most 256), a thread one column;
    rg      row groups: threads bn * rg <= SPLITK_THREADS, each group
            walks every rg-th output row;
    gx      column blocks, ceil(N / bn);
    kc      rows of K a split (a multiple of SPLITK_SUB, at most
            SPLITK_MAX_KC), walked SPLITK_SUB rows a pass;
    splits  ceil(K / kc): enough CTAs for ~SPLITK_CTAS_PER_SM an SM, at
            most one a SPLITK_SUB-row block of K.  Each split writes its
            (batch, M, N) partials < p; colsum_combine sums them."""
    if not 1 <= m <= SPLITK_MAX_M or k < 1 or n < 1 or batch < 1:
        raise ValueError(f"split-K GEMM takes 1 <= M <= {SPLITK_MAX_M}, K, "
                         f"N, batch >= 1; got M={m}, K={k}, N={n}, "
                         f"batch={batch}")
    bn = next((c for c in SPLITK_BN if n <= c), SPLITK_BN[-1])
    rg = min(SPLITK_THREADS // bn, m)
    gx = -(-n // bn)
    blocks = -(-k // SPLITK_SUB)
    want = -(-(SPLITK_CTAS_PER_SM * sms) // (gx * batch))
    splits = min(blocks, max(want, -(-k // SPLITK_MAX_KC)))
    kc = -(-blocks // splits) * SPLITK_SUB
    return dict(bn=bn, rg=rg, gx=gx, kc=kc, splits=-(-k // kc))


def rowdot_model(a, b, kch: int, ks: int | None = None) -> tuple:
    """numpy model of rowdot_kernel: a (batch, m, k), b (batch, k, n) field
    values, K cut into splits of ks rows (all of K when None).  In each
    chunk of kch rows of a split, lane l of a row's warp sums the products
    of columns l, l + 32, ... of the chunk (at most ceil(kch / 32)) in
    uint64 and reduces once with reduce_p; the 32 lanes' values (< p each)
    sum below 2^31 and reduce; a chunk past the split's first adds its
    result mod p.  colsum_combine then sums the splits' partials (< p
    each) in uint64 and reduces.  Returns (the product mod p, the largest
    lane sum as a Python int)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    k = a.shape[2]
    ks = ks or k
    parts, top = [], 0
    for s0 in range(0, k, ks):
        out = np.zeros(a.shape[:2] + b.shape[2:], np.uint64)
        for k0 in range(s0, min(k, s0 + ks), kch):
            warp = np.zeros_like(out)
            for lane in range(32):
                cols = np.arange(k0 + lane, min(k, s0 + ks, k0 + kch), 32)
                sums = a[:, :, cols] @ b[:, cols]          # exact below 2^64
                top = max(top, int(sums.max(initial=0)))
                warp += reduce_p(sums)
            out = reduce_p(out + reduce_p(warp))
        parts.append(out)
    if len(parts) == 1:
        return parts[0], top
    return reduce_p(np.sum(parts, axis=0, dtype=np.uint64)), top


def colsum_model(a, b, kc: int) -> tuple:
    """numpy model of colsum_kernel and colsum_combine (and of splitk_kernel
    at kc = SPLITK_SUB, one pass a split): a (batch, m, k),
    b (batch, k, n) field values.  Each split of kc rows gives every
    (batch, column, class) a lane's uint64 sum of at most kc products,
    reduced once with reduce_p; the combine sums the splits' partials
    (each < p) in uint64 and reduces.  Returns (the product mod p, the
    largest lane sum as a Python int)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    k = a.shape[2]
    parts, top = [], 0
    for k0 in range(0, k, kc):
        sums = a[:, :, k0:k0 + kc] @ b[:, k0:k0 + kc]      # exact below 2^64
        top = max(top, int(sums.max()))
        parts.append(reduce_p(sums))
    return reduce_p(np.sum(parts, axis=0, dtype=np.uint64)), top


# ----------------------------------------------------------- coded gradient

def _ceil16(x: int) -> int:
    return -(-x // 16) * 16


def stage_bytes(bm: int, d: int) -> int:
    """One ring stage: a (bm, d) slice rounded out to 16-byte ends."""
    return _ceil16(4 * bm * d) + COPY_SLACK


def grad_smem(bm: int, stages: int, d: int, c: int, part_smem: bool) -> int:
    """Dynamic shared memory of the gradient kernel's layout
    (csrc/coded_gradient.cuh coded_grad_kernel): barriers, the ring, z
    partials of every warp, ghat(z) and, in the "smem" mode, the (d, C)
    partials."""
    return (BAR_BYTES + stages * stage_bytes(bm, d) + 4 * bm * c * GRAD_WARPS
            + 4 * bm * c + (4 * d * c if part_smem else 0))


@functools.lru_cache(maxsize=None)
def gradient_plan(m: int, d: int, c: int) -> dict:
    """How the gradient kernel runs f[n] = X~[n]^T ghat(X~[n] W~[n]):

    mode   "reg": a thread keeps the raw uint64 sums of its ept elements
                  of (d, C) in registers across its whole strip;
           "smem": reduced uint32 partials of (d, C) in shared memory;
           "atomic": one atomicAdd per slice and element (d*C too large
                  for either);
    ept    register partials a thread keeps ("reg"; 0 otherwise);
    bm     rows per slice, at most MAX_BM (a multiple of pass 1's 8-row
           block at C = 1, of its 4-row block at C > 1, when one fits);
    stages ring depth (2, or 1 when two slices do not fit);
    sbytes one ring stage's bytes;
    smem   dynamic shared memory bytes.
    Raises where one row of X~ does not fit."""
    el = d * c
    ept = -(-el // GRAD_THREADS)
    reg = next((e for e in REG_EPT if ept <= e), 0)
    cap = max(1, min(MAX_BM, m))
    for mode in (("reg",) if reg else ("smem", "atomic")):
        part = mode == "smem"
        for stages in (2, 1):
            fits = [bm for bm in range(cap, 0, -1)
                    if grad_smem(bm, stages, d, c, part) + GRAD_STATIC
                    <= SMEM_MAX]
            if fits:
                bm = fits[0]
                rb = 8 if c == 1 else 4      # pass 1's rows a lane sums
                if bm >= rb:
                    bm -= bm % rb
                return dict(mode=mode, ept=reg, bm=bm, stages=stages,
                            sbytes=stage_bytes(bm, d),
                            smem=grad_smem(bm, stages, d, c, part))
    raise ValueError(f"coded gradient: d={d}, C={c} does not fit one row "
                     f"of X~ in shared memory")


@functools.lru_cache(maxsize=None)
def max_d(c: int = 1) -> int:
    """The widest d the gradient kernel takes for a (d, C) model: 58,004
    at C = 1, a little less at larger C (its z partials share the block's
    shared memory)."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            gradient_plan(1, mid, c)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


def gradient_route(d: int, c: int) -> str:
    """How the card computes f[n] = X~[n]^T ghat(X~[n] W~[n]) for X~
    (N, m, d) and a (d, C) model, in the coded-gradient kernels and the
    fused step:

    "body"     the gradient kernel (csrc/coded_gradient.cuh), which reads
               X~ once, wherever gradient_plan fits one row of X~ in a
               block's shared memory (d <= max_d(C));
    "cluster"  past that, up to cluster_max_d(), for a (d,) model
               (C = 1): the same single read on a thread-block cluster
               (csrc/coded_gradient_cluster.cuh), each CTA holding a
               column slice of the rows and z summed across the cluster;
    "wide"     past both: Z = X~ W~ on modmatmul's row-dot kernel (A's
               K-stride 1, N = C <= 16), ghat(Z) on poly_eval, X~^T ghat(Z)
               on its column-sum kernel (the transposed view, M-stride 1)
               -- the tiled kernel for C > 16 -- each exact mod p, so the
               bits equal the body's; the fused step then runs its
               epilogue on f.  It reads X~ twice.

    Every route is exact mod p, so all three give the same bits.  C > 1
    stays on the wide route: on an H100 (NVIDIA H100 80GB HBM3, 700 W,
    chip_smoke.py phase 14) a cluster kernel with C classes took 26.44
    device ms at (50, 156, 65,536), C = 10, against the wide route's 4.32
    (PERF.md section 6), so the cluster kernel takes C = 1 only."""
    if d <= max_d(c):
        return "body"
    if c == 1 and d <= cluster_max_d():
        return "cluster"
    return "wide"


def pass1_terms(d: int) -> int:
    """Products one lane sums in pass 1 before its single reduce_p: its
    share of the warp's 1/16 of d.  Must stay below NO_REDUCE_TERMS; it
    passes NO_REDUCE58_TERMS above d = 32768, so pass 1 needs the full
    reduce_p."""
    return -(-(-(-d // GRAD_WARPS)) // 32)


def strip_run(total: int, slots: int) -> tuple:
    """(run, ctas): `total` slices (client-major, ceil(m / bm) a client)
    cut into strips of `run` consecutive slices, one strip per persistent
    CTA; `slots` is SMs x resident CTAs per SM.  CTA g walks slices
    [g * run, min(total, (g + 1) * run)).  On an H100 strips beat shorter
    runs dealt round-robin, whose extra flushes cost more than their
    closer reads save."""
    run = -(-total // slots)
    return run, -(-total // run)


def slice_copy(base: int, start: int, nbytes: int, total: int) -> dict:
    """The bulk copy of one slice: `start`/`nbytes` are the slice's byte
    offset and size in an int32 tensor of `total` bytes at address `base`.

    The span is rounded out to 16-byte boundaries inside the tensor; the
    body (16-byte aligned address and size) goes by cp.async.bulk, and the
    words outside it -- only at the tensor's ragged ends -- by plain loads.
    `lead` is the view's offset (bytes) into its shared-memory stage."""
    a_s, a_e = base + start, base + start + nbytes
    g0 = a_s // 16 * 16
    lo = max(g0, _ceil16(base))
    hi = min(_ceil16(a_e), (base + total) // 16 * 16)
    if hi <= lo:
        return dict(lead=a_s - g0, body_lo=lo, body_bytes=0,
                    head_words=nbytes // 4, tail_words=0)
    return dict(lead=a_s - g0, body_lo=lo, body_bytes=hi - lo,
                head_words=max(0, lo - a_s) // 4,
                tail_words=max(0, a_e - hi) // 4)


# ------------------------------------------------- the cluster gradient

def slot_bytes(cw: int) -> int:
    """One row segment of cw words in a cluster ring stage, rounded out to
    16-byte ends (a row starts only 4-byte aligned at odd d)."""
    return _ceil16(4 * cw) + COPY_SLACK


def cluster_smem(k: int, bm: int, stages: int, cw: int,
                 part_smem: bool) -> int:
    """Dynamic shared memory of the cluster gradient kernel's layout
    (csrc/coded_gradient_cluster.cuh): its mbarriers, the ring of bm row
    segments a stage, two w~ segments, z partials of every warp, ghat(z),
    the k ranks' z partials twice (slice parity), and in the "smem" mode
    the (cw,) partials."""
    return (CLUSTER_BAR_BYTES + (stages * bm + 2) * slot_bytes(cw)
            + 4 * bm * GRAD_WARPS + 4 * bm + 2 * 4 * k * bm
            + (4 * cw if part_smem else 0))


@functools.lru_cache(maxsize=None)
def cluster_plan(m: int, d: int, c: int = 1, k: int | None = None) -> dict:
    """How the cluster gradient kernel runs f[n] = X~[n]^T ghat(X~[n] w~[n])
    for a (d,) model (C = 1) past max_d(1): a cluster of k CTAs shares
    every row of X~, rank r holding columns [r cw, min(d, (r+1) cw)).

    k      CTAs a cluster: of CLUSTER_SIZES (CLUSTER_NONPORTABLE needs
           cudaFuncAttributeNonPortableClusterSizeAllowed), the one whose
           plan keeps three stages and brings the most of X~ a slice (bm x
           cw words a CTA), the smaller on a tie; or `k` when given;
    cw     columns a rank owns: ceil(d / k) rounded up to 4 words, so a
           rank's segment keeps its row's 16-byte alignment;
    mode   "reg" (a thread's raw uint64 sums of its ept columns in
           registers) or "smem" (reduced uint32 partials of cw columns);
    ept    register partials a thread keeps ("reg"; 0 otherwise);
    stages ring depth: 3 (slice t + 1 resident for pass 1 while slice t
           runs pass 2, t + 2 in flight), or 2 where three do not fit;
    bm     rows a slice: the most `stages` stages hold, at most MAX_BM;
    slot   one row segment's bytes in a stage (slot_bytes(cw));
    smem   dynamic shared memory bytes.
    Raises for C > 1 (the wide route's: on an H100 the cluster kernel ran
    6x slower than it at C = 10, PERF.md) and where no cluster size fits."""
    if c != 1:
        raise ValueError(f"cluster gradient: C = 1 only, got C={c}")
    best = None
    for kk in ((k,) if k else CLUSTER_SIZES):
        cw = -(-(-(-d // kk)) // 4) * 4
        if d - (kk - 1) * cw < 1:
            continue                           # a rank without columns
        reg = next((e for e in REG_EPT if -(-cw // GRAD_THREADS) <= e), 0)
        mode = "reg" if reg else "smem"
        for stages in (3, 2):
            fits = [bm for bm in range(max(1, min(MAX_BM, m)), 0, -1)
                    if cluster_smem(kk, bm, stages, cw, mode == "smem")
                    + GRAD_STATIC <= SMEM_MAX]
            if fits:
                bm = fits[0]
                pl = dict(k=kk, cw=cw, mode=mode, ept=reg, bm=bm,
                          stages=stages, slot=slot_bytes(cw),
                          smem=cluster_smem(kk, bm, stages, cw,
                                            mode == "smem"))
                score = (stages, bm * cw)
                if best is None or score > best[0]:
                    best = (score, pl)
                break
    if best is None:
        raise ValueError(f"cluster gradient: d={d} does not fit a column "
                         f"slice of X~ in a cluster's shared memory")
    return best[1]


@functools.lru_cache(maxsize=None)
def cluster_max_d() -> int:
    """The widest d the cluster gradient kernel takes (its reach), found
    as max_d finds the body's."""
    lo, hi = 1, 1 << 22
    while lo < hi:
        mid = (lo + hi + 1) // 2
        try:
            cluster_plan(1, mid)
            lo = mid
        except ValueError:
            hi = mid - 1
    return lo


def cluster_model(x, w, coeffs, plan: dict) -> tuple:
    """numpy model of the cluster gradient kernel under `plan`
    (cluster_plan's dict): x (N, m, d), w (N, d, 1) field values.  Rank r
    of a cluster sums z over its own columns as the body's pass 1 does
    (warp q takes 1/16 of the rank's columns, lane l every 32nd of them,
    one reduce_p a lane sum, the warp's and the 16 warps' values < p
    summed and reduced); the k ranks' partials (< p each, < k p in all)
    are summed and reduced, ghat is evaluated canonically (field.cuh
    horner), and each rank adds X~^T ghat over its columns: per slice of
    bm rows a sum of at most bm products, reduced with reduce_p58 ("smem")
    or kept raw in uint64 for a whole client ("reg", at most m < 4096
    rows).  Returns (f (N, d, 1) uint64 < p, the largest pass-1 lane sum,
    the largest cross-rank sum) as (array, int, int)."""
    x = np.asarray(x, dtype=np.uint64)
    w = np.asarray(w, dtype=np.uint64)
    n, m, d = x.shape
    c = w.shape[2]
    k, cw, bm = plan["k"], plan["cw"], plan["bm"]
    pp = np.uint64(P)
    zr, top1 = [], 0
    for r in range(k):
        seg = slice(r * cw, min(d, (r + 1) * cw))
        xs, ws = x[:, :, seg], w[:, seg]
        wr = xs.shape[2]
        dq = -(-wr // GRAD_WARPS)
        warps = np.zeros((n, m, c), np.uint64)
        for q in range(GRAD_WARPS):
            lanes = np.zeros_like(warps)
            for lane in range(32):
                cols = np.arange(q * dq + lane, min(wr, (q + 1) * dq), 32)
                sums = xs[:, :, cols] @ ws[:, cols]       # exact below 2^64
                top1 = max(top1, int(sums.max(initial=0)))
                lanes += reduce_p(sums)
            warps += reduce_p(lanes)
        zr.append(reduce_p(warps))
    zsum = np.sum(zr, axis=0, dtype=np.uint64)
    top2 = int(zsum.max())
    z = reduce_p(zsum)
    g = np.full(z.shape, np.uint64(int(coeffs[-1])), np.uint64)
    for co in reversed([int(v) for v in coeffs[:-1]]):
        g = (g * z % pp + np.uint64(co)) % pp            # canonical Horner
    f = np.zeros((n, d, c), np.uint64)
    xt = np.swapaxes(x, 1, 2)                            # (N, d, m)
    if plan["mode"] == "reg":
        assert m < NO_REDUCE_TERMS
        return reduce_p(xt @ g), top1, top2
    for r0 in range(0, m, bm):
        sums = xt[:, :, r0:r0 + bm] @ g[:, r0:r0 + bm]    # bm products
        f = (f + reduce_p58(sums)) % pp
    return f, top1, top2


# ---------------------------------------------------------------- poly_eval

def poly_launch(length: int, sms: int) -> dict:
    """Which csrc/field_poly.cu kernel evaluates `length` elements, and on
    how many blocks of POLY_THREADS:

    ept 1         poly_eval_short, one thread an element, when that takes
                  at most one wave (sms x POLY_BLOCKS_PER_SM blocks);
    ept POLY_EPT  poly_eval_long, the grid-stride kernel: one block a
                  chunk of POLY_THREADS * POLY_EPT elements, at most one
                  full wave, so the blocks' chunk counts differ by at
                  most one."""
    wave = sms * POLY_BLOCKS_PER_SM
    rows = -(-length // POLY_THREADS)
    if rows <= wave:
        return dict(ept=1, blocks=max(1, rows))
    return dict(ept=POLY_EPT,
                blocks=min(-(-length // (POLY_THREADS * POLY_EPT)), wave))


def horner_lazy(z, coeffs) -> np.ndarray:
    """sum_t coeffs[t] z^t mod p as csrc/field_poly.cu evaluates it: g
    stays in [0, 2p) between steps, g * z + c < 2^54 is folded twice (the
    second fold in 32 bits), and one conditional subtract ends it."""
    z = np.asarray(z, dtype=np.uint64)
    co = [np.uint64(int(c)) for c in coeffs]
    g = np.full(z.shape, co[-1], np.uint64)
    for c in reversed(co[:-1]):
        x = g * z + c
        assert (x < np.uint64(1 << 54)).all()
        y = (x & np.uint64(MASK26)) + np.uint64(5) * (x >> np.uint64(26))
        assert (y < np.uint64(1 << 31)).all()
        g = (y & np.uint64(MASK26)) + np.uint64(5) * (y >> np.uint64(26))
        assert (g < np.uint64(2 * P)).all()
    return np.where(g >= np.uint64(P), g - np.uint64(P), g)


# ------------------------------------------------------------ the wide route

EPI_WARPS = 8                       # csrc/fused_step.cu kEpiWarps


def wide_model(x, w, coeffs, sms: int) -> np.ndarray:
    """numpy model of the wide route's gradient on a card of `sms` SMs: x
    (N, m, d), w (N, d, C <= 16) field values.  Z = X~ W~ as the row-dot
    kernel sums it (rowdot_model at rowdot_shape's chunk of K), ghat(Z) by
    poly_eval's lazy Horner, X~^T ghat(Z) as the column-sum kernel and its
    combine sum it (colsum_model at colsum_launch's split).  Returns
    (N, d, C) uint64 values < p."""
    n, m, d = x.shape
    c = w.shape[2]
    z, _ = rowdot_model(x, w, rowdot_shape(c, d)["kch"])
    g = horner_lazy(z, coeffs)
    f, _ = colsum_model(np.swapaxes(np.asarray(x, np.uint64), 1, 2), g,
                        colsum_launch(d, c, m, n, sms)["kc"])
    return f


def _warp_sums(terms) -> np.ndarray:
    """The epilogue's sum over its first axis (N clients or holders):
    warp w sums rows w, w + 8, ... in uint64 and reduces, the 8 warps'
    values (< p each) are summed and reduced once more."""
    parts = [reduce_p(np.sum(terms[w::EPI_WARPS], axis=0, dtype=np.uint64))
             for w in range(EPI_WARPS)]
    return reduce_p(np.sum(parts, axis=0, dtype=np.uint64))


def epilogue_model(f, adv_off, dfull, rvec, base, xty, wsh, radd, r0sh, *,
                   q_eta: int, inv2k1: int, k1: int) -> np.ndarray:
    """numpy model of csrc/fused_step.cu's fused_epilogue_kernel on a
    gradient f (N, d, C) of values < p (either route's): the decode fold
    common = sum_n dfull[n] (f[n] + adv_off[n]), each holder's gradient
    (base + common - xty) * q_eta, the TruncPr open c = sum_h rvec[h]
    (scaled[h] + radd[h]), its low k1 bits minus r0sh times inv(2^k1), and
    w' = wsh - delta.  Returns w' (N, d, C) as uint64 values < p."""
    u = lambda a: np.asarray(a, np.uint64)                  # noqa: E731
    f, base, xty, wsh, radd, r0sh = map(u, (f, base, xty, wsh, radd, r0sh))
    col = lambda v: u(v)[:, None, None]                     # noqa: E731
    pp = np.uint64(P)
    common = _warp_sums((f + col(adv_off)) % pp * col(dfull))
    scaled = (base + common[None] + pp - xty) % pp * np.uint64(q_eta % P) % pp
    c0 = _warp_sums(col(rvec) * ((scaled + radd) % pp)) & np.uint64(
        (1 << k1) - 1)
    delta = (scaled + pp - (c0[None] + pp - r0sh) % pp) % pp \
        * np.uint64(inv2k1 % P) % pp
    return (wsh + pp - delta) % pp
