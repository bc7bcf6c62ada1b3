"""repro_torch kernels/plan.py: the launchers' host-side choices, on the CPU.

The CUDA kernels run only on a card; every launch parameter they take is
decided in kernels/plan.py by pure functions, checked here: the reduction
mod p against `%`, the field GEMM's path at every main-path shape, the
thin kernel's instance and grid, the column-sum kernel's instance, K
splits and grid and a numpy model of its lane sums and split combine
(at random and at p - 1 values), poly_eval's grid and lazy Horner step,
the gradient kernel's plan (mode, slice height,
ring, shared memory, the no-reduce bounds), its strip split, the 16-byte
peel of each slice's bulk copy, and a numpy model of the gradient kernel
(its lanes, reductions and strip/flush schedule) against the plain coded
gradient, at random and at worst-case (p - 1) values.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import field
from repro_torch.kernels import plan, ref

P = field.P
# cifar10_case2: N=50 clients, mk=902 coded rows, d=3073, K=10, T=7
N, MK, D, KK, T = 50, 902, 3073, 10, 7


def test_reduce_p_matches_mod_on_edges_and_random():
    edges = [0, P - 1, P, P + 1, 1 << 26, (1 << 26) + 4, 1 << 52,
             (P - 1) ** 2, 64 * (P - 1) ** 2, 1 << 58, 4095 * (P - 1) ** 2,
             (1 << 64) - 1, (1 << 64) - 2, (1 << 41) - 1, (1 << 27) + 9]
    rng = np.random.default_rng(0)
    rand = rng.integers(0, 1 << 63, size=20000, dtype=np.uint64) * \
        np.uint64(2) + rng.integers(0, 2, size=20000, dtype=np.uint64)
    for xs in (np.array(edges, dtype=np.uint64), rand):
        want = np.array([int(v) % P for v in xs], dtype=np.uint64)
        np.testing.assert_array_equal(plan.reduce_p(xs), want)
    assert plan.P == P


def test_reduce_p58_matches_mod_below_2_58():
    """The thin GEMM's outputs and pass 2's per-slice sums (at most 64
    products < 2^52)."""
    edges = [0, P - 1, P, 1 << 26, (1 << 52) - 1, 64 * (P - 1) ** 2,
             (1 << 58) - 1, (1 << 32) * 5, (1 << 35) + 12345]
    rng = np.random.default_rng(1)
    rand = rng.integers(0, 1 << 58, size=20000, dtype=np.uint64)
    for xs in (np.array(edges, dtype=np.uint64), rand):
        want = np.array([int(v) % P for v in xs], dtype=np.uint64)
        np.testing.assert_array_equal(plan.reduce_p58(xs), want)


def _b_stride(k, n, transposed=False):
    b = torch.empty((n, k), dtype=torch.int32).t() if transposed else \
        torch.empty((k, n), dtype=torch.int32)
    return b.stride(1)


@pytest.mark.parametrize("what,m,k,n", [
    ("share X (setup)", N, T, 6151),
    ("lcc encode (setup, per holder)", N, KK + T, 6151),
    ("reconstruct coded X (setup)", 1, T + 1, 6151),
    ("share (per step)", N, T, 3073),
    ("reconstruct from all holders (per step)", 1, N, 3073),
    ("open model (per step)", 1, T + 1, 3073),
    ("model encode (per step, batched)", N, KK + T, 3073),
    ("decode base (per step, batched)", 1, N, 3073),
    ("siloed decode (per step, batched)", 1, N - 1, 3073)])
def test_main_path_gemms_take_the_thin_path(what, m, k, n):
    assert plan.gemm_path(m, k, _b_stride(k, n), n) == "thin", what
    launch = plan.thin_launch(m, n, k, 1, 132)
    assert k <= launch["kmax"] and launch["cols"] * launch["kmax"] <= 64
    if k in (T, T + 1, KK + T):             # share, reconstruct, LCC encode
        assert launch["kmax"] == k          # an exact instance: no padding


def _groups(m, n, k, batch):
    launch = plan.thin_launch(m, n, k, batch, 132)
    return launch["rpg"], launch["groups"]


def test_thin_row_groups_fill_the_card_at_narrow_n():
    # per-step share (50,7)@(7,3073): 4 column blocks -> rows split 50 ways
    assert _groups(N, 3073, T, 1) == (1, 50)
    assert plan.thin_launch(N, 3073, T, 1, 132)["gx"] == 4
    # model encode (50,50,17)@(50,17,3073): 7 column blocks x 50 batches
    assert _groups(N, 3073, KK + T, N) == (N, 1)
    # share X (50,7)@(7,27.7M): the columns fill the card, ~16 blocks an SM
    assert _groups(N, 27715387, T, 1) == (N, 1)
    assert plan.thin_launch(N, 27715387, T, 1, 132)["gx"] == 132 * 16
    for m, n, k, b in [(1, 5, 8, 1), (64, 100, 64, 3), (17, 9019, 7, 1)]:
        rpg, groups = _groups(m, n, k, b)
        assert rpg * groups >= m > rpg * (groups - 1)
        assert groups <= 65535


def test_other_gemms_take_the_tiled_path():
    # X^T y: (d, m) @ (m, 1) per client, K = 9019, A the transposed view of
    # the (N, m, d) shares: the column-sum path (the tiled path before it)
    xt = torch.empty((N, 9019, D), dtype=torch.int32).transpose(1, 2)
    y = torch.empty((N, 9019, 1), dtype=torch.int32)
    assert plan.gemm_path(D, 9019, y.stride(2), 1, xt.stride(1)) == "colsum"
    # A's K-stride 1 (a contiguous A) takes the row-dot path; N > 16 with
    # M > 128 stays tiled
    assert plan.gemm_path(D, 9019, 1, 1, 9019, 1) == "rowdot"
    assert plan.gemm_path(D, 9019, 1, 17, 1) == "tiled"
    assert plan.gemm_path(8, 65, 1, 100) == "splitk"             # K > 64
    assert plan.gemm_path(65, 8, 1, 100) == "tiled"              # M > 64
    assert plan.gemm_path(8, 8, _b_stride(8, 100, True), 100) == "tiled"
    assert plan.gemm_path(8, 8, 7, 1) == "thin"     # one column: any stride
    ks = (1, 7, 8, 9, 14, 15, 16, 17, 18, 24, 25, 33, 49, 50, 64)
    assert [plan.thin_launch(1, 100, k, 1, 132)["kmax"] for k in ks] == [
        7, 7, 8, 16, 16, 16, 16, 17, 24, 24, 32, 48, 64, 64, 64]
    for kmax, cols in plan.THIN_KMAX:
        assert cols * kmax <= 64 and kmax <= plan.NO_REDUCE58_TERMS
    for k in (0, 65):
        with pytest.raises(ValueError):
            plan.thin_launch(1, 100, k, 1, 132)


def _xty(n, m, d, c):
    """X^T y's operands as setup forms them: the transposed view of the
    (N, m, d) shares and the (N, m, C) targets (a view (N, m, 1) at C = 1)."""
    xt = torch.empty((n, m, d), dtype=torch.int32).transpose(1, 2)
    y = torch.empty((n, m, c), dtype=torch.int32)
    return xt, y


@pytest.mark.parametrize("what,n,m,d,c", [
    ("cifar10_case2", N, 9019, D, 1),
    ("cifar10_case2, a 10-class objective", N, 9019, D, 10),
    ("mnist10_like", 13, 390, 24, 10),
    ("cifar10_like", 15, 480, 96, 1),
    ("smoke", 13, 96, 12, 1)])
def test_x_t_y_takes_the_colsum_path(what, n, m, d, c):
    from repro_torch.kernels import modmatmul as mm
    xt, y = _xty(n, m, d, c)
    assert mm.path_of(xt, y) == "colsum", what
    assert mm.path_of(xt.contiguous(), y) == "rowdot", what   # K-stride 1


def _tasks(m, k, batch, launch):
    return batch * -(-m // 32) * launch["splits"]


@pytest.mark.parametrize("m,n,k,batch", [
    (D, 1, 9019, N), (D, 10, 9019, N), (24, 10, 390, 13), (33, 1, 65, 3),
    (257, 2, 4097, 2), (D, 10, 8193, 1), (95, 16, 9019, 2),
    (129, 1, 40000, 1), (100, 3, 20, 2), (70, 5, 300, 2)])
def test_colsum_launch_covers_k_and_the_tasks(m, n, k, batch):
    launch = plan.colsum_launch(m, n, k, batch, 132)
    kc, splits = launch["kc"], launch["splits"]
    assert launch["cmax"] == next(c for c in plan.COLSUM_CMAX if n <= c)
    assert kc % plan.COLSUM_ROWS == 0 and kc <= plan.NO_REDUCE_TERMS
    assert splits * kc >= k > (splits - 1) * kc
    # csrc/modmatmul.cu repro_modmatmul_colsum's check of the grid
    tasks = _tasks(m, k, batch, launch)
    assert launch["ctas"] * plan.COLSUM_WARPS >= tasks > \
        (launch["ctas"] - 1) * plan.COLSUM_WARPS


def test_colsum_launch_fills_the_card_at_cifar10_case2():
    """X^T y at cifar10_case2: 50 x 97 column groups a split; ~26 splits
    of 352 rows give ~15 waves of 8-warp CTAs at 8 CTAs an SM, so the last
    wave's imbalance is a few percent."""
    launch = plan.colsum_launch(D, 1, 9019, N, 132)
    assert launch == dict(cmax=1, kc=352, splits=26, ctas=15763)
    assert launch["ctas"] / (132 * 8) > 14
    assert plan.colsum_launch(D, 10, 9019, N, 132)["cmax"] == 10
    for n, k in ((17, 100), (0, 100), (1, 0)):
        with pytest.raises(ValueError):
            plan.colsum_launch(D, n, k, N, 132)


@pytest.mark.parametrize("b,m,k,n,kc", [
    (3, 33, 65, 1, None), (2, 57, 4097, 2, None), (1, 40, 8193, 10, None),
    (2, 19, 9019, 16, None), (1, 7, 40000, 1, None), (2, 65, 1000, 10, 100),
    (1, 40, 8193, 3, 4096), (2, 100, 20, 3, None)])
def test_colsum_model_matches_plain(b, m, k, n, kc):
    rng = np.random.default_rng(b * m + k + n)
    a = rng.integers(0, P, size=(b, m, k), dtype=np.int64).astype(np.int32)
    y = rng.integers(0, P, size=(b, k, n), dtype=np.int64).astype(np.int32)
    kc = kc or plan.colsum_launch(m, n, k, b, 132)["kc"]
    want = ref.modmatmul_batched(torch.from_numpy(a), torch.from_numpy(y))
    np.testing.assert_array_equal(plan.colsum_model(a, y, kc)[0],
                                  want.numpy())


@pytest.mark.parametrize("k,kc", [(8193, 4096), (4096, 4096), (40000, 352)])
def test_colsum_model_at_p_minus_1(k, kc):
    """x = y = p - 1: a lane of kc = NO_REDUCE_TERMS rows sums 4096
    products to within 2^42 of 2^64 (one more would wrap), and the splits'
    combine of up to 114 partials; the model still equals the plain
    product."""
    a = np.full((1, 5, k), P - 1, np.int32)
    y = np.full((1, k, 2), P - 1, np.int32)
    got, top = plan.colsum_model(a, y, kc)
    assert top == min(k, kc) * (P - 1) ** 2 < 1 << 64
    if kc == plan.NO_REDUCE_TERMS:
        assert top + (P - 1) ** 2 >= 1 << 64
    want = ref.modmatmul_batched(torch.from_numpy(a), torch.from_numpy(y))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("m,d,c,want", [
    (MK, D, 1, dict(mode="reg", ept=8, bm=8, stages=2)),
    (MK, D, 10, dict(mode="smem", ept=0, bm=4, stages=2)),
    (98, 24, 10, dict(mode="reg", ept=1, bm=64, stages=2)),
    (3, 24, 1, dict(mode="reg", ept=1, bm=3, stages=2)),
    (1, 40000, 1, dict(mode="atomic", ept=0, bm=1, stages=1))])
def test_gradient_plan(m, d, c, want):
    pl = plan.gradient_plan(m, d, c)
    assert {k: pl[k] for k in want} == want
    assert pl["smem"] <= plan.SMEM_MAX
    assert pl["smem"] == plan.grad_smem(pl["bm"], pl["stages"], d, c,
                                        pl["mode"] == "smem")
    assert pl["sbytes"] == plan.stage_bytes(pl["bm"], d)
    assert pl["sbytes"] % 16 == 0 and \
        pl["sbytes"] >= 4 * pl["bm"] * d + plan.COPY_SLACK
    assert 1 <= pl["bm"] <= plan.NO_REDUCE58_TERMS     # pass 2: reduce_p58
    if pl["mode"] == "reg":
        assert pl["ept"] * plan.GRAD_THREADS >= d * c
    assert plan.pass1_terms(d) < plan.NO_REDUCE_TERMS


def test_no_reduce_bound_covers_the_d_limit():
    """Pass 1's lane sums stay inside uint64 at the widest d the plan
    takes, but pass reduce_p58's 64 terms above d = 32768: pass 1 reduces
    with the full reduce_p.  Pass 2's per-slice sums (bm rows) and the thin
    GEMM's outputs (K terms) stay within reduce_p58's."""
    widest = plan.max_d()
    assert 50000 < widest < 60000
    assert plan.pass1_terms(widest) == -(-(-(-widest // 16)) // 32)
    assert plan.pass1_terms(widest) < plan.NO_REDUCE_TERMS
    assert plan.pass1_terms(32768) == plan.NO_REDUCE58_TERMS
    assert plan.pass1_terms(40000) > plan.NO_REDUCE58_TERMS
    assert plan.NO_REDUCE_TERMS * (P - 1) ** 2 < 1 << 64
    assert plan.NO_REDUCE58_TERMS * (P - 1) ** 2 < 1 << 58
    assert plan.MAX_BM <= plan.NO_REDUCE58_TERMS
    assert plan.THIN_MAX_K <= plan.NO_REDUCE58_TERMS
    with pytest.raises(ValueError):
        plan.gradient_plan(1, widest + 1, 1)


def _strip(total, run, g):
    """The slices CTA g walks (coded_grad_kernel: s0 = g * run, cnt =
    min(run, total - s0))."""
    return range(g * run, min(total, (g + 1) * run))


@pytest.mark.parametrize("total,slots", [(N * 113, 132), (7, 132),
                                         (1000, 264), (26, 26)])
def test_strips_cover_every_slice_once(total, slots):
    run, ctas = plan.strip_run(total, slots)
    assert ctas <= slots
    # csrc/coded_gradient.cuh launch_coded_grad's check of the split
    assert ctas * run >= total > (ctas - 1) * run
    seen, sizes = [], []
    for g in range(ctas):
        mine = _strip(total, run, g)
        seen.extend(mine)
        sizes.append(len(mine))
    assert seen == list(range(total))
    assert max(sizes) == run and min(sizes) >= 1


def test_strips_cut_the_accumulator_atomics():
    """cifar10_case2 at bm = 8: one flush per (strip, client) instead of
    one atomic per (slice, element): ~(S + N) * d atomics a step."""
    bm = plan.gradient_plan(MK, D, 1)["bm"]
    spb = -(-MK // bm)
    total = N * spb
    run, ctas = plan.strip_run(total, 132)
    touched = sum(len({s // spb for s in _strip(total, run, g)})
                  for g in range(ctas))
    assert touched <= ctas + N
    assert touched * D < total * D / 20


def test_slice_copy_peel_at_cifar10_case2_offsets():
    bm = plan.gradient_plan(MK, D, 1)["bm"]
    total = N * MK * D * 4
    assert (MK * D * 4) % 16 == 8           # odd clients start 8 bytes off
    peeled = 0
    for n in range(N):
        for r0 in range(0, MK, bm):
            rows = min(bm, MK - r0)
            start = (n * MK + r0) * D * 4
            cp = plan.slice_copy(0, start, rows * D * 4, total)
            assert cp["body_lo"] % 16 == 0 and cp["body_bytes"] % 16 == 0
            assert cp["lead"] == start % 16
            if start % 16:
                assert r0 % 4 or n % 2          # 4 | r0 and even n align
            assert 0 <= cp["body_lo"] and \
                cp["body_lo"] + cp["body_bytes"] <= total
            peeled += cp["head_words"] + cp["tail_words"]
    assert total % 16 == 0 and peeled == 0  # every slice is one bulk copy


@pytest.mark.parametrize("base,n_words,start_w,len_w", [
    (4, 1000, 0, 100),      # base 4 bytes off: the first slice peels a head
    (0, 1001, 900, 101),    # 4004-byte tensor: the last slice peels a tail
    (8, 6, 0, 6),           # a tensor smaller than one 16-byte line
    (12, 50, 3, 47)])
def test_slice_copy_reads_only_the_tensor(base, n_words, start_w, len_w):
    data = np.arange(n_words, dtype=np.int64) + 1
    total = 4 * n_words
    cp = plan.slice_copy(base, 4 * start_w, 4 * len_w, total)
    a_s = base + 4 * start_w
    g0 = a_s // 16 * 16
    stage = np.zeros((4 * len_w + plan.COPY_SLACK) // 4 + 8, np.int64)
    lo, nb = cp["body_lo"], cp["body_bytes"]
    assert lo % 16 == 0 and nb % 16 == 0
    assert base <= lo and lo + nb <= base + total
    for addr in range(lo, lo + nb, 4):                   # the bulk copy
        stage[(addr - g0) // 4] = data[(addr - base) // 4]
    heads = range(a_s, a_s + 4 * cp["head_words"], 4)
    tails = range(a_s + 4 * (len_w - cp["tail_words"]), a_s + 4 * len_w, 4)
    for addr in [*heads, *tails]:                        # plain loads
        stage[(addr - g0) // 4] = data[(addr - base) // 4]
    view = stage[cp["lead"] // 4: cp["lead"] // 4 + len_w]
    np.testing.assert_array_equal(view, data[start_w:start_w + len_w])


def _pass1(sl, w):
    """z = sl @ w as the kernel's pass 1 sums it: warp q takes columns
    [q dq, (q+1) dq), lane l of it every 32nd column from q dq + l; each
    lane's uint64 sum is reduced once with reduce_p, the 32 lanes summed
    (< 2^31) and reduced, then the 16 warps.  Returns (z, the largest
    lane sum)."""
    d = sl.shape[1]
    dq = -(-d // plan.GRAD_WARPS)
    j = np.arange(d)
    lane = (j // dq) * 32 + (j % dq) % 32
    onehot = np.zeros((d, plan.GRAD_THREADS), np.uint64)
    onehot[j, lane] = 1
    z = np.zeros((sl.shape[0], w.shape[1]), np.uint64)
    top = 0
    for cc in range(w.shape[1]):
        sums = (sl * w[:, cc]) @ onehot              # (rows, 512) lane sums
        top = max(top, int(sums.max()))
        warp = plan.reduce_p(plan.reduce_p(sums).reshape(-1, 16, 32).sum(2))
        z[:, cc] = plan.reduce_p(warp.sum(1))
    return z, top


def _model_gradient(x, w, co, slots):
    """numpy model of coded_grad_kernel: strips of slices (plan.strip_run),
    pass 1 by lanes (_pass1), Horner, pass 2 per the plan's mode -- "reg":
    raw uint64 sums across the strip, reduce_p every NO_REDUCE_TERMS rows;
    "smem" / "atomic": each slice's sums reduced with reduce_p58 -- flushed
    once per (strip, client) into a uint64 accumulator ("atomic": added per
    slice), then the mod-p write.  Returns (f, the largest pass-1 lane
    sum)."""
    n, m, d = x.shape
    c = w.shape[2]
    pl = plan.gradient_plan(m, d, c)
    bm = pl["bm"]
    spb = -(-m // bm)
    total = n * spb
    xs, ws = x.astype(np.uint64), w.astype(np.uint64)
    facc = np.zeros((n, d, c), np.uint64)
    coeffs = [int(v) for v in co]
    run, ctas = plan.strip_run(total, slots)
    top = 0
    for g in range(ctas):
        mine = _strip(total, run, g)
        acc = np.zeros((d, c), np.uint64)
        terms = 0
        for s in mine:
            cl, r0 = s // spb, (s % spb) * bm
            sl = xs[cl, r0:r0 + bm]
            z, lane_top = _pass1(sl, ws[cl])
            top = max(top, lane_top)
            gz = np.zeros_like(z)
            for cf in reversed(coeffs):
                gz = plan.reduce_p(gz * z + np.uint64(cf))
            part = sl.T @ gz                        # <= bm <= 64 products
            if pl["mode"] == "reg":
                if terms + len(sl) >= plan.NO_REDUCE_TERMS:
                    acc, terms = plan.reduce_p(acc), 1
                terms += len(sl)
                acc += part
            elif pl["mode"] == "smem":
                acc = plan.reduce_p(acc + plan.reduce_p58(part))
            else:
                facc[cl] += plan.reduce_p58(part)
            if s == mine[-1] or (s + 1) // spb != cl:
                facc[cl] += plan.reduce_p(acc)
                acc[:] = 0
                terms = 0
    return plan.reduce_p(facc).astype(np.int32), top


@pytest.mark.parametrize("n,m,d,c,degree,slots", [
    (3, 37, 29, 1, 1, 4), (5, 13, 24, 10, 3, 3), (2, 130, 300, 10, 1, 7),
    (4, 1, 6, 1, 3, 132), (2, 19, 5000, 1, 1, 3)])
def test_gradient_schedule_model_matches_plain(n, m, d, c, degree, slots):
    rng = np.random.default_rng(n * m + d + c)
    x = rng.integers(0, P, size=(n, m, d), dtype=np.int64).astype(np.int32)
    w = rng.integers(0, P, size=(n, d, c), dtype=np.int64).astype(np.int32)
    co = rng.integers(0, P, size=degree + 1, dtype=np.int64).astype(np.int32)
    want = ref.coded_gradient_matrix(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(co))
    np.testing.assert_array_equal(_model_gradient(x, w, co, slots)[0],
                                  want.numpy())


def test_gradient_model_at_p_minus_1_past_d_32768():
    """x = w = p - 1 at d = 40000 (the "atomic" mode): pass 1's lane sums
    reach past 2^58, where reduce_p58 would be wrong; the model, with the
    kernel's reductions, still equals the plain gradient."""
    n, m, d = 2, 3, 40000
    x = np.full((n, m, d), P - 1, np.int32)
    w = np.full((n, d, 1), P - 1, np.int32)
    co = np.array([5, P - 1], np.int32)
    assert plan.gradient_plan(m, d, 1)["mode"] == "atomic"
    got, top = _model_gradient(x, w, co, 132)
    assert top >= 1 << 58
    want = ref.coded_gradient_matrix(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(co))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("length,want", [
    (45100, dict(ept=1, blocks=177)), (1, dict(ept=1, blocks=1)),
    (256 * 1056, dict(ept=1, blocks=1056)),
    (256 * 1056 + 1, dict(ept=8, blocks=133)),
    (1 << 26, dict(ept=8, blocks=1056))])
def test_poly_launch_is_at_most_one_wave(length, want):
    """poly_eval: one thread an element while that fits one wave (the 8
    blocks an SM the long kernel's launch bounds keep resident), so one
    step's z (45,100) spreads over 177 blocks; past that the grid-stride
    kernel's blocks walk equal 2048-element chunk counts to within one."""
    launch = plan.poly_launch(length, 132)
    assert launch == want
    per_block = plan.POLY_THREADS * launch["ept"]
    chunks = -(-length // per_block)
    per = [len(range(b, chunks, launch["blocks"]))
           for b in range(launch["blocks"])]
    assert max(per) - min(per) <= 1 and min(per) >= 1


@pytest.mark.parametrize("degree", [0, 1, 3, 7, 63])
def test_horner_lazy_matches_plain(degree):
    """The kernel's lazy step (g in [0, 2p) between steps, two folds) at
    random values and at the edges: z and every coefficient p - 1, 0, 1."""
    rng = np.random.default_rng(degree)
    z = np.concatenate([rng.integers(0, P, 5000), [0, 1, P - 1, P - 2]])
    for co in (rng.integers(0, P, degree + 1), np.full(degree + 1, P - 1),
               np.arange(degree + 1) % 2):
        want = ref.poly_eval(torch.from_numpy(z.astype(np.int32)),
                             torch.from_numpy(co.astype(np.int32)))
        np.testing.assert_array_equal(plan.horner_lazy(z, co), want.numpy())



# ------------------------------------------- the row-dot and split-K paths

def _contig(*shape):
    return torch.empty(shape, dtype=torch.int32)


@pytest.mark.parametrize("what,ng,mg,d,c", [
    ("mpc_baseline Z = X W, cifar10_case2", 16, 3006, D, 1),
    ("the same at a 10-class objective", 16, 3006, D, 10),
    ("mpc_baseline Z = X W, cifar10_like", 5, 160, 96, 1),
    ("mpc_baseline Z = X W, mnist10_like", 4, 130, 24, 10)])
def test_baseline_z_takes_the_rowdot_path(what, ng, mg, d, c):
    from repro_torch.kernels import modmatmul as mm
    assert mm.path_of(_contig(ng, mg, d), _contig(ng, d, c)) == "rowdot", what
    # a batch stride of 0 (an expanded A) keeps the path
    assert mm.path_of(_contig(mg, d)[None].expand(ng, mg, d),
                      _contig(ng, d, c)) == "rowdot"


@pytest.mark.parametrize("b", [1, 32, 128])
def test_serving_scores_take_the_splitk_path(b):
    from repro_torch.kernels import modmatmul as mm
    a, w = _contig(b, D), _contig(D, N)
    assert mm.path_of(a[None], w[None]) == "splitk"
    assert plan.gemm_path(b, D, w.stride(1), N, a.stride(0),
                          a.stride(1)) == "splitk"


@pytest.mark.parametrize("m,k,n,a_st,b_col,want", [
    (3073, 9019, 1, (9019, 1), 1, "rowdot"),      # contiguous A, N <= 16
    (3073, 9019, 17, (1, 3073), 1, "tiled"),      # N > 16, M > 128
    (8, 65, 100, (65, 1), 1, "splitk"),           # K > 64, M <= 128
    (65, 8, 100, (8, 1), 1, "tiled"),             # M > 64, K <= 64
    (8, 8, 100, (8, 1), 8, "tiled"),              # strided B
    (129, 65, 100, (65, 1), 1, "tiled"),          # M past the split-K path
    (128, 65, 100, (65, 1), 1, "splitk"),
    (128, 65, 100, (65, 1), 65, "tiled"),         # ... with a strided B
    (200, 40, 16, (1, 200), 1, "colsum"),         # M-stride 1 first
    (200, 40, 16, (40, 1), 1, "rowdot"),
    (50, 17, 3073, (17, 1), 1, "thin")])
def test_gemm_path_order(m, k, n, a_st, b_col, want):
    assert plan.gemm_path(m, k, b_col, n, *a_st) == want


@pytest.mark.parametrize("m,n,k,batch,slots", [
    (3006, 1, D, 16, 264), (3006, 10, D, 16, 132), (3006, 16, D, 16, 132),
    (31, 1, 65, 3, 264), (1, 10, 4097, 1, 132), (3006, 2, 9019, 1, 264),
    (7, 1, 200000, 2, 132), (100, 3, 50, 300, 264), (24, 10, 96, 4, 264)])
def test_rowdot_launch_covers_m_and_k(m, n, k, batch, slots):
    launch = plan.rowdot_launch(m, n, k, batch, slots)
    kch, run, cpb = launch["kch"], launch["run"], launch["cpb"]
    ks, splits = launch["ks"], launch["splits"]
    assert launch["cmax"] == next(c for c in plan.ROWDOT_CMAX if n <= c)
    assert 1 <= kch <= ks <= k and -(-kch // 32) <= plan.NO_REDUCE_TERMS
    assert launch["smem"] == 4 * launch["cmax"] * kch <= plan.SMEM_MAX
    # csrc/modmatmul.cu repro_modmatmul_rowdot's checks of the strips and
    # of the splits of K
    assert run * cpb >= m > run * (cpb - 1)
    assert splits * ks >= k > (splits - 1) * ks
    assert splits == 1 or ks % 32 == 0
    assert cpb * batch * splits <= max(slots, batch)   # one wave when it can
    if ks * launch["cmax"] * 4 <= plan.SMEM_MAX:
        assert kch == ks                       # a split's B staged once a CTA


def test_rowdot_launch_at_the_baselines_z():
    """Z = X W at cifar10_case2: B staged whole (12 KB at C' = 1, 123 KB at
    10), the resident CTAs dealt evenly over the 16 groups."""
    assert plan.rowdot_launch(3006, 1, D, 16, 264) == dict(
        cmax=1, kch=D, smem=4 * D, run=188, cpb=16, splits=1, ks=D)
    assert plan.rowdot_launch(3006, 10, D, 16, 132) == dict(
        cmax=10, kch=D, smem=40 * D, run=376, cpb=8, splits=1, ks=D)
    for n, k in ((17, 100), (0, 100), (1, 0)):
        with pytest.raises(ValueError):
            plan.rowdot_shape(n, k)


@pytest.mark.parametrize("m,n,k,batch", [
    (1, 50, D, 1), (32, 50, D, 1), (128, 50, D, 1), (31, 130, 4097, 2),
    (3006 // 30, 500, 9019, 1), (1, 1, 65, 1), (128, 1000, 65, 3),
    (64, 7, 300000, 1), (5, 13, 96, 4)])
def test_splitk_launch_covers_n_and_k(m, n, k, batch):
    launch = plan.splitk_launch(m, n, k, batch, 132)
    bn, rg, gx = launch["bn"], launch["rg"], launch["gx"]
    kc, splits = launch["kc"], launch["splits"]
    assert bn in plan.SPLITK_BN and bn * rg <= plan.SPLITK_THREADS
    assert 1 <= rg <= m
    assert gx * bn >= n > (gx - 1) * bn
    assert kc % plan.SPLITK_SUB == 0 and kc <= plan.SPLITK_MAX_KC
    assert splits * kc >= k > (splits - 1) * kc


def test_splitk_launch_at_serving():
    """Serving's (B, 3073) @ (3073, 50): 49 splits of 64 rows, one CTA
    each."""
    for b, rg in ((1, 1), (32, 4), (128, 4)):
        assert plan.splitk_launch(b, N, D, 1, 132) == dict(
            bn=64, rg=rg, gx=1, kc=64, splits=49)
    for m, n, k in ((129, 10, 100), (0, 10, 100), (1, 0, 100), (1, 1, 0)):
        with pytest.raises(ValueError):
            plan.splitk_launch(m, n, k, 1, 132)


@pytest.mark.parametrize("b,m,k,n,kch", [
    (2, 5, D, 1, None), (1, 3, D, 10, None), (3, 4, 65, 16, None),
    (1, 2, 4097, 2, None), (2, 3, 1000, 10, 300), (1, 1, 31, 1, None)])
def test_rowdot_model_matches_plain(b, m, k, n, kch):
    rng = np.random.default_rng(b * m + k + n)
    a = rng.integers(0, P, size=(b, m, k), dtype=np.int64).astype(np.int32)
    y = rng.integers(0, P, size=(b, k, n), dtype=np.int64).astype(np.int32)
    kch = kch or plan.rowdot_shape(n, k)["kch"]
    want = ref.modmatmul_batched(torch.from_numpy(a), torch.from_numpy(y))
    np.testing.assert_array_equal(plan.rowdot_model(a, y, kch)[0],
                                  want.numpy())


@pytest.mark.parametrize("k,n", [(plan.ROWDOT_MAX_CHUNK // 4, 1),
                                 (plan.SMEM_MAX // 4 + 100, 1), (D, 16)])
def test_rowdot_model_at_p_minus_1(k, n):
    """x = y = p - 1 at the largest chunk rowdot_shape gives (and one past
    it: two chunks, the second added into the first): every lane sum
    stays below 2^64 and the model equals the plain product."""
    kch = plan.rowdot_shape(n, k)["kch"]
    a = np.full((1, 2, k), P - 1, np.int32)
    y = np.full((1, k, n), P - 1, np.int32)
    got, top = plan.rowdot_model(a, y, kch)
    assert top == -(-kch // 32) * (P - 1) ** 2 < 1 << 64
    want = ref.modmatmul_batched(torch.from_numpy(a), torch.from_numpy(y))
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("b", [1, 32, 128])
def test_rowdot_splits_k_at_a_ranks_serving_scores(b):
    """A sharded:4 rank's scores (B, 3073) @ (3073, 13): too few rows to
    fill the card, so K is cut over CTAs (one CTA walked all of K at
    B = 1) into splits of a multiple of 32 rows, the strips kept whole
    warps' worth of rows; the split model equals a numpy mod-p product,
    also at x = y = p - 1."""
    slots = 132                     # cmax 16 stages all of B: 1 CTA an SM
    launch = plan.rowdot_launch(b, 13, D, 1, slots)
    assert launch["splits"] > 1 and launch["ks"] % 32 == 0
    assert launch["run"] >= min(b, plan.rowdot_rows(16))
    assert launch["cpb"] * launch["splits"] <= slots
    rng = np.random.default_rng(b)
    for worst in (False, True):
        a = rng.integers(0, P, size=(1, b, D), dtype=np.int64)
        y = rng.integers(0, P, size=(1, D, 13), dtype=np.int64)
        if worst:
            a[:], y[:] = P - 1, P - 1
        got, top = plan.rowdot_model(a, y, launch["kch"], launch["ks"])
        assert top < 1 << 64
        want = np.zeros((1, b, 13), np.int64)
        for k0 in range(0, D, 512):       # exact: 512 products < 2^63
            want = (want + a[:, :, k0:k0 + 512] @ y[:, k0:k0 + 512]) % P
        np.testing.assert_array_equal(got.astype(np.int64), want)


def test_rowdot_keeps_one_split_where_rows_fill_the_card():
    """The MPC baseline's Z and the wide route's Z fill the card with
    rows: one split, as before K could be split."""
    for m, n, k, batch, slots in ((3006, 1, D, 16, 264),
                                  (3006, 10, D, 16, 132),
                                  (156, 10, 65536, 50, 132),
                                  (156, 1, 65536, 50, 132)):
        launch = plan.rowdot_launch(m, n, k, batch, slots)
        assert launch["splits"] == 1 and launch["ks"] == k


@pytest.mark.parametrize("m,d,k", [
    (156, 58005, None), (156, 65536, None), (1, 65536, None),
    (5, 65536, None), (156, 131072, None), (2, 180000, None),
    (1, plan.cluster_max_d(), None), (4095, 70001, None),
    (156, 65536, 8), (156, 58005, 16)])
def test_cluster_plan_limits(m, d, k):
    """The cluster kernel's plan fits a block's shared memory, gives each
    rank a 4-word multiple of columns (every rank some), keeps pass 1's
    lane sums below NO_REDUCE_TERMS products and the k ranks' sum of
    partials below 2^32, and its register mode holds the rank's columns."""
    pl = plan.cluster_plan(m, d, 1, k)
    k, cw, bm = pl["k"], pl["cw"], pl["bm"]
    assert k in plan.CLUSTER_SIZES
    assert cw % 4 == 0 and cw * k >= d > cw * (k - 1)
    assert pl["smem"] + plan.GRAD_STATIC <= plan.SMEM_MAX
    assert pl["smem"] == plan.cluster_smem(k, bm, pl["stages"], cw,
                                           pl["mode"] == "smem")
    assert pl["stages"] in (2, 3)
    assert pl["slot"] % 16 == 0 and pl["slot"] >= 4 * cw + plan.COPY_SLACK
    assert 1 <= bm <= min(m, plan.MAX_BM)
    assert plan.pass1_terms(cw) < plan.NO_REDUCE_TERMS
    assert k * (P - 1) < 1 << 32
    if pl["mode"] == "reg":
        assert pl["ept"] * plan.GRAD_THREADS >= cw
    else:
        assert pl["mode"] == "smem" and pl["ept"] == 0


def test_cluster_plan_at_the_wide_cell():
    """(50, 156, 65,536): 16 CTAs of 4,096 columns, register partials,
    three stages of 4 rows (64 KB a CTA a slice); C > 1 is refused."""
    assert plan.cluster_plan(156, 65536, 1) == dict(
        k=16, cw=4096, mode="reg", ept=8, bm=4, stages=3, slot=16416,
        smem=230736)
    for c in (2, 10):
        with pytest.raises(ValueError, match="C = 1 only"):
            plan.cluster_plan(156, 65536, c)


def test_cluster_reach_lies_past_the_body():
    """The cluster kernel starts where the body stops and reaches past
    2^17 columns of hashed features; one column more raises."""
    reach = plan.cluster_max_d()
    assert plan.max_d(1) < 131072 < reach
    plan.cluster_plan(1, reach)
    with pytest.raises(ValueError, match="column slice"):
        plan.cluster_plan(1, reach + 1)


@pytest.mark.parametrize("b,k", [(1, D), (128, D), (3, 9019)])
def test_colsum_model_at_the_splitk_kc(b, k):
    """The split-K kernel's arithmetic at the kc splitk_launch picks (64 at
    serving: one reduce_p58 a pass) with x = y = p - 1: lane sums stay
    below 2^58 and the combine equals the plain product."""
    kc = plan.splitk_launch(b, 5, k, 1, 132)["kc"]
    assert kc == plan.SPLITK_SUB
    a = np.full((1, b, k), P - 1, np.int32)
    y = np.full((1, k, 5), P - 1, np.int32)
    got, top = plan.colsum_model(a, y, kc)
    assert top == kc * (P - 1) ** 2 < 1 << 58
    want = ref.modmatmul_batched(torch.from_numpy(a), torch.from_numpy(y))
    np.testing.assert_array_equal(got, want.numpy())
