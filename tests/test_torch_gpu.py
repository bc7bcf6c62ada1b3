"""repro_torch on a CUDA card: each CUDA kernel against its plain version,
and the smoke goldens (fused and siloed schedules) and a fault plan's
shas through api.fit on the card.

These tests import no JAX (the card's machine need not have it), are marked
`gpu`, and skip where no card is present.  On a card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import hashlib

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import workloads
from repro_torch.core import field, protocol
from repro_torch.core import random as jrandom
from repro_torch.kernels import coded_gradient as cg
from repro_torch.kernels import field_poly as fp
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels import ops, ref, threefry

pytestmark = pytest.mark.gpu

P = field.P
GOLDEN_SHARES_SHA = \
    "459aaa671b3d6708b4918f1e54b29e083cecf6c85b5b617f882720596399afaf"
FAULTY_SHARES_SHA = \
    "239bb5c60a80c270b9417cf6025b80b18ef8a8dcb900ecda07ab9b289593352d"
FAULTY_HIST_SHA = \
    "d0a119966962c28edbfed2d3e6d6dffc3fc2413e49d189dc8148748d4147b86a"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fld(rng, *shape):
    arr = rng.integers(0, P, size=shape, dtype=np.int64).astype(np.int32)
    return torch.from_numpy(arr)


def _eq(got, want):
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("mkn", [(50, 7, 5000), (1, 8, 4099), (33, 3000, 17),
                                 (3, 5000, 300)])
def test_modmatmul_matches_plain(cuda, mkn):
    m, k, n = mkn
    rng = np.random.default_rng(k)
    a, b = _fld(rng, m, k), _fld(rng, k, n)
    _eq(mm.modmatmul(a.to(cuda), b.to(cuda)), ref.modmatmul(a, b))


def test_modmatmul_batched_matches_plain(cuda):
    rng = np.random.default_rng(3)
    x, y = _fld(rng, 4, 300, 70), _fld(rng, 4, 300, 1)
    _eq(mm.modmatmul_batched(x.to(cuda).transpose(1, 2), y.to(cuda)),
        ref.modmatmul_batched(x.transpose(1, 2), y))
    row, mix = _fld(rng, 13), _fld(rng, 13, 13, 24)
    _eq(mm.modmatmul_batched(row.to(cuda)[None, None].expand(13, 1, 13),
                             mix.to(cuda)),
        ref.modmatmul_batched(row[None, None].expand(13, 1, 13), mix))


@pytest.mark.parametrize("n,c,m,d", [
    pytest.param(5, 1, 37, 29, id="5-1"),
    pytest.param(13, 10, 37, 29, id="13-10"),
    # cifar10_ovr10_case2's instance: (d, 10) partials in shared memory
    pytest.param(50, 10, 64, 3073, id="50-10-smem")])
def test_fused_step_matches_plain(cuda, n, c, m, d):
    rng = np.random.default_rng(n + c)
    shapes = [(n, m, d), (n, d, c), (2,), (n,), (n,), (n,)] + [(n, d, c)] * 5
    args = [_fld(rng, *s) for s in shapes]
    kw = dict(q_eta=3, inv2k1=field.host_inv(1 << 8), k1=8)
    got = fs.fused_step(*[a.to(cuda) for a in args], **kw)
    for g, w in zip(got, ref.fused_step(*args, **kw)):
        _eq(g, w)


def test_fit_smoke_golden_on_the_card(cuda):
    ops.reset_launches()
    res = api.fit("smoke", "copml", "jit", key=0, iters=10)
    assert res.device.startswith("cuda")
    sha = hashlib.sha256(res.state.w_shares.cpu().numpy().astype(
        np.int32).tobytes()).hexdigest()
    assert sha == GOLDEN_SHARES_SHA
    counts = ops.launch_counts()
    assert counts["fused_step"] == 10
    assert counts["modmatmul"] > 0 and counts["modmatmul_batched"] > 0
    assert counts["coded_gradient_batched"] == 0


def _sha(arr, dtype=np.int32):
    return hashlib.sha256(np.asarray(arr, dtype).tobytes()).hexdigest()


@pytest.mark.parametrize("n,m,d,c,degree", [
    (3, 13, 6, 1, 1), (5, 13, 24, 10, 3), (5, 37, 3073, 1, 1),
    (2, 130, 3073, 10, 3)])
def test_coded_gradient_matches_plain(cuda, n, m, d, c, degree):
    """Ragged m (not a multiple of the slice height), d up to 3073."""
    rng = np.random.default_rng(n * m + d + c)
    x, w = _fld(rng, n, m, d), _fld(rng, n, d, c)
    co = _fld(rng, degree + 1)
    got = cg.coded_gradient_matrix(x.to(cuda), w.to(cuda), co.to(cuda))
    _eq(got, ref.coded_gradient_matrix(x, w, co))
    if c == 1:
        _eq(cg.coded_gradient_batched(x.to(cuda), w[..., 0].to(cuda),
                                      co.to(cuda)),
            ref.coded_gradient_batched(x, w[..., 0], co))
        _eq(cg.coded_gradient(x[0].to(cuda), w[0, :, 0].to(cuda),
                              co.to(cuda)),
            ref.coded_gradient(x[0], w[0, :, 0], co))


@pytest.mark.parametrize("shape,degree", [((45100,), 1), ((7, 13), 3),
                                          ((1,), 3)])
def test_poly_eval_matches_plain(cuda, shape, degree):
    rng = np.random.default_rng(degree)
    z, co = _fld(rng, *shape), _fld(rng, degree + 1)
    _eq(fp.poly_eval(z.to(cuda), co.to(cuda)), ref.poly_eval(z, co))


@pytest.mark.parametrize("length,degree,offset,worst", [
    (3_000_001, 7, 0, False),   # grid-stride, past one wave of chunks
    (5000, 63, 1, False),       # the most coefficients; z 4 bytes off
    (4099, 0, 0, False),        # a constant
    (2049, 7, 0, True),         # z and every coefficient p - 1
    (2_500_003, 63, 1, False),  # the grid-stride kernel at the edges
    (2_500_003, 7, 0, True)])
def test_poly_eval_grid_stride_and_edges(cuda, length, degree, offset, worst):
    rng = np.random.default_rng(length + degree)
    flat, co = _fld(rng, offset + length), _fld(rng, degree + 1)
    if worst:
        flat.fill_(P - 1)
        co.fill_(P - 1)
    z = flat.to(cuda)[offset:]
    _eq(fp.poly_eval(z, co.to(cuda)), ref.poly_eval(flat[offset:], co))


def test_faulty_fit_on_the_card(cuda):
    plan = api.FaultPlan.from_schedule(
        13, 6, stragglers={1: (0, 1), 4: (2,)}, dropouts={2: (7,)},
        adversaries={3: (8,)})
    res = api.fit("smoke_straggler", "copml", "jit", key=0, iters=6,
                  faults=plan)
    assert _sha(res.state.w_shares.cpu().numpy()) == FAULTY_SHARES_SHA
    assert _sha(res.history, np.float32) == FAULTY_HIST_SHA


@pytest.mark.parametrize("m,k", [(1, 1), (1, 8), (8, 7), (17, 17), (50, 7),
                                 (50, 17), (64, 64), (1, 50), (65, 17),
                                 (50, 65), (64, 1), (8, 64)])
def test_modmatmul_thin_path_matches_plain(cuda, m, k):
    """Every K bucket of the thin kernel and both sides of its M/K limits,
    at an odd N whose rows start off 16-byte lines."""
    from repro_torch.kernels.plan import gemm_path
    rng = np.random.default_rng(m * 100 + k)
    a, b = _fld(rng, m, k), _fld(rng, k, 2053)
    want = "thin" if m <= 64 and k <= 64 else \
        "splitk" if m <= 128 and k > 64 else "tiled"
    assert gemm_path(m, k, b.stride(1), 2053) == want
    _eq(mm.modmatmul(a.to(cuda), b.to(cuda)), ref.modmatmul(a, b))


def test_modmatmul_thin_broadcast_and_strided_b(cuda):
    from repro_torch.kernels.plan import gemm_path
    rng = np.random.default_rng(9)
    a, b = _fld(rng, 50, 17), _fld(rng, 6, 17, 1001)
    ab = a.to(cuda)[None].expand(6, 50, 17)              # batch stride 0
    _eq(mm.modmatmul_batched(ab, b.to(cuda)),
        ref.modmatmul_batched(a[None].expand(6, 50, 17), b))
    bt = _fld(rng, 300, 7)                               # B columns strided
    assert gemm_path(8, 7, bt.t().stride(1), 300) == "tiled"
    a8 = _fld(rng, 8, 7)
    _eq(mm.modmatmul(a8.to(cuda), bt.to(cuda).t()), ref.modmatmul(a8, bt.t()))


@pytest.mark.parametrize("n,m,d,c,degree,offset", [
    (3, 37, 29, 1, 1, 0),       # X~ of 12,876 bytes: a ragged tail
    (4, 45, 4000, 1, 1, 0),     # bm = 7, clients 0 mod 16
    (2, 19, 3073, 10, 3, 0),    # the "smem" accumulator mode, C = 10
    (2, 3, 40000, 1, 1, 0),     # the "atomic" mode, one stage, bm = 1
    (3, 3, 24, 1, 1, 0),        # m below one slice, two warps a row
    (5, 37, 3073, 1, 1, 1)])    # X~ starting 4 bytes off: a ragged head
def test_coded_gradient_ring_layouts(cuda, n, m, d, c, degree, offset):
    rng = np.random.default_rng(n + m + d + c)
    flat = _fld(rng, offset + n * m * d)
    x = flat.to(cuda)[offset:].view(n, m, d)
    w, co = _fld(rng, n, d, c), _fld(rng, degree + 1)
    _eq(cg.coded_gradient_matrix(x, w.to(cuda), co.to(cuda)),
        ref.coded_gradient_matrix(flat[offset:].view(n, m, d), w, co))


@pytest.mark.parametrize("c", [1, 10])
def test_fused_step_fault_form_matches_plain(cuda, c):
    """One adversary's offset (the fault form's non-zero adv_off)."""
    rng = np.random.default_rng(40 + c)
    n, m, d = 4, 19, 3073
    shapes = [(n, m, d), (n, d, c), (2,), (n,), (n,), (n,)] + [(n, d, c)] * 5
    args = [_fld(rng, *s) for s in shapes]
    args[3] = torch.zeros(n, dtype=torch.int32)
    args[3][2] = 1 << 20
    kw = dict(q_eta=5, inv2k1=field.host_inv(1 << 8), k1=8)
    got = fs.fused_step(*[a.to(cuda) for a in args], **kw)
    for g, w in zip(got, ref.fused_step(*args, **kw)):
        _eq(g, w)


def test_gradient_kernels_at_p_minus_1_past_d_32768(cuda):
    """x = w = p - 1 at d = 40000: pass 1's lane sums pass 2^58 (each
    product is near 2^52), so only the full reduce_p gives the right bits."""
    n, m, d = 2, 3, 40000
    x = torch.full((n, m, d), P - 1, dtype=torch.int32)
    w = torch.full((n, d, 1), P - 1, dtype=torch.int32)
    co = torch.tensor([5, P - 1], dtype=torch.int32)
    want = ref.coded_gradient_matrix(x, w, co)
    _eq(cg.coded_gradient_matrix(x.to(cuda), w.to(cuda), co.to(cuda)), want)
    rng = np.random.default_rng(7)
    rest = [_fld(rng, n) for _ in range(3)] + \
        [_fld(rng, n, d, 1) for _ in range(5)]
    rest[0] = torch.zeros(n, dtype=torch.int32)          # no adversary
    kw = dict(q_eta=5, inv2k1=field.host_inv(1 << 8), k1=8)
    got = fs.fused_step(*[a.to(cuda) for a in (x, w, co, *rest)], **kw)
    for g, w_ in zip(got, ref.fused_step(x, w, co, *rest, **kw)):
        _eq(g, w_)


def _xty_operands(rng, b, m, k, n, offset=0, worst=False, b_strided=False):
    """A = the transposed view of (b, k, m) "shares" starting `offset`
    words into their buffer, and B (b, k, n) "targets" (class-major with
    b_strided); x = y = p - 1 with `worst`.  Returns CPU tensors."""
    flat = _fld(rng, offset + b * k * m)
    y = _fld(rng, b, n, k).transpose(1, 2) if b_strided else _fld(rng, b, k, n)
    if worst:
        flat.fill_(P - 1)
        y.fill_(P - 1)
    return flat, y


def _on_card(flat, y, cuda, offset, b, m, k):
    return flat.to(cuda)[offset:].view(b, k, m).transpose(1, 2), y.to(cuda)


@pytest.mark.parametrize("b,m,k,n,offset,worst,b_strided", [
    (3, 33, 65, 1, 0, False, False),      # K just past the thin path
    (2, 257, 4097, 2, 0, False, False),   # K past one lane's 4096 terms
    (1, 3073, 8193, 10, 0, False, False),  # a batch of 1, past 8192
    (2, 95, 9019, 16, 1, False, False),   # A 4 bytes off a 16-byte line
    (1, 129, 40000, 1, 0, True, False),   # x = y = p - 1 at the largest K
    (13, 24, 390, 10, 0, False, False),   # mnist10_like's setup
    (2, 100, 20, 3, 0, False, False),     # one split, written directly
    (2, 70, 300, 5, 0, False, True)])     # B class-major (strided)
def test_modmatmul_colsum_matches_plain(cuda, b, m, k, n, offset, worst,
                                        b_strided):
    rng = np.random.default_rng(b * m + k + n)
    flat, y = _xty_operands(rng, b, m, k, n, offset, worst, b_strided)
    xt, yc = _on_card(flat, y, cuda, offset, b, m, k)
    assert mm.path_of(xt, yc) == "colsum"
    assert yc.stride() == y.stride()
    want = ref.modmatmul_batched(flat[offset:].view(b, k, m).transpose(1, 2),
                                 y)
    _eq(mm.modmatmul_batched(xt, yc), want)


@pytest.mark.parametrize("b,m,k,n,kc,worst", [
    (1, 40, 8193, 2, 4096, True),     # a lane sums 4096 products of p - 1
    (2, 70, 4096, 1, 4096, True),     # the same in one split: no combine
    (2, 65, 1000, 10, 100, False)])   # kc not a multiple of 32
def test_modmatmul_colsum_at_its_term_bound(cuda, b, m, k, n, kc, worst):
    """Splits the plan picks only for far larger batches: kc at
    NO_REDUCE_TERMS with every product near 2^52, and a ragged 32-row
    block at the end of every split."""
    from repro_torch.kernels import plan
    rng = np.random.default_rng(k + kc)
    flat, y = _xty_operands(rng, b, m, k, n, worst=worst)
    xt, yc = _on_card(flat, y, cuda, 0, b, m, k)
    splits = -(-k // kc)
    launch = dict(cmax=next(c for c in plan.COLSUM_CMAX if n <= c), kc=kc,
                  splits=splits,
                  ctas=-(-(b * -(-m // 32) * splits) // plan.COLSUM_WARPS))
    out = torch.empty((b, m, n), dtype=torch.int32, device=cuda)
    want = ref.modmatmul_batched(flat.view(b, k, m).transpose(1, 2), y)
    _eq(mm.colsum(xt, yc, out, launch), want)


def _gemm_operands(rng, b, m, k, n, offset=0, worst=False, bcast=False):
    """A (b, m, k) K-contiguous, `offset` words into its buffer (one (m, k)
    expanded over the batch with `bcast`), and B (b, k, n); x = y = p - 1
    with `worst`.  Returns CPU tensors (A's buffer, A, B)."""
    rows = 1 if bcast else b
    flat = _fld(rng, offset + rows * m * k)
    y = _fld(rng, b, k, n)
    if worst:
        flat.fill_(P - 1)
        y.fill_(P - 1)
    a = flat[offset:].view(rows, m, k)
    return flat, (a.expand(b, m, k) if bcast else a), y


def _a_on_card(flat, cuda, offset, b, m, k, bcast):
    a = flat.to(cuda)[offset:].view(1 if bcast else b, m, k)
    return a.expand(b, m, k) if bcast else a


@pytest.mark.parametrize("b,m,k,n,offset,worst,bcast", [
    (3, 1, 65, 1, 0, False, False),        # M = 1, K just past thin
    (2, 31, 3073, 10, 1, False, False),    # A 4 bytes off a 16-byte line
    (1, 3006, 4097, 16, 0, False, False),  # past one staged chunk of B
    (2, 31, 9019, 1, 0, True, False),      # x = y = p - 1
    (4, 31, 3073, 10, 0, False, True),     # batch stride 0
    (1, 31, 9019, 10, 3, True, False),     # chunks, worst sums, offset
    (2, 3, 60000, 1, 0, True, False)])     # two chunks at C = 1
def test_modmatmul_rowdot_matches_plain(cuda, b, m, k, n, offset, worst,
                                        bcast):
    rng = np.random.default_rng(b * m + k + n)
    flat, a, y = _gemm_operands(rng, b, m, k, n, offset, worst, bcast)
    ac = _a_on_card(flat, cuda, offset, b, m, k, bcast)
    assert mm.path_of(ac, y) == "rowdot"
    _eq(mm.modmatmul_batched(ac, y.to(cuda)), ref.modmatmul_batched(a, y))


@pytest.mark.parametrize("b,m,k,n,offset,worst,bcast,forced", [
    (1, 1, 65, 50, 0, False, False, False),
    (1, 31, 3073, 130, 1, False, False, False),   # A 4 bytes off
    (2, 128, 4097, 500, 0, False, True, False),   # batch stride 0
    (1, 1, 9019, 50, 0, True, False, False),      # x = y = p - 1
    (1, 128, 3073, 50, 0, True, False, False),
    (1, 31, 9019, 1, 0, False, False, True),      # N = 1 (row-dot's path)
    (300, 2, 65, 50, 0, False, False, False),     # one split, no combine
    (2, 5, 9019, 500, 0, True, False, False)])    # splits of 3 passes
def test_modmatmul_splitk_matches_plain(cuda, b, m, k, n, offset, worst,
                                        bcast, forced):
    from repro_torch.kernels import plan
    rng = np.random.default_rng(b * m + k + n + 1)
    flat, a, y = _gemm_operands(rng, b, m, k, n, offset, worst, bcast)
    ac = _a_on_card(flat, cuda, offset, b, m, k, bcast)
    want = ref.modmatmul_batched(a, y)
    if forced:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        out = torch.empty((b, m, n), dtype=torch.int32, device=cuda)
        _eq(mm.splitk(ac, y.to(cuda), out,
                      plan.splitk_launch(m, n, k, b, sms)), want)
    else:
        assert mm.path_of(ac, y) == "splitk"
        _eq(mm.modmatmul_batched(ac, y.to(cuda)), want)


def test_refused_launches_raise(cuda):
    """A launch that breaks a kernel's bounds is refused by its C entry
    (cudaErrorInvalidValue) and the wrapper raises: no fallback."""
    rng = np.random.default_rng(5)
    a, y = _fld(rng, 1, 4, 300).to(cuda), _fld(rng, 1, 300, 3).to(cuda)
    out = torch.empty((1, 4, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="rowdot"):       # kch > K
        mm.rowdot(a, y, out, dict(cmax=4, kch=301, run=4, cpb=1,
                                  smem=4 * 4 * 301, splits=1, ks=300))
    with pytest.raises(RuntimeError, match="rowdot"):       # strips short
        mm.rowdot(a, y, out, dict(cmax=4, kch=300, run=1, cpb=1,
                                  smem=4 * 4 * 300, splits=1, ks=300))
    with pytest.raises(RuntimeError, match="rowdot"):       # splits short
        mm.rowdot(a, y, out, dict(cmax=4, kch=96, run=4, cpb=1,
                                  smem=4 * 4 * 96, splits=3, ks=96))
    with pytest.raises(RuntimeError, match="splitk"):       # splits short
        mm.splitk(a, y, out, dict(bn=32, rg=4, gx=1, kc=64, splits=2))
    with pytest.raises(RuntimeError, match="splitk"):       # kc past 4096
        mm.splitk(a, y, out, dict(bn=32, rg=4, gx=1, kc=8192, splits=1))


# the six draws of a cifar10_case2 step (T = 7, N = 50, d = 3,073): the
# model encode's v and its Shamir coefficients, the masks' mix, TruncPr's
# r (span 2^k2) and the coefficients of [r] and [r0]
CIFAR_STEP_DRAWS = [((7, 3073), P), ((7, 7, 3073), P), ((7, 50, 3073), P),
                    ((3073,), 1 << 25), ((7, 3073), P), ((7, 3073), P)]


def _one_launch(entry: str, launches: int = 1) -> None:
    counts = ops.threefry_counts()
    assert counts == {e: launches if e == entry else 0
                      for e in threefry.ENTRIES}, counts


@pytest.mark.parametrize("shape,bounds", [
    *[(s, (0, span)) for s, span in CIFAR_STEP_DRAWS],
    ((7,), (0, P)), ((4097,), (0, 1 << 24)), ((5, 3), (0, 1000)),
    ((1,), (0, 1000)), ((1001,), (-(1 << 31), (1 << 31) - 1)),
    ((9,), (3, 4))])
def test_threefry_randint_matches_plain(cuda, shape, bounds):
    """The step's draw shapes, odd sizes, a span whose uint32 multiplier
    is nonzero (1000), negative minval, span 1: one launch a draw, the
    plain version's words bit for bit."""
    key = jrandom.fold_in(jrandom.PRNGKey(17), sum(shape))
    ops.reset_launches()
    got = jrandom.randint(key, shape, *bounds, device=cuda)
    _one_launch("randint")
    _eq(got, jrandom.randint(key, shape, *bounds))


def test_threefry_setup_draw_matches_plain(cuda):
    """Set-up's largest draw, X's Shamir coefficients at cifar10_case2
    (194M words), against the plain version run on the card."""
    key = jrandom.fold_in(jrandom.PRNGKey(3), 1)
    shape = (7, 9019, 3073)
    ops.reset_launches()
    got = field.random_field(key, shape, cuda)
    _one_launch("randint")
    halves = [jrandom._words(k) for k in jrandom.split(key)]
    want = jrandom._draw_plain(*halves, 7 * 9019 * 3073, 0, P, 0, cuda,
                               None).reshape(shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k,shape,span", [(3, (7, 5), P), (3, (3, 4), 1000),
                                          (70, (1001,), P), (64, (2,), 1)])
def test_threefry_randint_keys_matches_plain(cuda, k, shape, span):
    """A row a key, one launch a 64 rows."""
    keys = jrandom.split(jrandom.PRNGKey(5), k)
    ops.reset_launches()
    got = jrandom.randint_keys(keys, shape, 0, span, device=cuda)
    _one_launch("randint_keys", -(-k // 64))
    _eq(got, jrandom.randint_keys(keys, shape, 0, span))


@pytest.mark.parametrize("shape", [(1,), (7,), (4097,), (3, 5)])
def test_threefry_bits32_matches_plain(cuda, shape):
    key = jrandom.PRNGKey(23)
    ops.reset_launches()
    got = jrandom.bits32(key, shape, device=cuda)
    _one_launch("bits32")
    assert got.dtype == torch.int64
    _eq(got, jrandom.bits32(key, shape))
    for width in (8, 16):
        _eq(jrandom.bits(key, shape, width, device=cuda),
            jrandom.bits(key, shape, width))
    _eq(jrandom.uniform(key, shape, device=cuda), jrandom.uniform(key, shape))


def test_copml_train_on_the_card_equals_the_cpu(cuda):
    """Every draw of a short COPML job on the card is the kernel's, and the
    job's history and shares equal the CPU run's bit for bit."""
    wl = workloads.get("smoke")
    cx, cy = wl.client_data()
    runs = {}
    for dev in ("cpu", cuda):
        proto = protocol.Copml(wl.cfg, wl.m, wl.d, objective=wl.objective,
                               device=dev)
        ops.reset_launches()
        state, _, hist = proto.train(7, cx, cy, 3, history=True)
        runs[str(dev)] = (state.w_shares.cpu(), hist.cpu(),
                          ops.threefry_counts())
    (sh_cpu, h_cpu, n_cpu), (sh_card, h_card, n_card) = runs.values()
    _eq(sh_card, sh_cpu)
    assert torch.equal(h_card, h_cpu)
    assert not any(n_cpu.values())
    assert n_card["randint"] > 0 and n_card["bits32"] == 0
