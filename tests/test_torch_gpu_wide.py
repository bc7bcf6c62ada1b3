"""The coded gradient past d = 58,004 on a CUDA card: the cluster route
(each row over a thread-block cluster, X~ read once) and the wide route
(past the cluster's reach, and at C > 1) against the plain versions, bit
for bit, with rows and operands at p - 1, odd d, the cluster's widest d, m
below one slice, one client and every cluster size; the fused step on
either route, the epilogue alone, the launches each counts, a wide
workload's fit on both schedules and on proc:4 against the CPU's; and the
row-dot GEMM with K split over CTAs at a sharded rank's serving scores.

These tests import no JAX, are marked `gpu`, and skip where no card is
present.  On a card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_wide.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import field
from repro_torch.kernels import coded_gradient as cg
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import ops, plan, ref

pytestmark = pytest.mark.gpu

P = field.P
K1 = 18


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


def _operands(seed, n, m, d, c):
    rng = np.random.default_rng(seed)
    x, w, co = _fld(rng, n, m, d), _fld(rng, n, d, c), _fld(rng, 2)
    x[0] = P - 1
    x[:, -1] = P - 1
    w[0] = P - 1
    return rng, x, w, co


def _counts(gradient=0, epilogue=0, cluster=0) -> dict:
    return {"gradient": gradient, "epilogue": epilogue, "cluster": cluster}


@pytest.mark.parametrize("n,m,d,c", [(3, 37, 58005, 1), (2, 19, 65536, 10),
                                     (4, 1, 65536, 1), (2, 5, 70001, 16),
                                     (2, 3, 400000, 1)])
def test_wide_gradient_matches_plain(cuda, n, m, d, c):
    """The wide route, called directly (it serves d past the cluster's
    reach and C > 1; 400,000 is past the reach)."""
    _, x, w, co = _operands(d + c, n, m, d, c)
    ops.reset_launches()
    got = cg.wide_gradient(x.to(cuda), w.to(cuda), co.to(cuda))
    _eq(got, ref.coded_gradient_matrix(x, w, co))
    assert ops.wide_counts() == _counts(gradient=1)
    # Z on the row-dot kernel, X~^T ghat on the column-sum kernel
    assert ops.gemm_path_counts()["rowdot"] == 1
    assert ops.gemm_path_counts()["colsum"] == 1
    want_route = "cluster" if c == 1 and d <= plan.cluster_max_d() \
        else "wide"
    assert plan.gradient_route(d, c) == want_route
    if c == 1:
        ops.reset_launches()
        _eq(cg.coded_gradient_batched(x.to(cuda), w[..., 0].to(cuda),
                                      co.to(cuda)),
            ref.coded_gradient_batched(x, w[..., 0], co))
        assert ops.wide_counts() == _counts(
            **{"gradient" if want_route == "wide" else "cluster": 1})


@pytest.mark.parametrize("n,m,d,worst", [
    (4, 37, 65536, False),           # rows at p - 1
    (4, 37, 65536, True),            # every operand p - 1
    (3, 37, 58005, False),           # odd d: rows 4-byte aligned
    (2, 3, plan.cluster_max_d(), False),     # the cluster's widest d
    (3, 1, 65536, False),            # m below one slice
    (1, 9, 65536, False),            # one client
    (5, 160, 100003, False),         # shared-memory partials
    (50, 80, 100000, False)])        # DOROTHEA's step: the smem instance
def test_cluster_gradient_matches_plain(cuda, n, m, d, worst):
    assert plan.gradient_route(d, 1) == "cluster"
    _, x, w, co = _operands(3 * d + n, n, m, d, 1)
    if worst:
        for t in (x, w, co):
            t.fill_(P - 1)
    ops.reset_launches()
    got = cg.coded_gradient_matrix(x.to(cuda), w.to(cuda), co.to(cuda))
    _eq(got, ref.coded_gradient_matrix(x, w, co))
    assert ops.wide_counts() == _counts(cluster=1)
    assert ops.launch_counts()["coded_gradient_matrix"] == 0   # no body
    assert ops.gemm_path_counts()["rowdot"] == 0


@pytest.mark.parametrize("k", [8, 16])
def test_cluster_sizes_match_plain(cuda, k):
    """Both cluster sizes that fit at d = 65,536 (8: one row a slice,
    shared-memory partials; 16: four rows, register partials), and the
    refusal of C > 1, which takes the wide route."""
    n, m, d = 3, 37, 65536
    _, x, w, co = _operands(k, n, m, d, 1)
    got = cg.cluster_gradient(x.to(cuda), w.to(cuda), co.to(cuda), k=k)
    _eq(got, ref.coded_gradient_matrix(x, w, co))
    _, x, w, co = _operands(k + 10, 2, 5, d, 10)
    with pytest.raises(ValueError, match="C = 1 only"):
        cg.cluster_gradient(x.to(cuda), w.to(cuda), co.to(cuda))


@pytest.mark.parametrize("n,m,d,c", [(3, 37, 58005, 1), (13, 9, 65536, 10),
                                     (4, 23, 65536, 1)])
def test_wide_fused_step_matches_plain(cuda, n, m, d, c):
    """The fused step past d = 58,004 on the route the plan gives it: the
    cluster kernel then the epilogue, or the wide route and its int32
    epilogue."""
    rng, x, w, co = _operands(7 * d + c, n, m, d, c)
    rows = [_fld(rng, n) for _ in range(3)]
    mats = [_fld(rng, n, d, c) for _ in range(5)]
    mats[0][0] = P - 1
    kw = dict(q_eta=int(rng.integers(1, P)),
              inv2k1=field.host_inv(1 << K1), k1=K1)
    args = (x, w, co, *rows, *mats)
    ops.reset_launches()
    got = ops.fused_step(*[a.to(cuda) for a in args], **kw)
    for g, want in zip(got, ref.fused_step(*args, **kw)):
        _eq(g, want)
    # neither route launches the body: each counts in wide_counts
    assert ops.launch_counts()["fused_step"] == 0
    if plan.gradient_route(d, c) == "cluster":
        assert ops.wide_counts() == _counts(cluster=1)
    else:
        assert ops.wide_counts() == _counts(gradient=1, epilogue=1)


@pytest.mark.parametrize("b", [1, 32, 128])
def test_rowdot_split_matches_plain(cuda, b):
    """A sharded rank's serving scores (B, 3073) @ (3073, 13) on the
    row-dot kernel with K split over CTAs (and the splits combined), with
    random operands and with x = y = p - 1."""
    from repro_torch.kernels import modmatmul as mm
    rng = np.random.default_rng(b)
    for worst in (False, True):
        a, y = _fld(rng, b, 3073), _fld(rng, 3073, 13)
        if worst:
            a.fill_(P - 1)
            y.fill_(P - 1)
        assert mm.path_of(a[None], y[None]) == "rowdot"
        ops.reset_launches()
        _eq(ops.modmatmul(a.to(cuda), y.to(cuda)), ref.modmatmul(a, y))
        assert ops.gemm_path_counts()["rowdot"] == 1
    shape = plan.rowdot_shape(13, 3073)
    assert plan.rowdot_launch(b, 13, 3073, 1, mm._rowdot_slots(
        shape["cmax"], shape["smem"]))["splits"] > 1


def test_epilogue_alone_matches_plain(cuda):
    """The int32 epilogue at p - 1 everywhere and N past its 8 warps."""
    n, d, c = 19, 70001, 1
    ones = [torch.full((n,), P - 1, dtype=torch.int32) for _ in range(3)]
    mats = [torch.full((n, d, c), P - 1, dtype=torch.int32)
            for _ in range(6)]
    kw = dict(q_eta=P - 1, inv2k1=field.host_inv(1 << K1), k1=K1)
    args = (mats[0], *ones, *mats[1:])
    _eq(fs.epilogue(*[a.to(cuda) for a in args], **kw),
        ref.fused_epilogue(*args, **kw))


def _wide_workload():
    return dataclasses.replace(api.get_workload("quickstart"),
                               name="quickstart_wide", m=52, d=65536,
                               iters=2)


def test_wide_fit_on_the_card_equals_the_cpu(cuda):
    """quickstart's configuration at d = 65,536: the card's fit (the
    fused step on the cluster route) gives the CPU's bits."""
    wl = _wide_workload()
    want = api.fit(wl, "copml", "jit", key=0, iters=2, device="cpu")
    ops.reset_launches()
    got = api.fit(wl, "copml", "jit", key=0, iters=2)
    assert ops.launch_counts()["fused_step"] == 0
    assert ops.wide_counts() == _counts(cluster=2)
    _eq(got.state.w_shares, want.state.w_shares)
    np.testing.assert_array_equal(got.history, want.history)


def test_wide_fit_on_proc_workers_equals_the_cpu(cuda):
    """The same fit on proc:4: each worker's gradients take the cluster
    route on the card, once a step, and the fit gives the CPU's bits."""
    wl = _wide_workload()
    want = api.fit(wl, "copml", "jit", key=0, iters=2, device="cpu")
    got = api.fit(wl, "copml", "proc:4", key=0, iters=2)
    for rec in got.measured_comm["workers"]:
        assert rec["device"].startswith("cuda")
        assert rec["wide"] == _counts(cluster=2), rec["wide"]
        assert rec["launches"]["coded_gradient_batched"] == 0
    _eq(got.state.w_shares, want.state.w_shares)
    np.testing.assert_array_equal(got.history, want.history)
