"""The coded gradient's wide route on a CUDA card (d past 58,004): the
route's gradient and fused step against the plain versions, bit for bit,
with rows at p - 1, the epilogue alone, the launches it counts, and a
wide workload's fit on both schedules against the CPU's.

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


@pytest.mark.parametrize("n,m,d,c", [(3, 37, 58005, 1), (2, 19, 65536, 10),
                                     (4, 1, 65536, 1), (2, 5, 70001, 16)])
def test_wide_gradient_matches_plain(cuda, n, m, d, c):
    assert plan.gradient_route(d, c) == "wide"
    _, x, w, co = _operands(d + c, n, m, d, c)
    ops.reset_launches()
    got = cg.coded_gradient_matrix(x.to(cuda), w.to(cuda), co.to(cuda))
    _eq(got, ref.coded_gradient_matrix(x, w, co))
    assert ops.wide_counts() == {"gradient": 1, "epilogue": 0}
    # Z on the row-dot kernel, X~^T ghat on the column-sum kernel
    assert ops.gemm_path_counts()["rowdot"] == 1
    assert ops.gemm_path_counts()["colsum"] == 1
    if c == 1:
        _eq(cg.coded_gradient_batched(x.to(cuda), w[..., 0].to(cuda),
                                      co.to(cuda)),
            ref.coded_gradient_batched(x, w[..., 0], co))


@pytest.mark.parametrize("n,m,d,c", [(3, 37, 58005, 1), (13, 9, 65536, 10)])
def test_wide_fused_step_matches_plain(cuda, n, m, d, c):
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
    # the wide route launches no gradient kernel: it counts as wide
    assert ops.launch_counts()["fused_step"] == 0
    assert ops.wide_counts() == {"gradient": 1, "epilogue": 1}


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


@pytest.mark.parametrize("schedule", ["1", "0"])
def test_wide_fit_on_the_card_equals_the_cpu(cuda, monkeypatch, schedule):
    """quickstart's configuration at d = 65,536: the card's fit (the wide
    route on either schedule) gives the CPU's bits."""
    wl = dataclasses.replace(api.get_workload("quickstart"),
                             name="quickstart_wide", m=52, d=65536, iters=2)
    monkeypatch.setenv("REPRO_FUSED_STEP", schedule)
    want = api.fit(wl, "copml", "jit", key=0, iters=2, device="cpu")
    ops.reset_launches()
    got = api.fit(wl, "copml", "jit", key=0, iters=2)
    name = "fused_step" if schedule == "1" else "coded_gradient_batched"
    assert ops.launch_counts()[name] == 0
    assert ops.wide_counts() == {"gradient": 2,
                                 "epilogue": 2 if schedule == "1" else 0}
    _eq(got.state.w_shares, want.state.w_shares)
    np.testing.assert_array_equal(got.history, want.history)
