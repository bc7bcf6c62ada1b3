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
from repro_torch.core import field
from repro_torch.kernels import coded_gradient as cg
from repro_torch.kernels import field_poly as fp
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels import ops, ref

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


@pytest.mark.parametrize("n,c", [(5, 1), (13, 10)])
def test_fused_step_matches_plain(cuda, n, c):
    rng = np.random.default_rng(n + c)
    m, d = 37, 29
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


def test_fit_siloed_golden_on_the_card(cuda, monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_STEP", "0")
    ops.reset_launches()
    res = api.fit("smoke", "copml", "jit", key=0, iters=10)
    assert _sha(res.state.w_shares.cpu().numpy()) == GOLDEN_SHARES_SHA
    counts = ops.launch_counts()
    assert counts["coded_gradient_batched"] == 10
    assert counts["fused_step"] == 0


@pytest.mark.parametrize("mode", ["0", "1"])
def test_faulty_fit_on_the_card(cuda, monkeypatch, mode):
    monkeypatch.setenv("REPRO_FUSED_STEP", mode)
    plan = api.FaultPlan.from_schedule(
        13, 6, stragglers={1: (0, 1), 4: (2,)}, dropouts={2: (7,)},
        adversaries={3: (8,)})
    res = api.fit("smoke_straggler", "copml", "jit", key=0, iters=6,
                  faults=plan)
    assert _sha(res.state.w_shares.cpu().numpy()) == FAULTY_SHARES_SHA
    assert _sha(res.history, np.float32) == FAULTY_HIST_SHA
