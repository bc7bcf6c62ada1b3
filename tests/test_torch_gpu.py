"""repro_torch on a CUDA card: each CUDA kernel against its plain version,
and the smoke goldens through api.fit on the card.

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
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

P = field.P
GOLDEN_SHARES_SHA = \
    "459aaa671b3d6708b4918f1e54b29e083cecf6c85b5b617f882720596399afaf"


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
    assert counts["fused_step"] == 10 and min(counts.values()) > 0
