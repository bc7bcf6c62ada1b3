"""repro_torch's other protocols and secure serving on a CUDA card.

The card-side counterparts of test_torch_baselines.py, test_torch_protocols
.py and test_torch_serve.py: they import no JAX, hold the card to the JAX
package's pinned shas (chip_smoke.py's MPC_SHAS and AGG_SHAS, which the CPU
tests pin to the JAX package) and to the port's own CPU runs, are marked
`gpu`, and skip where no card is present.  On a card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_protocols.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import field
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.serve import coded

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scheme", ["bh08", "bgw"])
def test_mpc_baseline_shas_on_the_card(cuda, chip_smoke, scheme):
    ops.reset_launches()
    assert chip_smoke.mpc_smoke(scheme, cuda) == chip_smoke.MPC_SHAS[scheme]
    counts = ops.launch_counts()
    assert counts["modmatmul"] > 0 and counts["modmatmul_batched"] > 0


def test_aggregation_rounds_on_the_card(cuda, chip_smoke):
    assert chip_smoke.agg_rounds(cuda) == chip_smoke.AGG_SHAS


@pytest.mark.parametrize("protocol", ["float", "poly_float"])
@pytest.mark.parametrize("name", ["smoke", "mnist10_like", "linreg_smoke"])
def test_float_protocols_on_the_card(cuda, protocol, name):
    for engine, tol_w, tol_h in (("eager", 1e-9, 1e-9),
                                 ("jit", 1e-5, 1e-4)):
        got = api.fit(name, protocol, engine)
        want = api.fit(name, protocol, engine, device="cpu")
        assert got.device.startswith("cuda")
        np.testing.assert_allclose(got.weights, want.weights, rtol=0,
                                   atol=tol_w)
        np.testing.assert_allclose(got.history, want.history, rtol=0,
                                   atol=tol_h)


@pytest.mark.parametrize("name", ["smoke", "mnist10_like", "linreg_smoke"])
def test_secure_agg_fit_on_the_card(cuda, name):
    got = api.fit(name, "secure_agg", "jit", iters=6)
    want = api.fit(name, "secure_agg", "jit", iters=6, device="cpu")
    np.testing.assert_allclose(got.history, want.history, rtol=0, atol=1e-4)


def test_mpc_baseline_fit_on_the_card_equals_cpu(cuda):
    got = api.fit("mnist10_like", "mpc_baseline", "jit", iters=2)
    want = api.fit("mnist10_like", "mpc_baseline", "jit", iters=2,
                   device="cpu")
    np.testing.assert_array_equal(got.state.w_shares.cpu().numpy(),
                                  want.state.w_shares.numpy())
    np.testing.assert_array_equal(got.history, want.history)
    assert got.cost == want.cost


@pytest.mark.parametrize("name,protocol", [
    ("smoke", "copml"), ("mnist10_like", "copml"), ("smoke", "float")])
def test_serving_on_the_card_is_bit_exact(cuda, name, protocol):
    res = api.fit(name, protocol, "jit", iters=3)
    wl = api.get_workload(name)
    x, _ = wl.eval_set()
    x = np.asarray(x[:40], np.float32)
    srv = api.serve(name, res, "jit", batch_size=16)
    assert srv.model.w_cols.is_cuda
    assert srv.model.from_shares == (protocol == "copml")
    ops.reset_launches()
    secure = srv.score_field(x)
    assert ops.launch_counts()["modmatmul"] > 0
    np.testing.assert_array_equal(
        secure, coded.reference_scores(res.weights, x, wl.cfg).numpy())
    preds, stats = srv.serve(x)
    np.testing.assert_array_equal(preds, srv.predict(x))
    assert stats["batches"] == 3


@pytest.mark.parametrize("b", [1, 32, 128])
def test_serving_gemm_shapes_match_plain(cuda, b):
    """(B, 3073) @ (3073, 50), serving's packed GEMM at cifar10_case2's
    width, on the split-K kernel."""
    rng = np.random.default_rng(b)
    a = torch.from_numpy(rng.integers(0, field.P, (b, 3073), dtype=np.int64)
                         .astype(np.int32))
    w = torch.from_numpy(rng.integers(0, field.P, (3073, 50),
                                      dtype=np.int64).astype(np.int32))
    assert mm.path_of(a[None], w[None]) == "splitk"
    got = mm.modmatmul(a.to(cuda), w.to(cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(), ref.modmatmul(a, w).numpy())


@pytest.mark.parametrize("c", [1, 10])
def test_baseline_z_gemm_matches_plain(cuda, c):
    """Z = X W of the MPC baseline: a K-contiguous (N_g, m/3, d) share
    tensor times (N_g, d, C), on the row-dot kernel (a cut of cifar10_case2's
    (16, 3006, 3073))."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.integers(0, field.P, (4, 301, 3073),
                                      dtype=np.int64).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, field.P, (4, 3073, c),
                                      dtype=np.int64).astype(np.int32))
    assert mm.path_of(x, w) == "rowdot"
    got = mm.modmatmul_batched(x.to(cuda), w.to(cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(),
                                  ref.modmatmul_batched(x, w).numpy())
