"""repro_torch COPML protocol and api.fit vs the JAX package, on the CPU.

Setup and one fused iteration are compared live against the JAX package's
Copml on the same key (legacy threefry layout).  Whole fits are compared
against sha256 pins of the JAX package's api.fit(..., "copml", "jit",
key=0) outputs: the smoke goldens of tests/test_api.py, and the shares /
history shas below, produced by the JAX package under
`jax.threefry_partitionable(False)` (chip_smoke.py pins the same values).
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

from repro.api import workloads as jworkloads
from repro.core.protocol import Copml as JCopml
from repro_torch import api
from repro_torch.core import protocol
from repro_torch.core import random as jrandom

GOLDEN_W = [0.25, -0.375, 0.375, 0.5, -0.125, 0.25, 0.875, 1.25, -0.5,
            -1.125, -0.5, 0.125]
GOLDEN_SHARES_SHA = \
    "459aaa671b3d6708b4918f1e54b29e083cecf6c85b5b617f882720596399afaf"
GOLDEN_HIST_SHA = \
    "343e87b79c6ece3608774a43160dccbb80ef214111bdb0f9f9c066ead77f9e80"
PINNED = {
    ("mnist10_like", 3): (
        "ec665a028963a34ad6d3db0b2d5edadffb6e8bc51bb0c16bae48c7fcb5b1fe93",
        "081ef4be1cf1058e8eb2291105a8f176891e1d063c9f047cd5168927862b09f4"),
    ("linreg_smoke", 3): (
        "b73e3759792db9706b1c7cde248419d1ea5989f68a7d262fcdf19a757d9a018e",
        "6aeda2a10e06f4e07df80e48c6ff8f17d1dd5470eac3b7cf4ed941f31f172359"),
    ("cifar10_like", 3): (
        "a6b0724d58966fca077bbffbbfa518e42b8c692e5f347ab7ca5e5850be8bca8c",
        "01df5eac47631ff6c7df2421dadb4469a826034da4fe8f58dc2a1978b6c26bc2"),
    ("smoke_straggler", 4): (
        "a475aab02794841823767404680ec5a9ea337a869c1503fc449c2ddc0c2179da",
        "7ece876243ab5f5a5015f937a52c9f3374642f42ff6b4d36009288148a2fbae6"),
}


def _sha(arr, dtype):
    return hashlib.sha256(np.asarray(arr, dtype).tobytes()).hexdigest()


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", ["smoke", "mnist10_like"])
def test_setup_and_iteration_match_jax(name):
    """Copml.setup's shares / coded slices / X^T y shares, one fused
    iteration from the JAX state carried over by state_from_numpy, and
    the opened model are bit-equal to the JAX package's."""
    wl = jworkloads.get(name)
    cx, cy = wl.client_data()
    jproto = JCopml(wl.cfg, wl.m, wl.d, objective=wl.objective)
    tproto = protocol.Copml(wl.cfg, wl.m, wl.d, objective=wl.objective,
                            device="cpu")
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(3)
        ks, ki = jax.random.split(key)
        jstate = jax.jit(lambda k: jproto.setup(k, cx, cy))(ks)
        kit = jax.random.fold_in(ki, 2)
        jnext = jax.jit(jproto.iteration)(kit, jstate)
        jcoded_w = jax.jit(jproto.encode_model)(jax.random.split(kit)[0],
                                                jstate.w_shares)
    tstate = tproto.setup(jrandom.as_key(np.asarray(ks)), cx, cy)
    _eq(tstate.w_shares, jstate.w_shares)
    _eq(tstate.coded_x, jstate.coded_x)
    _eq(tstate.xty_shares, jstate.xty_shares)

    carried = protocol.state_from_numpy(
        np.asarray(jstate.w_shares), np.asarray(jstate.coded_x),
        np.asarray(jstate.xty_shares), np.asarray(jstate.step))
    tkit = jrandom.as_key(np.asarray(kit))
    _eq(tproto.encode_model(jrandom.split(tkit)[0], carried.w_shares),
        jcoded_w)
    tnext = tproto.iteration(tkit, carried)
    _eq(tnext.w_shares, jnext.w_shares)
    assert tnext.step == int(jnext.step) == 1
    _eq(tproto.open_model(tnext), jproto.open_model(jnext))


def test_fit_smoke_reproduces_goldens():
    res = api.fit("smoke", "copml", "jit", key=0, iters=10, device="cpu")
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert _sha(res.state.w_shares.numpy(), np.int32) == GOLDEN_SHARES_SHA
    assert _sha(res.history, np.float32) == GOLDEN_HIST_SHA
    assert res.triple == ("smoke", "copml", "jit")
    assert res.device == "cpu"
    assert res.history.shape == (10, 12) and res.accuracy.shape == (10,)
    assert set(res.timings) == {"setup_s", "iters_s"}


@pytest.mark.parametrize("name,iters", sorted(PINNED))
def test_fit_matches_jax_pins(name, iters):
    """The (d, C) matrix path, linreg, the case-2 T=2 workload and a
    decode from a straggler subset."""
    res = api.fit(name, "copml", "eager", key=0, iters=iters, device="cpu")
    s_sha, h_sha = PINNED[(name, iters)]
    assert _sha(res.state.w_shares.numpy(), np.int32) == s_sha
    assert _sha(res.history, np.float32) == h_sha


def test_fit_matches_live_jax_fit():
    """One whole fit against the JAX package's api.fit run live."""
    from repro import api as japi
    with jax.threefry_partitionable(False):
        want = japi.fit("linreg_smoke", "copml", "jit", key=0, iters=3)
    got = api.fit("linreg_smoke", "copml", "jit", key=0, iters=3,
                  device="cpu")
    _eq(got.state.w_shares, want.state.w_shares)
    _eq(got.history, want.history)
    _eq(got.weights, want.weights)
    assert got.final_accuracy == want.final_accuracy


def test_fit_options():
    """A JAX key's data as the key, history off, and argument checks."""
    with jax.threefry_partitionable(False):
        key = np.asarray(jax.random.PRNGKey(0))
    res = api.fit("smoke", key=key, iters=10, history=False, device="cpu")
    assert res.history is None and res.accuracy is None
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    with pytest.raises(ValueError, match="not ported"):
        api.fit("smoke", "float", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        api.fit("smoke", "copml", "sharded", device="cpu")


def test_scoring_helpers_match_jax():
    from repro.api import result as jresult
    res = api.fit("smoke", iters=4, device="cpu")
    x, y = api.get_workload("smoke").eval_set()
    assert api.accuracy_of(res.weights, x, y) == \
        jresult.accuracy_of(res.weights, x, y) == res.final_accuracy
    _eq(api.accuracy_curve(res.history, x, y),
        jresult.accuracy_curve(res.history, x, y))
    _eq(api.accuracy_curve(res.history, x, y), res.accuracy)
    with pytest.raises(ValueError, match="vector"):
        api.accuracy_of(np.zeros((12, 3)), x, y)
    assert "smoke x copml x jit on cpu" in res.summary()


def test_config_helpers_match_jax():
    from repro.core import protocol as jprotocol
    for n in (13, 15, 50):
        assert protocol.case1_params(n) == jprotocol.case1_params(n)
        assert protocol.case2_params(n) == jprotocol.case2_params(n)
    for name in ("smoke", "cifar10_case2", "gisette_case1"):
        jw, tw = jworkloads.get(name), api.get_workload(name)
        assert (tw.m, tw.d, tw.iters) == (jw.m, jw.d, jw.iters)
        assert dataclasses_equal(tw.cfg, jw.cfg)
        assert protocol.derive_update_constants(tw.cfg, tw.m) == \
            jprotocol.derive_update_constants(jw.cfg, jw.m)


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_cpu_data_matches_jax_builders():
    for name in ("cifar10_like", "mnist10_like", "linreg_smoke"):
        for got, want in zip(api.get_workload(name).data(),
                             jworkloads.get(name).data()):
            _eq(got, want)
    assert torch.get_default_dtype() == torch.float32
