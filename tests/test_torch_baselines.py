"""repro_torch's MpcBaseline (the [BH08] / [BGW88] Appendix-D baselines) vs
the JAX package's, on the CPU.

Every JAX call runs under `jax.threefry_partitionable(False)` (the legacy
stream the port emulates) and goes through MpcBaseline.setup / .iteration
directly: the JAX package's train() would first compile its step.  Shares
and opened weights must be bit-equal.
"""

import hashlib
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import api as japi
from repro.api import workloads as jworkloads
from repro.core import baselines as jbaselines
from repro_torch import api
from repro_torch.core import baselines
from repro_torch.core import random as jrandom

REPO = Path(__file__).resolve().parent.parent


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _sha(arr, dtype):
    return hashlib.sha256(np.asarray(arr, dtype).tobytes()).hexdigest()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_train(wl, scheme, seed, iters):
    """The JAX package's MpcBaseline.train key schedule, step by step:
    (setup state, [state after each step], [opened model after each])."""
    x, y, _, _ = wl.data()
    with jax.threefry_partitionable(False):
        mb = jbaselines.MpcBaseline(wl.cfg, wl.m, wl.d, scheme=scheme,
                                    objective=wl.objective)
        ks, ki = jax.random.split(jax.random.PRNGKey(seed))
        state = mb.setup(ks, x, y)
        states, opened = [], []
        for t in range(iters):
            states.append(mb.iteration(jax.random.fold_in(ki, t),
                                       states[-1] if states else state))
            opened.append(mb.open_model(states[-1]))
    return mb, state, states, opened


def check_setup_and_steps(name, scheme):
    """Setup shares (X, X^T y, w), the shares after each of two steps and
    the opened weights equal the JAX package's bit for bit."""
    wl = jworkloads.get(name)
    _, jstate, jsteps, jopened = _jax_train(wl, scheme, 1, 2)
    x, y, _, _ = wl.data()
    mb = baselines.MpcBaseline(wl.cfg, wl.m, wl.d, scheme=scheme,
                               objective=wl.objective, device="cpu")
    ks, ki = jrandom.split(jrandom.PRNGKey(1))
    state = mb.setup(ks, x, y)
    assert state.x_shares.shape == (3, wl.n_clients // 3, wl.m // 3, wl.d)
    _eq(state.x_shares, jstate.x_shares)
    _eq(state.xty_shares, jstate.xty_shares)
    _eq(state.w_shares, jstate.w_shares)
    for t, (jst, jw) in enumerate(zip(jsteps, jopened)):
        state = mb.iteration(jrandom.fold_in(ki, t), state)
        _eq(state.w_shares, jst.w_shares)
        _eq(mb.open_model(state), jw)
        assert state.step == int(jst.step) == t + 1


@pytest.mark.parametrize("scheme", ["bh08", "bgw"])
def test_setup_and_steps_match_jax(scheme):
    """smoke (N=13: 3 subgroups of 4, T=1); cifar10_like and mnist10_like
    are in test_torch_baselines_wide.py."""
    check_setup_and_steps("smoke", scheme)


def test_iteration_from_carried_jax_state():
    """One port iteration from the JAX package's MpcState, carried across by
    mpc_state_from_numpy, equals one JAX iteration on the same key."""
    wl = jworkloads.get("smoke")
    jmb, jstate, jsteps, _ = _jax_train(wl, "bh08", 4, 1)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(11)
        jnext = jmb.iteration(key, jsteps[0])
    mb = baselines.MpcBaseline(wl.cfg, wl.m, wl.d, device="cpu")
    carried = baselines.mpc_state_from_numpy(
        np.asarray(jsteps[0].w_shares), np.asarray(jsteps[0].x_shares),
        np.asarray(jsteps[0].xty_shares), np.asarray(jsteps[0].step))
    nxt = mb.iteration(jrandom.as_key(np.asarray(key)), carried)
    _eq(nxt.w_shares, jnext.w_shares)
    assert nxt.step == int(jnext.step) == 2
    _eq(mb.open_model(nxt), jmb.open_model(jnext))


@pytest.mark.parametrize("scheme", ["bh08", "bgw"])
def test_chip_smoke_mpc_shas_are_the_jax_packages(scheme):
    """chip_smoke.py's MPC_SHAS are the JAX package's smoke, key 0, 3
    iterations; the port reproduces them on the CPU, and so does api.fit
    (bh08, the registry's scheme) with its per-step history."""
    cs = _chip_smoke()
    wl = jworkloads.get("smoke")
    jmb, _, jsteps, jopened = _jax_train(wl, scheme, 0, 3)
    want = (_sha(jsteps[-1].w_shares, np.int32),
            _sha(jopened[-1], np.float32))
    assert cs.MPC_SHAS[scheme] == want
    assert cs.mpc_smoke(scheme, "cpu") == want
    if scheme == "bh08":
        res = api.fit("smoke", "mpc_baseline", "eager", key=0, iters=3,
                      device="cpu")
        assert (_sha(res.state.w_shares.numpy(), np.int32),
                _sha(res.weights, np.float32)) == want
        _eq(res.history, np.stack([np.asarray(w) for w in jopened]))


def check_fit_matches_jax(name):
    """api.fit(name, "mpc_baseline", engine) on both engines: shares,
    history and weights bit-equal to the JAX package's MpcBaseline on
    fit's key schedule (key 0), and TrainResult.cost equal to its."""
    wl = jworkloads.get(name)
    _, _, jsteps, jopened = _jax_train(wl, "bh08", 0, 2)
    for engine in ("eager", "jit"):
        res = api.fit(name, "mpc_baseline", engine, key=0, iters=2,
                      device="cpu")
        _eq(res.state.w_shares, jsteps[-1].w_shares)
        _eq(res.history, np.stack([np.asarray(w) for w in jopened]))
        _eq(res.weights, jopened[-1])
        assert res.cost == japi.PROTOCOLS["mpc_baseline"].cost(wl, 2)
        assert res.timings["setup_s"] >= 0 and res.timings["iters_s"] >= 0


@pytest.mark.parametrize("name", ["smoke", "linreg_smoke"])
def test_fit_matches_jax(name):
    """smoke and linreg_smoke (same shapes, the linreg objective's
    coefficients); mnist10_like is in test_torch_baselines_wide.py."""
    check_fit_matches_jax(name)


def test_mpc_baseline_guards():
    wl = api.get_workload("smoke")
    with pytest.raises(AssertionError, match="2T\\+1"):
        baselines.MpcBaseline(wl.cfg, wl.m, wl.d, groups=5, device="cpu")
    mb = baselines.MpcBaseline(wl.cfg, wl.m, wl.d, device="cpu")
    assert (mb.n_g, mb.lambdas, mb.c_out) == (4, (1, 2, 3, 4), 1)
    jmb = jbaselines.MpcBaseline(wl.cfg, wl.m, wl.d)
    assert (mb.q_eta, mb.e, mb.k1, mb.k2) == (jmb.q_eta, jmb.e, jmb.k1,
                                              jmb.k2)
    _eq(mb.poly_coeffs, jmb.poly_coeffs)
