"""repro_torch's protocol registry and its float, poly_float and secure_agg
protocols and cost model vs the JAX package, on the CPU.

JAX calls run under `jax.threefry_partitionable(False)`.  The float
trainers are held to tolerances: float64 "eager" within 1e-9 of the JAX
package's numpy loops, float32 "jit" within 1e-5 (weights) and 1e-4
(history) of its lax.scan, as tests/test_api.py holds the JAX engines to
each other.  A secure_agg aggregation round is bit-equal on the same float
gradients; a whole secure_agg fit (whose float gradients differ in the
last bits) is held within 1e-4.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import cost_model as jcost
from repro.core import secure_agg as jsa
from repro_torch import api
from repro_torch.core import cost_model, meshutil, secure_agg
from repro_torch.core import random as jrandom

REPO = Path(__file__).resolve().parent.parent
WORKLOADS = ["smoke", "mnist10_like", "linreg_smoke"]


def _jfit(*args, **kw):
    with jax.threefry_partitionable(False):
        return japi.fit(*args, **kw)


@pytest.mark.parametrize("protocol", ["float", "poly_float"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_float_protocols_match_jax(protocol, name):
    """eager (float64) within 1e-9 of the JAX package's numpy trainers;
    jit (float32) within 1e-5 / 1e-4 of its compiled scans."""
    for engine, tol_w, tol_h in (("eager", 1e-9, 1e-9),
                                 ("jit", 1e-5, 1e-4)):
        got = api.fit(name, protocol, engine, device="cpu")
        want = _jfit(name, protocol, engine)
        assert got.weights.dtype == want.weights.dtype
        assert got.weights.shape == want.weights.shape
        np.testing.assert_allclose(got.weights, want.weights, rtol=0,
                                   atol=tol_w)
        np.testing.assert_allclose(got.history, want.history, rtol=0,
                                   atol=tol_h)
        assert got.cost is None and got.state is None
        assert got.triple == (name, protocol, engine)


def _jax_round(key, g, cfg, sel=None):
    with jax.threefry_partitionable(False):
        jsel = None if sel is None else (jnp.asarray(sel[0]),
                                         jnp.asarray(sel[1]))
        return np.asarray(jsa._secure_mean_step(key, jnp.asarray(g), cfg,
                                                None, jsel))


@pytest.mark.parametrize("n,t,width", [(13, 1, 12), (15, 2, 240)])
def test_secure_mean_step_bit_equal(n, t, width):
    """One aggregation round on identical float gradients (some past the
    clip) gives the JAX package's opened mean bit for bit: all holders,
    and a per-step T+1 holder selection."""
    cfg_t = secure_agg.SecureAggConfig(n_clients=n, t=t)
    cfg_j = jsa.SecureAggConfig(n_clients=n, t=t)
    g = np.random.default_rng(n).normal(0, 4, (n, width)).astype(np.float32)
    with jax.threefry_partitionable(False):
        key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
        jsel = jsa.selection_arrays(cfg_j, [tuple(range(n - t - 1, n))])
    tkey = jrandom.as_key(np.asarray(key))
    tsel = secure_agg.selection_arrays(cfg_t, [tuple(range(n - t - 1, n))])
    np.testing.assert_array_equal(np.asarray(tsel[1]), np.asarray(jsel[1]))
    for sel_j, sel_t in ((None, None),
                         ((jsel[0][0], jsel[1][0]), (tsel[0][0], tsel[1][0]))):
        want = _jax_round(key, g, cfg_j, sel_j)
        got = secure_agg._secure_mean_step(tkey, torch.from_numpy(g), cfg_t,
                                           None, sel_t)
        np.testing.assert_array_equal(got.numpy(), want)


def test_secure_aggregate_and_decode_match_jax():
    """The pytree round trip (secure_aggregate, a static holder subset) and
    encode_local / encode_all / aggregate_shares / decode_mean piecewise."""
    n, t = 13, 1
    cfg_t = secure_agg.SecureAggConfig(n_clients=n, t=t)
    cfg_j = jsa.SecureAggConfig(n_clients=n, t=t)
    rng = np.random.default_rng(5)
    grads = [{"w": rng.normal(0, 3, (4, 3)).astype(np.float32),
              "b": rng.normal(0, 3, (3,)).astype(np.float32)}
             for _ in range(n)]
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(21)
        want = jsa.secure_aggregate(
            key, [{k: jnp.asarray(v) for k, v in g.items()} for g in grads],
            cfg_j, subset=(4, 9))
        keys = jax.random.split(key, n + 1)
        flat = jnp.asarray(np.stack([np.concatenate(
            [g["b"], g["w"].ravel()]) for g in grads]))
        jshares = jnp.stack([jsa.encode_local(keys[j], flat[j], cfg_j)
                             for j in range(n)])
        jsum = jax.vmap(jsa.aggregate_shares)(jnp.swapaxes(jshares, 0, 1))
    got = secure_agg.secure_aggregate(
        jrandom.as_key(np.asarray(key)),
        [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads],
        cfg_t, subset=(4, 9))
    assert sorted(got) == ["b", "w"] and got["w"].shape == (4, 3)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    tkeys = jrandom.split(jrandom.as_key(np.asarray(key)), n + 1)
    tflat = torch.from_numpy(np.asarray(flat))
    np.testing.assert_array_equal(
        secure_agg.encode_local(tkeys[2], tflat[2], cfg_t).numpy(),
        np.asarray(jshares[2]))
    tshares = secure_agg.encode_all(tkeys[:n], tflat, cfg_t)
    np.testing.assert_array_equal(tshares.numpy(), np.asarray(jshares))
    np.testing.assert_array_equal(
        secure_agg.aggregate_shares(tshares).numpy(), np.asarray(jsum))


def test_chip_smoke_agg_shas_are_the_jax_packages():
    """chip_smoke.py's AGG_SHAS are the JAX package's three aggregation
    rounds (chip_smoke.agg_rounds' gradients, keys and holder choice), and
    the port reproduces them on the CPU."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    wl = api.get_workload("smoke")
    cfg = jsa.SecureAggConfig(n_clients=wl.n_clients, t=wl.cfg.t)
    sums, means = [], []
    with jax.threefry_partitionable(False):
        sel = jsa.selection_arrays(cfg, [(3, 5)])
        for t in range(3):
            g = jnp.asarray(cs.agg_gradients(np, t, cfg.n_clients, wl.d))
            keys = jax.random.split(
                jax.random.fold_in(jax.random.PRNGKey(0), t),
                cfg.n_clients + 1)
            shares = jax.vmap(lambda k, gj: jsa.encode_local(k, gj, cfg))(
                keys[:cfg.n_clients], g)
            sums.append(np.asarray(jax.vmap(jsa.aggregate_shares)(
                jnp.swapaxes(shares, 0, 1))))
            means.append(np.asarray(jsa.decode_mean(
                keys[cfg.n_clients], jnp.asarray(sums[-1]), cfg, None,
                (sel[0][0], sel[1][0]) if t == 2 else None)))
    want = (cs.sha(np.stack(sums), np.int32),
            cs.sha(np.stack(means), np.float32))
    assert cs.AGG_SHAS == want
    assert cs.agg_rounds("cpu") == want


@pytest.mark.parametrize("name", WORKLOADS)
def test_secure_agg_fit_matches_jax(name):
    """Whole fits, both engines, within 1e-4 of the JAX package's jit fit;
    the two port engines give the same bits."""
    want = _jfit(name, "secure_agg", "jit", iters=6)
    got = {e: api.fit(name, "secure_agg", e, iters=6, device="cpu")
           for e in ("eager", "jit")}
    np.testing.assert_array_equal(got["eager"].history, got["jit"].history)
    res = got["jit"]
    assert res.weights.dtype == np.float32
    np.testing.assert_allclose(res.weights, want.weights, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.history, want.history, rtol=0, atol=1e-4)
    assert res.state == secure_agg.SecureAggConfig(
        n_clients=want.state.n_clients, t=want.state.t)
    assert res.cost is None


def test_secure_agg_fault_plans():
    """A straggler plan picks each round's T+1 holders (same model as the
    fault-free fit within the aggregation's rounding); adversarial plans
    are rejected before any compute, as by the JAX package."""
    plan = api.FaultPlan.from_schedule(13, 4, stragglers={1: (0, 1)},
                                       dropouts={2: (7,)})
    res = api.fit("smoke", "secure_agg", "jit", iters=4, faults=plan,
                  device="cpu")
    np.testing.assert_array_equal(res.availability, plan.available)
    jplan = japi.FaultPlan.from_schedule(13, 4, stragglers={1: (0, 1)},
                                         dropouts={2: (7,)})
    want = _jfit("smoke", "secure_agg", "jit", iters=4, faults=jplan)
    np.testing.assert_allclose(res.history, want.history, rtol=0, atol=1e-4)
    bad = api.FaultPlan.from_schedule(13, 4, adversaries={2: (3,)})
    with pytest.raises(api.FaultPlanViolation, match="adversarially"):
        api.fit("smoke", "secure_agg", "jit", iters=4, faults=bad,
                device="cpu")
    with pytest.raises(ValueError, match="no fault injection"):
        api.fit("smoke", "float", "jit", iters=4, faults=plan, device="cpu")
    assert api.PROTOCOLS["secure_agg"].fault_threshold(
        api.get_workload("smoke")) == 2


def test_cost_model_matches_jax():
    """Every cost_model function equals the JAX package's over a grid of
    workloads (cifar10_case2's among them), and TrainResult.cost is the
    JAX fit's for copml and mpc_baseline."""
    grid = [cost_model.Workload(m, d, n, k, t, j, r, c)
            for (m, d, n, k, t, j, r, c) in [
                (9019, 3073, 50, 10, 7, 50, 1, 1),
                (9019, 3073, 50, 10, 7, 5, 1, 10),
                (96, 12, 13, 4, 1, 10, 1, 1), (390, 24, 13, 4, 1, 25, 3, 10),
                (6000, 5000, 40, 9, 5, 50, 1, 1)]]
    for w in grid:
        jw = jcost.Workload(**w.__dict__)
        assert cost_model.copml_costs(w) == jcost.copml_costs(jw)
        for scheme in ("bh08", "bgw"):
            for groups in (3, 5):
                assert cost_model.mpc_baseline_costs(w, scheme=scheme,
                                                     groups=groups) == \
                    jcost.mpc_baseline_costs(jw, scheme=scheme, groups=groups)
            assert cost_model.speedup(w, scheme=scheme) == \
                jcost.speedup(jw, scheme=scheme)
    hw = cost_model.WanParams(bandwidth_mbps=100.0, latency_s=0.01)
    assert cost_model.copml_costs(grid[0], hw) == jcost.copml_costs(
        jcost.Workload(**grid[0].__dict__), jcost.WanParams(100.0, 0.01))
    for p, j in [(2, 3), (4, 5), (7, 1)]:
        for h in (False, True):
            assert cost_model.proc_net_frames(p, j, h) == \
                jcost.proc_net_frames(p, j, h)
    wl = japi.get_workload("cifar10_case2")
    for name in ("copml", "mpc_baseline"):
        want = japi.PROTOCOLS[name].cost(wl, 5)
        assert api.PROTOCOLS[name].cost(api.get_workload("cifar10_case2"),
                                        5) == want
    res = api.fit("smoke", "mpc_baseline", "jit", iters=2, device="cpu")
    assert res.cost == japi.PROTOCOLS["mpc_baseline"].cost(
        japi.get_workload("smoke"), 2)
    assert "modeled total" in res.summary()


def test_protocol_registry_and_validation():
    """The JAX package's registry names and argument checks."""
    assert api.protocol_names() == japi.protocol_names() == (
        "copml", "float", "mpc_baseline", "poly_float", "secure_agg")
    assert set(api.PROTOCOLS) == set(japi.PROTOCOLS)
    with pytest.raises(KeyError, match="unknown protocol.*registered: "
                       "copml, float, mpc_baseline"):
        api.fit("smoke", "quantum", "jit", device="cpu")
    with pytest.raises(ValueError, match="supports engines"):
        api.fit("smoke", "float", "sharded", device="cpu")
    # copml runs every engine of the JAX package: sharded:4 gives jit's
    # bits
    got = api.fit("smoke", "copml", "sharded:4", iters=2, device="cpu")
    want = api.fit("smoke", "copml", "jit", iters=2, device="cpu")
    np.testing.assert_array_equal(got.weights, want.weights)
    np.testing.assert_array_equal(got.state.w_shares.numpy(),
                                  want.state.w_shares.numpy())
    meshutil.close_meshes()
    with pytest.raises(ValueError, match="supports engines"):
        api.fit("smoke", "float", "proc:2", device="cpu")
    with pytest.raises(ValueError, match="straggler-subset"):
        api.fit("smoke", "float", "jit", subset=(0, 1, 2), device="cpu")
    # a workload's default subset only binds protocols that decode one
    res = api.fit("smoke_straggler", "mpc_baseline", "jit", iters=2,
                  device="cpu")
    assert res.triple == ("smoke_straggler", "mpc_baseline", "jit")
    with pytest.raises(ValueError, match="subset must be None"):
        api.fit("smoke", "copml", "jit", subset="most", device="cpu")
    plan = api.FaultPlan.from_schedule(13, 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        api.fit("smoke", "copml", "jit", iters=2, subset=(0, 1),
                faults=plan, device="cpu")
    assert isinstance(api.PROTOCOLS["copml"], api.Protocol)

    class Echo(api.Protocol):
        name = "echo_test"

        def _run(self, wl, engine, key, iters, subset, history, plan,
                 device, timings):
            w = torch.zeros(wl.w_shape)
            return w, torch.zeros((iters,) + wl.w_shape), None

    api.register_protocol(Echo())
    try:
        res = api.fit("smoke", "echo_test", "eager", iters=2, device="cpu")
        assert res.triple == ("smoke", "echo_test", "eager")
        assert res.history.shape == (2, 12)
    finally:
        del api.PROTOCOLS["echo_test"]
