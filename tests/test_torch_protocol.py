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
from repro_torch.api import workloads
from repro_torch.core import meshutil, protocol, quantize
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


def _concatenated_rows(proto, client_xs, client_ys):
    """Phase 1 as one host array: every client's rows joined by
    np.concatenate (its dtype promotion included), then quantized."""
    xq = quantize.quantize(np.concatenate(
        [np.asarray(x) for x in client_xs], axis=0), proto.cfg.lx,
        proto.device)
    targets = proto.obj.prepare_targets(
        np.concatenate([np.asarray(y) for y in client_ys], axis=0))
    yq = quantize.quantize(np.asarray(targets, np.float32), proto.cfg.lg,
                           proto.device)
    return xq, yq


def _client_rows(kind, x, n):
    """Clients of a kind of input: np.array_split's (sizes one row apart),
    with empty clients, in float64, int8, a mix of dtypes, CPU tensors."""
    parts = np.array_split(np.arange(x.shape[0]), n)
    f32 = x.astype(np.float32)
    i8 = np.round(x * 90).astype(np.int8)
    if kind == "split":
        return [f32[i] for i in parts]
    if kind == "empty":
        return [f32[:0]] + [f32[i] for i in parts[:-1]] + \
            [np.zeros((0, x.shape[1]), np.float32), f32[parts[-1]]]
    if kind == "float64":
        return [x[i] for i in parts]
    if kind == "int8":
        return [i8[i] for i in parts]
    if kind == "mixed":
        srcs = (x, f32, i8)
        return [srcs[j % 3][i] for j, i in enumerate(parts)]
    assert kind == "tensor"
    return [torch.from_numpy(f32[i]) for i in parts]


@pytest.mark.parametrize("kind", ["split", "empty", "float64", "int8",
                                  "mixed", "tensor"])
def test_setup_rows_equal_the_concatenated_rows(monkeypatch, kind):
    """setup.rows stages each client's rows straight into one buffer: its
    field elements equal those of the clients' rows concatenated on the
    host and quantized, and so does the whole CopmlState, with no host
    bytes staged and no copy to a card counted on the CPU."""
    wl = workloads.get("smoke")
    cx, cy = wl.client_data()
    x = np.concatenate(cx).astype(np.float64) * 1.37
    y = np.concatenate(cy)
    cy = [y[i] for i in np.array_split(np.arange(len(y)), wl.n_clients)]
    cx = _client_rows(kind, x, wl.n_clients)
    if kind == "empty":
        cy = [y[:0]] + cy[:-1] + [y[:0], cy[-1]]
    proto = protocol.Copml(wl.cfg, wl.m, wl.d, objective=wl.objective,
                           device="cpu")
    before = dict(protocol.ROWS_COUNTS)
    xq, yq = proto.quantize_rows(cx, cy)
    assert dict(protocol.ROWS_COUNTS) == before
    want_x, want_y = _concatenated_rows(proto, cx, cy)
    assert xq.dtype == want_x.dtype == torch.int32
    assert torch.equal(xq, want_x) and torch.equal(yq, want_y)

    key = jrandom.as_key(11)
    got = proto.setup(key, cx, cy)
    monkeypatch.setattr(proto, "quantize_rows",
                        lambda xs, ys: _concatenated_rows(proto, xs, ys))
    want = proto.setup(key, cx, cy)
    for f in ("w_shares", "coded_x", "xty_shares"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.step == want.step == 0


def test_setup_rows_refuse_rows_of_another_width():
    wl = workloads.get("smoke")
    cx, cy = wl.client_data()
    proto = protocol.Copml(wl.cfg, wl.m, wl.d, device="cpu")
    with pytest.raises(ValueError, match="client 1's rows"):
        proto.quantize_rows([cx[0], cx[1][:, :-1]], cy[:2])


def test_fit_smoke_reproduces_goldens():
    res = api.fit("smoke", "copml", "jit", key=0, iters=10, device="cpu")
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert _sha(res.state.w_shares.numpy(), np.int32) == GOLDEN_SHARES_SHA
    assert _sha(res.history, np.float32) == GOLDEN_HIST_SHA
    assert res.triple == ("smoke", "copml", "jit")
    assert res.device == "cpu"
    assert res.history.shape == (10, 12) and res.accuracy.shape == (10,)
    assert set(res.timings) == {"setup_s", "iters_s", "spans", "counts"}


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
    with pytest.raises(KeyError, match="unknown protocol"):
        api.fit("smoke", "quantum", device="cpu")
    # a bare "sharded" spec on the CPU is one rank: the same bits
    res = api.fit("smoke", "copml", "sharded", key=key, iters=10,
                  history=False, device="cpu")
    assert res.engine == "sharded"
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    meshutil.close_meshes()


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


# ------------------------------------------- the siloed schedule and faults

# smoke_straggler (N=13, K=3, T=1, R=10) under tests/test_faults.py's plan:
# stragglers, a dropout and an adversary, min availability exactly R.
# The shas are the JAX package's run_copml_engine(..., "jit", PRNGKey(0),
# iters=6) with that plan, the same on both of its schedules.
FAULTY_SHARES_SHA = \
    "239bb5c60a80c270b9417cf6025b80b18ef8a8dcb900ecda07ab9b289593352d"
FAULTY_HIST_SHA = \
    "d0a119966962c28edbfed2d3e6d6dffc3fc2413e49d189dc8148748d4147b86a"


def _fault_plan():
    return api.FaultPlan.from_schedule(
        13, 6, stragglers={1: (0, 1), 4: (2,)}, dropouts={2: (7,)},
        adversaries={3: (8,)})


def _random_state(rng, proto):
    """Field-valued CopmlState arrays of `proto`'s shapes (the phases below
    take any state), as numpy."""
    n, mk = proto.cfg.n_clients, -(-proto.m // proto.cfg.k)
    fld = lambda *s: rng.integers(0, P, s).astype(np.int32)  # noqa: E731
    return (fld(n, *proto.w_shape), fld(n, mk, proto.d),
            fld(n, *proto.w_shape), fld(n, *proto.w_shape))


P = protocol.field.P


def _carried_state(name, seed):
    """(JAX Copml in siloed mode, port Copml, JAX state, port state, coded
    model) over field-valued arrays of `name`'s shapes."""
    from repro.core.protocol import CopmlState as JState
    import jax.numpy as jnp
    wl = jworkloads.get(name)
    jproto = JCopml(wl.cfg, wl.m, wl.d, objective=wl.objective)
    jproto.fused_mode = "0"
    tproto = protocol.Copml(wl.cfg, wl.m, wl.d, objective=wl.objective,
                            device="cpu")
    w_sh, cx, xty, coded_w = _random_state(np.random.default_rng(seed),
                                           tproto)
    jstate = JState(w_shares=jnp.asarray(w_sh), coded_x=jnp.asarray(cx),
                    xty_shares=jnp.asarray(xty), step=jnp.asarray(0))
    tstate = protocol.state_from_numpy(w_sh, cx, xty)
    return jproto, tproto, jstate, tstate, coded_w


@pytest.mark.parametrize("name", ["smoke", "mnist10_like"])
def test_local_gradient_matches_jax(name):
    """Phase 3 for a (d,) and a (d, C) model (the batched and the matrix
    coded-gradient entries)."""
    import jax.numpy as jnp
    jproto, tproto, jstate, tstate, coded_w = _carried_state(name, 1)
    _eq(tproto.local_gradient(tstate.coded_x, torch.from_numpy(coded_w)),
        jax.jit(jproto.local_gradient)(jstate.coded_x, jnp.asarray(coded_w)))


def test_decode_and_update_matches_jax():
    """decode_and_update in its static-subset and (subset_idx, dvec) forms,
    and a siloed iteration with an adversary, each bit-equal to the JAX
    package's methods on the same state (one jitted JAX program); the
    port's fused schedule gives the adversary's step the same bits."""
    import jax.numpy as jnp
    jproto, tproto, jstate, tstate, coded_w = _carried_state("smoke", 2)
    n, rthr = jproto.cfg.n_clients, jproto.cfg.recovery_threshold
    sub = tuple(range(n - rthr, n))                  # the LAST R clients
    adv = np.zeros(n, bool)
    adv[0] = True
    jidx, jdv = jproto.plan_constants([sub, tuple(range(rthr))])

    def jax_phases(key, st, f):
        return (jproto.decode_and_update(key, st, f, sub).w_shares,
                jproto.decode_and_update(key, st, f, subset_idx=jidx[0],
                                         dvec=jdv[0]).w_shares,
                jproto.iteration(key, st, subset_idx=jidx[0], dvec=jdv[0],
                                 adv=jnp.asarray(adv)).w_shares)

    f_t = tproto.local_gradient(tstate.coded_x, torch.from_numpy(coded_w))
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(5)
        want = jax.jit(jax_phases)(key, jstate, jnp.asarray(f_t.numpy()))
    tkey = jrandom.as_key(np.asarray(key))
    tidx, tdv = tproto.plan_constants([sub, tuple(range(rthr))])
    _eq(tidx, jidx)
    _eq(tdv, jdv)
    assert tidx.dtype == torch.int64 and tdv.dtype == torch.int32
    _eq(tproto.decode_and_update(tkey, tstate, f_t, sub).w_shares, want[0])
    _eq(tproto.decode_and_update(tkey, tstate, f_t, subset_idx=tidx[0],
                                 dvec=tdv[0]).w_shares, want[1])
    for mode in ("0", "1"):
        tproto.fused_mode = mode
        got = tproto.iteration(tkey, tstate, subset_idx=tidx[0], dvec=tdv[0],
                               adv=torch.from_numpy(adv))
        _eq(got.w_shares, want[2])


def _count_siloed(monkeypatch):
    calls = {"local_gradient": 0}
    real = protocol.Copml.local_gradient

    def spy(self, *a, **kw):
        calls["local_gradient"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(protocol.Copml, "local_gradient", spy)
    return calls


def test_fit_siloed_reproduces_goldens(monkeypatch):
    """REPRO_FUSED_STEP=0: the siloed schedule gives the fused schedule's
    (and the JAX package's) goldens."""
    monkeypatch.setenv("REPRO_FUSED_STEP", "0")
    calls = _count_siloed(monkeypatch)
    res = api.fit("smoke", "copml", "jit", key=0, iters=10, device="cpu")
    assert calls["local_gradient"] == 10
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert _sha(res.state.w_shares.numpy(), np.int32) == GOLDEN_SHARES_SHA
    assert _sha(res.history, np.float32) == GOLDEN_HIST_SHA
    assert res.availability is None


@pytest.mark.parametrize("mode", ["0", "1"])
def test_faulty_fit_matches_jax_pins_on_both_schedules(monkeypatch, mode):
    """The plan's stragglers, dropout and adversary give the JAX package's
    shas, and the same opened model and history as the fault-free run."""
    monkeypatch.setenv("REPRO_FUSED_STEP", mode)
    calls = _count_siloed(monkeypatch)
    plan = _fault_plan()
    res = api.fit("smoke_straggler", "copml", "eager", key=0, iters=6,
                  faults=plan, device="cpu")
    assert calls["local_gradient"] == (6 if mode == "0" else 0)
    assert _sha(res.state.w_shares.numpy(), np.int32) == FAULTY_SHARES_SHA
    assert _sha(res.history, np.float32) == FAULTY_HIST_SHA
    np.testing.assert_array_equal(res.availability, plan.available)
    assert "churn: min 10/13 clients available" in res.summary()
    free = api.fit("smoke_straggler", "copml", "jit", key=0, iters=6,
                   subset="all", device="cpu")
    _eq(res.weights, free.weights)
    _eq(res.history, free.history)


def test_driver_cache_follows_the_schedule_env(monkeypatch):
    """The driver cache is keyed on REPRO_FUSED_STEP too: flipping it after
    a workload's first fit selects the other schedule."""
    from repro_torch.api import protocols as tprotocols
    wl, cpu = api.get_workload("smoke"), torch.device("cpu")
    monkeypatch.setenv("REPRO_FUSED_STEP", "1")
    fused = tprotocols.driver(wl, cpu)
    monkeypatch.setenv("REPRO_FUSED_STEP", "0")
    siloed = tprotocols.driver(wl, cpu)
    assert (fused.fused_mode, siloed.fused_mode) == ("1", "0")
    assert tprotocols.driver(wl, cpu) is siloed
    monkeypatch.setenv("REPRO_FUSED_STEP", "2")
    with pytest.raises(ValueError, match="REPRO_FUSED_STEP"):
        tprotocols.driver(wl, cpu)
