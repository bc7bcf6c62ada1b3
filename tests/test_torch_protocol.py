"""repro_torch COPML protocol and api.fit vs the JAX package, on the CPU.

Setup and one fused iteration are compared live against the JAX package's
Copml on the same key (legacy threefry layout).  Whole fits are compared
against sha256 pins of the JAX package's api.fit(..., "copml", "jit",
key=0) outputs: the smoke goldens of tests/test_api.py, and the shares /
history shas below, produced by the JAX package under
`jax.threefry_partitionable(False)` (chip_smoke.py pins the same values).
"""

import contextlib
import hashlib

import jax
import numpy as np
import pytest
import torch

from repro.api import workloads as jworkloads
from repro.core import lagrange as jlagrange
from repro.core.protocol import Copml as JCopml
from repro_torch import api
from repro_torch.api import workloads
from repro_torch.core import lagrange, meshutil, protocol, quantize
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


def test_setup_encodes_with_the_drivers_matrix(monkeypatch):
    """Set-up's LCC encode takes Copml._enc, built once, for each of the
    T+1 holders; its state equals a set-up that rebuilds the encode matrix
    for every holder (the JAX package's Python-int matrix), bit for bit."""
    wl = workloads.get("cifar10_like")               # K = 3, T = 2, N = 15
    cx, cy = wl.client_data()
    proto = protocol.Copml(wl.cfg, wl.m, wl.d, objective=wl.objective,
                           device="cpu")
    key = jrandom.PRNGKey(4)
    real, mats = lagrange._lcc_encode_with, []

    def spy(e, blocks, masks):
        mats.append(e)
        return real(e, blocks, masks)

    def rebuild(e, blocks, masks):
        mats.append(e)
        return real(torch.from_numpy(np.asarray(jlagrange.encode_matrix(
            proto.alphas, proto.betas))), blocks, masks)

    monkeypatch.setattr(lagrange, "_lcc_encode_with", spy)
    got = proto.setup(key, cx, cy)
    assert len(mats) == wl.cfg.t + 1
    assert all(m is proto._enc for m in mats)
    monkeypatch.setattr(lagrange, "_lcc_encode_with", rebuild)
    want = proto.setup(key, cx, cy)
    assert len(mats) == 2 * (wl.cfg.t + 1)
    _eq(got.coded_x, want.coded_x)
    _eq(got.w_shares, want.w_shares)
    _eq(got.xty_shares, want.xty_shares)


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


@contextlib.contextmanager
def row_copies():
    """Spies on set-up's rows while open: the source device of every
    Tensor.copy_ (set-up's one copy a client into its buffer) under
    "copies", and under "joined" the np.concatenate calls given 2-D
    arrays (a host array of all the rows)."""
    seen = {"copies": [], "joined": 0}
    copy_, concatenate = torch.Tensor.copy_, np.concatenate

    def spy_copy(dst, src, *a, **kw):
        seen["copies"].append(src.device.type)
        return copy_(dst, src, *a, **kw)

    def spy_concatenate(arrays, *a, **kw):
        arrays = list(arrays)
        seen["joined"] += any(np.ndim(x) == 2 for x in arrays)
        return concatenate(arrays, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "copy_", spy_copy)
        mp.setattr(np, "concatenate", spy_concatenate)
        yield seen


@pytest.mark.parametrize("kind", ["split", "empty", "float64", "int8",
                                  "mixed", "tensor"])
def test_setup_rows_equal_the_concatenated_rows(monkeypatch, kind):
    """setup.rows stages each client's rows straight into one buffer: its
    field elements equal those of the clients' rows concatenated on the
    host and quantized, and so does the whole CopmlState, with one copy
    from each non-empty client and no host array of all the rows."""
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
    with row_copies() as seen:
        xq, yq = proto.quantize_rows(cx, cy)
    assert seen["copies"] == ["cpu"] * sum(len(x) > 0 for x in cx)
    assert seen["joined"] == 0
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


# --------------------------- the JAX package's siloed Phases 3+4, and faults

# smoke_straggler (N=13, K=3, T=1, R=10) under tests/test_faults.py's plan:
# stragglers, a dropout and an adversary, min availability exactly R.
# The shas are the JAX package's run_copml_engine(..., "jit", PRNGKey(0),
# iters=6) with that plan, the same on both of its schedules (REPRO_FUSED_STEP
# "0" and "1").
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
    """(JAX Copml, port Copml, JAX state, port state, coded model) over
    field-valued arrays of `name`'s shapes."""
    from repro.core.protocol import CopmlState as JState
    import jax.numpy as jnp
    wl = jworkloads.get(name)
    jproto = JCopml(wl.cfg, wl.m, wl.d, objective=wl.objective)
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


DECODE_FORMS = ("static", "plan", "adversary")


@pytest.fixture(scope="module")
def siloed_jax_steps():
    """The JAX package's siloed step on a carried smoke state, in one
    jitted program: decode_and_update applied to local_gradient of the
    encoded model, decoding from the LAST R clients as a static subset, as
    a plan's (subset_idx, dvec), and so with client 0 adversarial."""
    import jax.numpy as jnp
    from repro.core import field as jfield
    from repro.core.protocol import ADV_OFFSET
    jproto, tproto, jstate, tstate, _ = _carried_state("smoke", 2)
    n, rthr = jproto.cfg.n_clients, jproto.cfg.recovery_threshold
    sub = tuple(range(n - rthr, n))
    subsets = [sub, tuple(range(rthr))]
    adv = np.zeros(n, bool)
    adv[0] = True
    jidx, jdv = jproto.plan_constants(subsets)

    def siloed(key, st):
        k1_, k2_ = jax.random.split(key)
        f = jproto.local_gradient(st.coded_x,
                                  jproto.encode_model(k1_, st.w_shares))
        bad = jnp.where(jnp.asarray(adv)[:, None],
                        jfield.add(f, jnp.asarray(ADV_OFFSET, f.dtype)), f)
        plan = dict(subset_idx=jidx[0], dvec=jdv[0])
        return (jproto.decode_and_update(k2_, st, f, sub).w_shares,
                jproto.decode_and_update(k2_, st, f, **plan).w_shares,
                jproto.decode_and_update(k2_, st, bad, **plan).w_shares)

    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(5)
        want = jax.jit(siloed)(key, jstate)
    return dict(want=dict(zip(DECODE_FORMS, want)), key=key, sub=sub,
                subsets=subsets, adv=adv, jidx=jidx, jdv=jdv, tproto=tproto,
                tstate=tstate)


@pytest.mark.parametrize("form", DECODE_FORMS)
def test_decode_and_update_matches_jax(siloed_jax_steps, form):
    """The port's fused iteration from a static decode subset, from a
    plan's (subset_idx, dvec), and so with an adversary, is bit-equal to
    the JAX package's siloed step on the same state and key."""
    case = siloed_jax_steps
    tproto, tstate = case["tproto"], case["tstate"]
    tkey = jrandom.as_key(np.asarray(case["key"]))
    if form == "static":
        got = tproto.iteration(tkey, tstate, case["sub"])
    else:
        tidx, tdv = tproto.plan_constants(case["subsets"])
        _eq(tidx, case["jidx"])
        _eq(tdv, case["jdv"])
        assert tidx.dtype == torch.int64 and tdv.dtype == torch.int32
        adv = torch.from_numpy(case["adv"]) if form == "adversary" else None
        got = tproto.iteration(tkey, tstate, subset_idx=tidx[0], dvec=tdv[0],
                               adv=adv)
    _eq(got.w_shares, case["want"][form])
    assert got.step == tstate.step + 1


def _count_siloed(monkeypatch):
    calls = {"local_gradient": 0}
    real = protocol.Copml.local_gradient

    def spy(self, *a, **kw):
        calls["local_gradient"] += 1
        return real(self, *a, **kw)

    monkeypatch.setattr(protocol.Copml, "local_gradient", spy)
    return calls


@pytest.mark.parametrize("env", [None, "0", "1", "kernel", "2"])
def test_fit_ignores_the_fused_step_env(monkeypatch, env):
    """REPRO_FUSED_STEP is the JAX package's knob: under any value of it,
    or none, the port's smoke fit gives the goldens through the one driver
    cached for (workload, device), and never runs the siloed Phase 3 in
    process."""
    from repro_torch.api import protocols as tprotocols
    wl, cpu = api.get_workload("smoke"), torch.device("cpu")
    monkeypatch.delenv("REPRO_FUSED_STEP", raising=False)
    drv = tprotocols.driver(wl, cpu)
    if env is not None:
        monkeypatch.setenv("REPRO_FUSED_STEP", env)
    calls = _count_siloed(monkeypatch)
    res = api.fit("smoke", "copml", "jit", key=0, iters=10, device="cpu")
    assert calls["local_gradient"] == 0
    assert tprotocols.driver(wl, cpu) is drv
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert _sha(res.state.w_shares.numpy(), np.int32) == GOLDEN_SHARES_SHA
    assert _sha(res.history, np.float32) == GOLDEN_HIST_SHA
    assert res.availability is None


def test_faulty_fit_matches_jax_pins(monkeypatch):
    """The plan's stragglers, dropout and adversary give the JAX package's
    shas, and the same opened model and history as the fault-free run."""
    calls = _count_siloed(monkeypatch)
    plan = _fault_plan()
    res = api.fit("smoke_straggler", "copml", "eager", key=0, iters=6,
                  faults=plan, device="cpu")
    assert calls["local_gradient"] == 0
    assert _sha(res.state.w_shares.numpy(), np.int32) == FAULTY_SHARES_SHA
    assert _sha(res.history, np.float32) == FAULTY_HIST_SHA
    np.testing.assert_array_equal(res.availability, plan.available)
    assert "churn: min 10/13 clients available" in res.summary()
    free = api.fit("smoke_straggler", "copml", "jit", key=0, iters=6,
                   subset="all", device="cpu")
    _eq(res.weights, free.weights)
    _eq(res.history, free.history)
