"""The port's sharded engine on the CPU: gloo rank processes, bit-exact
COPML and serving.

`api.fit(wl, "copml", "sharded:D", device="cpu")` splits the client axis
over D rank processes (core/meshutil.ClientMesh) whose EXCHANGE and OPEN
steps are real torch.distributed collectives.  Each case of the JAX
package's distributed parity script (tests/test_distributed.py) must give
the JAX package's jit bits -- weights, model shares and history -- on both
REPRO_SHARDED_OVERLAP settings; the collectives are held to their
definitions (the JAX package's psum_scatter / all_to_all layouts) on
field values near p, and a rank that raises makes the caller raise.

The rank-side helpers below are module-level so the ranks can import them
by name; this module imports JAX only inside the reference fixtures, so a
rank process never does.
"""

import os
import time

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import field, meshutil, objectives
from repro_torch.core import random as jrandom
from repro_torch.core.protocol import (CopmlConfig, _pad_clients,
                                       case1_params, case2_params)
from repro_torch.serve import coded

KEY = 5
ITERS = 3


@pytest.fixture(scope="module", autouse=True)
def meshes():
    """One 4-rank and one 2-rank gloo mesh, reused by every case (fit's
    "sharded:D" finds them in client_mesh's cache); closed afterwards."""
    got = {d: meshutil.client_mesh(d, "cpu") for d in (4, 2)}
    yield got
    meshutil.close_meshes()


@pytest.fixture
def overlap(request, monkeypatch):
    monkeypatch.setenv("REPRO_SHARDED_OVERLAP", request.param)
    return request.param


def _faults(mod):
    return mod.FaultPlan.random(13, ITERS, seed=2, straggle_p=0.3,
                                n_adversaries=1, min_available=10)


#: the cases of tests/test_distributed.py's _SUBPROC: (N, K, T, subset,
#: history, objective name, fault plan)
CASES = {
    "n13_ragged_history": (13, *case1_params(13), None, True, None, False),
    "case2_n16": (16, *case2_params(16), None, False, None, False),
    "subset_last_r": (13, 3, 1, tuple(range(3, 13)), False, None, False),
    "ovr3_history": (13, 3, 1, None, True, "ovr3", False),
    "faultplan_adversary": (13, 3, 1, None, True, None, True),
}


def _workload(mod, name):
    """Case `name` as a Workload of `mod` (the port's api or the JAX
    package's)."""
    n, k, t, _, _, obj, _ = CASES[name]
    if mod is api:
        objs, config = objectives, CopmlConfig
    else:
        from repro.core import objectives as objs
        from repro.core.protocol import CopmlConfig as config
    kw = {} if obj is None else dict(objective=objs.multiclass_logistic(3))
    return mod.Workload(name=f"sharded_{name}", m=78, d=6, seed=3,
                        cfg=config(n_clients=n, k=k, t=t, eta=1.0),
                        iters=ITERS, **kw)


def _fit(mod, name, engine, **kw):
    _, _, _, subset, history, _, faulty = CASES[name]
    if faulty:
        kw["faults"] = _faults(mod)
    return mod.fit(_workload(mod, name), "copml", engine, key=KEY,
                   iters=ITERS, subset=subset, history=history, **kw)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's jit fit of each case (legacy threefry stream),
    computed once per case."""
    import jax
    from repro import api as japi
    cache = {}

    def get(name):
        if name not in cache:
            with jax.threefry_partitionable(False):
                res = _fit(japi, name, "jit")
                cache[name] = (np.asarray(res.weights),
                               np.asarray(res.state.w_shares),
                               None if res.history is None
                               else np.asarray(res.history))
        return cache[name]

    return get


def _assert_matches(res, ref, name):
    w, shares, hist = ref
    np.testing.assert_array_equal(res.weights, w)
    np.testing.assert_array_equal(res.state.w_shares.numpy(), shares)
    if CASES[name][4]:
        np.testing.assert_array_equal(res.history, hist)
    else:
        assert res.history is None
    assert res.state.step == ITERS


@pytest.mark.parametrize("overlap", ["0", "1"], indirect=True)
@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded4_equals_jax_jit(name, overlap, jax_refs):
    res = _fit(api, name, "sharded:4", device="cpu")
    assert res.engine == "sharded:4"
    _assert_matches(res, jax_refs(name), name)
    if CASES[name][6]:
        np.testing.assert_array_equal(res.availability,
                                      _faults(api).available)
        assert _faults(api).has_adversaries
    ranks = res.timings["ranks"]
    assert [r["device"] for r in ranks] == ["cpu"] * 4
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert res.timings["setup_s"] > 0 and res.timings["iters_s"] > 0
    kinds = {"1": {"ring_reduce_scatter", "ring_all_to_all", "all_gather"},
             "0": {"reduce_scatter", "all_to_all", "all_gather"}}[overlap]
    for r in ranks:
        assert set(r["sent_bytes"]) == kinds
        assert all(v > 0 for v in r["sent_bytes"].values())
        assert not any(r["threefry"].values())      # CPU draws launch none


@pytest.mark.parametrize("overlap", ["0", "1"], indirect=True)
@pytest.mark.parametrize("name", ["n13_ragged_history",
                                  "faultplan_adversary"])
def test_sharded2_equals_jax_jit(name, overlap, jax_refs):
    res = _fit(api, name, api.EngineSpec("sharded", devices=2),
               device="cpu")
    assert res.engine == "sharded:2"
    _assert_matches(res, jax_refs(name), name)


def test_sharded1_lands_on_the_smoke_golden():
    from test_torch_protocol import (GOLDEN_HIST_SHA, GOLDEN_SHARES_SHA,
                                     GOLDEN_W, _sha)
    res = api.fit("smoke", "copml", "sharded:1", key=0, iters=10,
                  device="cpu")
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert _sha(res.state.w_shares.numpy(), np.int32) == GOLDEN_SHARES_SHA
    assert _sha(res.history, np.float32) == GOLDEN_HIST_SHA
    assert res.engine == "sharded:1"
    meshutil.client_mesh(1, "cpu").close()


def test_mesh_spec_and_sharded_step(meshes):
    """A ClientMesh parses as "sharded" over it; sharded_step runs one
    iteration over padded arrays with the fit's bits."""
    mesh = meshes[4]
    spec = api.parse_engine(mesh)
    assert (spec.kind, spec.label, spec.resolve_mesh() is mesh) == \
        ("sharded", "sharded:4", True)
    assert api.EngineSpec("sharded", devices=4).resolve_mesh("cpu") is mesh
    assert (mesh.backend, mesh.devices) == ("gloo",
                                            [torch.device("cpu")] * 4)
    wl = api.get_workload("smoke")
    res = api.fit(wl, "copml", mesh, key=1, iters=1, history=False,
                  device="cpu")
    proto = api.protocols.driver(wl, "cpu")
    state = api.fit(wl, "copml", "jit", key=1, iters=0, history=False,
                    device="cpu").state
    fn, n_pad = proto.sharded_step(mesh)
    assert n_pad == 16
    _, ki = jrandom.split(jrandom.PRNGKey(1))
    w = fn(*(_pad_clients(x, n_pad) for x in (
        state.w_shares, state.coded_x, state.xty_shares)), ki)
    assert w.shape == (16, wl.d)
    np.testing.assert_array_equal(w[:13].numpy(),
                                  res.state.w_shares.numpy())


def test_sharded_serving_equals_reference(meshes):
    """Every window of a sharded:4 / sharded:2 server equals
    reference_scores of the opened model (and the jit server's)."""
    res = api.fit("mnist10_like", "copml", "jit", iters=2, history=False,
                  device="cpu")
    x, _ = api.get_workload("mnist10_like").eval_set()
    x = np.asarray(x[:37], np.float32)
    want = coded.reference_scores(res.weights, x,
                                  api.get_workload("mnist10_like").cfg)
    for engine in ("sharded:4", "sharded:2"):
        srv = api.serve("mnist10_like", res, engine, batch_size=16,
                        device="cpu")
        assert (srv.engine, srv.kind) == (engine, "sharded")
        np.testing.assert_array_equal(srv.score_field(x), want.numpy())
        preds, stats = srv.serve(x)
        assert stats["batches"] == 3 and len(preds) == 37


# ------------------------------------------------ collectives on the ranks


def _near_p(rng, shape):
    """Canonical field values, most of them within 2^20 of p."""
    v = field.P - 1 - rng.integers(0, 1 << 20, shape)
    v[..., ::3] = rng.integers(0, field.P, v[..., ::3].shape)
    return torch.from_numpy(v.astype(np.int32))


def _rank_reduce_scatter(rank, xs, nshards):
    return meshutil.psum_scatter_mod(xs[rank.rank], rank, nshards)


def _rank_rings(rank, xs, blocks):
    x = xs[rank.rank]
    n_loc = x.shape[0] // rank.size
    ring = meshutil.ring_reduce_scatter_mod(
        lambda j: x[j * n_loc:(j + 1) * n_loc], rank)
    mono = meshutil.psum_scatter_mod(x, rank)
    b = blocks[rank.rank]
    stacked = meshutil.ring_all_to_all(
        lambda j: b[j * n_loc:(j + 1) * n_loc], rank)
    got = stacked.transpose(0, 1).reshape(n_loc, rank.size * b.shape[1],
                                          *b.shape[2:])
    return ring, mono, got, meshutil.all_to_all_clients(b, rank)


def _rank_all_to_all(rank, xs):
    return meshutil.all_to_all_clients(xs[rank.rank], rank)


def _rank_all_gather(rank, xs):
    return meshutil.all_gather_clients(xs[rank.rank], rank)


@pytest.mark.parametrize("nshards", [None, meshutil.NARROW_SHARDS + 1],
                         ids=["narrow", "wide"])
def test_reduce_scatter_mod_is_the_field_sum(meshes, nshards):
    rng = np.random.default_rng(0)
    xs = _near_p(rng, (4, 8, 5))
    out = meshes[4].run(_rank_reduce_scatter, xs, nshards)
    want = xs.to(torch.int64).sum(0) % field.P
    np.testing.assert_array_equal(torch.cat(out).numpy(), want.numpy())


def test_all_to_all_has_the_jax_layout(meshes):
    """split_axis=0, concat_axis=1, tiled: rank r's output[h, s*n_loc+o]
    is rank s's input[r*n_loc+h, o]."""
    rng = np.random.default_rng(1)
    d, n_loc = 4, 3
    xs = _near_p(rng, (d, d * n_loc, n_loc, 2))
    out = meshes[4].run(_rank_all_to_all, xs)
    for r in range(d):
        want = np.concatenate([xs[s, r * n_loc:(r + 1) * n_loc].numpy()
                               for s in range(d)], axis=1)
        np.testing.assert_array_equal(out[r].numpy(), want)
    gathered = meshes[4].run(_rank_all_gather, xs)
    for g in gathered:
        np.testing.assert_array_equal(g.numpy(),
                                      xs.reshape(-1, n_loc, 2).numpy())


def test_rings_equal_the_monolithic_collectives(meshes):
    rng = np.random.default_rng(2)
    d, n_loc = 4, 2
    xs = _near_p(rng, (d, d * n_loc, 7))
    blocks = _near_p(rng, (d, d * n_loc, n_loc, 3))
    for ring, mono, got, want in meshes[4].run(_rank_rings, xs, blocks):
        np.testing.assert_array_equal(ring.numpy(), mono.numpy())
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# ------------------------------------------------- failure and devices


def _rank_raises_on_1(rank, x):
    if rank.rank == 1:
        raise ValueError("rank one refuses")
    return meshutil.all_gather_clients(x, rank)     # blocks on rank 1


def test_a_rank_that_raises_fails_the_call_in_time():
    mesh = meshutil.ClientMesh(2, "cpu", timeout_s=60)
    t0 = time.monotonic()
    with pytest.raises(meshutil.RankFailure,
                       match="(?s)rank 1.*rank one refuses") as err:
        mesh.run(_rank_raises_on_1, torch.zeros(2, dtype=torch.int32))
    assert err.value.rank == 1
    assert time.monotonic() - t0 < 30
    assert mesh.closed
    assert not any(p.is_alive() for p in mesh._procs)
    with pytest.raises(RuntimeError, match="closed"):
        mesh.run(_rank_all_gather, torch.zeros((2, 1), dtype=torch.int32))


def test_a_rank_without_its_card_raises():
    dev = torch.device("cuda", torch.cuda.device_count())
    with pytest.raises(meshutil.RankFailure, match="sees .* CUDA device"):
        meshutil.ClientMesh(2, dev, backend="gloo", timeout_s=60)


def test_backend_rule():
    from repro.core import meshutil as jmeshutil
    assert (meshutil.CLIENT_AXIS, meshutil.NARROW_SHARDS) == \
        (jmeshutil.CLIENT_AXIS, jmeshutil.NARROW_SHARDS)
    cards = torch.cuda.device_count()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert meshutil.choose_backend(4, cpu) == "gloo"
    assert meshutil.choose_backend(cards + 1, cuda) == "gloo"
    with pytest.raises(ValueError, match="NCCL refuses"):
        meshutil.choose_backend(cards + 1, cuda, "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        meshutil.choose_backend(1, cpu, "mpi")
    assert meshutil.rank_devices(3, cuda, "gloo") == \
        [torch.device("cuda", 0)] * 3
    assert meshutil.rank_devices(2, cuda, "nccl") == \
        [torch.device("cuda", 0), torch.device("cuda", 1)]


def _rank_modules(rank):
    import sys
    return sorted(m for m in ("jax", "repro") if m in sys.modules), \
        torch.get_num_threads(), os.getpid()


def test_ranks_import_no_jax_and_run_one_thread(meshes):
    out = meshes[2].run(_rank_modules)
    assert [o[:2] for o in out] == [([], 1)] * 2
    assert len({o[2] for o in out} | {os.getpid()}) == 3
