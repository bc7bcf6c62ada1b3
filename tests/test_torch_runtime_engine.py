"""The port's proc:N engine on the CPU: real OS processes and sockets,
bit-exact COPML, measured communication.

proc:4 on smoke must land on the smoke goldens (the constants of
tests/test_torch_protocol.py, the JAX package's pinned jit outputs: a JAX
proc run is not the reference, since the installed jax defaults to the
partitionable threefry stream), with exactly the frames the static
choreography (cost_model.proc_net_frames) budgets and each worker's
GEMMs exactly those worker.step_gemms lists; a slow link makes a
straggler whose absence the survivors decode around to the same bits.
"""

import collections

import numpy as np
import pytest

from repro.api import engine as jengine
from repro_torch import api
from repro_torch.core import cost_model
from repro_torch.launch.runtime import worker

from test_torch_protocol import (GOLDEN_HIST_SHA, GOLDEN_SHARES_SHA,
                                 GOLDEN_W, _sha)

MEASURED_PHASES = {"setup", "encode", "exchange", "trunc_open", "open_model"}


def _worker_gemms(rec) -> collections.Counter:
    return collections.Counter({tuple(g[:5]): g[5] for g in rec["gemms"]})


def _assert_worker_gemms(res, wl):
    """Every rank made the GEMMs step_gemms lists, `iters` times each."""
    mc = res.measured_comm
    step = worker.step_gemms(wl.n_clients, wl.cfg.k, wl.cfg.t,
                             wl.d * wl.objective.n_outputs, mc["procs"],
                             wl.cfg.recovery_threshold)
    want = collections.Counter({k: v * mc["iters"] for k, v in step.items()})
    for rec in mc["workers"]:
        assert _worker_gemms(rec) == want


def test_proc_engine_reproduces_the_smoke_goldens():
    """api.fit over proc:4 -- 4 worker subprocesses, real sockets -- lands
    on the pinned bits, with measured (not modeled) communication."""
    res = api.fit("smoke", "copml", "proc:4", key=0, iters=10, history=True,
                  device="cpu")
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert _sha(res.state.w_shares.numpy(), np.int32) == GOLDEN_SHARES_SHA
    assert _sha(res.history, np.float32) == GOLDEN_HIST_SHA
    assert res.engine == "proc:4" and res.device == "cpu"
    assert res.state.step == 10

    mc = res.measured_comm
    assert mc["procs"] == 4 and mc["iters"] == 10
    assert mc["engine"] == "proc:4"
    assert set(mc["bytes_by_phase"]) == MEASURED_PHASES
    assert all(v > 0 for v in mc["bytes_by_phase"].values())
    assert mc["total_bytes"] == sum(mc["bytes_by_phase"].values())
    assert MEASURED_PHASES - {"setup"} <= set(mc["seconds_by_phase"])
    assert mc["wall_s"] > mc["setup_wall_s"] > 0
    assert mc["degraded_steps"] == 0          # loopback, no injected delay
    assert mc["frames_by_phase"] == cost_model.proc_net_frames(
        4, 10, history=True)
    assert mc["dropped_frames"] == {}
    assert "measured" in res.summary()
    assert set(res.timings) == {"setup_s", "iters_s"}
    # every worker ran on the run's device and made the listed GEMMs; on
    # the CPU no kernel is launched, so every launch count is 0
    assert [w["device"] for w in mc["workers"]] == ["cpu"] * 4
    for rec in mc["workers"]:
        assert not any(rec["launches"].values())
        assert not any(rec["gemm_paths"].values())
    _assert_worker_gemms(res, api.get_workload("smoke"))


def test_proc_straggler_emerges_and_stays_bit_exact():
    """A slow link (not a FaultPlan) makes rank 3 miss the decode
    deadline; the survivors' R-subset decode matches the fault-free jit
    model bit for bit, and every frame was still sent."""
    ref = api.fit("smoke_straggler", "copml", "jit", key=0, subset="all",
                  history=False, device="cpu")
    net_cfg = api.NetConfig(links=((3, None, 0.35),), decode_timeout_s=0.05)
    res = api.fit("smoke_straggler", "copml",
                  api.EngineSpec("proc", devices=4, net=net_cfg),
                  key=0, subset="all", history=False, device="cpu")
    mc = res.measured_comm
    assert mc["degraded_steps"] >= 1
    assert mc["frames_by_phase"] == cost_model.proc_net_frames(
        mc["procs"], mc["iters"], history=False)
    assert sum(mc["dropped_frames"].values()) >= 1
    np.testing.assert_array_equal(res.weights, ref.weights)
    np.testing.assert_array_equal(res.state.w_shares.numpy(),
                                  ref.state.w_shares.numpy())
    assert res.history is None and "degraded steps" in res.summary()


@pytest.mark.slow
def test_proc_multiclass_bit_exact_vs_jit():
    """The (d, C) matrix-model path over 4 processes (the last rank owns 1
    client and 3 zero-padded rows)."""
    ref = api.fit("mnist10_like", "copml", "jit", key=0, iters=3,
                  history=False, device="cpu")
    res = api.fit("mnist10_like", "copml", "proc:4", key=0, iters=3,
                  history=False, device="cpu")
    np.testing.assert_array_equal(res.weights, ref.weights)
    np.testing.assert_array_equal(res.state.w_shares.numpy(),
                                  ref.state.w_shares.numpy())
    _assert_worker_gemms(res, api.get_workload("mnist10_like"))


def test_proc_rejects_fault_plans():
    """The proc engine has no replay: stragglers come from the network."""
    plan = api.FaultPlan.random(13, 4, seed=0, straggle_p=0.1,
                                min_available=10)
    with pytest.raises(ValueError, match="no FaultPlan replay"):
        api.fit("smoke_straggler", "copml", "proc:4", key=0, faults=plan,
                device="cpu")


def test_proc_spec_parsing_and_validation():
    assert api.parse_engine("proc").kind == "proc"
    assert api.parse_engine("proc").label == "proc"
    sp = api.parse_engine("proc:6")
    assert (sp.kind, sp.devices, sp.label) == ("proc", 6, "proc:6")
    assert "proc" in api.ENGINES and "proc" in api.engine_names()
    assert api.ENGINES == jengine.ENGINES
    api.EngineSpec("proc", net=api.NetConfig(latency_s=0.1))   # valid
    with pytest.raises(ValueError, match="takes no net"):
        api.EngineSpec("jit", net=api.NetConfig())
    with pytest.raises(ValueError, match="takes no mesh"):
        api.EngineSpec("proc", mesh=object())
    with pytest.raises(ValueError, match="devices must be"):
        api.parse_engine("proc:0")


def test_run_copml_engine_dispatches_eager_and_jit():
    """The one dispatch from a spec to a Copml engine: eager and jit run
    Copml.train; proc and sharded are refused."""
    wl = api.get_workload("smoke")
    proto = api.protocols.driver(wl, "cpu")
    cx, cy = wl.client_data()
    for spec in ("eager", api.JIT):
        state, w, hist = api.run_copml_engine(proto, spec, 0, cx, cy, 10,
                                              history=True)
        np.testing.assert_array_equal(np.asarray(w, np.float64),
                                      np.asarray(GOLDEN_W))
        assert _sha(hist.numpy(), np.float32) == GOLDEN_HIST_SHA
    with pytest.raises(ValueError, match="Queue A item 3"):
        api.run_copml_engine(proto, "sharded:2", 0, cx, cy, 1)
    with pytest.raises(ValueError, match="run_copml_proc"):
        api.run_copml_engine(proto, "proc:4", 0, cx, cy, 1)
