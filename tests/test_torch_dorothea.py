"""COPML at DOROTHEA's width, d = 100,000 (past the gradient body's
58,004), and a job's fault plan and gradient counts, on the CPU.

The cluster route's plan at 80 coded rows (N = 50, K = 10) and its numpy
model against the plain gradient; a small Copml past d = 58,004 held to
the benchmark's plain reference (`bench/reference/copml_logreg.py`, loaded
by path); a job under a per-step straggler plan against the fault-free
job of the same key; and `timings["counts"]`, one job's coded gradients
by route (and set-up's row copies, none on the CPU), with the process's
counters already holding other launches.
"""

import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import protocols
from repro_torch.api.faults import FaultPlan
from repro_torch.core import field, protocol
from repro_torch.kernels import coded_gradient as cg
from repro_torch.kernels import ops, plan, ref

P = field.P
D = 100_000                     # DOROTHEA's features
ROOT = Path(__file__).resolve().parents[1]


def _reference():
    path = ROOT / "bench" / "reference" / "copml_logreg.py"
    spec = importlib.util.spec_from_file_location("copml_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(seed, m, d):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.normal(0.0, 0.5, (m, d)), -1.0, 1.0).astype(np.float32)
    y = (rng.random(m) < 0.5).astype(np.float32)
    return x, y


def _split(x, y, n):
    idx = np.array_split(np.arange(x.shape[0]), n)
    return [x[i] for i in idx], [y[i] for i in idx]


@pytest.fixture
def counted(monkeypatch):
    """ops.fused_step counting each call under its route as the card's
    launchers do (the CPU's plain version counts nothing), over process
    counters that already hold other launches."""
    monkeypatch.setattr(ops, "LAUNCHES", collections.Counter(fused_step=7))
    monkeypatch.setattr(cg, "WIDE_LAUNCHES",
                        collections.Counter(cluster=5, gradient=2))
    real = ops.fused_step

    def fused_step(x, w, *args, **kw):
        route = plan.gradient_route(x.shape[-1], w.shape[-1])
        if route == "body":
            ops.LAUNCHES["fused_step"] += 1
        else:
            cg.WIDE_LAUNCHES["cluster" if route == "cluster"
                             else "gradient"] += 1
        return real(x, w, *args, **kw)

    monkeypatch.setattr(ops, "fused_step", fused_step)


def _counts(**kw) -> dict:
    out = dict.fromkeys(ops.GRADIENT_KERNELS + cg.WIDE_STEPS, 0)
    out.update(kw)
    return out


def test_dorothea_width_takes_the_cluster_route_in_smem_mode():
    """(80, 100,000): 16 CTAs a cluster, 6,252 columns a rank (more than
    the register partials hold), 2-row slices in 3 stages, inside the
    H100's 227 KB of shared memory a block."""
    assert plan.gradient_route(D, 1) == "cluster"
    pl = plan.cluster_plan(80, D)
    assert pl == dict(k=16, cw=6252, mode="smem", ept=0, bm=2, stages=3,
                      slot=plan.slot_bytes(6252), smem=225848)
    assert pl["smem"] + plan.GRAD_STATIC <= plan.SMEM_MAX


def test_cluster_model_matches_plain_at_dorothea_width():
    """The kernel's numpy model under that plan, three slices of rows,
    one client's rows and model at p - 1."""
    pl = plan.cluster_plan(80, D)
    rng = np.random.default_rng(28)
    n, m = 2, 5
    x = rng.integers(0, P, (n, m, D), dtype=np.int64)
    w = rng.integers(0, P, (n, D, 1), dtype=np.int64)
    co = rng.integers(0, P, 2, dtype=np.int64)
    x[0], w[0] = P - 1, P - 1
    f, _, _ = plan.cluster_model(x, w, co, pl)
    t = [torch.from_numpy(a.astype(np.int32)) for a in (x, w, co)]
    np.testing.assert_array_equal(f.astype(np.int64),
                                  ref.coded_gradient_matrix(*t).numpy())


def test_copml_past_58004_is_judged_by_the_reference(counted):
    """N = 13, Case 1, 16 rows at d = 100,000, three steps through the
    benchmark's dispatch (run_copml_engine on "jit"): every step within
    TruncPr's rounding of the reference's update, and the job's counts
    three cluster gradients, whatever the process counted before.  eta
    keeps gradient descent stable at d / m = 6,250 (a step's gain on
    X X^T ~ 0.23 d I is 3 / 2^12 x 0.0725 x 0.23 d = 1.2; at eta = 1 it
    is 100, and TruncPr's input leaves the field by the third step)."""
    n, m, iters = 13, 16, 3
    k, t = protocol.case1_params(n)
    cfg = protocol.CopmlConfig(n_clients=n, k=k, t=t, eta=0.01)
    proto = protocol.Copml(cfg, m, D, device="cpu")
    x, y = _rows(5, m, D)
    cx, cy = _split(x, y, n)
    timings = {}
    _, w, hist = protocols.run_copml_engine(proto, "jit", 11, cx, cy, iters,
                                            history=True, timings=timings)
    assert timings["counts"] == _counts(cluster=iters)
    assert ops.wide_counts()["cluster"] == 5 + iters
    rmod = _reference()
    rcfg = dict(field_p=P, m=m, eta=cfg.eta, lx=cfg.lx, lw=cfg.lw, cb=cfg.cb,
                r=cfg.r, k2=cfg.k2, sigmoid_bound=cfg.sigmoid_bound,
                sigmoid_grid=2001)
    rf = rmod.Reference(rcfg, x, y, torch.device("cpu"))
    assert (rf.f.k1, rf.f.q_eta) == (proto.k1, proto.q_eta)
    got = rmod.judge_jobs(rf, [dict(hist=hist.numpy(), w=w.numpy())])
    assert got["step_gap"] == 0


def test_straggler_plan_opens_the_fault_free_models(counted):
    """N = 20, K = 4, T = 1 (R = 13): a straggler a step, three of them
    inside the fault-free decode subset, gives the fault-free job's opened
    models bit for bit; its spans hold `setup.faults` once and otherwise
    the fault-free job's paths, which hold none."""
    n, m, d, iters = 20, 40, 12, 4
    cfg = protocol.CopmlConfig(n_clients=n, k=4, t=1)
    proto = protocol.Copml(cfg, m, d, device="cpu")
    cx, cy = _split(*_rows(3, m, d), n)
    faults = FaultPlan.from_schedule(
        n, iters, stragglers={0: [0], 1: [12], 2: [19], 3: [5]})
    runs = []
    for step_subsets in (None, faults.subsets(cfg.recovery_threshold)):
        timings = {}
        _, w, hist = protocols.run_copml_engine(
            proto, "jit", 7, cx, cy, iters, history=True, timings=timings,
            step_subsets=step_subsets)
        runs.append((w, hist, timings))
    (w0, h0, free), (w1, h1, faulty) = runs
    assert torch.equal(w0, w1) and torch.equal(h0, h1)
    assert "setup.faults" not in free["spans"]
    assert faulty["spans"]["setup.faults"][0] == 1
    assert set(faulty["spans"]) - {"setup.faults"} == set(free["spans"])
    assert free["counts"] == faulty["counts"] == _counts(fused_step=iters)
