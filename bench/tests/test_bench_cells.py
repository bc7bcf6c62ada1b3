"""The cells past the paper's two shapes, on the CPU: DOROTHEA's
configuration and the straggler mix load by name, the straggler plans
repeat by seed and job, a tiny straggler cell runs correct, and the two
readers of the program's counts and fault-plan span read synthetic job
records (None where a record lacks them)."""

import json
import types

import pytest
import torch

import run as bench_run
from conftest import ROOT
from drivers import train_stragglers
from yardstick import data, registry

NEW_CELLS = ("dorothea_case2.train", "cifar10_case2.stragglers")


def test_new_cells_load_by_name():
    spec = registry.load_spec(ROOT / "BENCHMARK.json")
    cifar = registry.config("cifar10_case2")
    cfg = registry.config("dorothea_case2")
    assert set(cfg) == set(cifar)
    assert (cfg["m"], cfg["d"], cfg["n_clients"], cfg["k"], cfg["t"]) == \
        (800, 100_000, 50, 10, 7)
    assert {k: v for k, v in cfg.items() if k not in (
        "source", "name", "m", "d", "eta", "assumed")} == \
        {k: v for k, v in cifar.items() if k not in (
            "source", "name", "m", "d", "eta", "assumed")}
    mix = registry.traffic("stragglers")
    assert registry.driver(mix["driver"]).run is not None
    assert mix["stragglers_per_step"] == 1
    for name in NEW_CELLS:
        cell = registry.cell(spec, name)
        assert cell["chips"] == 1
        e2e = {m["name"] for m in
               registry.cell_metrics(spec, name, "end_to_end")}
        assert e2e == {"fit_s", "setup_s"}
        layer = {m["name"] for m in
                 registry.cell_metrics(spec, name, "per_layer")}
        assert "xtilde_reads_per_iter.train" in layer
        assert ("fault_plan_ms.train" in layer) == name.endswith("stragglers")


def test_straggler_plans_repeat_by_seed_and_job():
    seed = 2**31 + 28
    keys = [data.program_key(seed, j) for j in range(3)]
    plans = [train_stragglers.straggler_steps(seed, k, 50, 50, 1)
             for k in keys]
    assert plans[0] == train_stragglers.straggler_steps(seed, keys[0], 50,
                                                        50, 1)
    assert plans[0] != plans[1] != plans[2]
    for plan in plans:
        assert sorted(plan) == list(range(50))
        assert all(len(c) == 1 and 0 <= c[0] < 50 for c in plan.values())
    # about 32 distinct stragglers in 50 uniform draws from 50
    assert 20 <= len({c[0] for c in plans[0].values()}) <= 45
    two = train_stragglers.straggler_steps(seed, keys[0], 20, 4, 2)
    assert all(len(set(c)) == 2 for c in two.values())


def _ctx(jobs, iters=2):
    return types.SimpleNamespace(record=dict(jobs=jobs), cfg=dict(iters=iters))


def _job(traced=False, counts=None, faults_s=None):
    spans = {"setup.rows": [1, 0.01], "train.step": [2, 0.02]}
    if faults_s is not None:
        spans["setup.faults"] = [1, faults_s]
    timings = dict(setup_s=0.1, iters_s=0.2, spans=spans)
    if counts is not None:
        timings["counts"] = dict(
            dict.fromkeys(("fused_step", "coded_gradient_batched",
                           "coded_gradient_matrix", "coded_gradient",
                           "cluster", "gradient", "epilogue"), 0), **counts)
    return dict(traced=traced, timings=timings)


def test_xtilde_reads_per_iter():
    read = registry.metric_reader("xtilde_reads_per_iter.train")
    body = _job(counts=dict(fused_step=2))
    cluster = _job(counts=dict(cluster=2))
    wide = _job(counts=dict(gradient=2, epilogue=2))
    assert read(_ctx([body, cluster, _job(True, dict(gradient=9))])) == 1.0
    assert read(_ctx([wide])) == 2.0
    assert read(_ctx([cluster, wide])) == 1.5
    assert read(_ctx([_job(counts={})])) is None         # a CPU run
    assert read(_ctx([_job(), body])) is None            # no counts kept
    assert read(_ctx([])) is None


def test_fault_plan_ms():
    read = registry.metric_reader("fault_plan_ms.train")
    jobs = [_job(faults_s=0.010), _job(faults_s=0.030),
            _job(traced=True, faults_s=9.0)]
    assert read(_ctx(jobs)) == pytest.approx(20.0)
    assert read(_ctx([_job(), _job()])) is None           # fault-free
    assert read(_ctx([_job(faults_s=0.01), _job()])) is None
    assert read(_ctx([])) is None


def test_a_tiny_straggler_cell_is_correct(bench_copy):
    """N = 20, K = 4, T = 1 (R = 13): every job under a plan of its own,
    judged by the reference's step check."""
    root, spec = bench_copy
    cfg = json.loads((root / "configs" / "tiny.json").read_text())
    cfg["n_clients"] = 20
    (root / "configs" / "tiny20.json").write_text(json.dumps(cfg))
    spec["workloads"].append(
        {"name": "tiny20.stragglers", "config": "tiny20",
         "traffic": "stragglers", "chips": 1, "why": "CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tiny.train" in m.get("workloads", ()) \
                or m["name"] == "fault_plan_ms.train":
            m["workloads"].append("tiny20.stragglers")
    cell = registry.cell(spec, "tiny20.stragglers")
    h = bench_run.Harness(spec, cell, 2**31 + 29, 0.2, False,
                          torch.device("cpu"), root)
    record = h.driver.run(h)
    assert h.system.System.__name__ == "System"     # restored
    got = h.driver.judge(h, record)
    assert got["step_gap"] == 0
    ctx = bench_run.Context(h, record)
    assert registry.metric_reader("fault_plan_ms.train", root)(ctx) > 0
    # the CPU counts no kernel launch
    assert registry.metric_reader("xtilde_reads_per_iter.train",
                                  root)(ctx) is None
    for job in record["jobs"]:
        assert job["timings"]["spans"]["setup.faults"][0] == 1
    res = bench_run.run_cell(spec, "tiny20.stragglers", 2**31 + 30, 0.2,
                             False, torch.device("cpu"), root)
    assert res["correct"], res["limits"]
    assert set(res["metrics"]) == {"fit_s", "setup_s"}
