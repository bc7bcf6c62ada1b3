"""The ten-class cell on the CPU: its configuration, mix, system and
reference load by name and it reports the class-agnostic training metrics
and the two new rooflines; a tiny ten-class cell (mnist10_like's shape)
runs correct and its control does not; the two roofline readers read
synthetic traces (None where a range is missing)."""

import json
import types

import pytest
import torch

import control
import run as bench_run
from conftest import ROOT
from test_bench_harness import _Event
from yardstick import registry, roofline

CELL = "cifar10_ovr10_case2.train_ovr"
CPU = torch.device("cpu")
#: mnist10_like's shape: m = 390, d = 24, N = 13, Case 1
TINY_OVR = dict(m=390, d=24, n_clients=13, k=4, t=1, eta=1.0)
TRAIN = {"protocol_setup_ms.train", "iter_ms.train",
         "launches_per_iter.train", "idle_share.train", "threefry_ms.train",
         "threefry_launches_per_iter.train", "setup_rows_ms.train",
         "xtilde_reads_per_iter.train"}


def test_the_ten_class_cell_loads_by_name():
    spec = registry.load_spec(ROOT / "BENCHMARK.json")
    cifar = registry.config("cifar10_case2")
    cfg = registry.config("cifar10_ovr10_case2")
    assert set(cfg) == set(cifar) | {"n_classes", "reduced"}
    assert (cfg["m"], cfg["d"], cfg["n_classes"], cfg["n_clients"],
            cfg["k"], cfg["t"], cfg["reduced"]) == \
        (50_000, 3073, 10, 50, 10, 7, [])
    own = ("source", "name", "m", "eta", "k2", "objective", "system",
           "reference", "data", "guarantees", "assumed", "n_classes",
           "reduced")
    assert {k: v for k, v in cfg.items() if k not in own} == \
        {k: v for k, v in cifar.items() if k not in own}
    cell = registry.cell(spec, CELL)
    assert cell["chips"] == 1 and cell["config"] == "cifar10_ovr10_case2"
    mix = registry.traffic(cell["traffic"])
    assert registry.driver(mix["driver"]).run is not None
    assert (mix["warm_jobs"], mix["trace_jobs"]) == (1, 1)
    assert registry.system(cfg["system"]).System is not None
    ref = registry.reference(cfg["reference"])
    assert ref.LIMITS == {"step_gap": 0, "drift_z": 8.0}
    e2e = {m["name"] for m in registry.cell_metrics(spec, CELL,
                                                    "end_to_end")}
    assert e2e == {"fit_s", "setup_s"}
    layer = {m["name"] for m in registry.cell_metrics(spec, CELL,
                                                      "per_layer")}
    assert layer == TRAIN | {"class_gradient_roofline.train",
                             "xty_roofline.train"}
    for name in ("cifar10_case2.train", "gisette_case1.train",
                 "dorothea_case2.train", "cifar10_case2.stragglers"):
        assert "xty_roofline.train" in {
            m["name"] for m in registry.cell_metrics(spec, name,
                                                     "per_layer")}


@pytest.fixture
def tiny_ovr(bench_copy):
    """bench_copy with a ten-class configuration at mnist10_like's shape
    and its cell, in every list that names the ten-class cell."""
    root, spec = bench_copy
    cfg = json.loads((root / "configs" / "cifar10_ovr10_case2.json")
                     .read_text())
    cfg.update(TINY_OVR)
    (root / "configs" / "tiny_ovr.json").write_text(json.dumps(cfg))
    spec["workloads"].append(
        {"name": "tiny_ovr.train_ovr", "config": "tiny_ovr",
         "traffic": "train_ovr", "chips": 1, "why": "CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny_ovr.train_ovr")
    return root, spec


def test_a_tiny_ten_class_cell_is_correct(tiny_ovr):
    root, spec = tiny_ovr
    res = bench_run.run_cell(spec, "tiny_ovr.train_ovr", 2**31 + 33, 0.3,
                             False, CPU, root)
    assert res["correct"], res["limits"]
    assert res["limits"]["step_gap"]["value"] == 0
    assert set(res["metrics"]) == {"fit_s", "setup_s"}
    cell = registry.cell(spec, "tiny_ovr.train_ovr")
    h = bench_run.Harness(spec, cell, 2**31 + 34, 0.1, False, CPU, root)
    record = h.driver.run(h)
    assert record["y"].min() >= 0 and record["y"].max() < 10
    assert all(j["hist"].shape == (50, 24, 10)
               for j in record["jobs"])
    for job in record["jobs"]:
        assert job["timings"]["spans"]["setup.xty"][0] == 1


def test_the_tiny_ten_class_control_is_not_correct(tiny_ovr):
    root, spec = tiny_ovr
    rows = control.control_runs("tiny_ovr.train_ovr", [1, 2, 2**31 + 3],
                                0.3, CPU, spec, root)
    for row in rows:
        assert not row["correct"], row


def _ctx(cfg, events):
    from yardstick import trace
    tr = trace.DeviceTrace()
    tr.ingest(events)
    return types.SimpleNamespace(trace=tr, roofline=roofline, cfg=cfg)


def _range(name):
    """One range `name` over [100, 400) ns with a kernel of 100 ns launched
    inside it, and one launched outside."""
    return [_Event("bench.window", 0, 1000, False, mark=True),
            _Event(name, 100, 300, False, mark=True),
            _Event("cudaLaunchKernel", 150, 10, False, corr=7),
            _Event("cudaLaunchKernel", 600, 10, False, corr=8),
            _Event("k1", 200, 100, True, corr=7),
            _Event("k2", 700, 100, True, corr=8)]


def test_class_gradient_roofline_takes_the_configurations_classes():
    read = registry.metric_reader("class_gradient_roofline.train")
    cfg = registry.config("cifar10_ovr10_case2")
    ctx = _ctx(cfg, _range("kernels.fused_step"))
    least, kind = roofline.bound_s(*roofline.fused_work(50, 5000, 3073, 10,
                                                        1))
    assert kind == "operations"
    assert read(ctx) == pytest.approx(100.0 * least / 100e-9)
    assert read(_ctx(cfg, _range("setup.xty"))) is None


def test_xty_roofline_reads_the_programs_span():
    read = registry.metric_reader("xty_roofline.train")
    for name, c in (("cifar10_ovr10_case2", 10), ("cifar10_case2", 1)):
        cfg = registry.config(name)
        ops, nbytes = roofline.gemm_work(3073, cfg["m"], c)
        least, _ = roofline.bound_s(50 * ops, 50 * nbytes)
        assert read(_ctx(cfg, _range("setup.xty"))) == \
            pytest.approx(100.0 * least / 100e-9)
        assert read(_ctx(cfg, _range("kernels.fused_step"))) is None
