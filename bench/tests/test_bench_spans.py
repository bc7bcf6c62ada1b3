"""The readers of the program's own spans (repro_torch.obs), on the CPU:
synthetic profiler events and job records, and the spans of a tiny
training cell's real jobs."""

import types

import pytest
import torch

import run as bench_run
from test_bench_harness import _Event
from yardstick import registry, trace

TRAIN_READERS = ("threefry_ms.train", "setup_rows_ms.train")


def _trace(events):
    tr = trace.DeviceTrace()
    tr.ingest(events)
    return tr


def test_threefry_launches_count_only_draws_inside_steps():
    ev = [_Event("bench.window", 0, 2000, False, mark=True),
          _Event("setup.share", 0, 400, False, mark=True),
          _Event("random.threefry", 100, 100, False, mark=True),
          _Event("train.step", 500, 400, False, mark=True),
          _Event("random.threefry", 550, 100, False, mark=True),
          _Event("step.masks", 700, 100, False, mark=True),
          _Event("train.step", 1000, 400, False, mark=True),
          _Event("random.threefry", 1050, 50, False, mark=True)]
    launches = [(150, 1), (560, 2), (600, 3), (750, 4), (1060, 5),
                (1500, 6)]
    for t, corr in launches:
        ev += [_Event("cudaLaunchKernel", t, 5, False, corr=corr),
               _Event(f"k{corr}", t + 10, 20, True, corr=corr)]
    ev.append(_Event("Memcpy HtoD (Pageable -> Device)", 580, 5, True,
                     corr=7))
    ev.append(_Event("cudaMemcpyAsync", 575, 5, False, corr=7))
    read = registry.metric_reader("threefry_launches_per_iter.train")
    ctx = types.SimpleNamespace(trace=_trace(ev))
    assert read(ctx) == pytest.approx(3 / 2)     # k2, k3, k5 over 2 steps
    # the parent's trace: the benchmark's ranges only
    plain = [e for e in ev if e.name() not in
             ("setup.share", "train.step", "random.threefry", "step.masks")]
    assert read(types.SimpleNamespace(trace=_trace(plain))) is None
    assert read(types.SimpleNamespace(trace=None)) is None


def _job(traced, rows_s, draw_s):
    spans = {"setup.rows": [1, rows_s],
             "setup.share/random.threefry": [2, 0.5],
             "setup.share": [1, 0.9],
             "train.step/step.encode/random.threefry": [4, draw_s],
             "train.step/step.masks/random.threefry": [8, 3 * draw_s],
             "train.step/step.masks": [2, 0.2],
             "train.step": [2, 0.3]}
    return dict(traced=traced,
                timings=dict(setup_s=1.0, iters_s=0.3, spans=spans))


def test_span_readers_take_the_untraced_jobs():
    jobs = [_job(False, 0.050, 0.001), _job(False, 0.070, 0.002),
            _job(True, 9.0, 9.0)]
    ctx = types.SimpleNamespace(record=dict(jobs=jobs), cfg=dict(iters=2))
    read = registry.metric_reader
    # (4 + 8) ms of draws over the two untraced jobs' 4 steps
    assert read("threefry_ms.train")(ctx) == pytest.approx(12.0 / 4)
    assert read("setup_rows_ms.train")(ctx) == pytest.approx(60.0)
    for job in jobs:                      # the parent keeps no spans
        del job["timings"]["spans"]
    for name in TRAIN_READERS:
        assert read(name)(ctx) is None
    ctx.record = dict(jobs=[])
    for name in TRAIN_READERS:
        assert read(name)(ctx) is None


def test_a_tiny_cell_feeds_the_span_readers(bench_copy):
    root, spec = bench_copy
    cell = registry.cell(spec, "tiny.train")
    h = bench_run.Harness(spec, cell, 2**31 + 17, 0.2, False,
                          torch.device("cpu"), root)
    record = h.driver.run(h)
    ctx = bench_run.Context(h, record)
    steps = h.cfg["iters"] * len(record["jobs"])
    assert all(j["timings"]["spans"]["train.step"][0] == h.cfg["iters"]
               for j in record["jobs"]) and steps > 0
    for name in TRAIN_READERS:
        assert registry.metric_reader(name, root)(ctx) > 0
    names = {m["name"] for m in
             registry.cell_metrics(spec, "tiny.train", "per_layer")}
    assert set(TRAIN_READERS) | {"threefry_launches_per_iter.train"} <= names
