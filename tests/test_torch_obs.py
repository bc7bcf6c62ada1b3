"""repro_torch.obs: spans at the port's layer boundaries, on the CPU.

With nothing listening a span is one shared null context; a Recorder
totals spans by path; under torch.profiler the spans are ranges of the
profiler's host timeline.  The protocol's and the server's spans are
checked on the port's smoke shape, and a run with spans recorded gives
the bits of a run without.
"""

import inspect
import re
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api, obs
from repro_torch.api import workloads
from repro_torch.core import protocol
from repro_torch.kernels import ops
from test_torch_protocol import row_copies

#: the ranges the benchmark opens itself (bench/systems, bench/drivers):
#: a program span of one of these names would add to their counts
BENCH_RANGES = {"copml.setup", "copml.iteration", "kernels.fused_step",
                "serve.score_shares", "serve.window", "bench.window"}
SRC = Path(protocol.__file__).resolve().parents[1]


def _smoke_copml():
    wl = workloads.get("smoke")
    cx, cy = wl.client_data()
    proto = protocol.Copml(wl.cfg, wl.m, wl.d, objective=wl.objective,
                           device="cpu")
    return wl, proto, cx, cy


def test_span_without_listeners_is_the_shared_null(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert obs.span("a") is obs.span("b") is obs._OFF
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with obs.span("train.step"):
                with obs.span("random.threefry"):
                    pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == obs.__file__ and d.size_diff > 0]
    assert grown == []
    assert not re.search(r"environ|getenv", inspect.getsource(obs))


def test_recorder_totals_nested_spans_by_path(monkeypatch):
    ticks = iter(range(100))
    monkeypatch.setattr(obs.time, "perf_counter", lambda: float(next(ticks)))
    with obs.Recorder() as rec:
        for _ in range(2):
            with obs.span("train.step"):          # 4 ticks a step
                with obs.span("random.threefry"):
                    pass
        with obs.span("random.threefry"):
            pass
        with obs.Recorder() as inner:
            with obs.span("step.open"):
                pass
    assert rec.spans == {"train.step/random.threefry": [2, 2.0],
                         "train.step": [2, 6.0],
                         "random.threefry": [1, 1.0]}
    assert inner.spans == {"step.open": [1, 1.0]}
    assert obs.span("x") is obs._OFF                # both recorders left


def test_profiler_sees_the_protocol_spans():
    _, proto, cx, cy = _smoke_copml()
    timings = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        proto.train(0, cx, cy, 2, history=True, timings=timings)
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(
            (e.time_range.start, e.time_range.end))
    for name in ("setup.rows", "setup.share", "setup.lcc", "train.step",
                 "step.encode", "step.masks", "step.open"):
        assert name in ranges, name
    assert len(ranges["train.step"]) == 2

    def inside(outer):
        return [d for d in ranges["random.threefry"]
                if any(s <= d[0] and d[1] <= e for s, e in ranges[outer])]

    assert inside("setup.share") and inside("setup.lcc")
    assert inside("train.step")
    spans = timings["spans"]
    assert spans["train.step"][0] == 2 and spans["setup.rows"][0] == 1
    assert spans["train.step/step.encode/random.threefry"][0] == 4
    assert spans["train.step/step.masks/random.threefry"][0] == 8
    assert spans["setup.share/random.threefry"][0] == 2
    assert spans["setup.lcc/random.threefry"][0] >= 1
    draws = sum(c for p, (c, _) in spans.items()
                if p.endswith("random.threefry"))
    assert draws == len(ranges["random.threefry"])
    assert all(c >= 1 and s >= 0 for c, s in spans.values())


@pytest.mark.parametrize("profiled", [False, True])
def test_spans_leave_the_bits_as_they_were(profiled):
    _, proto, cx, cy = _smoke_copml()
    _, w0, h0 = proto.train(5, cx, cy, 3, history=True)
    timings = {}
    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _, w1, h1 = proto.train(5, cx, cy, 3, history=True,
                                    timings=timings)
    else:
        _, w1, h1 = proto.train(5, cx, cy, 3, history=True, timings=timings)
    assert torch.equal(w0, w1) and torch.equal(h0, h1)
    assert timings["spans"]["train.step"][0] == 3


def test_setup_rows_opens_once_a_job_and_counts_its_copies():
    """Each job's timings hold setup.rows once, and each job copies every
    client's rows once, with no host array of all the rows; the job's
    counts hold only the coded gradients by route."""
    _, proto, cx, cy = _smoke_copml()
    for key in (1, 2):
        timings = {}
        with row_copies() as seen:
            proto.train(key, cx, cy, 2, timings=timings)
        assert timings["spans"]["setup.rows"][0] == 1
        assert seen["copies"] == ["cpu"] * len(cx)
        assert seen["joined"] == 0
        assert set(timings["counts"]) == set(ops.gradient_counts())


def test_serving_window_spans():
    res = api.fit("smoke", "copml", "jit", key=0, iters=2, device="cpu")
    srv = api.serve("smoke", res, "jit", device="cpu")
    x = workloads.get("smoke").eval_set()[0][:4]
    with obs.Recorder() as rec:
        dec = srv._decide(srv.logits(x))
    assert np.array_equal(dec, srv.predict(x))
    assert set(rec.spans) == {"serve.quantize", "serve.fetch"}
    assert all(c == 1 for c, _ in rec.spans.values())


def test_span_names_are_not_the_benchmarks():
    names = set()
    for path in SRC.rglob("*.py"):
        names |= set(re.findall(r'obs\.span\(\s*"([^"]+)"',
                                path.read_text()))
    assert names == {"setup.rows", "setup.share", "setup.lcc",
                     "setup.xty", "setup.faults", "train.step",
                     "step.encode", "step.masks", "step.open",
                     "random.threefry", "serve.quantize", "serve.fetch"}
    assert not names & BENCH_RANGES
    assert not any("/" in n for n in names)
