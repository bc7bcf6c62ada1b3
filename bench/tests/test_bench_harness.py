"""The harness on the CPU: files found by name, the yardstick's arithmetic,
the schedule, the percentiles, the reference and the import guard."""

import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, TINY

import run as bench_run
from drivers import open_loop
from reference import copml_logreg as ref_mod
from yardstick import data, guard, registry, roofline


def test_new_files_are_found_by_name(bench_copy):
    root, spec = bench_copy
    (root / "metrics" / "jobs_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.record['jobs'])\n")
    spec["per_layer"].append(
        {"name": "jobs_seen", "unit": "jobs", "better": "higher",
         "source": "program_counter", "layer": "protocols",
         "moves": "fit_s", "workloads": ["tiny.train"]})
    res = bench_run.run_cell(spec, "tiny.train", 7, 0.2, False,
                             torch.device("cpu"), root)
    assert res["correct"], res
    assert set(res["metrics"]) == {"fit_s", "setup_s"}
    ctx_jobs = res["attempted"]
    assert ctx_jobs >= 1
    metrics = registry.cell_metrics(spec, "tiny.train", "per_layer")
    assert "jobs_seen" in [m["name"] for m in metrics]
    assert registry.metric_reader("jobs_seen", root)(
        types.SimpleNamespace(record={"jobs": [1, 2]})) == 2


def test_every_named_file_exists():
    spec = registry.load_spec(ROOT / "BENCHMARK.json")
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file()
        cfg = registry.config(c["name"])
        registry.system(cfg["system"])
        registry.reference(cfg["reference"])
    for w in spec["workloads"]:
        registry.driver(registry.traffic(w["traffic"])["driver"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(registry.metric_reader(m["name"]))


def test_names_are_refused_when_malformed():
    with pytest.raises(ValueError):
        registry.config("../configs/cifar10_case2")


def test_every_cell_reports_its_metrics():
    spec = registry.load_spec(ROOT / "BENCHMARK.json")
    for w in spec["workloads"]:
        e2e = {m["name"] for m in
               registry.cell_metrics(spec, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = registry.cell_metrics(spec, w["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


def test_roofline_copy_holds_the_kernel_table():
    least, by = roofline.bound_s(*roofline.fused_work(50, 902, 3073, 1, 1))
    assert by == "bytes" and round(least * 1e3, 4) == 0.1668
    ops, nbytes = roofline.gemm_work(32, 3073, 50)
    assert round(nbytes / roofline.HBM_BYTES_PER_S * 1e3, 5) == 0.00030
    assert roofline.bound_s(ops, nbytes)[1] == "operations"
    assert math.isclose(roofline.FIELD_OPS_PER_S, 16.73e12, rel_tol=1e-3)


def test_schedule_repeats_by_seed_and_keeps_its_gaps():
    due_a, idx_a = open_loop.schedule(1000.0, 2.0, 2**31 + 5, 64)
    due_b, idx_b = open_loop.schedule(1000.0, 2.0, 2**31 + 5, 64)
    due_c, _ = open_loop.schedule(1000.0, 2.0, 11, 64)
    assert np.array_equal(due_a, due_b) and np.array_equal(idx_a, idx_b)
    assert not np.array_equal(due_a, due_c)
    assert len(due_a) == 2000
    gaps_a = np.sort(np.diff(np.concatenate([[0.0], due_a])))
    gaps_c = np.sort(np.diff(np.concatenate([[0.0], due_c])))
    assert np.allclose(gaps_a, gaps_c)
    assert abs(due_a[-1] - 2.0) < 0.05


def test_percentiles_take_every_query():
    n = 100
    loop = dict(answered=np.ones(n, bool), due=np.zeros(n),
                done=np.arange(1, n + 1) * 1e-3)
    got = open_loop.latency_stats(loop)
    assert got == {"query_p50_ms": pytest.approx(50.0),
                   "query_p95_ms": pytest.approx(95.0)}
    loop["answered"][-10:] = False        # a tenth never answered
    assert "query_p95_ms" not in open_loop.latency_stats(loop)


def test_seeds_and_keys():
    big = 2**31 + 123456789
    assert data.subseed(big, "rows") == data.subseed(big, "rows")
    assert data.subseed(big, "rows") != data.subseed(big, "queries")
    key = data.program_key(big, 3)
    assert key.dtype == np.uint32 and key.shape == (2,)
    x1, y1 = data.planted_rows(40, 6, 2.0, big, "cpu")
    x2, y2 = data.planted_rows(40, 6, 2.0, big, "cpu")
    assert np.array_equal(x1, x2) and np.array_equal(y1, y2)
    assert np.abs(x1).max() <= 1.0


def _tiny_cfg():
    cfg = json.loads((BENCH / "configs" / "cifar10_case2.json").read_text())
    cfg.update(TINY)
    return cfg


def test_reference_constants():
    cfg = json.loads((BENCH / "configs" / "cifar10_case2.json").read_text())
    f = ref_mod.Fixed(cfg)
    assert (f.q_eta, f.e, f.k1, f.k2) == (2, 14, 24, 25)
    assert f.coeffs == [1024, 5]
    assert f.p == 2**26 - 5


def test_reference_accepts_its_own_trajectory_and_refuses_a_shifted_one():
    cfg = _tiny_cfg()
    x, y = data.planted_rows(cfg["m"], cfg["d"], 2.0, 5, "cpu")
    gen = torch.Generator().manual_seed(1)
    job = ref_mod.control_job(cfg, x, y, gen, "cpu", cfg["lx"])
    ref = ref_mod.Reference(cfg, x, y, "cpu")
    got = ref_mod.judge_jobs(ref, [job])
    assert got["step_gap"] == 0 and got["drift_z"] < 8
    job["hist"][10, 0] += 1.0
    assert ref_mod.judge_jobs(ref, [job])["step_gap"] > 0


def test_reference_logits_are_the_field_products():
    cfg = _tiny_cfg()
    x, y = data.planted_rows(cfg["m"], cfg["d"], 2.0, 5, "cpu")
    ref = ref_mod.Reference(cfg, x, y, "cpu")
    w = np.linspace(-3, 3, cfg["d"]).astype(np.float32)
    lg, dec = ref.logits(w, x)
    want = np.round(x * 4).astype(np.int64) @ np.round(w * 8).astype(np.int64)
    assert np.array_equal(lg * 32, want.astype(np.float32))
    assert np.array_equal(dec, (want > 0).astype(np.int32))


def test_guard_compares_whole_top_level_names(tmp_path):
    mods = {"repro_torch": types.ModuleType("repro_torch"),
            "repro_torch.api": types.ModuleType("repro_torch.api"),
            "numpy": np}
    assert guard.offending(mods) == []
    for bad in ("jax", "jaxlib.xla", "flax", "repro", "repro.api"):
        assert guard.offending(dict(mods, **{bad: types.ModuleType(bad)})) \
            == [bad]
    old = types.ModuleType("old")
    (tmp_path / "benchmarks").mkdir()
    old.__file__ = str(tmp_path / "benchmarks" / "run.py")
    assert guard.offending({"old": old}, checkout=tmp_path) == ["old"]


def test_a_run_loads_no_forbidden_module(bench_copy):
    root, spec = bench_copy
    (root / "spec.json").write_text(json.dumps(spec))
    script = (
        "import sys, json, torch\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(BENCH)!r}]\n"
        "import run\n"
        "from yardstick import guard, registry\n"
        f"spec = json.load(open({str(root / 'spec.json')!r}))\n"
        "res = run.run_cell(spec, 'tiny.serve', 3, 0.2, False,\n"
        f"                   torch.device('cpu'), {str(root)!r})\n"
        "assert res['correct'], res\n"
        f"print(guard.offending(checkout={str(ROOT)!r}))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card_or_the_program(tmp_path):
    cmd = [sys.executable, "bench/run.py", "--workload",
           "cifar10_case2.train", "--seed", "1", "--seconds", "1"]
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0 and out.stdout == ""
    bare = tmp_path / "bare"
    bare.mkdir()
    subprocess.run(["cp", "-r", str(BENCH), str(bare / "bench")], check=True)
    subprocess.run(["cp", str(ROOT / "BENCHMARK.json"), str(bare)],
                   check=True)
    out = subprocess.run(cmd, cwd=bare, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_json_keeps_the_contract_form():
    import re
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

    def line(s):
        return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
            and "\t" not in s

    assert 1 <= spec["run_seconds"] <= 51
    assert all(line(w) for w in spec["command"])
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("bench/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and line(w["why"]) and w["chips"] == 1
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%":
            assert m["better"] == "higher" or "idle" in m["name"]
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))


class _Event:
    """A profiler event as torch 2.11's `_KinetoEvent` shows it."""

    def __init__(self, name, start, dur, device, corr=0, mark=False):
        self._v = (name, start, dur, device, corr, mark)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] \
            else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_reduction():
    from yardstick import trace
    ev = [_Event("bench.window", 0, 1000, False, mark=True),
          _Event("bench.window", 0, 1000, True, mark=True),   # device side
          _Event("copml.iteration", 100, 300, False, mark=True),
          _Event("cudaLaunchKernel", 150, 10, False, corr=7),
          _Event("cudaLaunchKernel", 600, 10, False, corr=8),
          _Event("aten::add", 590, 30, False),
          _Event("k_inside", 200, 100, True, corr=7),
          _Event("k_outside", 250, 150, True, corr=8),
          _Event("Memcpy HtoD (Pageable -> Device)", 700, 50, True, corr=9)]
    tr = trace.DeviceTrace()
    tr.ingest(ev)
    assert tr.window("bench.window") == (0, 1000)
    assert [op[2] for op in tr.ops_launched_in("copml.iteration")] == \
        ["k_inside"]
    assert tr.busy_ns(0, 1000) == 200 + 50       # [200, 400) and the copy
    gaps = tr.idle_gaps(0, 1000)
    assert gaps[0] == ["host: bench.window", pytest.approx(300e-9)]
    assert [g[1] for g in gaps[1:]] == [pytest.approx(250e-9),
                                        pytest.approx(200e-9)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert tr.host_at(600) == "aten::add"
    names = dict(tr.device_seconds_by_name(0, 1000))
    assert names["k_outside"] == pytest.approx(150e-9)


def test_window_readings_leave_out_the_profiled_windows():
    wins = [(0.0, 1.0, 0, 2), (1.5, 2.5, 2, 1), (3.0, 4.0, 3, 1)]
    loop = dict(windows=wins, profiled_from=None)
    assert open_loop.untraced_windows(loop) == wins
    loop["profiled_from"] = 2.6
    assert open_loop.untraced_windows(loop) == wins[:2]
    loop["due"] = np.array([-0.5, -0.25, 1.0, 2.0])
    ctx = types.SimpleNamespace(record=dict(loop=loop))
    read = registry.metric_reader
    assert read("window_ms.serve")(ctx) == pytest.approx(1e3)
    assert read("queue_wait_ms.serve")(ctx) == pytest.approx(500.0)


def test_shared_readings():
    from yardstick import readings, trace
    ev = [_Event("bench.window", 0, 1000, False, mark=True),
          _Event("kernels.fused_step", 100, 300, False, mark=True),
          _Event("kernels.fused_step", 500, 300, False, mark=True),
          _Event("cudaLaunchKernel", 150, 10, False, corr=7),
          _Event("cudaLaunchKernel", 550, 10, False, corr=8),
          _Event("cudaLaunchKernel", 900, 10, False, corr=9),
          _Event("k1", 200, 100, True, corr=7),
          _Event("k2", 600, 100, True, corr=8),
          _Event("k3", 920, 50, True, corr=9)]
    tr = trace.DeviceTrace()
    tr.ingest(ev)
    ctx = types.SimpleNamespace(trace=tr, roofline=roofline)
    assert readings.idle_pct(ctx) == pytest.approx(75.0)
    work = (0.0, 100e-9 * roofline.HBM_BYTES_PER_S)     # 100 ns of bytes
    assert readings.range_roofline(ctx, "kernels.fused_step", work) == \
        pytest.approx(100.0)
    assert readings.range_roofline(ctx, "serve.score_shares", work) is None
    ctx.trace = None
    assert readings.idle_pct(ctx) is None
    jobs = [dict(traced=False), dict(traced=True)]
    ctx.record = dict(jobs=jobs)
    assert readings.untraced_jobs(ctx) == jobs[:1]
    ctx.record = dict(jobs=jobs[1:])
    assert readings.untraced_jobs(ctx) == jobs[1:]
