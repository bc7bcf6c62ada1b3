"""The benchmark's own tests: `python -m pytest -q bench/tests` from the
repository's root (the repository's tier-1 run collects only tests/).
Tests marked `gpu` need a CUDA card and skip without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a configuration small enough for the CPU: the port's `smoke` shape
TINY = dict(m=96, d=12, n_clients=13, k=4, t=1)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card")


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark's folder with a tiny configuration, two tiny
    mixes and a spec that names cells of them: nothing of the original is
    edited."""
    root = tmp_path / "bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "out", "__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "cifar10_case2.json").read_text())
    cfg.update(TINY)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "serve_b32.json").read_text())
    mix.update(rate_qps=4000, pool=64, batch_size=8, window_ms=2.0)
    (root / "traffic" / "tiny_serve.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] += [
        {"name": "tiny.train", "config": "tiny", "traffic": "train",
         "chips": 1, "why": "CPU test"},
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve",
         "chips": 1, "why": "CPU test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            train = any(w.endswith(".train") for w in m["workloads"])
            m["workloads"].append("tiny.train" if train else "tiny.serve")
    return root, spec
