"""The command on a card: each cell, short windows, untraced and traced.
Marked `gpu`; skips where no CUDA card is present."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

CELLS = ("cifar10_case2.train", "gisette_case1.train",
         "cifar10_case2.serve_b32", "gisette_case1.serve_b1")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["limits"]
    assert list(res)[-1] == "limits"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["metrics"]
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert res["breakdown"]["device_ops"]
