"""The port's CLI (python -m repro_torch.api.cli) on the CPU: --list prints
the live registries, a smoke fit lands on the smoke golden, --straggle-p
prints the plan and the churn, and `serve` (serve_main) prints the same
agreement line as the JAX package's serve_main."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.api import cli as jcli
from repro_torch import api
from repro_torch.api import cli
from repro_torch.api import engine as engine_mod

from test_torch_protocol import GOLDEN_W

REPO = Path(__file__).resolve().parent.parent


def _registries(out: str) -> dict:
    rows = {}
    for line in out.splitlines():
        name, _, rest = line.partition(":")
        rows[name] = [e.strip() for e in rest.split(",") if e.strip()]
    return rows


def _live() -> dict:
    return {"workloads": list(api.workload_names()),
            "protocols": sorted(api.PROTOCOLS),
            "engines": list(api.engine_names()),
            "objectives": list(api.objective_names())}


def test_list_prints_the_live_registries(capsys):
    """--list enumerates the live registries: a kind registered at run
    time appears without a CLI edit."""
    cli.main(["--list"])
    assert _registries(capsys.readouterr().out) == _live()
    api.register_engine_kind(engine_mod.EngineKind(
        "testkind", "registered by test_list_prints_the_live_registries"))
    try:
        cli.main(["--list"])
        listed = _registries(capsys.readouterr().out)
        assert listed == _live() and "testkind" in listed["engines"]
    finally:
        engine_mod.KINDS.pop("testkind", None)


def test_list_through_the_module_matches_the_registries():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.api.cli", "--list"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert _registries(out.stdout) == _live()


@pytest.fixture
def fits(monkeypatch):
    """Every TrainResult the CLI's fit returns, in order."""
    got = []

    def fit(*args, **kw):
        got.append(api.fit(*args, **kw))
        return got[-1]

    monkeypatch.setattr(cli, "fit", fit)
    return got


def test_smoke_fit_lands_on_the_golden(fits, capsys):
    cli.main(["smoke", "--iters", "10", "--device", "cpu"])
    (res,) = fits
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(GOLDEN_W))
    assert res.triple == ("smoke", "copml", "jit") and res.device == "cpu"
    assert capsys.readouterr().out.strip() == res.summary()


def test_straggle_p_prints_the_plan_and_the_churn(fits, capsys):
    cli.run(["smoke_straggler", "--iters", "4", "--straggle-p", "0.2",
             "--no-history", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    (res,) = fits
    thr = api.fault_threshold(api.get_workload("smoke_straggler"))
    plan = api.FaultPlan.random(13, 4, seed=0, straggle_p=0.2,
                                min_available=thr)
    assert out[0] == plan.describe(thr)
    np.testing.assert_array_equal(res.availability, plan.available)
    assert out[1] == res.summary() and "churn: min" in out[1]
    assert res.history is None


def test_serve_prints_the_jax_packages_agreement(capsys):
    """serve_main on smoke: the secure scores' decisions against the
    opened float model's.  A few eval rows sit at a logit near 0, where
    the fixed-point score can fall on the other side, so the agreement is
    below 1; the line must be the JAX package's, which runs the same
    model (its legacy key stream) through its own serving."""
    cli.run(["serve", "smoke", "--iters", "10", "--device", "cpu"])
    line = capsys.readouterr().out.splitlines()[-1]
    with jax.threefry_partitionable(False):
        jcli.serve_main(["smoke", "--iters", "10"])
    want = capsys.readouterr().out.splitlines()[-1]
    assert line == want
    assert line.startswith("agreement with opened-model scoring: ")
    assert line.endswith(" over 96 queries")
