"""The check must judge a broken timed path not correct.

Each test skips the harness's look for a card, runs a tiny cell on the CPU
through the benchmark's own drivers and checks, with the program broken
underneath, and expects `correct` to come out false.  The faults a cell can
have on one card: a step (or window) that returns its state unchanged,
half of the batch left out with the mean taken over the rest, and an
answer altered where it is produced.  (The exchange between chips is not a
fault of a one-card cell.)  The control -- the plain reference in the
program's place, the data at one fractional bit fewer -- must fail too.
"""

import pytest
import torch

import control
import run as bench_run
from repro_torch.core import protocol
from repro_torch.kernels import ops
from repro_torch.serve import coded

CPU = torch.device("cpu")


def _run(bench_copy, cell, overrides=None, seed=2**31 + 77):
    root, spec = bench_copy
    return bench_run.run_cell(spec, cell, seed, 0.3, False, CPU, root,
                              overrides)


def test_sound_runs_are_correct(bench_copy):
    for cell in ("tiny.train", "tiny.serve"):
        res = _run(bench_copy, cell)
        assert res["correct"], res


def _unchanged_step(self, key, state, *a, **kw):
    return state


def _half_batch(orig):
    def fused_step(x, *args, q_eta, **kw):
        x = x.clone()
        x[:, x.shape[1] // 2:] = 0          # half the rows left out ...
        return orig(x, *args, q_eta=2 * q_eta, **kw)   # ... mean of the rest
    return fused_step


def _altered_model(orig):
    def open_model(self, state):
        w = orig(self, state)
        w[0] += 1.0
        return w
    return open_model


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_training_faults_are_caught(bench_copy, monkeypatch, fault):
    if fault == "unchanged":
        monkeypatch.setattr(protocol.Copml, "iteration", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(ops, "fused_step", _half_batch(ops.fused_step))
    else:
        monkeypatch.setattr(protocol.Copml, "open_model",
                            _altered_model(protocol.Copml.open_model))
    res = _run(bench_copy, "tiny.train")
    assert not res["correct"], res
    lim = res["limits"]
    assert lim["step_gap"]["value"] > 0 or \
        lim["drift_z"]["value"] > lim["drift_z"]["limit"], lim


def _stale_window(orig):
    last = {}

    def score_shares(model, xq):
        out = orig(model, xq)
        prev = last.get("z")
        last["z"] = out
        return out if prev is None else prev
    return score_shares


def _half_window(orig):
    def score_shares(model, xq):
        xq = xq.clone()
        xq[xq.shape[0] // 2:] = 0
        return orig(model, xq)
    return score_shares


def _altered_logit(orig):
    def open_logits(z, model):
        out = orig(z, model).clone()
        out[0, 0] = (out[0, 0] + 1) % (2**26 - 5)
        return out
    return open_logits


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_serving_faults_are_caught(bench_copy, monkeypatch, fault):
    if fault == "unchanged":
        monkeypatch.setattr(coded, "score_shares",
                            _stale_window(coded.score_shares))
    elif fault == "half_batch":
        monkeypatch.setattr(coded, "score_shares",
                            _half_window(coded.score_shares))
    else:
        monkeypatch.setattr(coded, "open_logits",
                            _altered_logit(coded.open_logits))
    res = _run(bench_copy, "tiny.serve")
    assert not res["correct"], res
    assert res["limits"]["logit_gap"]["value"] > 0


@pytest.mark.parametrize("cell,number", [("tiny.train", "step_gap"),
                                         ("tiny.serve", "logit_gap")])
def test_the_control_is_not_correct(bench_copy, cell, number):
    root, spec = bench_copy
    rows = control.control_runs(cell, [1, 2, 2**31 + 3], 0.3, CPU, spec, root)
    for row in rows:
        assert not row["correct"], row
        assert row["limits"][number]["value"] > \
            row["limits"][number]["limit"]
