"""repro_torch fault plans vs the JAX package, on the CPU.

The port keeps its own copies of api/faults.FaultPlan and train/elastic's
budgets; on the same inputs they give the JAX package's masks, subsets,
headroom, descriptions and errors.  fit(..., faults=) checks a plan before
any compute, and the traced-subset helpers of core/shamir and core/mpc
match the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.api import faults as jfaults
from repro.core import lagrange as jlagrange
from repro.core import mpc as jmpc
from repro.core import shamir as jshamir
from repro.train import elastic as jelastic
from repro_torch import api
from repro_torch.api import faults, workloads
from repro_torch.core import field, mpc, protocol, shamir
from repro_torch.train import elastic

_N, _R, _ITERS = 13, 10, 6          # smoke_straggler: K=3, T=1


def _schedule(mod):
    return mod.FaultPlan.from_schedule(
        _N, _ITERS, stragglers={1: (0, 1), 4: (2,)}, dropouts={2: (7,)},
        adversaries={3: (8,)})


BUILDERS = {
    "from_schedule": _schedule,
    "fault_free": lambda mod: mod.FaultPlan.fault_free(_N, 8),
    "random_repaired": lambda mod: mod.FaultPlan.random(
        _N, 20, seed=7, straggle_p=0.3, n_dropouts=1, n_adversaries=1,
        min_available=_R),
    "random_churn": lambda mod: mod.FaultPlan.random(
        _N, 9, seed=3, straggle_p=0.5),
    "masks": lambda mod: mod.FaultPlan(
        _N, 3, np.eye(3, _N, dtype=bool) == 0, np.eye(3, _N, dtype=bool)),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_plans_match_jax(builder):
    got, want = BUILDERS[builder](faults), BUILDERS[builder](jfaults)
    np.testing.assert_array_equal(got.available, want.available)
    np.testing.assert_array_equal(got.adversary, want.adversary)
    np.testing.assert_array_equal(got.available_counts,
                                  want.available_counts)
    np.testing.assert_array_equal(got.headroom(_R), want.headroom(_R))
    assert (got.is_fault_free, got.has_adversaries) == \
        (want.is_fault_free, want.has_adversaries)
    assert got.describe(_R) == want.describe(_R)
    assert got.describe() == want.describe()
    if want.available_counts.min() >= _R:
        assert got.subsets(_R) == want.subsets(_R)
        np.testing.assert_array_equal(got.validate(_R), want.validate(_R))
    else:
        with pytest.raises(faults.FaultPlanViolation) as e_got:
            got.validate(_R)
        with pytest.raises(jfaults.FaultPlanViolation) as e_want:
            want.validate(_R)
        assert str(e_got.value) == str(e_want.value)
    cut = got.slice(2)
    np.testing.assert_array_equal(cut.available, want.slice(2).available)
    with pytest.raises(ValueError):
        got.available[0, 0] = False


ERRORS = {
    "step outside": lambda mod: mod.FaultPlan.from_schedule(
        _N, 4, stragglers={9: (0,)}),
    "client outside": lambda mod: mod.FaultPlan.from_schedule(
        _N, 4, dropouts={0: (13,)}),
    "both": lambda mod: mod.FaultPlan(_N, 2, np.ones((2, _N), bool),
                                      np.ones((2, _N), bool)),
    "mask shape": lambda mod: mod.FaultPlan(_N, 2, np.ones((3, _N), bool),
                                            np.zeros((3, _N), bool)),
    "too many faults": lambda mod: mod.FaultPlan.random(
        _N, 4, n_dropouts=10, n_adversaries=4),
    "cannot repair": lambda mod: mod.FaultPlan.random(
        _N, 4, seed=1, n_dropouts=5, min_available=_R),
    "slice": lambda mod: mod.FaultPlan.fault_free(_N, 3).slice(4),
    "subsets": lambda mod: _schedule(mod).subsets(_R + 1),
    "budget": lambda mod: mod.validate_budget([12, 9, 11], _R),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_plan_errors_match_jax(case):
    with pytest.raises(ValueError) as e_got:
        ERRORS[case](faults)
    with pytest.raises(ValueError) as e_want:
        ERRORS[case](jfaults)
    assert type(e_got.value).__name__ == type(e_want.value).__name__
    assert str(e_got.value) == str(e_want.value)


def test_budgets_match_jax():
    for n, k, t, r in [(13, 3, 1, 1), (50, 10, 7, 1), (20, 2, 1, 2)]:
        got = elastic.straggler_budget(n, k, t, r)
        want = jelastic.straggler_budget(n, k, t, r)
        assert (got.n, got.recovery_threshold, got.tolerable) == \
            (want.n, want.recovery_threshold, want.tolerable)
    assert elastic.secure_agg_budget(13, 4).tolerable == \
        jelastic.secure_agg_budget(13, 4).tolerable == 8
    np.testing.assert_array_equal(elastic.plan_headroom([12, 10], _R),
                                  jelastic.plan_headroom([12, 10], _R))
    assert issubclass(elastic.FaultPlanViolation, ValueError)
    assert faults.FaultPlanViolation is elastic.FaultPlanViolation
    assert api.FaultPlan is faults.FaultPlan
    assert api.fault_threshold(api.get_workload("smoke_straggler")) == _R


def test_fit_checks_a_plan_before_any_compute(monkeypatch):
    """A plan below the recovery threshold, of the wrong type, size or
    length, or given with a subset, raises before Copml.train runs."""
    def no_compute(*args, **kw):
        raise AssertionError("Copml.train ran")

    monkeypatch.setattr(protocol.Copml, "train", no_compute)
    fit = lambda **kw: api.fit("smoke_straggler", "copml", "jit",  # noqa
                               iters=4, device="cpu", **kw)
    bad = faults.FaultPlan.from_schedule(_N, 4, dropouts={1: (0, 1, 2, 3)})
    with pytest.raises(faults.FaultPlanViolation, match="step 1"):
        fit(faults=bad)
    with pytest.raises(ValueError, match="mutually exclusive"):
        fit(faults=faults.FaultPlan.fault_free(_N, 4), subset=(0, 1))
    with pytest.raises(TypeError, match="FaultPlan"):
        fit(faults=np.ones((4, _N), bool))
    with pytest.raises(ValueError, match="13"):
        fit(faults=faults.FaultPlan.fault_free(12, 4))
    with pytest.raises(ValueError, match="needs 4"):
        fit(faults=faults.FaultPlan.fault_free(_N, 3))


def test_fit_slices_a_longer_plan_and_records_availability():
    plan = faults.FaultPlan.from_schedule(_N, 9, stragglers={1: (4, 5)})
    res = api.fit("smoke_straggler", "copml", "jit", key=1, iters=3,
                  faults=plan, device="cpu")
    np.testing.assert_array_equal(res.availability, plan.available[:3])
    assert res.availability.shape == (3, _N)
    assert "churn: min 11/13" in res.summary()


def test_step_subsets_and_dynamic_reconstruct_match_jax():
    """shamir.step_subset_arrays (one weight row per distinct subset),
    reconstruct_dyn and mpc.add_public against the JAX package's."""
    points = tuple(range(20, 33))
    subsets = [(0, 1, 2), (4, 7, 9, 11), (0, 1, 2), (12, 3, 5)]
    calls = []

    def weights(sub):
        calls.append(sub)
        return shamir.recon_weights(points, sub).astype(np.int32)

    idx, wts = shamir.step_subset_arrays(subsets, 3, weights)
    jidx, jwts = jshamir.step_subset_arrays(
        subsets, 3, lambda s: jshamir.recon_weights(points, s))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(wts.numpy(), np.asarray(jwts))
    assert idx.dtype == torch.int64 and wts.dtype == torch.int32
    assert len(calls) == 3
    rng = np.random.default_rng(0)
    shares = rng.integers(0, field.P, (13, 4, 5)).astype(np.int32)
    for s in range(len(subsets)):
        got = shamir.reconstruct_dyn(torch.from_numpy(shares), idx[s], wts[s])
        want = jshamir.reconstruct_dyn(jnp.asarray(shares), jidx[s], jwts[s])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = mpc.add_public(torch.from_numpy(shares), field.P + 12345)
    want = jmpc.add_public(jnp.asarray(shares), field.P + 12345)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,straggle_p", [("smoke_straggler", 0.2),
                                             ("cifar10_case2", 0.02)])
def test_plan_decode_rows_equal_the_matrix_sums(name, straggle_p):
    """Copml._decode_vec and plan_constants give, for every subset of a
    drawn plan, the K x R decode matrix summed over its K rows mod p (the
    JAX package's Python-int matrix)."""
    wl = workloads.get(name)
    cfg, r = wl.cfg, wl.cfg.recovery_threshold
    proto = protocol.Copml(cfg, wl.m, wl.d, objective=wl.objective,
                           device="cpu")
    plan = faults.FaultPlan.random(cfg.n_clients, 12, seed=11,
                                   straggle_p=straggle_p, min_available=r)
    subsets = [tuple(s)[:r] for s in plan.subsets(r)]
    assert len(set(subsets)) > 2
    want = np.stack([
        (np.asarray(jlagrange.decode_matrix(
            [proto.alphas[i] for i in s], proto.betas[:cfg.k]),
            np.int64).sum(axis=0) % field.P).astype(np.int32)
        for s in subsets])
    for s, sub in enumerate(subsets):
        got = proto._decode_vec(sub)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want[s])
    idx, dvs = proto.plan_constants(plan.subsets(r))
    np.testing.assert_array_equal(idx.numpy(), np.array(subsets))
    np.testing.assert_array_equal(dvs.numpy(), want)
