"""The port's training step (models/model_zoo.build(...).loss_fn /
train_step) against the JAX package's, on the CPU at the SMOKE configs in
float32, from the same weights (params_from_jax), optimizer state
(opt_state_from_jax) and batch:

* loss_fn's gradients, leaf by leaf, within GRAD_TOL of the leaf's
  max |JAX gradient|;
* one train_step: loss and grad_norm within STEP_TOL (relative); the
  new parameters and optimizer state within STEP_TOL of each leaf's
  max |JAX value|;
* loss chunking and microbatching leave the step unchanged (the JAX
  package's tests/test_models.py checks the same on its own step).

The archs are split over two files by family (this one: the attention
families; test_torch_train_step_ssm.py: ssm, moe, encdec, hybrid); the
JAX side of an arch is computed once a module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model_zoo as jzoo
from repro.optim import optimizers as joptim
from repro_torch.configs import registry
from repro_torch.models import model, model_zoo
from repro_torch.optim import optimizers

import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).parent))
from test_torch_lm_serving import np_params  # noqa: E402

ARCHS = ["qwen3-1.7b", "qwen2.5-3b", "smollm-360m", "llama3.2-3b",
         "internvl2-2b"]
B, S = 2, 8
STEP = 3
GRAD_TOL = 1e-5
STEP_TOL = 1e-5


def np_batch(cfg, b=B, s=S, seed=1) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    fs = jzoo._frontier_shape(cfg, b)
    if fs is not None:
        batch["frontier"] = (0.5 * rng.standard_normal(fs)).astype(
            np.float32)
    return batch


def np_opt_state(cfg, params_np: dict, seed=2):
    """The JAX optimizer's init, moved away from zero (numpy float32), so
    that one update is smooth in the gradient."""
    rng = np.random.default_rng(seed)
    st = joptim.make(cfg.optimizer).init(
        {k: jnp.asarray(v) for k, v in params_np.items()})
    return jax.tree.map(
        lambda x: (np.asarray(x) + 1e-4 * np.abs(
            rng.standard_normal(x.shape)) + 1e-5).astype(np.float32), st)


def leaf_close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)
    return err


class Case:
    """One arch in float32: the JAX side (gradients, one train_step)
    computed once, numpy inputs for the port."""

    def __init__(self, arch, **build_kw):
        self.jc = jregistry.smoke_config(arch).scaled(dtype="float32")
        self.tc = registry.smoke_config(arch).scaled(dtype="float32")
        self.kw = build_kw
        self.pn = np_params(self.jc)
        self.bn = np_batch(self.jc, **build_kw.pop("batch_shape", {}))
        self.sn = np_opt_state(self.jc, self.pn)
        jb = jzoo.build(self.jc, **self.kw)
        pj = {k: jnp.asarray(v) for k, v in self.pn.items()}
        bj = {k: jnp.asarray(v) for k, v in self.bn.items()}
        with jax.threefry_partitionable(False):
            (tot, loss), g = jax.jit(jax.value_and_grad(
                jb.loss_fn, has_aux=True))(pj, bj)
            p2, s2, met = jax.jit(jb.train_step)(
                pj, jax.tree.map(jnp.asarray, self.sn), bj,
                jnp.asarray(STEP, jnp.int32))
        self.j_loss = (float(tot), float(loss))
        self.j_grads = {k: np.asarray(v) for k, v in g.items()}
        self.j_params = {k: np.asarray(v) for k, v in p2.items()}
        self.j_state = jax.tree.map(np.asarray, s2)
        self.j_metrics = {k: float(v) for k, v in met.items()}

    def port(self, **kw):
        """(params, opt_state, batch) for the port, on the CPU."""
        params = model.params_from_jax(self.tc, self.pn, "cpu")
        state = optimizers.opt_state_from_jax(self.tc, self.sn, "cpu")
        batch = {k: torch.from_numpy(v.copy()) for k, v in self.bn.items()}
        return params, state, batch

    def check_grads(self):
        params, _, batch = self.port()
        bm = model_zoo.build(self.tc, **self.kw)
        names = sorted(params)
        leaves = {k: params[k].requires_grad_(True) for k in names}
        tot, loss = bm.loss_fn(leaves, batch)
        grads = torch.autograd.grad(tot, [leaves[k] for k in names])
        assert float(tot.detach()) == pytest.approx(self.j_loss[0],
                                                    rel=STEP_TOL)
        assert float(loss.detach()) == pytest.approx(self.j_loss[1],
                                                     rel=STEP_TOL)
        assert set(names) == set(self.j_grads)
        return max(leaf_close(g.numpy(), self.j_grads[k], GRAD_TOL, k)
                   for k, g in zip(names, grads))

    def check_step(self, **kw):
        params, state, batch = self.port()
        bm = model_zoo.build(self.tc, **{**self.kw, **kw})
        p2, s2, met = bm.train_step(params, state, batch, STEP)
        assert p2 is params and s2 is state          # updated in place
        for k in ("loss", "grad_norm"):
            assert float(met[k]) == pytest.approx(self.j_metrics[k],
                                                  rel=STEP_TOL), k
        errs = [leaf_close(p2[k].numpy(), self.j_params[k], STEP_TOL, k)
                for k in self.j_params]
        flat_j = jax.tree.leaves(self.j_state)
        flat_t = jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy(), s2))
        assert len(flat_j) == len(flat_t)
        errs += [leaf_close(t, j, STEP_TOL, "opt state")
                 for t, j in zip(flat_t, flat_j)]
        return max(errs)


@pytest.fixture(scope="module")
def cases():
    memo = {}

    def get(arch, **kw):
        key = (arch, tuple(sorted((k, str(v)) for k, v in kw.items())))
        if key not in memo:
            memo[key] = Case(arch, **kw)
        return memo[key]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_jax(cases, arch):
    cases(arch).check_grads()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_jax(cases, arch):
    cases(arch).check_step()


def test_microbatched_step_equals_jax(cases):
    """microbatch = 1 of a batch of 2: float32 gradients accumulated and
    divided by 2, as the JAX package's scan does."""
    cases("smollm-360m", microbatch=1).check_step()


def test_loss_chunking_leaves_the_step_unchanged(cases):
    """The chunked cross-entropy (S = 32, chunks of 8) against JAX's
    unchunked step (the port's chunks recompute their logits in
    backward)."""
    case = cases("smollm-360m", batch_shape=dict(s=32))
    case.check_step(loss_chunk=8)
    case.check_grads()


def test_microbatching_leaves_the_step_unchanged(cases):
    """The port's microbatched step (microbatch 1 of 2) against JAX's
    plain step: the same loss, gradient norm and update within
    STEP_TOL (a mask of ones: each microbatch's mean weighs the same)."""
    case = cases("qwen3-1.7b")
    params, state, batch = case.port()
    batch["mask"] = torch.ones_like(batch["mask"])
    outs = []
    for mb in (0, 1):
        p = {k: v.clone() for k, v in params.items()}
        st = jax.tree.map(lambda t: t.clone(), state)
        p, st, met = model_zoo.build(case.tc, microbatch=mb).train_step(
            p, st, batch, STEP)
        outs.append((p, met))
    (p0, m0), (p1, m1) = outs
    for k in ("loss", "grad_norm"):
        assert float(m1[k]) == pytest.approx(float(m0[k]), rel=STEP_TOL)
    for k in p0:
        leaf_close(p1[k].numpy(), p0[k].numpy(), STEP_TOL, k)


def test_build_still_serves_and_input_specs_are_meta():
    cfg = registry.smoke_config("internvl2-2b")
    bm = model_zoo.build(cfg)
    assert {"train_step", "loss_fn", "prefill_step", "decode_step"} <= \
        set(vars(bm))
    from repro_torch.models.config import TRAIN_4K, DECODE_32K
    specs = model_zoo.input_specs(cfg, TRAIN_4K)
    jspecs = jzoo.input_specs(jregistry.smoke_config("internvl2-2b"),
                              TRAIN_4K)
    assert set(specs) == set(jspecs)
    for k, t in specs.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(jspecs[k].shape)
        assert str(t.dtype).split(".")[-1] == str(jspecs[k].dtype)
    assert set(model_zoo.input_specs(cfg, DECODE_32K)) == {"tokens"}
