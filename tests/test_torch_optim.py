"""The port's optimizers (optim/optimizers) against the JAX package's:
one update from the same gradients, state and parameters, in float32
(rtol 1e-6, floored at 1e-6 of the leaf's max) and with bf16 parameters
(within one bf16 ulp); the JAX
package's own optimizer tests (tests/test_quantize_optim.py) mirrored;
the sliced update of a large leaf equal to the whole-leaf update."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import optimizers as joptim
from repro_torch.optim import optimizers

NAMES = ["adamw", "sgdm", "adafactor"]
SHAPES = {"a": (4, 6), "b": (6,), "c": (2, 3, 5), "d": (3, 1, 4)}


def _case(seed: int, scale: float):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
             for k, s in SHAPES.items()}
    return params, grads, rng


def _jax_state(name, params, rng):
    """The JAX optimizer's init, perturbed away from zero (numpy)."""
    st = joptim.make(name).init({k: jnp.asarray(v)
                                 for k, v in params.items()})
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.01 * np.abs(
            rng.standard_normal(x.shape)).astype(np.float32), st)


def _close(got, want, rtol, err_msg=""):
    """|got - want| <= rtol x (|want| + max |want| of the leaf): relative,
    with the leaf's scale as the floor (the clip's float32 scale moves
    every element by ~1 ulp of the leaf, a near-cancelled one too)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _leaves(tree) -> list:
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(
        jax.tree.map(lambda t: t.float().numpy()
                     if isinstance(t, torch.Tensor) else np.asarray(t),
                     tree))]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("scale", [0.05, 3.0])     # unclipped, clipped
def test_update_equals_jax_float32(name, scale):
    params, grads, rng = _case(1, scale)
    st = _jax_state(name, params, rng)
    jp, jst, jn = joptim.make(name).update(
        {k: jnp.asarray(v) for k, v in grads.items()},
        jax.tree.map(jnp.asarray, st),
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(3, jnp.int32))
    tp, tst, tn = optimizers.make(name).update(
        {k: torch.from_numpy(v.copy()) for k, v in grads.items()},
        optimizers.opt_state_from_jax(name, st, "cpu"),
        {k: torch.from_numpy(v.copy()) for k, v in params.items()}, 3)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in params:
        _close(tp[k].numpy(), jp[k], 1e-6, k)
    for got, want in zip(_leaves(tst), _leaves(jst)):
        _close(got, want, 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_update_equals_jax_bf16(name):
    """bf16 parameters and gradients: the clip rounds the scaled gradient
    to bf16 and the new parameters round to bf16, as in JAX; float32
    moments.  Parameters within one bf16 ulp (2^-8 relative), state
    within rtol 1e-5."""
    params, grads, rng = _case(2, 3.0)
    pb = {k: v.astype(ml_dtypes.bfloat16) for k, v in params.items()}
    gb = {k: v.astype(ml_dtypes.bfloat16) for k, v in grads.items()}
    st = _jax_state(name, params, rng)
    jp, jst, jn = joptim.make(name).update(
        {k: jnp.asarray(v) for k, v in gb.items()},
        jax.tree.map(jnp.asarray, st),
        {k: jnp.asarray(v) for k, v in pb.items()},
        jnp.asarray(0, jnp.int32))

    def tb(v):
        return torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
    tp, tst, tn = optimizers.make(name).update(
        {k: tb(v) for k, v in gb.items()},
        optimizers.opt_state_from_jax(name, st, "cpu"),
        {k: tb(v) for k, v in pb.items()}, 0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in params:
        assert tp[k].dtype == torch.bfloat16
        want = np.asarray(jp[k]).astype(np.float32)
        np.testing.assert_allclose(tp[k].float().numpy(), want,
                                   rtol=2 ** -8, err_msg=k)
    for got, want in zip(_leaves(tst), _leaves(jst)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_sliced_update_equals_whole_leaf(name, monkeypatch):
    """A leaf past SLICE_ELEMENTS is updated slice by slice (elementwise;
    Adafactor's statistics over the last two axes): the same values."""
    params, grads, _ = _case(3, 3.0)
    outs = []
    for limit in (optimizers.SLICE_ELEMENTS, 5):
        monkeypatch.setattr(optimizers, "SLICE_ELEMENTS", limit)
        opt = optimizers.make(name)
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        st = opt.init(p)
        for step in range(3):
            g = {k: torch.from_numpy(v.copy()) * (step + 1)
                 for k, v in grads.items()}
            p, st, n = opt.update(g, st, p, step)
        outs.append((p, st, float(n)))
    (p0, s0, n0), (p1, s1, n1) = outs
    assert n0 == pytest.approx(n1, rel=1e-6)
    for k in p0:
        _close(p1[k].numpy(), p0[k].numpy(), 1e-6, k)
    for a, b in zip(_leaves(s1), _leaves(s0)):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_optimizer_descends_quadratic(name):
    opt = optimizers.make(name, optimizers.OptConfig(
        name=name, lr=0.1, weight_decay=0.0))
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = opt.init(params)
    for step in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = opt.update(grads, state, params, step)
    assert float(params["w"].abs().max()) < 0.5


def test_adafactor_state_is_factored():
    opt = optimizers.make("adafactor")
    st = opt.init({"w": torch.zeros((64, 32)), "b": torch.zeros((7,))})
    assert st["f"]["w"]["vr"].shape == (64,)
    assert st["f"]["w"]["vc"].shape == (32,)
    assert st["f"]["b"]["v"].shape == (7,)


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = optimizers.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(optimizers.global_norm(clipped)) == pytest.approx(
        1.0, rel=1e-3)


def test_opt_state_from_jax_checks_its_input():
    with pytest.raises(ValueError, match="adamw state has"):
        optimizers.opt_state_from_jax("adamw", {"m": {}}, "cpu")
    with pytest.raises(ValueError, match="want float32"):
        optimizers.opt_state_from_jax(
            "sgdm", {"m": {"w": np.zeros(3, np.float64)}}, "cpu")
