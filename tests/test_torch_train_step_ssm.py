"""test_torch_train_step.py's checks for the state-space, MoE, encoder-
decoder and hybrid families (split off to keep each file's JAX
compilation short); see that file for the tolerances."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_train_step import Case  # noqa: E402

ARCHS = ["falcon-mamba-7b", "qwen3-moe-30b-a3b", "arctic-480b",
         "whisper-tiny", "zamba2-2.7b"]


@pytest.fixture(scope="module")
def cases():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = Case(arch)
        return memo[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_jax(cases, arch):
    cases(arch).check_grads()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_jax(cases, arch):
    cases(arch).check_step()


def test_mamba2_gradient_stays_finite_where_jax_overflows():
    """zamba2's SSD with a strong decay (a_log = 4) over a 128-step chunk:
    exp of the masked upper triangle overflows.  The JAX package masks
    after the exp, so its loss is finite and its gradients NaN; the port
    masks before it: the same loss (float32, rtol 1e-6), finite
    gradients."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from repro.models import model_zoo as jzoo
    from repro_torch.models import model, model_zoo
    from test_torch_train_step import np_batch, np_params  # noqa: E402
    from repro.configs import registry as jregistry
    from repro_torch.configs import registry
    jc = jregistry.smoke_config("zamba2-2.7b").scaled(dtype="float32")
    tc = registry.smoke_config("zamba2-2.7b").scaled(dtype="float32")
    pn = np_params(jc)
    pn["layers/a_log"] = np.full_like(pn["layers/a_log"], 4.0)
    bn = np_batch(jc, s=256)
    (tot, _), g = jax.jit(jax.value_and_grad(
        jzoo.build(jc).loss_fn, has_aux=True))(
        {k: jnp.asarray(v) for k, v in pn.items()},
        {k: jnp.asarray(v) for k, v in bn.items()})
    assert any(np.isnan(np.asarray(v)).any() for v in g.values())
    pt = model.params_from_jax(tc, pn, "cpu")
    names = sorted(pt)
    leaves = {k: pt[k].requires_grad_(True) for k in names}
    tt, _ = model_zoo.build(tc).loss_fn(
        leaves, {k: torch.from_numpy(v) for k, v in bn.items()})
    gt = torch.autograd.grad(tt, [leaves[k] for k in names])
    assert float(tt.detach()) == pytest.approx(float(tot), rel=1e-6)
    assert all(bool(torch.isfinite(x).all()) for x in gt)
