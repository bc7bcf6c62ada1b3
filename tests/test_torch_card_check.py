"""train/card_check on the CPU: the card-against-CPU train-step measure
that chip_smoke.py and tests/test_torch_gpu_lm.py apply, run here with the
CPU on both sides (every gap exactly 0) for each optimizer's state shape,
and its seeded state and one-ulp update gap checked by hand."""

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import model, model_zoo
from repro_torch.optim import optimizers
from repro_torch.train import card_check

B, S = 2, 12


def _batch(cfg, gen):
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    batch = {"tokens": tokens[:, :S], "labels": tokens[:, 1:],
             "mask": torch.ones((B, S))}
    fs = model_zoo._frontier_shape(cfg, B)
    if fs is not None:
        batch["frontier"] = 0.5 * torch.randn(fs, generator=gen)
    return batch


# adamw, and arctic's adafactor (factored and vector statistics)
@pytest.mark.parametrize("arch", ["smollm-360m", "arctic-480b"])
def test_cpu_against_itself_gives_zero_gaps(arch):
    cfg = registry.smoke_config(arch).scaled(dtype="float32")
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {k: v.clone() for k, v in params.items()}
    batch = _batch(cfg, torch.Generator().manual_seed(1))
    errs = card_check.card_cpu_step(cfg, params, batch, device="cpu")
    assert set(errs) == {"loss", "grads", "step_loss", "grad_norm",
                         "update", "opt_state"}
    assert all(v == 0.0 for v in errs.values()), errs
    for k in params:                     # the caller's weights unchanged
        assert torch.equal(params[k], before[k]), k
    assert set(card_check.card_cpu_step(cfg, params, batch, False,
                                        device="cpu")) == {"loss", "grads"}


@pytest.mark.parametrize("name", ["adamw", "sgdm", "adafactor"])
def test_seeded_state_is_far_from_zero(name):
    params = {"w": torch.ones((3, 4)), "b": torch.ones(4)}
    grads = {"w": torch.full((3, 4), -2.0), "b": torch.full((4,), 0.5)}
    state = card_check.seeded_state(name, params, grads,
                                    torch.Generator().manual_seed(0))
    init = optimizers.make(name).init(params)

    def walk(got, want, name_, signed):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for n in want:
                walk(got[n], want[n], name_ or n, signed)
            return
        assert got.shape == want.shape and got.dtype == torch.float32
        r = float(grads[name_].abs().max())
        if signed:
            assert float(got.abs().max()) > 0
        else:
            assert bool(((got >= r * r) & (got < 2 * r * r)).all())
    for n in init:
        walk(state[n], init[n], None, n == "m")


def test_update_gap_allows_one_ulp_of_the_new_value():
    old = torch.tensor([1.0, -3.0])
    new = torch.tensor([1.5, -3.5])
    one_ulp = torch.nextafter(new, torch.full_like(new, 10.0))
    assert card_check.update_gap(one_ulp, new, old) == 0.0
    two = new + 4 * (one_ulp - new)
    assert card_check.update_gap(two, new, old) > 0.0
    assert card_check.rel(torch.tensor([1.0, 2.0]),
                          torch.tensor([1.0, 4.0])) == 0.5
