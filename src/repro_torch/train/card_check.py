"""One train step on the CUDA card against the same step on the CPU.

From the same weights and batch (CPU tensors), `card_cpu_step` takes
loss_fn's loss and gradients, and one train_step from a seeded optimizer
state, on both devices, and returns each quantity's gap as max |card -
cpu| / max |cpu|.  chip_smoke.py's phase 13 (c) and the card tests of
tests/test_torch_gpu_lm.py hold the port to it.

The seeded state is far from zero (`seeded_state`), so that one update is
smooth in the gradient: from zero moments adamw's update is lr x
sign(g), which turns a rounding-sized gradient gap into a full step.  The
update is read as a difference of rounded parameters, so two updates a
rounding apart can land one float32 ulp of the new value apart:
`update_gap` allows that ulp an element.
"""

from __future__ import annotations

import torch

from ..models import model_zoo as MZ
from ..optim import optimizers
from .checkpoint import flatten


def rel(got, want) -> float:
    """max |got - want| / max |want|, on the CPU in float32."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if got.shape != want.shape:
        raise ValueError(f"shapes {tuple(got.shape)} != {tuple(want.shape)}")
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def update_gap(new_card, new_cpu, old) -> float:
    """max |new_card - new_cpu| / max |new_cpu - old|, one float32 ulp of
    the new value (|new_cpu| 2^-23) allowed an element."""
    new_card, new_cpu, old = (t.detach().float().cpu()
                              for t in (new_card, new_cpu, old))
    gap = ((new_card - new_cpu).abs() - new_cpu.abs() * 2.0 ** -23)
    return float(gap.clamp_min(0).max()
                 / (new_cpu - old).abs().max().clamp_min(1e-30))


def seeded_state(optimizer: str, params: dict, grads: dict,
                 gen: torch.Generator) -> dict:
    """The optimizer's state for `params` (CPU), far from zero: with r a
    leaf's max |gradient|, first moments ~ N(0, r^2) and second-moment
    statistics (adamw's v, adafactor's factors) in [r^2, 2 r^2)."""
    state = optimizers.make(optimizer).init(params)

    def fill(node, name, signed):
        if isinstance(node, dict):
            return {n: fill(v, name or n, signed) for n, v in node.items()}
        r = float(grads[name].abs().max()) + 1e-12
        if signed:
            return torch.randn(node.shape, generator=gen) * r
        return (1.0 + torch.rand(node.shape, generator=gen)) * r * r
    return {n: fill(sub, None, n == "m") for n, sub in state.items()}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


# the step's number (adamw's bias corrections, adafactor's decay) and
# seeded_state's seed
STEP, SEED = 3, 5


def card_cpu_step(cfg, params: dict, batch: dict, with_step: bool = True,
                  device="cuda") -> dict:
    """loss_fn's loss and gradients (and with `with_step` one train_step
    at STEP from seeded_state) on the CPU and on `device` (the card), from
    copies of `params` and `batch` (CPU tensors, left unchanged).  Returns
    the gaps: "loss", "grads" (the worst leaf), and with the step
    "step_loss", "grad_norm", "update" (update_gap, the worst leaf) and
    "opt_state" (the worst leaf)."""
    bm = MZ.build(cfg)
    outs, state0 = [], None
    for dev in ("cpu", device):
        # copies: train_step updates its parameters and state in place
        p = _to(params, dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        tot, _, grads = MZ.value_and_grads(bm.loss_fn, p, b)
        out = dict(tot=tot.detach(), grads=grads)
        if with_step:
            if state0 is None:
                state0 = seeded_state(cfg.optimizer, params, grads,
                                      torch.Generator().manual_seed(SEED))
            p, state, met = bm.train_step(p, _to(state0, dev), b, STEP)
            out.update(loss=met["loss"], gnorm=met["grad_norm"], new=p,
                       state=state)
        outs.append(out)
        del p
    w, c = outs
    errs = {"loss": rel(c["tot"], w["tot"]),
            "grads": max(rel(c["grads"][k], w["grads"][k])
                         for k in w["grads"])}
    if with_step:
        errs["step_loss"] = rel(c["loss"], w["loss"])
        errs["grad_norm"] = rel(c["gnorm"], w["gnorm"])
        errs["update"] = max(update_gap(c["new"][k], w["new"][k], params[k])
                             for k in params)
        errs["opt_state"] = max(rel(a, b) for a, b in zip(
            flatten(c["state"]), flatten(w["state"])))
    return errs
