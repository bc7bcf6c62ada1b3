"""Optimizers (plain torch on dicts of tensors): AdamW, SGD-momentum and
factored Adafactor, the JAX package's optim/optimizers.py.

Adafactor matters at full scale: arctic-480b's unfactored AdamW float32
states (~5.8 TB) fit no card; the factored second moment (row and column
statistics) keeps optimizer memory near O(params / d).

Each optimizer is (init(params) -> state, update(grads, state, params,
step) -> (params, state, grad_norm)).  The arithmetic follows the JAX
package's types step by step: the clip scales in float32 and casts back
to the gradient's type; b1^t, b2^t and t^-0.8 are float32 tensor
operations; weight decay applies to leaves of rank >= 2; the new value
rounds back to the parameter's type.

`update` writes the new parameters and state into the tensors it was
given and returns them (the JAX trainer donates both to its step), and
it updates a leaf slice by slice over its leading axes, so a large
leaf's float32 temporaries stay at one slice.  The update is
elementwise within a slice (Adafactor's statistics reduce only over the
last two axes), so the values are those of the whole-leaf update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.protocol import resolve_device

#: elements of a leaf's float32 temporaries an update slice may hold
SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    momentum: float = 0.9
    clip_norm: float = 1.0


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _flat_slices(numel: int):
    """Slices of a flattened elementwise leaf, SLICE_ELEMENTS long."""
    for s in range(0, max(numel, 1), SLICE_ELEMENTS):
        yield slice(s, min(numel, s + SLICE_ELEMENTS))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    summed in sorted-name order (jax's tree order over a dict), a large
    leaf slice by slice."""
    total = None
    for name in sorted(tree):
        flat = tree[name].reshape(-1)
        for sl in _flat_slices(flat.numel()):
            x = flat[sl].float()
            s = torch.sum(x * x)
            total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), norm): the
    scale is applied in float32 and each gradient cast back to its own
    type, in place.  Returns the same dict and the norm."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    for g in grads.values():
        flat = g.view(-1)
        for sl in _flat_slices(flat.numel()):
            flat[sl] = (flat[sl].float() * scale).to(g.dtype)
    return grads, norm


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _step_t(step, device) -> torch.Tensor:
    """step.astype(float32) + 1 as a 0-dim float32 tensor on `device`."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device, dtype=torch.float32) + 1.0
    return _f32(float(step) + 1.0, device)


def _slices(shape: tuple, keep: int):
    """Index tuples over the leading axes of `shape`, leaving the last
    `keep` axes whole: () (the whole leaf) when it has at most
    SLICE_ELEMENTS elements, else one index tuple a slice."""
    lead = shape[:len(shape) - keep]
    if not lead or int(np.prod(shape, dtype=np.int64)) <= SLICE_ELEMENTS:
        yield ()
        return
    yield from np.ndindex(*lead)


def adamw(cfg: OptConfig) -> Optimizer:
    def init(params: dict) -> dict:
        return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()}}

    def update(grads: dict, state: dict, params: dict, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        dev = gnorm.device
        t = _step_t(step, dev)
        bc1 = 1.0 - torch.pow(_f32(cfg.b1, dev), t)
        bc2 = 1.0 - torch.pow(_f32(cfg.b2, dev), t)
        for k in sorted(params):
            p, g, m, v = (params[k].view(-1), grads[k].view(-1),
                          state["m"][k].view(-1), state["v"][k].view(-1))
            decay = params[k].dim() >= 2
            for sl in _flat_slices(p.numel()):
                gf = g[sl].float()
                ms = cfg.b1 * m[sl] + (1 - cfg.b1) * gf
                vs = cfg.b2 * v[sl] + (1 - cfg.b2) * gf * gf
                upd = cfg.lr * (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps)
                pf = p[sl].float()
                if decay:
                    upd = upd + cfg.lr * cfg.weight_decay * pf
                p[sl] = (pf - upd).to(p.dtype)
                m[sl] = ms
                v[sl] = vs
        return params, state, gnorm

    return Optimizer(init, update)


def sgdm(cfg: OptConfig) -> Optimizer:
    def init(params: dict) -> dict:
        return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)
                      for k, p in params.items()}}

    def update(grads: dict, state: dict, params: dict, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        for k in sorted(params):
            p, g, m = (params[k].view(-1), grads[k].view(-1),
                       state["m"][k].view(-1))
            for sl in _flat_slices(p.numel()):
                ms = cfg.momentum * m[sl] + g[sl].float()
                p[sl] = (p[sl].float() - cfg.lr * ms).to(p.dtype)
                m[sl] = ms
        return params, state, gnorm

    return Optimizer(init, update)


def adafactor(cfg: OptConfig) -> Optimizer:
    """Factored second moment; no first moment, no float32 master copy."""

    def init(params: dict) -> dict:
        def make(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"f": {k: make(p) for k, p in params.items()}}

    def update(grads: dict, state: dict, params: dict, step):
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        dev = gnorm.device
        beta = 1.0 - torch.pow(_step_t(step, dev), -0.8)
        one_beta = 1.0 - beta
        for k in sorted(params):
            p, g, s = params[k], grads[k], state["f"][k]
            if p.dim() < 2:
                gf = g.float()
                v = beta * s["v"] + one_beta * (gf * gf + 1e-30)
                upd = cfg.lr * gf / (torch.sqrt(v) + cfg.eps)
                p.copy_((p.float() - upd).to(p.dtype))
                s["v"].copy_(v)
                continue
            for idx in _slices(tuple(p.shape), 2):
                gf = g[idx].float()
                g2 = gf * gf + 1e-30
                vr = beta * s["vr"][idx] + one_beta * torch.mean(g2, dim=-1)
                vc = beta * s["vc"][idx] + one_beta * torch.mean(g2, dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :] /
                    torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True),
                                    1e-30)[..., None]) + cfg.eps
                pf = p[idx].float()
                upd = cfg.lr * gf / denom + cfg.lr * cfg.weight_decay * pf
                p[idx] = (pf - upd).to(p.dtype)
                s["vr"][idx] = vr
                s["vc"][idx] = vc
        return params, state, gnorm

    return Optimizer(init, update)


def make(name: str, cfg: OptConfig | None = None) -> Optimizer:
    cfg = cfg or OptConfig(name=name)
    return {"adamw": adamw, "sgdm": sgdm, "adafactor": adafactor}[name](cfg)


def opt_state_from_jax(cfg_or_name, state_np: dict, device=None) -> dict:
    """The JAX package's optimizer state (numpy float32 arrays) as the
    port's, on the card unless device="cpu": adamw {"m", "v"}, sgdm
    {"m"}, adafactor {"f": {name: {"vr", "vc"} or {"v"}}}, each leaf a
    float32 tensor.  cfg_or_name: a ModelConfig (its .optimizer) or the
    optimizer's name."""
    device = resolve_device(device)
    name = getattr(cfg_or_name, "optimizer", cfg_or_name)
    want = {"adamw": {"m", "v"}, "sgdm": {"m"}, "adafactor": {"f"}}[name]
    if set(state_np) != want:
        raise ValueError(f"{name} state has {sorted(want)}, got "
                         f"{sorted(state_np)}")

    def carry(x, what):
        if isinstance(x, dict):
            return {k: carry(v, f"{what}/{k}") for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype != np.float32:
            raise ValueError(f"{what}: dtype {arr.dtype}, want float32")
        return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)

    return {k: carry(v, k) for k, v in state_np.items()}
