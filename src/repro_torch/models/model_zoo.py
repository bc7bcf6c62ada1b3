"""Public model API: build(cfg) -> init, prefill and decode steps, and
decode caches.

Everything here is shape-polymorphic over (batch, seq).  The training
half of the JAX package's module (cross_entropy, loss_fn, train_step,
input_specs) comes with the LM training slice.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from ..core.protocol import resolve_device
from . import model as M
from .config import ModelConfig


def _frontier_shape(cfg: ModelConfig, batch: int):
    if cfg.family == "encdec":
        return (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        return (batch, cfg.n_patches, cfg.d_model)
    return None


# ---------------------------------------------------------------- cache init

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero decode caches, in the JAX package's layout:
    dense / vlm / moe: (K, V), each (L, B, max_seq, Hkv, hd);
    ssm: (conv (L, B, K-1, di), state (L, B, di, N) float32);
    hybrid: ((conv, state) by (group, layer), (K, V) by group);
    encdec: (K, V, cross K, cross V), the cross ones encoder_seq long.
    On the card unless device="cpu" is asked for."""
    device = resolve_device(device)

    def mk(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    L, hkv, hd, dt = cfg.n_layers, cfg.n_kv, cfg.hd, cfg.torch_dtype
    f32 = torch.float32
    if cfg.family in ("dense", "vlm", "moe"):
        return (mk((L, batch, max_seq, hkv, hd), dt),
                mk((L, batch, max_seq, hkv, hd), dt))
    if cfg.family == "ssm":
        conv = mk((L, batch, cfg.ssm_conv - 1, cfg.d_inner), dt)
        h = mk((L, batch, cfg.d_inner, cfg.ssm_state), f32)
        return (conv, h)
    if cfg.family == "hybrid":
        g, a = cfg.n_layers // cfg.attn_every, cfg.attn_every
        conv = mk((g, a, batch, cfg.ssm_conv - 1, cfg.d_inner), dt)
        nh = cfg.mamba2_heads
        h = mk((g, a, batch, nh, cfg.d_inner // nh, cfg.ssm_state), f32)
        kv = (mk((g, batch, max_seq, hkv, hd), dt),
              mk((g, batch, max_seq, hkv, hd), dt))
        return ((conv, h), kv)
    if cfg.family == "encdec":
        return (mk((L, batch, max_seq, hkv, hd), dt),
                mk((L, batch, max_seq, hkv, hd), dt),
                mk((L, batch, cfg.encoder_seq, hkv, hd), dt),
                mk((L, batch, cfg.encoder_seq, hkv, hd), dt))
    raise ValueError(cfg.family)


# --------------------------------------------------------------------- steps

@dataclasses.dataclass(frozen=True)
class BuiltModel:
    cfg: ModelConfig
    init_params: Any
    prefill_step: Any
    decode_step: Any


def build(cfg: ModelConfig) -> BuiltModel:

    @torch.no_grad()
    def prefill_step(params, batch):
        """Forward pass producing the last position's logits + decode
        caches."""
        tokens = batch["tokens"]
        h, caches, _ = M.forward(cfg, params, tokens,
                                 frontier=batch.get("frontier"))
        logits = M.logits_from_h(params, h[:, -1:])
        return logits, caches

    @torch.no_grad()
    def decode_step(params, caches, tokens, pos: int):
        """One new token against the caches at position pos (the caches
        are updated in place and returned)."""
        h, new_caches, _ = M.forward(cfg, params, tokens, caches=caches,
                                     pos=pos)
        logits = M.logits_from_h(params, h)
        return logits, new_caches

    return BuiltModel(
        cfg=cfg,
        init_params=functools.partial(M.init_params, cfg),
        prefill_step=prefill_step,
        decode_step=decode_step,
    )
