"""Public model API: build(cfg) -> init, train, prefill and decode steps,
input specs and decode caches.

Everything here is shape-polymorphic over (batch, seq).  `train_step`
updates the parameters and optimizer state in place and returns them (the
JAX package's trainer donates both to its jitted step); `prefill_step` and
`decode_step` run without autograd.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import meshutil
from ..core.protocol import resolve_device
from ..optim import optimizers
from . import model as M
from .config import ModelConfig, ShapeConfig

# the mesh axes a batch is split over (sharding/partition)
BATCH_AXES = ("pod", "data")

LOSS_CHUNK = 0            # 0 = full logits; >0 = seq-chunked cross-entropy


def cross_entropy(params, h, labels, mask, *, chunk: int = 0):
    """Next-token cross-entropy from hidden states, optionally chunked over
    the sequence: sum of the masked negative log-likelihoods over sum of
    the mask (at least 1).  A chunk's logits are recomputed in backward
    (torch.utils.checkpoint), so only one chunk's (B, chunk, V) logits are
    alive at a time; the sums are carried chunk by chunk, as the JAX
    package's scan carries them."""
    if chunk and h.shape[1] > chunk and h.shape[1] % chunk == 0:
        num = torch.zeros((), dtype=torch.float32, device=h.device)
        den = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo in range(0, h.shape[1], chunk):
            sl = slice(lo, lo + chunk)
            args = (params["embed"], h[:, sl], labels[:, sl], mask[:, sl])
            if torch.is_grad_enabled():
                n, d = checkpoint(_ce_chunk, *args, use_reentrant=False)
            else:
                n, d = _ce_chunk(*args)
            num, den = num + n, den + d
        return num / torch.clamp_min(den, 1.0)
    num, den = _ce_chunk(params["embed"], h, labels, mask)
    return num / torch.clamp_min(den, 1.0)


def _ce_chunk(embed, h, labels, mask):
    logits = M.logits_from_h({"embed": embed}, h).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return torch.sum(nll), torch.sum(mask)


def _frontier_shape(cfg: ModelConfig, batch: int):
    if cfg.family == "encdec":
        return (batch, cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        return (batch, cfg.n_patches, cfg.d_model)
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins (no memory) for every model input of a
    shape: train tokens / labels int32 and mask float32 (B, S); prefill
    tokens (B, S); decode tokens (B, 1); the frontier (whisper frames,
    vlm patches) in the model's type except for decode."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    out = {}
    if shape.kind == "train":
        out["tokens"] = meta((b, s), torch.int32)
        out["labels"] = meta((b, s), torch.int32)
        out["mask"] = meta((b, s), torch.float32)
    elif shape.kind == "prefill":
        out["tokens"] = meta((b, s), torch.int32)
    else:                                        # decode: one new token
        out["tokens"] = meta((b, 1), torch.int32)
    fs = _frontier_shape(cfg, b)
    if fs is not None and shape.kind != "decode":
        out["frontier"] = meta(fs, cfg.torch_dtype)
    return out


# ---------------------------------------------------------------- cache init

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Zero decode caches, in the JAX package's layout:
    dense / vlm / moe: (K, V), each (L, B, max_seq, Hkv, hd);
    ssm: (conv (L, B, K-1, di), state (L, B, di, N) float32);
    hybrid: ((conv, state) by (group, layer), (K, V) by group);
    encdec: (K, V, cross K, cross V), the cross ones encoder_seq long.
    On the card unless device="cpu" (or "meta", for shapes alone) is
    asked for."""
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

def value_and_grads(loss_fn, params: dict, batch: dict) -> tuple:
    """(total, loss, grads) of `loss_fn(params, batch) -> (total, loss)`,
    differentiated in total; grads in the parameters' types, contiguous
    (the optimizer updates them through flat views)."""
    names = sorted(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        tot, loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(tot, [leaves[k] for k in names])
    return tot.detach(), loss.detach(), \
        {k: g.contiguous() for k, g in zip(names, grads)}


@dataclasses.dataclass(frozen=True)
class BuiltModel:
    cfg: ModelConfig
    init_params: Any
    train_step: Any
    prefill_step: Any
    decode_step: Any
    loss_fn: Any


def build(cfg: ModelConfig, opt_cfg: Optional[optimizers.OptConfig] = None,
          microbatch: int = 0, loss_chunk: int = LOSS_CHUNK) -> BuiltModel:
    opt = optimizers.make(cfg.optimizer, opt_cfg)

    def loss_fn(params, batch):
        """(loss + 0.01 * aux, loss): the cross-entropy and the MoE
        load-balance term."""
        h, _, aux = M.forward(cfg, params, batch["tokens"],
                              frontier=batch.get("frontier"),
                              collect_cache=False)
        loss = cross_entropy(params, h, batch["labels"], batch["mask"],
                             chunk=loss_chunk)
        return loss + 0.01 * aux, loss

    def grad_fn(params, batch):
        """(grads in the parameters' types, loss)."""
        _, loss, grads = value_and_grads(loss_fn, params, batch)
        return grads, loss

    def train_step(params, opt_state, batch, step):
        """One step: gradients (accumulated in float32 over microbatches
        and divided by their count when the batch is larger than
        `microbatch`), then the optimizer's update, in place.  Returns
        (params, opt_state, {"loss", "grad_norm"})."""
        b = batch["tokens"].shape[0]
        if microbatch and b > microbatch:
            n = b // microbatch
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(n):
                sl = slice(i * microbatch, (i + 1) * microbatch)
                g, l = grad_fn(params, {
                    k: meshutil.maybe_constrain(v[sl], BATCH_AXES)
                    for k, v in batch.items()})
                for k in grads:
                    grads[k] += g[k]
                loss = loss + l
                del g
            for g in grads.values():
                g /= n
            loss = loss / n
        else:
            grads, loss = grad_fn(params, batch)
        params, opt_state, gnorm = opt.update(grads, opt_state, params,
                                              step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

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
        train_step=train_step,
        prefill_step=prefill_step,
        decode_step=decode_step,
        loss_fn=loss_fn,
    )
