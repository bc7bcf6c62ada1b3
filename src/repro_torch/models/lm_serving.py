"""Batched decode serving driver: prefill once, decode autoregressively.

Greedy (or sampled) decoding with a fixed-size cache.  Runs on the CUDA
card unless device="cpu" is asked for; with no card and no device it
raises, as every entry point of the port does.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import random as jrandom
from ..core.protocol import resolve_device
from . import model_zoo as MZ
from .config import ModelConfig


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 16
    cache_len: int = 256
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0


def _tree_map2(fn, a, b):
    if isinstance(a, tuple):
        return tuple(_tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _copy_prefill_into_cache(cfg, prefill_caches, caches, prompt_len):
    """Write the prefill-produced K/V (seq = prompt_len) into the serving
    cache (seq = cache_len) at offset 0, in place."""
    def place(full, pref):
        if full.shape == pref.shape:
            return pref
        # same rank; the (only) differing dim is the sequence dim
        for ax, (a, b) in enumerate(zip(full.shape, pref.shape)):
            if a != b:
                full.narrow(ax, 0, b).copy_(pref)
                return full
        return pref
    return _tree_map2(place, caches, prefill_caches)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _as_tensor(x, device, dtype=None):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def prefill_into_cache(cfg: ModelConfig, params, batch: dict,
                       cache_len: int):
    """prefill_step on `batch` (tokens (B, S0) and the frontier, on the
    weights' device), its caches copied into zero caches cache_len long.

    Returns (logits (B, 1, vocab), caches, pos0): pos0 is the position of
    the first decode step (vlm: the n_patches prefix is in the cache)."""
    bm = MZ.build(cfg)
    tokens = batch["tokens"]
    b, s0 = tokens.shape
    logits, pcaches = bm.prefill_step(params, batch)
    caches = MZ.init_cache(cfg, b, cache_len, tokens.device)
    caches = _copy_prefill_into_cache(cfg, pcaches, caches, s0)
    return logits, caches, s0 + (cfg.n_patches if cfg.family == "vlm"
                                 else 0)


def decode_next(cfg: ModelConfig, params, caches, token, pos: int,
                scfg: ServeConfig, key):
    """One decode step of `token` (B, 1) at `pos`, then the next token:
    greedy, or drawn with a subkey split from `key` (sampled).

    Returns (next token (B, 1) int32, caches, key, logits)."""
    logits, caches = MZ.build(cfg).decode_step(params, caches, token, pos)
    lg = logits[:, -1]
    if scfg.greedy:
        nxt = torch.argmax(lg, dim=-1)
    else:
        keys = jrandom.split(key)
        key, sub = keys[0], keys[1]
        nxt = jrandom.categorical(sub, lg / scfg.temperature)
    return nxt.to(torch.int32)[:, None], caches, key, logits


@torch.no_grad()
def generate(cfg: ModelConfig, params, prompts, scfg: ServeConfig,
             frontier=None, device=None):
    """prompts: (B, S0) ints.  Returns (tokens (B, S0+new) int32, stats).

    stats: prefill_s (prefill and the cache copy), decode_s (the
    max_new_tokens - 1 decode steps) and tokens_per_s, each clock read
    after a device synchronise."""
    device = resolve_device(device)
    for name, t in params.items():
        if t.device.type != device.type:
            raise ValueError(f"parameter {name} is on {t.device}, the run "
                             f"on {device}")
    prompts = _as_tensor(prompts, device, torch.int32)
    b, s0 = prompts.shape
    batch = {"tokens": prompts}
    if frontier is not None:
        batch["frontier"] = _as_tensor(frontier, device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches, pos0 = prefill_into_cache(cfg, params, batch,
                                              scfg.cache_len)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    key = jrandom.PRNGKey(scfg.seed)
    tokens = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]]
    t0 = time.perf_counter()
    for i in range(scfg.max_new_tokens - 1):
        nxt, caches, key, _ = decode_next(cfg, params, caches, tokens[-1],
                                          pos0 + i, scfg, key)
        tokens.append(nxt)
    new = torch.cat(tokens, dim=1)
    _sync(device)
    decode_s = time.perf_counter() - t0
    stats = {"prefill_s": prefill_s, "decode_s": decode_s,
             "tokens_per_s": b * (scfg.max_new_tokens - 1) /
             max(decode_s, 1e-9)}
    return torch.cat([prompts, new], dim=1), stats
