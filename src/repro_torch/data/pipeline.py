"""Deterministic synthetic datasets (real corpora are not available
offline).

  * lm_batch: token streams with Zipfian unigram statistics and a planted
    n-gram structure, so an LM's loss falls; keyed by (seed, step), so a
    restarted run replays the same stream, and host-sliced.
  * classification: the paper's (m, d) binary tasks: two Gaussian classes
    with a planted separator (CIFAR-10-scale / GISETTE-scale stand-ins,
    Section V-A).
  * multiclass: C Gaussian clusters with integer labels (MNIST-scale
    stand-in for the one-vs-rest objective).
  * regression: y = x @ w* + noise for the linreg objective.

The same seed gives the same arrays as the JAX package's builders.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from ..core import random as jrandom
from ..core.protocol import resolve_device


@dataclasses.dataclass(frozen=True)
class LmDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


@functools.lru_cache(maxsize=1)
def _libm_powf():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib.powf


def _trunc_powf(u: np.ndarray, e: np.float32) -> np.ndarray:
    """int32(powf(u, e)) for float32 u > 0, as XLA:CPU computes it (its
    f32 power is the C library's powf).  The float64 power is within a
    float32 ulp of powf, so its integer part is powf's unless it lies
    within two float32 ulps of an integer; those few elements call powf
    itself."""
    r = u.astype(np.float64) ** np.float64(e)
    out = np.floor(r)
    ulp = np.spacing(r.astype(np.float32)).astype(np.float64)
    near = np.abs(r - np.round(r)) <= 2 * ulp
    if near.any():
        powf = _libm_powf()
        out[near] = [np.floor(powf(float(x), float(e))) for x in u[near]]
    return out.astype(np.int32)


def lm_batch(cfg: LmDataConfig, step: int, *, host_slice=None,
             device=None) -> dict:
    """The batch of `step`, deterministic in (seed, step), equal to the
    JAX package's bit for bit (legacy threefry):
    u = uniform(fold_in(PRNGKey(seed), step), (b, s + 1), minval 1e-6),
    tokens int32(u ** (-1 / zipf_a)) clipped to the vocab, each even
    position replaced by its predecessor + 1 (a roll) and clipped again;
    tokens[:, :-1], labels tokens[:, 1:] and a float32 mask of ones.

    host_slice: (start, size) rows for this host (None = all rows): the
    key is folded with `start`.  Computed on the CPU (the float32 power
    must be the C library's), returned on `device`: the CUDA card unless
    device="cpu" is asked for."""
    device = resolve_device(device)
    key = jrandom.fold_in(jrandom.PRNGKey(cfg.seed), step)
    b, s = cfg.global_batch, cfg.seq_len
    if host_slice is not None:
        start, size = host_slice
        key = jrandom.fold_in(key, start)
        b = size
    u = jrandom.uniform(key, (b, s + 1), 1e-6, 1.0).numpy()
    e = np.float32(-1.0 / cfg.zipf_a)
    tokens = np.clip(_trunc_powf(u, e), 0, cfg.vocab - 1)
    even = (np.arange(s + 1) % 2 == 0)[None, :]
    tokens = np.where(even, np.roll(tokens, 1, axis=1) + 1, tokens)
    tokens = torch.from_numpy(np.clip(tokens, 0, cfg.vocab - 1).astype(
        np.int32)).to(device)
    return {"tokens": tokens[:, :-1],
            "labels": tokens[:, 1:],
            "mask": torch.ones((b, s), dtype=torch.float32, device=device)}


def classification_dataset(m: int, d: int, seed: int = 0,
                           margin: float = 2.0, test_m: int = 0):
    """Two-class Gaussian task with a planted separator; features in [-1, 1].

    Returns (X, y[, X_test, y_test]).  Accuracy of float logistic regression
    lands around the paper's 80-97% range depending on `margin`.
    """
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=d) / np.sqrt(d)
    total = m + test_m
    x = np.clip(rng.normal(size=(total, d)) * 0.5, -1, 1)
    logits = x @ w_star * margin * np.sqrt(d)
    y = (1 / (1 + np.exp(-logits)) > rng.uniform(size=total)).astype(
        np.float32)
    if test_m:
        return (x[:m], y[:m], x[m:], y[m:])
    return x[:m], y[:m]


def multiclass_dataset(m: int, d: int, n_classes: int, seed: int = 0,
                       margin: float = 1.4, test_m: int = 0):
    """C Gaussian clusters with planted unit class directions (MNIST-scale
    stand-in for the one-vs-rest objective); features in [-1, 1].

    Returns (X, y[, X_test, y_test]) with y integer class labels in
    [0, C).  `margin` is the cluster-mean norm in noise-std units (0.5):
    argmax accuracy of one-vs-rest logistic regression rises from chance
    toward 1 as margin grows past ~1.
    """
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(n_classes, d))
    mu /= np.linalg.norm(mu, axis=1, keepdims=True)       # unit directions
    total = m + test_m
    y = rng.integers(0, n_classes, size=total)
    x = np.clip(mu[y] * margin * 0.5 + rng.normal(size=(total, d)) * 0.5,
                -1, 1).astype(np.float64)
    y = y.astype(np.int32)
    if test_m:
        return x[:m], y[:m], x[m:], y[m:]
    return x[:m], y[:m]


def regression_dataset(m: int, d: int, seed: int = 0, noise: float = 0.1,
                       test_m: int = 0):
    """Linear-regression task y = x @ w* + noise; features in [-1, 1] and
    |y| small enough for the protocol's 2^lg target quantization."""
    rng = np.random.default_rng(seed)
    w_star = rng.normal(size=d) / np.sqrt(d)
    total = m + test_m
    x = np.clip(rng.normal(size=(total, d)) * 0.5, -1, 1)
    y = (x @ w_star + noise * rng.normal(size=total)).astype(np.float32)
    if test_m:
        return x[:m], y[:m], x[m:], y[m:]
    return x[:m], y[:m]


def split_clients(x, y, n: int):
    """Distribute rows evenly across N clients (paper Section V-A)."""
    idx = np.array_split(np.arange(x.shape[0]), n)
    return [x[i] for i in idx], [y[i] for i in idx]
