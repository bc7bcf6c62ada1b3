"""Deterministic synthetic datasets (numpy; real corpora are not available
offline).

  * classification: the paper's (m, d) binary tasks: two Gaussian classes
    with a planted separator (CIFAR-10-scale / GISETTE-scale stand-ins,
    Section V-A).
  * multiclass: C Gaussian clusters with integer labels (MNIST-scale
    stand-in for the one-vs-rest objective).
  * regression: y = x @ w* + noise for the linreg objective.

The same seed gives the same arrays as the JAX package's builders.
"""

from __future__ import annotations

import numpy as np


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
