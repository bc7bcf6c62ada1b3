"""Inputs made from the run's seed, on the device, in a few large calls.

The planted-separator task is the port's own synthetic stand-in for the
paper's datasets (`data/pipeline.classification_dataset`: features
N(0, 0.5^2) clipped to [-1, 1], a separator w* ~ N(0, 1/d), labels drawn
from the logistic of margin * sqrt(d) * x.w*), made here with a
`torch.Generator` so that the same seed gives the same arrays without the
program's help.  Every stream is seeded from (seed, purpose), so the
training rows, the queries and the schedules do not depend on one another.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

PURPOSES = ("rows", "queries", "schedule", "keys")


def subseed(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for one stream of a run."""
    if purpose not in PURPOSES:
        raise ValueError(f"unknown purpose {purpose!r}")
    h = hashlib.sha256(f"{int(seed)}/{purpose}/{int(index)}".encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def generator(seed: int, purpose: str, device, index: int = 0):
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, purpose, index))
    return gen


def program_key(seed: int, job: int) -> np.ndarray:
    """The program's (2,) uint32 threefry key of job `job`."""
    s = subseed(seed, "keys", job)
    return np.array([s & 0xFFFFFFFF, (s >> 32) & 0x7FFFFFFF], np.uint32)


def planted_rows(m: int, d: int, margin: float, seed: int, device,
                 purpose: str = "rows"):
    """(x float32 (m, d), y float32 (m,) in {0, 1}) as host arrays."""
    gen = generator(seed, purpose, device)
    w_star = torch.randn(d, generator=gen, device=device,
                         dtype=torch.float64) / np.sqrt(d)
    x = (torch.randn((m, d), generator=gen, device=device) * 0.5).clamp_(
        -1.0, 1.0)
    logits = (x.double() @ w_star) * (margin * np.sqrt(d))
    u = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
    y = (torch.sigmoid(logits) > u).to(torch.float32)
    return x.cpu().numpy(), y.cpu().numpy()


def queries(n: int, d: int, seed: int, device) -> np.ndarray:
    """(n, d) float32 queries from the task's feature distribution."""
    gen = generator(seed, "queries", device)
    x = (torch.randn((n, d), generator=gen, device=device) * 0.5).clamp_(
        -1.0, 1.0)
    return x.cpu().numpy()
