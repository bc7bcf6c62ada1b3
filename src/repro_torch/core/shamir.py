"""Shamir T-out-of-N secret sharing over F_p for arbitrary-shape tensors.

Shares are stacked on a leading axis of length N: shares[i] is client i's
share, i.e. h(lambda_i) where h(z) = secret + z*R_1 + ... + z^T * R_T.

Evaluation points lambda_1..lambda_N are public static ints, so the power /
interpolation matrices are computed exactly on the host (and cached on each
device); share generation and reconstruction are then one field GEMM each.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from . import field
from .labels import Opened, Public, Share


def default_eval_points(n: int, offset: int = 1) -> tuple:
    """N distinct public evaluation points (1..N by default)."""
    return tuple(range(offset, offset + n))


@lru_cache(maxsize=None)
def _power_matrix(points: tuple, t: int) -> np.ndarray:
    """P[i, j] = lambda_i^{j+1} mod p, shape (N, T)."""
    out = np.zeros((len(points), t), dtype=np.int64)
    for i, lam in enumerate(points):
        acc = 1
        for j in range(t):
            acc = (acc * (int(lam) % field.P)) % field.P
            out[i, j] = acc
    return out.astype(np.int32)


@lru_cache(maxsize=None)
def _recon_matrix(points: tuple) -> np.ndarray:
    """Lagrange weights at z=0 for the given nodes, shape (1, R)."""
    return field.host_lagrange_coeffs(points, [0])


@lru_cache(maxsize=None)
def _on_device(kind: str, points: tuple, t: int, device: str):
    arr = _power_matrix(points, t) if kind == "power" else \
        _recon_matrix(points)
    return torch.from_numpy(arr).to(device)


def power_matrix(points: Sequence[int], t: int, device) -> Public:
    """The public (N, T) matrix lambda_i^{j+1} mod p on `device`: shares
    are secret + power_matrix @ coefficients."""
    return _on_device("power", tuple(points), t, str(device))


def share(key, secret, t: int, n: int,
          points: Sequence[int] | None = None,
          holders: int | None = None) -> Share:
    """Create N Shamir shares of `secret` with threshold t.

    Returns int32 (N, *secret.shape) on secret's device: shares =
    secret + P @ R with P the public (N, T) power matrix.  `holders` keeps
    only the first `holders` rows; the coefficient draw is the full one, so
    those rows are bit-identical to the full sharing's."""
    if points is None:
        points = default_eval_points(n)
    points = tuple(points)
    assert len(points) == n
    rows = n if holders is None else holders
    if t == 0:
        return secret[None].expand((rows,) + tuple(secret.shape))
    dev = secret.device
    coeffs = field.random_field(key, (t,) + tuple(secret.shape), dev)
    pmat = _on_device("power", points, t, str(dev))[:rows]       # (rows, T)
    mix = field.matmul(pmat, coeffs.reshape(t, -1))             # (rows, numel)
    return field.add_(mix.view((rows,) + tuple(secret.shape)), secret[None])


def recon_weights(points: Sequence[int], subset: Sequence[int]) -> np.ndarray:
    """Host-side (r,) Lagrange weights at z=0 for `subset` of the points."""
    lams = tuple(int(points[i]) for i in subset)
    return _recon_matrix(lams)[0]


def reconstruct(shares: Share, t: int, points: Sequence[int] | None = None,
                subset: Sequence[int] | None = None) -> Opened:
    """Reconstruct the secret from shares (leading axis = clients).

    Any t+1 shares suffice; `subset` selects which client indices to use
    (defaults to the first t+1; "all" interpolates from all N)."""
    n = shares.shape[0]
    if points is None:
        points = default_eval_points(n)
    if subset == "all":
        subset = tuple(range(n))
    elif subset is None:
        subset = tuple(range(t + 1))
    else:
        subset = tuple(subset)[: t + 1]
    assert len(subset) >= t + 1
    r = len(subset)
    lams = tuple(points[i] for i in subset)
    w = _on_device("recon", lams, 0, str(shares.device))         # (1, r)
    sub = shares[: r] if list(subset) == list(range(r)) else \
        shares[torch.tensor(subset, device=shares.device)]
    out = field.matmul(w, sub.reshape(r, -1))
    return out.reshape(shares.shape[1:])


def step_subset_arrays(step_subsets, r: int, weight_fn,
                       device="cpu") -> tuple:
    """Per-step subsets -> (iters, r) int64 gather indices and (iters, r)
    int32 weight rows on `device`, for the dynamic decode paths.

    weight_fn(subset_tuple) -> (r,) int32 public decode/reconstruction row;
    called once per DISTINCT subset (host work is O(#distinct), not
    O(iters))."""
    cache: dict = {}
    idx = np.zeros((len(step_subsets), r), np.int64)
    wts = np.zeros((len(step_subsets), r), np.int32)
    for s, sub in enumerate(step_subsets):
        sub = tuple(int(i) for i in sub)
        assert len(sub) >= r, (
            f"step {s} subset has {len(sub)} < {r} clients")
        sub = sub[:r]
        if sub not in cache:
            cache[sub] = weight_fn(sub)
        idx[s] = sub
        wts[s] = cache[sub]
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wts).to(device))


def reconstruct_dyn(shares: Share, idx, weights) -> Opened:
    """Reconstruct from the clients `idx` (an (r,) index tensor on shares'
    device) with their precomputed `recon_weights` row (r,): the field math
    of `reconstruct` with a static subset, for subsets chosen per step."""
    r = idx.shape[0]
    sub = shares.index_select(0, idx)
    w = torch.as_tensor(weights, dtype=torch.int32, device=shares.device)
    out = field.matmul(w.reshape(1, r), sub.reshape(r, -1))
    return out.reshape(shares.shape[1:])


def share_batch(key, secrets, t: int, n: int,
                points: Sequence[int] | None = None) -> Share:
    """Share J independent secrets (leading axis = owners) in ONE GEMM:
    secrets (J, ...) -> shares (J, N, ...)."""
    return share(key, secrets, t, n, points).transpose(0, 1)


def reshare(key, shares: Share, t: int, n: int,
            points: Sequence[int] | None = None) -> Share:
    """Degree reduction by re-sharing (BGW): every client re-shares its share
    with a fresh degree-t polynomial; the new shares of the secret are the
    lambda-weighted combination of the incoming sub-shares."""
    if points is None:
        points = default_eval_points(n)
    points = tuple(points)
    sub = share_batch(key, shares, t, n, points)   # (owner, holder, ...)
    w = _on_device("recon", points, 0, str(shares.device))      # (1, N)
    out = field.matmul(w, sub.reshape(n, -1))      # interpolate over owners
    return out.reshape(shares.shape)
