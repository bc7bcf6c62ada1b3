"""Share-level MPC primitives (paper Appendix C).

All values are Shamir-shared with threshold T across N clients; share
tensors carry the client axis first: (N, ...).

* add / sub / mul-by-public-constant: LOCAL (no communication).
* mul (share x share) needs degree reduction:
    - BGW [2]:   local product -> re-share -> recombine.
    - BH08 [3]:  offline pair ([rho]_T, [rho]_2T); online mask, open, re-mask.
"""

from __future__ import annotations

from typing import Sequence

from ..kernels import ops
from . import field, shamir
from . import random as jrandom
from .labels import Opened, Share


def add(xs: Share, ys: Share) -> Share:
    return field.add(xs, ys)


def sub(xs: Share, ys: Share) -> Share:
    return field.sub(xs, ys)


def mul_public(xs: Share, c: int) -> Share:
    return field.mul_scalar(xs, c)


def add_public(xs: Share, c: int) -> Share:
    """Add a public constant: by convention added to every share (the
    constant is embedded as the degree-0 coefficient on all shares)."""
    return field.add(xs, int(c) % field.P)


def _local_product(xs, ys, matmul: bool):
    """Per-client product; matmul=True is one batched field GEMM over the
    client axis (xs may be a strided view, e.g. a transpose)."""
    if matmul:
        return ops.modmatmul_batched(xs, ys)
    return field.mul(xs, ys)


def mul_bgw(key, xs: Share, ys: Share, t: int, *, matmul: bool = False,
            points: Sequence[int] | None = None) -> Share:
    """BGW multiplication: local product (degree 2T shares) + re-share.

    Requires N >= 2T+1.  If matmul=True, xs:(N,A,B) @ ys:(N,B,C)."""
    n = xs.shape[0]
    assert n >= 2 * t + 1, "BGW needs N >= 2T+1"
    prod = _local_product(xs, ys, matmul)
    return shamir.reshare(key, prod, t, n, points)


def mul_bh08(key, xs: Share, ys: Share, t: int, *, matmul: bool = False,
             points: Sequence[int] | None = None) -> Share:
    """[BH08] multiplication with an offline random pair.

    Offline: rho random; [rho]_T and [rho]_2T dealt.
    Online:  open d = x*y - rho from degree-2T shares (needs 2T+1 of them),
             output [rho]_T + d  (local add of a now-public value)."""
    n = xs.shape[0]
    assert n >= 2 * t + 1, "BH08 needs N >= 2T+1 to open the 2T-degree mask"
    if points is None:
        points = shamir.default_eval_points(n)
    prod = _local_product(xs, ys, matmul)  # (N, ...) degree-2T shares
    k_rho, k_t, k_2t = jrandom.split(key, 3)
    rho = field.random_field(k_rho, prod.shape[1:], prod.device)
    rho_t = shamir.share(k_t, rho, t, n, points)
    rho_2t = shamir.share(k_2t, rho, 2 * t, n, points)
    masked = field.sub(prod, rho_2t)
    opened = shamir.reconstruct(masked, 2 * t, points)
    return field.add(rho_t, opened[None])


def open_shares(xs: Share, t: int, points: Sequence[int] | None = None,
                subset: Sequence[int] | None = None) -> Opened:
    """Publicly reconstruct a shared value (e.g. the final model w^(J))."""
    return shamir.reconstruct(xs, t, points, subset)
