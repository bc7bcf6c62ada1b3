"""Secure truncation (TruncPr, Catrina & Saxena [37]) on Shamir shares.

Given shares [a] of a fixed-point value a in (-2^{k2-1}, 2^{k2-1}) embedded in
F_p, returns shares [z] with  z = floor(a / 2^{k1}) + s,
P(s = 1) = (a mod 2^{k1}) / 2^{k1}  -- stochastic rounding of a/2^{k1}.

Protocol (passively secure, statistical privacy in the k2 -> log p gap):
  offline: r uniform in [0, 2^{k2}); dealer shares [r] and [r0],
           r0 = r mod 2^{k1}.
  online:  open c = a + 2^{k2-1} + r  (mod p); c0 = c mod 2^{k1};
           [a0] = c0 - [r0];  [z] = ([a] - [a0]) * inv(2^{k1}).
"""

from __future__ import annotations

import math

import torch

from . import field, shamir
from . import random as jrandom
from .labels import Share


def trunc_pr_randomness(key, shape, k1: int, k2: int, share, device="cpu"):
    """The offline, value-INDEPENDENT half of TruncPr: draw r, deal [r], [r0].

    Consumes the key stream exactly as trunc_pr_core does (same split
    arity, same draw shapes, same share calls), which is what lets the
    fused step pre-deal this randomness and stay bit-exact."""
    kr, ks1, ks2 = jrandom.split(key, 3)
    r = jrandom.randint(kr, shape, 0, 1 << k2, device=device)
    r0 = r & ((1 << k1) - 1)
    return share(ks1, r), share(ks2, r0)


def trunc_pr_core(key, a_shares: Share, k1: int, k2: int,
                  share, open_) -> Share:
    """TruncPr's arithmetic, parameterized over the share/open primitives.

    a_shares: (N, ...) shares.  Returns shares of
    floor(a/2^{k1}) + Bernoulli((a mod 2^{k1})/2^{k1})."""
    assert 0 < k1 < k2 < field.P_BITS
    shape = a_shares.shape[1:]
    r_sh, r0_sh = trunc_pr_randomness(key, shape, k1, k2, share,
                                      a_shares.device)
    bias = 1 << (k2 - 1)
    c_sh = field.add(a_shares, field.add(r_sh, torch.full_like(a_shares, bias)))
    c = open_(c_sh)
    c0 = c & ((1 << k1) - 1)
    a0_sh = field.sub(c0[None].expand(r0_sh.shape), r0_sh)
    num = field.sub(a_shares, a0_sh)
    return field.mul_scalar(num, field.host_inv(1 << k1))


def trunc_pr(key, a_shares: Share, k1: int, k2: int, t: int,
             points=None) -> Share:
    """Probabilistic truncation of shared fixed-point values by 2^{k1}."""
    n = a_shares.shape[0]
    if points is None:
        points = shamir.default_eval_points(n)
    return trunc_pr_core(
        key, a_shares, k1, k2,
        share=lambda k, s: shamir.share(k, s, t, n, points),
        open_=lambda c_sh: shamir.reconstruct(c_sh, t, points))


def statistical_gap(k2: int) -> float:
    """kappa = log2 p - k2 bits of statistical hiding."""
    return math.log2(field.P) - k2
