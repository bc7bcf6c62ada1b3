"""Lagrange Coded Computing (LCC) encode/decode -- the heart of COPML.

Dataset X (quantized, in F_p) is partitioned into K row-blocks X_1..X_K.
With T random mask blocks Z_{K+1}..Z_{K+T}, the Lagrange polynomial

    u(z) = sum_k X_k * l_k(z) + sum_{k=K+1..K+T} Z_k * l_k(z)

(through public points beta_1..beta_{K+T}) is evaluated at public points
alpha_1..alpha_N, giving client i its coded slice  X~_i = u(alpha_i)  of size
|X|/K.  Any T colluding clients learn nothing; any polynomial f of degree D
applied pointwise to coded slices can be decoded from R = D*(K+T-1)+1
evaluations.

Alphas/betas are public static ints, so encoding and decoding are a field
GEMM against a host-computed coefficient matrix.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import field


def recovery_threshold(r: int, k: int, t: int) -> int:
    """Minimum #evaluations to decode: (2r+1)(K+T-1)+1 (deg f = 2r+1)."""
    return (2 * r + 1) * (k + t - 1) + 1


def default_points(n: int, k: int, t: int) -> tuple:
    """Disjoint public evaluation points: betas = 1..K+T, alphas = K+T+1..K+T+N."""
    betas = tuple(range(1, k + t + 1))
    alphas = tuple(range(k + t + 1, k + t + 1 + n))
    return alphas, betas


def encode_matrix(alphas: Sequence[int], betas: Sequence[int]) -> np.ndarray:
    """(N, K+T) public coefficient matrix  E[i, k] = l_k(alpha_i)."""
    return field.host_lagrange_coeffs(betas, alphas)


def decode_matrix(alphas_subset: Sequence[int], betas_targets: Sequence[int]) -> np.ndarray:
    """(K, R) public matrix  D[k, j] = prod_{l != j} (beta_k - a_l)/(a_j - a_l)."""
    return field.host_lagrange_coeffs(alphas_subset, betas_targets)


def lcc_encode(blocks, mask_blocks, alphas: Sequence[int], betas: Sequence[int]):
    """Encode (K, B, D) data blocks + (T, B, D) masks -> (N, B, D) coded slices.

    Works equally on secret *shares* of the blocks (encoding is linear)."""
    e = torch.from_numpy(encode_matrix(alphas, betas)).to(blocks.device)
    return _lcc_encode_with(e, blocks, mask_blocks)


def _lcc_encode_with(e, blocks, mask_blocks):
    """lcc_encode against an (N, K+T) encode matrix `e` already on the
    blocks' device (a caller that encodes many times builds it once)."""
    stacked = torch.cat([blocks, mask_blocks], dim=0)        # (K+T, B, D)
    kt = stacked.shape[0]
    coded = field.matmul(e, stacked.reshape(kt, -1))
    return coded.reshape((e.shape[0],) + stacked.shape[1:])


def lcc_decode(evals, subset_alphas: Sequence[int], betas: Sequence[int], k: int):
    """Decode h(beta_1..beta_K) from R evaluations h(alpha_j), j in subset.

    evals: (R, ...) field tensor.  Returns (K, ...) decoded per-block values."""
    r = evals.shape[0]
    d = torch.from_numpy(decode_matrix(subset_alphas, betas[:k])).to(
        evals.device)
    out = field.matmul(d, evals.reshape(r, -1))
    return out.reshape((k,) + evals.shape[1:])


def partition_rows(x, k: int):
    """Split rows into K equal blocks, padding with zero rows if needed.

    Returns (blocks (K, m_pad/K, ...), pad_rows)."""
    m = x.shape[0]
    per = -(-m // k)
    pad = per * k - m
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], dim=0)
    return x.reshape((k, per) + tuple(x.shape[1:])), pad
