"""repro_torch field, quantization and sharing layers vs the JAX package.

Inputs come from numpy seeds; every comparison is exact (canonical field
values in [0, p), or dequantized int / 2^l in float32).  Randomized layers
(shamir, mpc, truncation) draw from the same key on both sides, under the
legacy threefry layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import field as jfield
from repro.core import lagrange as jlagrange
from repro.core import mpc as jmpc
from repro.core import quantize as jquantize
from repro.core import shamir as jshamir
from repro.core import truncation as jtrunc
from repro_torch.core import (field, lagrange, mpc, quantize, shamir,
                              truncation)
from repro_torch.core import random as jrandom

P = field.P


def _fld(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_elementwise_ops(seed):
    rng = np.random.default_rng(seed)
    a, b = _fld(rng, 513), _fld(rng, 513)
    a[:4] = (0, 1, P - 1, P - 2)
    b[:4] = (P - 1, 0, P - 1, 1)
    ta, tb = _t(a), _t(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _eq(field.add(ta, tb), (a.astype(np.int64) + b) % P)
    inplace = ta.clone()
    assert field.add_(inplace, tb) is inplace
    _eq(inplace, (a.astype(np.int64) + b) % P)
    _eq(field.sub(ta, tb), (a.astype(np.int64) - b) % P)
    _eq(field.neg(ta), jfield.neg(ja))
    _eq(field.mul(ta, tb), jfield.np_mul(a, b))
    _eq(field.mul(ta, tb), jfield.mul(ja, jb))
    c = int(rng.integers(0, 2 ** 40))
    _eq(field.mul_scalar(ta, c), jfield.mul_scalar(ja, c))
    _eq(field.pow_const(ta, 12345), jfield.pow_const(ja, 12345))
    nz = np.where(a == 0, 1, a)
    _eq(field.mul(field.inv(_t(nz)), _t(nz)), np.ones_like(nz))
    for dt in (torch.int32, torch.int64):
        assert field.add(ta, tb).dtype == torch.int32
        assert field.mul(ta.to(dt), tb).dtype == dt


def test_reductions_over_int32_range():
    rng = np.random.default_rng(5)
    t = rng.integers(0, 2 ** 31, size=(4096,), dtype=np.int64)
    t[:6] = (0, 1, P - 1, P, 2 * P - 1, 2 ** 31 - 1)
    tt = _t(t)
    _eq(field.barrett_reduce(tt), t % P)
    _eq(field.fold26(tt), t % P)
    _eq(field.barrett_reduce(tt), jfield.barrett_reduce(jnp.asarray(t, jnp.int32)))


@pytest.mark.parametrize("mkn", [(1, 1, 1), (5, 37, 3), (7, 9000, 2),
                                 (3, 8193, 5), (13, 13, 240)])
def test_matmul_matches_oracles(mkn):
    """The CPU field GEMM (kernels/ref.py) vs the numpy uint64 oracle and
    the JAX package's jnp limb matmul, across the 2^13 float64 chunk."""
    m, k, n = mkn
    rng = np.random.default_rng(k)
    a, b = _fld(rng, m, k), _fld(rng, k, n)
    want = jfield.np_matmul(a, b)
    _eq(field.matmul(_t(a), _t(b)), want)
    _eq(field.matmul(_t(a), _t(b)), jfield.matmul(jnp.asarray(a), jnp.asarray(b)))
    _eq(field.matvec(_t(a), _t(b[:, 0])), want[:, 0])


def test_poly_and_host_helpers():
    rng = np.random.default_rng(3)
    x = _fld(rng, 4, 9)
    coeffs = _fld(rng, 4)
    _eq(field.evaluate_poly(coeffs, _t(x)),
        jfield.evaluate_poly(coeffs, jnp.asarray(x)))
    _eq(field.evaluate_poly_dyn(_t(coeffs), _t(x)),
        jfield.evaluate_poly_dyn(jnp.asarray(coeffs), jnp.asarray(x)))
    xs, ts = (3, 5, 8, 11), (0, 1, 2, 100)
    _eq(field.host_lagrange_coeffs(xs, ts), jfield.host_lagrange_coeffs(xs, ts))
    assert field.host_inv(12345) == jfield.host_inv(12345)
    _eq(lagrange.encode_matrix((9, 10, 11), (1, 2)),
        jlagrange.encode_matrix((9, 10, 11), (1, 2)))


def _lagrange_loop(xs, targets):
    """The plain reference: L[t, j] = prod_{l != j} (z_t - x_l)/(x_j - x_l)
    as a triple loop over Python ints with one pow an entry (a zero
    denominator inverts to 0)."""
    xs = [int(x) % P for x in xs]
    ts = [int(t) % P for t in targets]
    out = np.zeros((len(ts), len(xs)), dtype=np.int64)
    for ti, z in enumerate(ts):
        for j, xj in enumerate(xs):
            num, den = 1, 1
            for l, xl in enumerate(xs):
                if l != j:
                    num = num * ((z - xl) % P) % P
                    den = den * ((xj - xl) % P) % P
            out[ti, j] = num * pow(den, P - 2, P) % P
    return out.astype(np.int32)


_CIFAR = lagrange.default_points(50, 10, 7)       # (alphas, betas)
_GISETTE = lagrange.default_points(50, 16, 1)
LAGRANGE_CASES = {    # (nodes, targets)
    "cifar10_case2.encode": (_CIFAR[1], _CIFAR[0]),
    "cifar10_case2.decode": (_CIFAR[0][:49], _CIFAR[1][:10]),
    "gisette_case1.encode": (_GISETTE[1], _GISETTE[0]),
    "gisette_case1.decode": (_GISETTE[0][:49], _GISETTE[1][:16]),
    "recon_at_zero": (tuple(range(68, 76)), (0,)),
    "recon_all_at_zero": (tuple(range(68, 118)), (0,)),
    "target_on_a_node": ((3, 5, 8, 11), (8, 0, 3, 11, 6)),
    "unsorted_nodes": ((40, 7, 23, 1, 99, 12), (5, 64, 2, 0)),
    "outside_the_field": ((P + 3, -4, 2 ** 70, -P - 9, 2 * P + 1),
                          (-1, P, 2 ** 40 + 3, -2 ** 65, P + 3)),
    "one_node": ((7,), (1, 7, P + 7)),
    "no_targets": ((1, 2, 3), ()),
}


@pytest.mark.parametrize("case", sorted(LAGRANGE_CASES))
def test_host_lagrange_coeffs_equal_the_loop(case):
    """The barycentric form gives the triple loop's (m, n) int32 array,
    element for element: the three configurations' encode and decode
    shapes, z = 0, targets on nodes, unsorted nodes, points outside [0, p)."""
    xs, ts = LAGRANGE_CASES[case]
    got = field.host_lagrange_coeffs(xs, ts)
    assert got.dtype == np.int32 and got.shape == (len(ts), len(xs))
    _eq(got, _lagrange_loop(xs, ts))


@pytest.mark.parametrize("dropped", range(50))
def test_one_straggler_decode_matrices_equal_the_loop(dropped):
    """Every one-straggler subset of N = 50 (R = 49) at both Case 1 and
    Case 2 decode targets."""
    for (alphas, betas), k in ((_CIFAR, 10), (_GISETTE, 16)):
        sub = alphas[:dropped] + alphas[dropped + 1:]
        _eq(lagrange.decode_matrix(sub, betas[:k]),
            _lagrange_loop(sub, betas[:k]))


def test_duplicate_nodes_keep_the_loops_zero_columns():
    """Duplicate nodes (equal mod p) have a zero denominator, which inverts
    to 0 as host_inv(0) does: their columns are 0, the rest is the loop's."""
    xs, ts = (1, 2, 2, 9, 2 + P, 7), (2, 7, 0, 4, P + 9)
    got = field.host_lagrange_coeffs(xs, ts)
    _eq(got, _lagrange_loop(xs, ts))
    assert not got[:, [1, 2, 4]].any()
    _eq(got[1], [0, 0, 0, 0, 0, 1])
    assert got[[2, 3], 0].all()


def test_host_inv_all_matches_host_inv():
    a = np.array([0, 1, 2, P - 1, 12345, 0, 777, P - 2], np.int64)
    _eq(field.host_inv_all(a), [field.host_inv(v) for v in a])
    assert field.host_inv_all(np.zeros(0, np.int64)).shape == (0,)


def test_lcc_encode_decode_match_jax():
    """LCC encode of (K, B, D) blocks + (T, B, D) masks, then decode of the
    blocks from R = K+T encodings (a degree-1 'gradient')."""
    rng = np.random.default_rng(8)
    k, t, n = 3, 2, 7
    alphas, betas = lagrange.default_points(n, k, t)
    blocks, masks = _fld(rng, k, 4, 5), _fld(rng, t, 4, 5)
    enc = lagrange.lcc_encode(_t(blocks), _t(masks), alphas, betas)
    _eq(enc, jlagrange.lcc_encode(jnp.asarray(blocks), jnp.asarray(masks),
                                  alphas, betas))
    sub = alphas[2:2 + k + t]
    _eq(lagrange.lcc_decode(enc[2:2 + k + t], sub, betas, k), blocks)
    padded, pad = lagrange.partition_rows(_t(blocks.reshape(12, 5))[:11], k)
    assert pad == 1 and padded.shape == (k, 4, 5)
    assert lagrange.recovery_threshold(1, k, t) == \
        jlagrange.recovery_threshold(1, k, t)


def test_quantize_ties_in_float32():
    """Ties round half to even in float32: 0.12500000001 is a tie only
    after the float32 cast (float64 scaling would round it up)."""
    x = np.array([0.375, -0.625, 0.12500000001, -0.37500000001, 0.1, -1.0,
                  1.0 / 3.0, 2.5, -2.5, 0.0])
    for lx in (2, 3, 11):
        got = quantize.quantize(x, lx)
        _eq(got, jquantize.quantize(jnp.asarray(x), lx))
        assert got.dtype == torch.int32
        _eq(quantize.dequantize(got, lx),
            jquantize.dequantize(jnp.asarray(got.numpy()), lx))
    assert int(quantize.quantize(np.array([0.12500000001]), 2)[0]) == 0


def _jkey(seed):
    with jax.threefry_partitionable(False):
        return jax.random.PRNGKey(seed)


def _tkey(jk):
    return jrandom.as_key(np.asarray(jk))


@pytest.mark.parametrize("t,n", [(1, 13), (2, 15), (7, 50)])
def test_shamir_share_reconstruct(t, n):
    rng = np.random.default_rng(t)
    secret = _fld(rng, 6, 5)
    pts = tuple(range(20, 20 + n))
    jk = _jkey(t)
    with jax.threefry_partitionable(False):
        jsh = jax.jit(lambda k, s: jshamir.share(k, s, t, n, pts))(
            jk, jnp.asarray(secret))
        jsb = jax.jit(lambda k, s: jshamir.share_batch(k, s, t, n, pts))(
            jk, jnp.asarray(secret))
        jre = jax.jit(lambda k, s: jshamir.reshare(k, s, t, n, pts))(jk, jsh)
    tsh = shamir.share(_tkey(jk), _t(secret), t, n, pts)
    _eq(tsh, jsh)
    _eq(shamir.share(_tkey(jk), _t(secret), t, n, pts, holders=t + 1),
        np.asarray(jsh)[: t + 1])
    _eq(shamir.share_batch(_tkey(jk), _t(secret), t, n, pts), jsb)
    _eq(shamir.reshare(_tkey(jk), tsh, t, n, pts), jre)
    _eq(shamir.reconstruct(tsh, t, pts), secret)
    _eq(shamir.reconstruct(tsh, t, pts, subset="all"), secret)
    sub = tuple(range(n - t - 1, n))
    _eq(shamir.reconstruct(tsh, t, pts, subset=sub), secret)
    _eq(shamir.recon_weights(pts, sub), jshamir.recon_weights(pts, sub))


@pytest.mark.parametrize("mul", ["bh08", "bgw"])
def test_mpc_secure_matmul(mul):
    """X^T y as in the setup: a transposed view of (N, m, d) shares times
    (N, m, C) shares, degree-reduced; then opened."""
    rng = np.random.default_rng(11)
    n, t, m, d, c = 13, 2, 17, 6, 3
    pts = tuple(range(30, 30 + n))
    x, y = _fld(rng, n, m, d), _fld(rng, n, m, c)
    jk = _jkey(4)
    jfn = jmpc.mul_bh08 if mul == "bh08" else jmpc.mul_bgw
    tfn = mpc.mul_bh08 if mul == "bh08" else mpc.mul_bgw
    with jax.threefry_partitionable(False):
        want = jax.jit(lambda k, a, b: jfn(
            k, jnp.swapaxes(a, 1, 2), b, t, matmul=True, points=pts))(
                jk, jnp.asarray(x), jnp.asarray(y))
        want_open = jax.jit(lambda w: jmpc.open_shares(w, t, pts))(want)
    got = tfn(_tkey(jk), _t(x).transpose(1, 2), _t(y), t, matmul=True,
              points=pts)
    _eq(got, want)
    _eq(mpc.open_shares(got, t, pts), want_open)
    _eq(mpc.mul_public(_t(x), 7), jmpc.mul_public(jnp.asarray(x), 7))


@pytest.mark.parametrize("shape", [(5,), (4, 3)])
def test_trunc_pr(shape):
    rng = np.random.default_rng(2)
    n, t, k1, k2 = 13, 1, 9, 24
    pts = tuple(range(40, 40 + n))
    a = _fld(rng, n, *shape)
    jk = _jkey(6)
    with jax.threefry_partitionable(False):
        want = jax.jit(lambda k, x: jtrunc.trunc_pr(k, x, k1, k2, t, pts))(
            jk, jnp.asarray(a))
        jr, jr0 = jax.jit(lambda k: jtrunc.trunc_pr_randomness(
            k, shape, k1, k2, lambda kk, s: jshamir.share(kk, s, t, n, pts)))(
                jk)
    _eq(truncation.trunc_pr(_tkey(jk), _t(a), k1, k2, t, pts), want)
    tr, tr0 = truncation.trunc_pr_randomness(
        _tkey(jk), shape, k1, k2, lambda k, s: shamir.share(k, s, t, n, pts))
    _eq(tr, jr)
    _eq(tr0, jr0)
    assert truncation.statistical_gap(k2) == jtrunc.statistical_gap(k2)
