"""The coded gradient past d = 58,004 (the cluster and the wide routes),
held to the JAX package on the CPU, bit for bit.

On the card the gradient kernel needs one row of X~ in a block's shared
memory; past plan.max_d(C) the siloed and fused schedules take another
route (plan.gradient_route): up to plan.cluster_max_d(C) at C = 1 the
cluster kernel (each row's column slices over a thread-block cluster, z
summed across it), past that the wide route: Z = X~ W~ on the row-dot
GEMM, ghat(Z) on poly_eval, X~^T ghat(Z) on the column-sum GEMM, then the
fused step's epilogue.  The CPU has no card, so these tests hold both
routes through plan.py's numpy models of those kernels (cluster_model,
wide_model, epilogue_model) against the JAX package's jnp references
(~6 s a call at d = 65,536 on an 8-core x86-64 host, so the shapes are
few and each is computed once), and a wide workload's whole fit, which
runs the plain versions on the CPU, against the JAX package's api.fit,
run live.  The card's own runs of the routes are in
tests/test_torch_gpu_wide.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.kernels import ops as jops
from repro_torch import api
from repro_torch.core import field
from repro_torch.kernels import ops, plan, ref

P = field.P
SMS = 132                           # an H100's SMs: colsum_launch's split
K1 = 18
# clients and coded rows of the model tests: one operand set for each
# (d, C), shared by the gradient and the fused-step tests
N, M = 3, 5


def _fld(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.int64).astype(np.int32)


def _operands(seed, n, m, d, c):
    """x (N, m, d), w (N, d, C) and ghat's coefficients, with x's first
    client and w's first client all p - 1 and a row of x at p - 1 in every
    client: each lane sum at its largest."""
    rng = np.random.default_rng(seed)
    x, w, co = _fld(rng, n, m, d), _fld(rng, n, d, c), _fld(rng, 4)
    x[0] = P - 1
    x[:, -1] = P - 1
    w[0] = P - 1
    return x, w, co


def _step_operands(d, c):
    """The fused step's operands beside _operands(d + c, N, M, d, c)."""
    rng = np.random.default_rng(d - c)
    rows = [_fld(rng, N) for _ in range(3)]          # adv_off, dfull, rvec
    rows[0][1] = 0
    mats = [_fld(rng, N, d, c) for _ in range(5)]    # base xty wsh radd r0sh
    mats[0][0] = P - 1
    kw = dict(q_eta=int(rng.integers(1, P)),
              inv2k1=field.host_inv(1 << K1), k1=K1)
    return rows, mats, kw


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX package's gradient (coded_gradient_batched at C = 1,
    coded_gradient_matrix at C = 10) and fused_step at (N, M, d, C), each
    computed once per (d, C) and shared by every model test here."""
    cache = {}

    def get(d, c):
        if (d, c) not in cache:
            x, w, co = _operands(d + c, N, M, d, c)
            rows, mats, kw = _step_operands(d, c)
            if c == 1:
                grad = jops.coded_gradient_batched(
                    jnp.asarray(x), jnp.asarray(w[..., 0]),
                    jnp.asarray(co))[..., None]
            else:
                grad = jops.coded_gradient_matrix(
                    jnp.asarray(x), jnp.asarray(w), jnp.asarray(co))
            jf, jw = jops.fused_step(*(jnp.asarray(a) for a in (
                x, w, co, *rows, *mats)), **kw)
            cache[d, c] = dict(grad=np.asarray(grad), f=np.asarray(jf),
                               new_w=np.asarray(jw))
        return cache[d, c]
    return get


@pytest.mark.parametrize("c", [1, 10])
def test_route_is_the_body_wherever_its_plan_fits(c):
    """The body up to max_d(C); past it the cluster route up to its reach
    for a (d,) model, the wide route for C > 1 and past the reach."""
    widest = plan.max_d(c)
    reach = plan.cluster_max_d()
    if c == 1:
        assert widest == 58004
        assert 131072 < reach < 1 << 18
    for d in (1, 3073, 40000, widest):
        assert plan.gradient_route(d, c) == "body"
        plan.gradient_plan(156, d, c)             # fits
    for d in (widest + 1, 58005, 65536, reach):
        assert plan.gradient_route(d, c) == ("cluster" if c == 1
                                             else "wide")
        with pytest.raises(ValueError, match="does not fit one row"):
            plan.gradient_plan(156, d, c)
    for d in (reach + 1, 1 << 20):
        assert plan.gradient_route(d, c) == "wide"
        with pytest.raises(ValueError, match="does not fit a column slice"):
            plan.cluster_plan(1, d)


@pytest.mark.parametrize("c", [1, 10])
@pytest.mark.parametrize("d", [58005, 65536])
def test_wide_gradient_model_matches_jax(jax_refs, d, c):
    """The three kernels' numpy models, composed, equal the JAX package's
    coded_gradient_batched (C = 1) / coded_gradient_matrix (C = 10)."""
    x, w, co = _operands(d + c, N, M, d, c)
    # contiguous X~: Z takes the row-dot kernel, X~^T ghat the column-sum one
    assert plan.gemm_path(M, d, 1, c, d, 1) == "rowdot"
    assert plan.gemm_path(d, M, 1, c, 1, d) == "colsum"
    assert plan.rowdot_shape(c, d)["kch"] // 32 <= plan.NO_REDUCE_TERMS
    assert plan.colsum_launch(d, c, M, N, SMS)["kc"] <= plan.NO_REDUCE_TERMS
    got = plan.wide_model(x, w, co, SMS)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  jax_refs(d, c)["grad"])


@pytest.mark.parametrize("c", [1, 10])
@pytest.mark.parametrize("d", [58005, 65536])
def test_wide_fused_step_model_matches_jax(jax_refs, d, c):
    """wide_model then the epilogue's model equal the JAX package's
    fused_step (f and the updated shares); so does the port's CPU
    dispatch."""
    x, w, co = _operands(d + c, N, M, d, c)
    rows, mats, kw = _step_operands(d, c)
    want = jax_refs(d, c)
    f = plan.wide_model(x, w, co, SMS)
    new_w = plan.epilogue_model(f, *rows, *mats, **kw)
    np.testing.assert_array_equal(f.astype(np.int64), want["f"])
    np.testing.assert_array_equal(new_w.astype(np.int64), want["new_w"])
    tf, tw = ops.fused_step(*(torch.from_numpy(a) for a in (x, w, co, *rows,
                                                             *mats)), **kw)
    np.testing.assert_array_equal(tf.numpy(), want["f"])
    np.testing.assert_array_equal(tw.numpy(), want["new_w"])


@pytest.mark.parametrize("k", [None, 8])
@pytest.mark.parametrize("d", [58005, 65536])
def test_cluster_model_matches_jax(jax_refs, d, k):
    """The cluster kernel's numpy model (per-rank partials of z, their sum
    across the cluster, pass 2 in the plan's mode: registers at 16 CTAs,
    shared memory at 8) equals the JAX package's coded_gradient_batched,
    and with the epilogue's model its fused_step, with operands at p - 1;
    every lane sum stays below 2^64 and the cross-rank sum below 2^32."""
    x, w, co = _operands(d + 1, N, M, d, 1)
    rows, mats, kw = _step_operands(d, 1)
    want = jax_refs(d, 1)
    pl = plan.cluster_plan(M, d, 1, k)
    assert pl["mode"] == ("smem" if k == 8 else "reg")
    f, top1, top2 = plan.cluster_model(x, w, co, pl)
    assert top1 < 1 << 64 and top2 < pl["k"] * P < 1 << 32
    np.testing.assert_array_equal(f.astype(np.int64), want["grad"])
    np.testing.assert_array_equal(f.astype(np.int64), want["f"])
    new_w = plan.epilogue_model(f, *rows, *mats, **kw)
    np.testing.assert_array_equal(new_w.astype(np.int64), want["new_w"])


def test_epilogue_model_at_p_minus_1():
    """Every operand p - 1 and N past the 8 warps: the epilogue's sums at
    their largest."""
    n, d, c = 19, 7, 3
    ones = [np.full(n, P - 1, np.int32) for _ in range(3)]
    mats = [np.full((n, d, c), P - 1, np.int32) for _ in range(6)]
    kw = dict(q_eta=P - 1, inv2k1=field.host_inv(1 << K1), k1=K1)
    got = plan.epilogue_model(mats[0], *ones, *mats[1:], **kw)
    t = [torch.from_numpy(a) for a in (mats[0], *ones, *mats[1:])]
    np.testing.assert_array_equal(got.astype(np.int64),
                                  ref.fused_epilogue(*t, **kw).numpy())


WIDE = "quickstart_wide"


@pytest.fixture(scope="module")
def wide_jax_fit():
    """The JAX package's api.fit of the wide workload: quickstart's
    configuration (N = 13, K = 4, T = 1) at d = 65,536 and m = 13, one
    row a client.  Its host memory grows with m * d: the fit's process
    peaks at 6.3 GB (about 20 GB at m = 52) and takes ~55 s on an 8-core
    x86-64 host."""
    wl = dataclasses.replace(japi.get_workload("quickstart"), name=WIDE,
                             m=13, d=65536, iters=2)
    with jax.threefry_partitionable(False):
        res = japi.fit(wl, "copml", "jit", key=0, iters=2)
    return (np.asarray(res.state.w_shares), np.asarray(res.history),
            np.asarray(res.weights))


def test_wide_fit_matches_jax(wide_jax_fit):
    """api.fit of the wide workload on the CPU equals the JAX package's
    api.fit bit for bit.  The CPU runs the plain
    versions (kernels/ref); on the card the same fit takes the cluster
    route (tests/test_torch_gpu_wide.py holds the card's fit to the
    CPU's)."""
    wl = dataclasses.replace(api.get_workload("quickstart"), name=WIDE,
                             m=13, d=65536, iters=2)
    assert plan.gradient_route(wl.d, 1) == "cluster"
    got = api.fit(wl, "copml", "jit", key=0, iters=2, device="cpu")
    shares, history, weights = wide_jax_fit
    np.testing.assert_array_equal(got.state.w_shares.numpy(), shares)
    np.testing.assert_array_equal(got.history, history)
    np.testing.assert_array_equal(got.weights, weights)
