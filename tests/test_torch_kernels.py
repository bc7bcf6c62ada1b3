"""repro_torch kernels: the plain versions vs the JAX package's kernels,
the CPU dispatch, and the launchers' input checks (the CUDA kernels vs the
plain versions are in tests/test_torch_gpu.py, which runs on a card).

The JAX side runs its Pallas kernels in interpret mode (`force_pallas=True`,
as tests/test_fused_step.py runs them) and its jnp references; every
comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import field as jfield
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import field
from repro_torch.kernels import coded_gradient as cg
from repro_torch.kernels import field_poly as fp
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels import ops, plan, ref

P = field.P
K1 = 8


def _fld(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("mkn", [(5, 37, 11), (1, 8, 33), (20, 130, 3)])
def test_modmatmul_plain_matches_pallas(mkn):
    m, k, n = mkn
    rng = np.random.default_rng(m * k)
    a, b = _fld(rng, m, k), _fld(rng, k, n)
    got = ref.modmatmul(_t(a), _t(b))
    _eq(got, jops.modmatmul(jnp.asarray(a), jnp.asarray(b), force_pallas=True))
    _eq(got, jref.modmatmul(jnp.asarray(a), jnp.asarray(b)))
    _eq(ref.modmatmul(_t(a.T.copy()).t(), _t(b)), got)      # strided view


@pytest.mark.parametrize("bmkn", [(3, 5, 37, 11), (13, 1, 13, 24)])
def test_modmatmul_batched_plain_matches_pallas(bmkn):
    bsz, m, k, n = bmkn
    rng = np.random.default_rng(bsz + k)
    a, b = _fld(rng, bsz, m, k), _fld(rng, bsz, k, n)
    got = ref.modmatmul_batched(_t(a), _t(b))
    _eq(got, jops.modmatmul_batched(jnp.asarray(a), jnp.asarray(b),
                                    force_pallas=True))
    _eq(got, jref.modmatmul_batched(jnp.asarray(a), jnp.asarray(b)))
    # a broadcast row (batch stride 0), as the decode base uses it
    row = _t(a[0])[None].expand(bsz, m, k)
    _eq(ref.modmatmul_batched(row, _t(b)),
        jref.modmatmul_batched(jnp.broadcast_to(jnp.asarray(a[0]),
                                                (bsz, m, k)), jnp.asarray(b)))


@pytest.mark.parametrize("bsz,k,d,c", [(3, 100, 40, 1), (2, 70, 24, 10)])
def test_xty_colsum_model_and_plain_match_pallas(bsz, k, d, c):
    """X^T y as setup forms it: the transposed view of (N, m, d) shares
    times (N, m, C) targets.  The port sends it to the column-sum kernel;
    its numpy model (plan.colsum_model, the kernel's lane sums and split
    combine) and the plain version equal the JAX package's kernel."""
    rng = np.random.default_rng(bsz * k + c)
    x, y = _fld(rng, bsz, k, d), _fld(rng, bsz, k, c)
    xt = _t(x).transpose(1, 2)
    assert mm.path_of(xt, _t(y)) == "colsum"
    want = jops.modmatmul_batched(jnp.swapaxes(jnp.asarray(x), 1, 2),
                                  jnp.asarray(y), force_pallas=True)
    _eq(ref.modmatmul_batched(xt, _t(y)), want)
    launch = plan.colsum_launch(d, c, k, bsz, 132)
    _eq(plan.colsum_model(x.transpose(0, 2, 1), y, launch["kc"])[0], want)


def _operands(rng, n, m, d, c, degree):
    return (_fld(rng, n, m, d), _fld(rng, n, d, c), _fld(rng, degree + 1),
            _fld(rng, n), _fld(rng, n), _fld(rng, n), _fld(rng, n, d, c),
            _fld(rng, n, d, c), _fld(rng, n, d, c), _fld(rng, n, d, c),
            _fld(rng, n, d, c))


@pytest.mark.parametrize("n,c", [(5, 1), (5, 10), (13, 1), (13, 10)])
def test_fused_step_plain_matches_pallas(n, c):
    """Small ragged shapes: m and d not multiples of the JAX kernel's
    8-row/8-column blocks."""
    rng = np.random.default_rng(n * 100 + c)
    m, d = 13, 11
    args = _operands(rng, n, m, d, c, 1)
    kw = dict(q_eta=int(rng.integers(1, P)), inv2k1=jfield.host_inv(1 << K1),
              k1=K1)
    f_t, w_t = ref.fused_step(*map(_t, args), **kw)
    jargs = tuple(jnp.asarray(a) for a in args)
    f_p, w_p = jops.fused_step(*jargs, bm=8, dc=8, force_pallas=True, **kw)
    f_r, w_r = jref.fused_step(*jargs, **kw)
    _eq(f_t, f_p)
    _eq(w_t, w_p)
    _eq(f_t, f_r)
    _eq(w_t, w_r)
    _eq(ref.coded_gradient_matrix(_t(args[0]), _t(args[1]), _t(args[2])),
        jref.coded_gradient_matrix(*jargs[:3]))


def test_cpu_dispatch_uses_plain_versions():
    """CPU tensors go to kernels/ref.py and count no launch."""
    rng = np.random.default_rng(1)
    ops.reset_launches()
    a, b = _t(_fld(rng, 4, 9)), _t(_fld(rng, 9, 6))
    _eq(ops.modmatmul(a, b), ref.modmatmul(a, b))
    _eq(ops.modmatmul_batched(a[None], b[None]),
        ref.modmatmul_batched(a[None], b[None]))
    args = tuple(map(_t, _operands(rng, 5, 7, 6, 2, 1)))
    kw = dict(q_eta=3, inv2k1=field.host_inv(1 << K1), k1=K1)
    for got, want in zip(ops.fused_step(*args, **kw),
                         ref.fused_step(*args, **kw)):
        _eq(got, want)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_kernel_launchers_refuse_cpu_tensors():
    """A launcher takes only CUDA tensors; it never falls back."""
    rng = np.random.default_rng(2)
    a, b = _t(_fld(rng, 4, 9)), _t(_fld(rng, 9, 6))
    with pytest.raises(ValueError, match="not cuda"):
        mm.modmatmul(a, b)
    with pytest.raises(TypeError, match="int32"):
        mm.modmatmul(a.to(torch.int64), b)
    args = tuple(map(_t, _operands(rng, 5, 7, 6, 2, 1)))
    with pytest.raises(ValueError, match="cuda"):
        fs.fused_step(*args, q_eta=3, inv2k1=5, k1=K1)


def test_pick_bm_fits_shared_memory():
    assert fs.plan_args is cg.plan_args      # one gradient body, one plan
    bm = lambda d, c: plan.gradient_plan(plan.MAX_BM, d, c)["bm"]  # noqa: E731
    assert bm(3073, 1) == 8                  # cifar10_case2: ~98 KB a slice
    assert bm(24, 10) == plan.MAX_BM
    with pytest.raises(ValueError):
        bm(60000, 1)


# ragged small shapes: m = 13 and d in {6, 24} are not multiples of the
# JAX kernels' blocks; every JAX Pallas shape is a compile of several
# seconds in interpret mode, so each function takes two that between them
# cover N in {3, 5}, d in {6, 24}, C in {1, 10} and degrees 1 and 3


def _coeffs(rng, degree):
    return _fld(rng, degree + 1)


@pytest.mark.parametrize("n,m,d,c,degree", [(3, 13, 6, 1, 1),
                                            (5, 13, 24, 10, 3)])
def test_coded_gradient_matrix_plain_matches_pallas(n, m, d, c, degree):
    rng = np.random.default_rng(n * d + c + degree)
    x, w, co = _fld(rng, n, m, d), _fld(rng, n, d, c), _coeffs(rng, degree)
    got = ref.coded_gradient_matrix(_t(x), _t(w), _t(co))
    jx, jw, jc = jnp.asarray(x), jnp.asarray(w), jnp.asarray(co)
    _eq(got, jops.coded_gradient_matrix(jx, jw, jc, force_pallas=True))
    _eq(got, jref.coded_gradient_matrix(jx, jw, jc))


@pytest.mark.parametrize("n,m,d,degree", [(3, 13, 24, 1), (5, 13, 6, 3)])
def test_coded_gradient_batched_plain_matches_pallas(n, m, d, degree):
    rng = np.random.default_rng(n * d + degree)
    x, w, co = _fld(rng, n, m, d), _fld(rng, n, d), _coeffs(rng, degree)
    got = ref.coded_gradient_batched(_t(x), _t(w), _t(co))
    jx, jw, jc = jnp.asarray(x), jnp.asarray(w), jnp.asarray(co)
    _eq(got, jops.coded_gradient_batched(jx, jw, jc, force_pallas=True))
    _eq(got, jref.coded_gradient_batched(jx, jw, jc))


@pytest.mark.parametrize("m,d,degree", [(13, 24, 3)])
def test_coded_gradient_plain_matches_pallas(m, d, degree):
    rng = np.random.default_rng(m + d + degree)
    x, w, co = _fld(rng, m, d), _fld(rng, d), _coeffs(rng, degree)
    got = ref.coded_gradient(_t(x), _t(w), _t(co))
    jx, jw, jc = jnp.asarray(x), jnp.asarray(w), jnp.asarray(co)
    _eq(got, jops.coded_gradient(jx, jw, jc, force_pallas=True))
    _eq(got, jref.coded_gradient(jx, jw, jc))


@pytest.mark.parametrize("shape,degree", [((3, 13), 1), ((4099,), 3)])
def test_poly_eval_plain_matches_pallas(shape, degree):
    rng = np.random.default_rng(len(shape) + degree)
    z, co = _fld(rng, *shape), _coeffs(rng, degree)
    got = ref.poly_eval(_t(z), _t(co))
    _eq(got, jops.poly_eval(jnp.asarray(z), jnp.asarray(co),
                            force_pallas=True))
    _eq(got, jref.poly_eval(jnp.asarray(z), jnp.asarray(co)))


def test_cpu_dispatch_of_the_siloed_kernels():
    """The coded-gradient and poly_eval entries take the plain versions on
    CPU tensors and count no launch."""
    rng = np.random.default_rng(4)
    ops.reset_launches()
    x, co = _t(_fld(rng, 3, 13, 6)), _t(_coeffs(rng, 1))
    w, wm = _t(_fld(rng, 3, 6)), _t(_fld(rng, 3, 6, 10))
    _eq(ops.coded_gradient_batched(x, w, co),
        ref.coded_gradient_batched(x, w, co))
    _eq(ops.coded_gradient_matrix(x, wm, co),
        ref.coded_gradient_matrix(x, wm, co))
    _eq(ops.coded_gradient(x[0], w[0], co), ref.coded_gradient(x[0], w[0], co))
    _eq(ops.poly_eval(x, co), ref.poly_eval(x, co))
    # the three coded-gradient forms are views of one another
    _eq(ref.coded_gradient_batched(x, w, co),
        ref.coded_gradient_matrix(x, w[..., None], co)[..., 0])
    _eq(ref.coded_gradient(x[0], w[0], co),
        ref.coded_gradient_batched(x, w, co)[0])
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_siloed_kernel_launchers_refuse_bad_inputs():
    """The coded-gradient and poly_eval launchers take only contiguous
    int32 CUDA tensors of matching shapes; they never fall back."""
    rng = np.random.default_rng(5)
    x, w, co = _t(_fld(rng, 3, 13, 6)), _t(_fld(rng, 3, 6)), _t(_fld(rng, 2))
    with pytest.raises(ValueError, match="cuda"):
        cg.coded_gradient_batched(x, w, co)
    with pytest.raises(ValueError, match="cuda"):
        cg.coded_gradient(x[0], w[0], co)
    with pytest.raises(TypeError, match="int32"):
        cg.coded_gradient_matrix(x.to(torch.int64), w[..., None], co)
    with pytest.raises(ValueError, match="shapes"):
        cg.coded_gradient_matrix(x, w[:, :5, None], co)
    with pytest.raises(ValueError, match="cuda"):
        fp.poly_eval(x, co)
    with pytest.raises(TypeError, match="int32"):
        fp.poly_eval(x.to(torch.int64), co)
    with pytest.raises(ValueError, match=r"\(r\+1,\)"):
        fp.poly_eval(x, co[None])
