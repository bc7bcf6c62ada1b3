"""Kernel dispatch and launch counts.

A tensor on the CPU goes to the plain torch version in kernels/ref.py; a
CUDA tensor goes to the hand-written kernel, or the launcher raises.  There
is no fallback from a kernel to its plain version and no tuning knob.

LAUNCHES counts the kernel launches of each op (CPU calls count nothing),
so a run can show that its main path went through the kernels;
gemm_path_counts breaks the field GEMM's launches down by kernel path.
Past d = 58,004 (plan.gradient_route) a coded gradient or fused step
launches no body of the gradient kernel but the cluster kernel or the wide
route's field kernels: it counts in wide_counts, not in LAUNCHES.
core/random.py launches the threefry kernel itself (kernels/threefry.py):
threefry_counts shows its launches by entry.
"""

from __future__ import annotations

import collections

from . import coded_gradient as _cg
from . import field_poly as _fp
from . import fused_step as _fs
from . import modmatmul as _mm
from . import ref
from . import threefry as _tf
from .plan import gradient_route

KERNELS = ("modmatmul", "modmatmul_batched", "fused_step",
           "coded_gradient_batched", "coded_gradient_matrix",
           "coded_gradient", "poly_eval")
GRADIENT_KERNELS = ("fused_step", "coded_gradient_batched",
                    "coded_gradient_matrix", "coded_gradient")
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
    _mm.PATH_LAUNCHES.clear()
    _cg.WIDE_LAUNCHES.clear()
    _tf.LAUNCHES.clear()


def launch_counts() -> dict:
    return {k: LAUNCHES[k] for k in KERNELS}


def gemm_path_counts() -> dict:
    """Launches of modmatmul[_batched] by plan.gemm_path ("thin", "colsum",
    "rowdot", "splitk", "tiled") since the last reset."""
    return {p: _mm.PATH_LAUNCHES[p] for p in _mm.PATHS}


def wide_counts() -> dict:
    """Since the last reset: "cluster", the cluster route's gradients (a
    coded gradient or a fused step on the cluster kernel); "gradient", the
    wide route's (each one launch of the row-dot GEMM, poly_eval and the
    column-sum GEMM; the GEMMs also count in gemm_path_counts); and
    "epilogue", the fused step's epilogue launched on a wide one."""
    return {s: _cg.WIDE_LAUNCHES[s] for s in _cg.WIDE_STEPS}


def gradient_counts() -> dict:
    """Coded gradients since the last reset, by route: each body kernel's
    launches under its name in launch_counts ("fused_step" and the three
    "coded_gradient*" entries), and wide_counts' "cluster", "gradient"
    and "epilogue".  The body and the cluster kernel read X~ once a
    gradient, the wide route twice."""
    return dict({k: LAUNCHES[k] for k in GRADIENT_KERNELS}, **wide_counts())


def threefry_counts() -> dict:
    """Launches of the threefry kernel since the last reset, by entry:
    "randint" (one key), "randint_keys" (a row a key; one launch per 64
    rows) and "bits32".  A draw on the CPU counts nothing."""
    return {e: _tf.LAUNCHES[e] for e in _tf.ENTRIES}


def _count_gradient(name: str, d: int, c: int) -> None:
    """One launch of `name`'s gradient kernel, unless (d, C) took the
    cluster or the wide route (counted in wide_counts)."""
    if gradient_route(d, c) == "body":
        LAUNCHES[name] += 1


def modmatmul(a, b):
    """(a @ b) mod p; a (M, K), b (K, N) int32 field tensors."""
    if a.device.type == "cpu":
        return ref.modmatmul(a, b)
    out = _mm.modmatmul(a, b)
    LAUNCHES["modmatmul"] += 1
    return out


def modmatmul_batched(a, b):
    """(a[i] @ b[i]) mod p over a leading batch axis; a (B, M, K),
    b (B, K, N).  On the card a strided view (e.g. a transpose) is read
    in place."""
    if a.device.type == "cpu":
        return ref.modmatmul_batched(a, b)
    out = _mm.modmatmul_batched(a, b)
    LAUNCHES["modmatmul_batched"] += 1
    return out


def poly_eval(z, coeffs):
    """Elementwise ghat(z) over F_p; z any shape, coeffs (r+1,)."""
    if z.device.type == "cpu":
        return ref.poly_eval(z, coeffs)
    out = _fp.poly_eval(z, coeffs)
    LAUNCHES["poly_eval"] += 1
    return out


def coded_gradient(x, w, coeffs):
    """f = x^T ghat(x w) for one client; x (m, d), w (d,)."""
    if x.device.type == "cpu":
        return ref.coded_gradient(x, w, coeffs)
    out = _cg.coded_gradient(x, w, coeffs)
    _count_gradient("coded_gradient", x.shape[-1], 1)
    return out


def coded_gradient_batched(x, w, coeffs):
    """f[n] = x[n]^T ghat(x[n] w[n]) for every client; x (N, m, d),
    w (N, d): the sharded ranks' and proc workers' Phase 3 for a vector
    model."""
    if x.device.type == "cpu":
        return ref.coded_gradient_batched(x, w, coeffs)
    out = _cg.coded_gradient_batched(x, w, coeffs)
    _count_gradient("coded_gradient_batched", x.shape[-1], 1)
    return out


def coded_gradient_matrix(x, w, coeffs):
    """The same for a matrix model w (N, d, C); returns (N, d, C)."""
    if x.device.type == "cpu":
        return ref.coded_gradient_matrix(x, w, coeffs)
    out = _cg.coded_gradient_matrix(x, w, coeffs)
    _count_gradient("coded_gradient_matrix", x.shape[-1], w.shape[-1])
    return out


def fused_step(x, w, coeffs, adv_off, dfull, rvec, base, xty, wsh, radd,
               r0sh, *, q_eta: int, inv2k1: int, k1: int):
    """One COPML Phase 3+4 step (post model-encode).

    x: (N, m, d) coded slices; w: (N, d, C) coded models; coeffs: (r+1,)
    ghat coefficients; adv_off / dfull / rvec: (N,) corruption offsets,
    zero-scattered decode row, and open row; base / xty / wsh / radd /
    r0sh: (N, d, C) decode base, X^T y shares, model shares, TruncPr
    [r] + bias, and [r0].  Returns (f, new_w): the per-client coded
    gradients and the updated model shares."""
    args = (x, w, coeffs, adv_off, dfull, rvec, base, xty, wsh, radd, r0sh)
    kw = dict(q_eta=q_eta, inv2k1=inv2k1, k1=k1)
    if x.device.type == "cpu":
        return ref.fused_step(*args, **kw)
    out = _fs.fused_step(*args, **kw)
    _count_gradient("fused_step", x.shape[-1], w.shape[-1])
    return out
