"""Launcher for the CUDA coded gradient (csrc/coded_gradient.cu).

Replaces the TPU kernels `coded_gradient` (:120), `coded_gradient_matrix`
(:183) and `coded_gradient_batched` (:215) of
src/repro/kernels/coded_gradient.py: f[n] = X~[n]^T ghat(X~[n] W~[n]), the
Phase 3 of the sharded ranks and proc workers.  The TPU walks a sequential
(client, row block) grid and revisits the output block in VMEM; Hopper
blocks run in parallel, so the gradient kernel (csrc/coded_gradient.cuh,
the same body the fused step runs) is persistent: each CTA walks a strip
of (bm, d) slices of X~ that a ring of bulk copies brings into shared
memory one slice ahead, uses each slice for both z = X~ W~ and
X~^T ghat(z), and adds its partials to a uint64 accumulator once per
client; a second kernel writes the accumulator mod p.  The three entries
below are views of that one launch: a (d,) model is C = 1, the
single-client form N = 1.

Bound on an H100: reading X~ once, N * m * d * 4 bytes over 3.35 TB/s
(554 MB, ~0.17 ms at cifar10_case2, for C = 1 and C = 10 alike).  Every
launch parameter comes from `launch_args` (kernels/plan.py's
gradient_plan and strip_run): bm = 8 and two ~98 KB stages at d = 3073,
C = 1, one strip per resident CTA.

The kernel needs one row of X~ in a block's shared memory, so past
plan.max_d(C) (58,004 at C = 1) the gradient takes another route
(plan.gradient_route; the TPU kernel chunks d instead).  Up to
plan.cluster_max_d(), at C = 1, `cluster_gradient` runs the cluster
kernel (csrc/coded_gradient_cluster.cuh): a thread-block cluster holds
each row's column slices in its CTAs' shared memory and sums z across
them, so X~ is still read once (0.61 ms bound at N = 50, m = 156,
d = 65,536; 2.05 GB).  Past that, or at C > 1, `wide_gradient` runs
Z = X~ W~ on modmatmul's row-dot kernel, ghat(Z) on poly_eval and
X~^T ghat(Z) on the column-sum kernel; it reads X~ twice.  WIDE_LAUNCHES
counts the cluster gradients ("cluster", fused steps included), the wide
gradients ("gradient": one each of the three launches) and the fused
step's epilogues on a wide gradient ("epilogue").
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import build
from . import field_poly as _fp
from . import modmatmul as _mm
from .plan import (MAX_DEGREE, cluster_plan, gradient_plan, gradient_route,
                   strip_run)

MODES = {"reg": 0, "smem": 1, "atomic": 2}     # csrc GradMode
WIDE_STEPS = ("gradient", "epilogue", "cluster")
WIDE_LAUNCHES: collections.Counter = collections.Counter()

_FN = None
_CLUSTER_FN = None
_SLOTS: dict = {}       # (library, ept, C == 1, smem) -> resident CTAs
_CLUSTERS: dict = {}    # (library, ept, smem, k) -> resident clusters


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("coded_gradient").repro_coded_gradient
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                       + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _slots(lib: str, ept: int, c: int, smem: int) -> int:
    """Resident CTAs of the gradient kernel's instance in library `lib`
    (csrc/coded_gradient.cuh grad_slots), asked once per instance and
    shared-memory size."""
    key = (lib, ept, c == 1, smem)
    if key not in _SLOTS:
        fn = getattr(build.load(lib), f"repro_{lib}_slots")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        slots = ctypes.c_int(0)
        err = fn(ept, c, smem, ctypes.byref(slots))
        if err:
            raise RuntimeError(f"{lib}: gradient kernel occupancy query "
                               f"failed: CUDA error {err}")
        _SLOTS[key] = slots.value
    return _SLOTS[key]


def _cluster_fn():
    global _CLUSTER_FN
    if _CLUSTER_FN is None:
        fn = build.load("coded_gradient").repro_coded_gradient_cluster
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
                       + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _CLUSTER_FN = fn
    return _CLUSTER_FN


def _clusters(lib: str, ept: int, smem: int, k: int) -> int:
    """Resident clusters of k CTAs of the cluster kernel's instance in
    library `lib` (csrc/coded_gradient_cluster.cuh cluster_slots), asked
    once per instance, shared-memory size and k."""
    key = (lib, ept, smem, k)
    if key not in _CLUSTERS:
        fn = getattr(build.load(lib), f"repro_{lib}_cluster_slots")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        clusters = ctypes.c_int(0)
        err = fn(ept, 1, smem, k, ctypes.byref(clusters))
        if err:
            raise RuntimeError(f"{lib}: cluster gradient occupancy query "
                               f"failed: CUDA error {err}")
        _CLUSTERS[key] = clusters.value
    return _CLUSTERS[key]


def cluster_args(lib: str, nb: int, m: int, d: int, c: int,
                 k: int | None = None) -> tuple:
    """(bm, stages, mode, ept, k, cw, slot, smem, run, clusters): every
    launch parameter of the cluster gradient kernel in library `lib`, from
    plan.cluster_plan (at cluster size `k` when given) and plan.strip_run
    over the resident clusters."""
    pl = cluster_plan(m, d, c, k)
    slots = _clusters(lib, pl["ept"], pl["smem"], pl["k"])
    run, clusters = strip_run(nb * -(-m // pl["bm"]), slots)
    return (pl["bm"], pl["stages"], MODES[pl["mode"]], pl["ept"], pl["k"],
            pl["cw"], pl["slot"], pl["smem"], run, clusters)


def plan_args(lib: str, nb: int, m: int, d: int, c: int) -> tuple:
    """(bm, stages, mode, ept, sbytes, smem, run, ctas): every launch
    parameter of the gradient kernel in library `lib` ("coded_gradient"
    or "fused_step"), from plan.gradient_plan and plan.strip_run."""
    pl = gradient_plan(m, d, c)               # cached: one plan per shape
    slots = _slots(lib, pl["ept"], c, pl["smem"])
    run, ctas = strip_run(nb * -(-m // pl["bm"]), slots)
    return (pl["bm"], pl["stages"], MODES[pl["mode"]], pl["ept"],
            pl["sbytes"], pl["smem"], run, ctas)


def coded_gradient_matrix(x, w, coeffs):
    """f[n] = x[n]^T ghat(x[n] @ w[n]) mod p on the card; x (N, m, d),
    w (N, d, C), coeffs (r+1,), all contiguous int32 in [0, p) on one
    cuda device.  Returns (N, d, C) int32."""
    if x.dim() != 3 or w.dim() != 3 or coeffs.dim() != 1:
        raise ValueError(f"coded gradient: x (N, m, d), w (N, d, C), coeffs "
                         f"(r+1,); got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(coeffs.shape)}")
    nb, m, d = x.shape
    c = w.shape[2]
    if tuple(w.shape[:2]) != (nb, d) or not 1 <= coeffs.shape[0] <= \
            MAX_DEGREE + 1:
        raise ValueError(f"coded gradient: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, coeffs {tuple(coeffs.shape)}")
    for name, t in (("x", x), ("w", w), ("coeffs", coeffs)):
        if t.dtype != torch.int32:
            raise TypeError(f"coded gradient: {name} must be int32, got "
                            f"{t.dtype}")
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"coded gradient: {name} is on {t.device}; "
                             f"every operand must be on one cuda device")
        if not t.is_contiguous():
            raise ValueError(f"coded gradient: {name} must be contiguous")
    if nb > 65535 or max(m, d, c) >= 1 << 31:
        raise ValueError(f"coded gradient: N={nb} (<= 65535), m={m}, d={d}, "
                         f"C={c} exceed the kernel's grid")
    f = torch.empty((nb, d, c), dtype=torch.int32, device=x.device)
    if f.numel() == 0:
        return f
    if m == 0:
        return f.zero_()
    route = gradient_route(d, c)
    if route == "wide":
        return wide_gradient(x, w, coeffs)
    if route == "cluster":
        return cluster_gradient(x, w, coeffs)
    plan = plan_args("coded_gradient", nb, m, d, c)
    facc = torch.zeros((nb, d, c), dtype=torch.int64, device=x.device)
    wt = w.transpose(1, 2).contiguous()          # class-major: a view at C=1
    err = _fn()(x.data_ptr(), wt.data_ptr(), coeffs.data_ptr(),
                coeffs.shape[0] - 1, facc.data_ptr(), f.data_ptr(), nb, m, d,
                c, *plan, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"coded_gradient kernel launch failed: CUDA error "
                           f"{err}")
    return f


def cluster_gradient(x, w, coeffs, k: int | None = None):
    """f[n] = x[n]^T ghat(x[n] @ w[n]) mod p on the cluster kernel, operands
    as coded_gradient_matrix's (checked there; m >= 1) with C = 1 (the
    plan raises otherwise), at cluster size `k` when given
    (plan.cluster_plan's otherwise).  Returns (N, d, 1) int32."""
    nb, m, d = x.shape
    c = w.shape[2]
    plan = cluster_args("coded_gradient", nb, m, d, c, k)
    facc = torch.zeros((nb, d, c), dtype=torch.int64, device=x.device)
    f = torch.empty((nb, d, c), dtype=torch.int32, device=x.device)
    wt = w.transpose(1, 2).contiguous()          # class-major: a view at C=1
    err = _cluster_fn()(x.data_ptr(), wt.data_ptr(), coeffs.data_ptr(),
                        coeffs.shape[0] - 1, facc.data_ptr(), f.data_ptr(),
                        nb, m, d, c, *plan,
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"coded_gradient cluster kernel launch failed: "
                           f"CUDA error {err}")
    WIDE_LAUNCHES["cluster"] += 1
    return f


def wide_gradient(x, w, coeffs):
    """The wide route: f[n] = x[n]^T ghat(x[n] @ w[n]) mod p from three
    launches of the field kernels, operands as coded_gradient_matrix's
    (x contiguous, so Z takes the row-dot kernel and the transposed view
    the column-sum kernel up to C = 16).  Returns (N, d, C) int32."""
    z = _mm.modmatmul_batched(x, w)                      # (N, m, C)
    g = _fp.poly_eval(z, coeffs)
    f = _mm.modmatmul_batched(x.transpose(1, 2), g)      # (N, d, C)
    WIDE_LAUNCHES["gradient"] += 1
    return f


def coded_gradient_batched(x, w, coeffs):
    """The (d,) model form: x (N, m, d), w (N, d) -> (N, d)."""
    if w.dim() != 2:
        raise ValueError(f"coded_gradient_batched: w must be (N, d), got "
                         f"{tuple(w.shape)}")
    return coded_gradient_matrix(x, w[..., None], coeffs)[..., 0]


def coded_gradient(x, w, coeffs):
    """One client: x (m, d), w (d,) -> (d,)."""
    if x.dim() != 2 or w.dim() != 1:
        raise ValueError(f"coded_gradient: x (m, d), w (d,); got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    return coded_gradient_matrix(x[None], w[None, :, None], coeffs)[0, :, 0]
