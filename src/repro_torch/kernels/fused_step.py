"""Launcher for the CUDA fused COPML step (csrc/fused_step.cu).

Replaces the TPU kernel `fused_step` of src/repro/kernels/fused_step.py:
one whole Phase 3+4 step after the model encode.  The TPU walks its
(client, row block) grid in order and carries f and the decode fold in
VMEM; Hopper blocks run in parallel, so the step is the persistent
gradient kernel of csrc/coded_gradient.cuh (a ring of bulk-copied X~
slices, each used for both z = X~ W~ and X~^T ghat(z), partials added to
a uint64 accumulator with integer atomics once per client a strip
touches: exact, order-independent) followed by an epilogue kernel, a block
per 32 model elements with warps over the clients (decode fold, gradient,
q_eta scale, TruncPr masked open and rescale, model update).

Bound on an H100: reading X~ once, N * m * d * 4 bytes over 3.35 TB/s
(554 MB, ~0.17 ms at cifar10_case2); everything else is < 1% of the bytes.
The gradient kernel's launch parameters (slice height, ring, accumulator
mode, strips) are kernels/coded_gradient.py plan_args'.

Past plan.max_d(C) the step takes one of two routes (plan.gradient_route):
"cluster", the cluster gradient kernel (csrc/coded_gradient_cluster.cuh:
X~ still read once, each row spread over a thread-block cluster) then the
same epilogue, with its launch parameters from coded_gradient.cluster_args;
or "wide", where coded_gradient.wide_gradient's three field kernels compute
f and `epilogue` runs the same epilogue kernel on it (its int32 instance).
A step's bits are the body's on either.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .coded_gradient import (WIDE_LAUNCHES, cluster_args, plan_args,
                             wide_gradient)
from ..core.field import P
from .plan import MAX_DEGREE, gradient_route

_FN = None
_CLUSTER_FN = None
_EPI = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("fused_step").repro_fused_step
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_int64] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _cluster_fn():
    global _CLUSTER_FN
    if _CLUSTER_FN is None:
        fn = build.load("fused_step").repro_fused_step_cluster
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                       + [ctypes.c_int64] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_int64] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _CLUSTER_FN = fn
    return _CLUSTER_FN


def _epi_fn():
    global _EPI
    if _EPI is None:
        fn = build.load("fused_step").repro_fused_epilogue
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                       + [ctypes.c_int64] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _EPI = fn
    return _EPI


def _check(what: str, shapes: dict, device) -> None:
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}; every "
                             f"operand must be on one cuda device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _epilogue_shapes(nb, d, c, adv_off, dfull, rvec, base, xty, wsh, radd,
                     r0sh) -> dict:
    return {"adv_off": (adv_off, (nb,)), "dfull": (dfull, (nb,)),
            "rvec": (rvec, (nb,)), "base": (base, (nb, d, c)),
            "xty": (xty, (nb, d, c)), "wsh": (wsh, (nb, d, c)),
            "radd": (radd, (nb, d, c)), "r0sh": (r0sh, (nb, d, c))}


def epilogue(f, adv_off, dfull, rvec, base, xty, wsh, radd, r0sh, *,
             q_eta: int, inv2k1: int, k1: int):
    """The fused step's epilogue on the card, on a gradient f (N, d, C)
    of int32 values < p (the wide route's); the other operands as
    ops.fused_step's.  Returns new_w (N, d, C) int32."""
    if f.dim() != 3:
        raise ValueError(f"fused_step epilogue: f must be (N, d, C), got "
                         f"{tuple(f.shape)}")
    nb, d, c = f.shape
    _check("fused_step epilogue", {"f": (f, (nb, d, c)), **_epilogue_shapes(
        nb, d, c, adv_off, dfull, rvec, base, xty, wsh, radd, r0sh)},
        f.device)
    if not (1 <= nb <= 1024 and 0 < k1 < 26) or d * c >= 1 << 31:
        raise ValueError(f"fused_step epilogue: N={nb} (1..1024), d={d}, "
                         f"C={c}, k1={k1}")
    new_w = torch.empty_like(f)
    err = _epi_fn()(f.data_ptr(), adv_off.data_ptr(), dfull.data_ptr(),
                    rvec.data_ptr(), base.data_ptr(), xty.data_ptr(),
                    wsh.data_ptr(), radd.data_ptr(), r0sh.data_ptr(),
                    new_w.data_ptr(), nb, d, c, int(q_eta) % P,
                    int(inv2k1) % P, k1,
                    torch.cuda.current_stream(f.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_step epilogue launch failed: CUDA error "
                           f"{err}")
    WIDE_LAUNCHES["epilogue"] += 1
    return new_w


def fused_step(x, w, coeffs, adv_off, dfull, rvec, base, xty, wsh, radd,
               r0sh, *, q_eta: int, inv2k1: int, k1: int):
    """One fused step on the card; operands as ops.fused_step.  Returns
    (f, new_w), both (N, d, C) int32."""
    nb, m, d = x.shape
    c = w.shape[2]
    _check("fused_step", {"x": (x, (nb, m, d)), "w": (w, (nb, d, c)),
                          "coeffs": (coeffs, (coeffs.shape[0],)),
                          **_epilogue_shapes(nb, d, c, adv_off, dfull, rvec,
                                             base, xty, wsh, radd, r0sh)},
           x.device)
    if not (1 <= nb <= 1024 and m >= 1
            and 1 <= coeffs.shape[0] <= MAX_DEGREE + 1 and 0 < k1 < 26):
        raise ValueError(f"fused_step: N={nb} (1..1024), m={m} (>= 1), degree "
                         f"{coeffs.shape[0] - 1}, k1={k1}")
    route = gradient_route(d, c)
    if route == "wide":
        f = wide_gradient(x, w, coeffs)
        return f, epilogue(f, adv_off, dfull, rvec, base, xty, wsh, radd,
                           r0sh, q_eta=q_eta, inv2k1=inv2k1, k1=k1)
    if route == "cluster":
        plan, launch = cluster_args("fused_step", nb, m, d, c), _cluster_fn()
    else:
        plan, launch = plan_args("fused_step", nb, m, d, c), _fn()
    facc = torch.zeros((nb, d, c), dtype=torch.int64, device=x.device)
    f = torch.empty((nb, d, c), dtype=torch.int32, device=x.device)
    new_w = torch.empty_like(f)
    wt = w.transpose(1, 2).contiguous()          # class-major: a view at C=1
    err = launch(x.data_ptr(), wt.data_ptr(), coeffs.data_ptr(),
                coeffs.shape[0] - 1, adv_off.data_ptr(), dfull.data_ptr(),
                rvec.data_ptr(), base.data_ptr(), xty.data_ptr(),
                wsh.data_ptr(), radd.data_ptr(), r0sh.data_ptr(),
                facc.data_ptr(), f.data_ptr(), new_w.data_ptr(),
                nb, m, d, c, *plan, int(q_eta) % P, int(inv2k1) % P, k1,
                torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_step {route} kernel launch failed: CUDA "
                           f"error {err}")
    if route == "cluster":
        WIDE_LAUNCHES["cluster"] += 1
    return f, new_w
