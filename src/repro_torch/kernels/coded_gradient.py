"""Launcher for the CUDA coded gradient (csrc/coded_gradient.cu).

Replaces the TPU kernels `coded_gradient` (:120), `coded_gradient_matrix`
(:183) and `coded_gradient_batched` (:215) of
src/repro/kernels/coded_gradient.py: f[n] = X~[n]^T ghat(X~[n] W~[n]), the
COPML hot loop of the siloed schedule.  The TPU walks a sequential
(client, row block) grid and revisits the output block in VMEM; Hopper
blocks run in parallel, so the gradient kernel (csrc/coded_gradient.cuh,
the same body the fused step runs) stages each (bm, d) slice of X~ in
shared memory once for both z = X~ W~ and X~^T ghat(z), adds its reduced
partials to a uint64 accumulator with integer atomics, and a second kernel
writes the accumulator mod p.  The three entries below are views of that
one launch: a (d,) model is C = 1, the single-client form N = 1.

Bound on an H100: reading X~ once, N * m * d * 4 bytes over 3.35 TB/s
(554 MB, ~0.17 ms at cifar10_case2, for C = 1 and C = 10 alike).  The
slice height bm is the largest that keeps a block's shared memory near
100 KB, so two blocks share an SM and one block's loads overlap the other's
arithmetic.  One row of X~ must fit a block's shared memory: d + C above
~58 K raises (the TPU kernel chunks d instead).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

SMEM_TARGET = 100 * 1024       # bytes of X~ slice per block
SMEM_MAX = 227 * 1024          # an H100 block's dynamic shared memory
MAX_BM = 64                    # rows per block: pass-2 sums of <= 64 terms

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("coded_gradient").repro_coded_gradient
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def pick_bm(d: int, c: int) -> int:
    """Rows of X~ per block: as many as fit SMEM_TARGET, at least 1."""
    bm = max(1, min(MAX_BM, SMEM_TARGET // (4 * (d + c))))
    if 4 * bm * (d + c) > SMEM_MAX:
        raise ValueError(f"coded gradient: d={d}, C={c} does not fit one "
                         f"row of X~ in shared memory")
    return bm


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
    if tuple(w.shape[:2]) != (nb, d) or coeffs.shape[0] < 1:
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
    bm = pick_bm(d, c)
    facc = torch.zeros((nb, d, c), dtype=torch.int64, device=x.device)
    err = _fn()(x.data_ptr(), w.data_ptr(), coeffs.data_ptr(),
                coeffs.shape[0] - 1, facc.data_ptr(), f.data_ptr(), nb, m, d,
                c, bm, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"coded_gradient kernel launch failed: CUDA error "
                           f"{err}")
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
