"""Launcher for the CUDA field GEMM (csrc/modmatmul.cu).

Replaces the TPU kernels `modmatmul` and `modmatmul_batched` of
src/repro/kernels/modmatmul.py (7-bit limbs, 16 exact f32 MXU products,
one Barrett reduce per block).  This version multiplies field elements
directly in uint64 on the CUDA cores and reduces with the pseudo-Mersenne
fold of csrc/field.cuh.

Bound on an H100: the main path's GEMMs (Shamir share, LCC encode,
reconstruct, decode base) have M <= 64 and K <= 64 with a huge N, so each
moves ~4 bytes per element of B and of C for a few MACs: memory-bound at
3.35 TB/s.  They take the thin kernel (A staged whole, columns of B in
registers, coalesced 4-byte rows).  X^T y (K = 9019, N = C <= 16, A the
transposed view of the shares) reads 5.54 GB of shares once: it takes the
column-sum kernel, a split-K GEMV whose lanes own columns of the shares and
keep N uint64 sums each in registers.  The MPC baseline's Z = X W (A
K-contiguous, N = C' <= 16) reads 591 MB of shares once: it takes the
row-dot kernel, a GEMV a row of A against B staged in shared memory
(with K split over CTAs, and the splits combined, when the rows are too
few to fill the card: a sharded rank's serving scores).
Serving's scores (M = B <= 128 queries, K = d, N = N C') take the split-K
kernel, which cuts K over enough CTAs to fill the card and combines their
partials.  Everything else (strided B with large M and N) takes the tiled
kernel, which reads operands through their strides and masks ragged edges.
kernels/plan.py makes every choice: gemm_path the kernel, and
thin_launch / colsum_launch / rowdot_launch / splitk_launch each kernel's
instance, splits and grid.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from . import build
from .plan import (colsum_launch, gemm_path, rowdot_launch, rowdot_shape,
                   splitk_launch, thin_launch)

PATHS = ("thin", "colsum", "rowdot", "splitk", "tiled")       # gemm_path's
PATH_LAUNCHES: collections.Counter = collections.Counter()
_FNS: dict = {}
_SLOTS: dict = {}       # (cmax, smem) -> resident rowdot CTAs
_TILED = dict(kmax=0, cols=0, gx=0, groups=0, rpg=0)
# C entry -> (pointers after A's and B's strides, ints, int64s after them)
_ARGS = {"repro_modmatmul": (1, 9, 0), "repro_modmatmul_colsum": (2, 8, 0),
         "repro_modmatmul_rowdot": (2, 10, 1),
         "repro_modmatmul_splitk": (2, 9, 0)}


def _fn(name: str = "repro_modmatmul"):
    """The C entry `name` of the modmatmul library: repro_modmatmul (thin
    and tiled), repro_modmatmul_colsum, _rowdot or _splitk."""
    if name not in _FNS:
        fn = getattr(build.load("modmatmul"), name)
        ptrs, ints, wide = _ARGS[name]
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 3
                       + [ctypes.c_void_p] + [ctypes.c_int64] * 3
                       + [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints
                       + [ctypes.c_int64] * wide + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _rowdot_slots(cmax: int, smem: int) -> int:
    """Resident CTAs of the row-dot kernel's instance at `smem` bytes
    (csrc/modmatmul.cu rowdot_slots), asked once per instance and size."""
    key = (cmax, smem)
    if key not in _SLOTS:
        fn = build.load("modmatmul").repro_modmatmul_rowdot_slots
        fn.argtypes = [ctypes.c_int, ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        slots = ctypes.c_int(0)
        err = fn(cmax, smem, ctypes.byref(slots))
        if err:
            raise RuntimeError(f"modmatmul rowdot occupancy query failed: "
                               f"CUDA error {err}")
        _SLOTS[key] = slots.value
    return _SLOTS[key]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(a, b, batched: bool):
    nd = 3 if batched else 2
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32:
            raise TypeError(f"modmatmul: {name} must be int32, got {t.dtype}")
        if t.dim() != nd:
            raise ValueError(f"modmatmul: {name} must be {nd}-D, got "
                             f"{tuple(t.shape)}")
        if t.device.type != "cuda":
            raise ValueError(f"modmatmul: {name} is on {t.device}, not cuda")
    if a.device != b.device:
        raise ValueError(f"modmatmul: operands on {a.device} and {b.device}")
    if a.shape[-1] != b.shape[-2] or (batched and a.shape[0] != b.shape[0]):
        raise ValueError(f"modmatmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    # grid limits: batch on gridDim.z, M tiles on gridDim.y, 32-bit sizes
    if batched and a.shape[0] > 65535 or a.shape[-2] > 1 << 21 or \
            max(a.shape[-1], b.shape[-1]) >= 1 << 31:
        raise ValueError(f"modmatmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} exceed the kernel's grid")


def path_of(a, b) -> str:
    """The kernel (plan.gemm_path) that takes a (B, M, K) @ (B, K, N)
    product of these shapes and strides: "thin", "colsum", "rowdot",
    "splitk" or "tiled"."""
    return gemm_path(a.shape[1], a.shape[2], b.stride(2), b.shape[2],
                     a.stride(1), a.stride(2))


def modmatmul_batched(a, b):
    """(a[i] @ b[i]) mod p on the card; a (B, M, K), b (B, K, N) int32 in
    [0, p), any strides (a batch stride may be 0).  Returns (B, M, N)."""
    _check(a, b, True)
    bsz, m, k = a.shape
    n = b.shape[2]
    out = torch.empty((bsz, m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    path = path_of(a, b)
    sms = _sms(a.device.index)
    if path == "colsum":
        colsum(a, b, out, colsum_launch(m, n, k, bsz, sms))
    elif path == "rowdot":
        shape = rowdot_shape(n, k)
        rowdot(a, b, out, rowdot_launch(
            m, n, k, bsz, _rowdot_slots(shape["cmax"], shape["smem"])))
    elif path == "splitk":
        splitk(a, b, out, splitk_launch(m, n, k, bsz, sms))
    else:
        launch = thin_launch(m, n, k, bsz, sms) if path == "thin" \
            else _TILED
        err = _fn()(a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(),
                    out.data_ptr(), bsz, m, n, k, launch["kmax"],
                    launch["cols"], launch["gx"], launch["groups"],
                    launch["rpg"],
                    torch.cuda.current_stream(a.device).cuda_stream)
        if err:
            raise RuntimeError(f"modmatmul kernel launch failed: CUDA error "
                               f"{err}")
    PATH_LAUNCHES[path] += 1
    return out


def colsum(a, b, out, launch: dict):
    """The column-sum kernel into `out` (B, M, N) as `launch` (plan.
    colsum_launch's dict) says; a's M-stride must be 1.  Its K splits write
    (splits, B, M, N) partials that a second kernel combines."""
    bsz, m, k = a.shape
    n = b.shape[2]
    part = out
    if launch["splits"] > 1:
        part = torch.empty((launch["splits"], bsz, m, n), dtype=torch.int32,
                           device=a.device)
    err = _fn("repro_modmatmul_colsum")(
        a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(), out.data_ptr(),
        part.data_ptr(), bsz, m, n, k, launch["cmax"], launch["kc"],
        launch["splits"], launch["ctas"],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"modmatmul colsum kernel launch failed: CUDA "
                           f"error {err}")
    return out


def rowdot(a, b, out, launch: dict):
    """The row-dot kernel into `out` (B, M, N) as `launch` (plan.
    rowdot_launch's dict) says; a's K-stride must be 1.  Its K splits, if
    any, write (splits, B, M, N) partials that colsum's combine kernel
    sums."""
    bsz, m, k = a.shape
    n = b.shape[2]
    part = out
    if launch["splits"] > 1:
        part = torch.empty((launch["splits"], bsz, m, n), dtype=torch.int32,
                           device=a.device)
    err = _fn("repro_modmatmul_rowdot")(
        a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(), out.data_ptr(),
        part.data_ptr(), bsz, m, n, k, launch["cmax"], launch["kch"],
        launch["run"], launch["cpb"], launch["splits"], launch["ks"],
        launch["smem"], torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"modmatmul rowdot kernel launch failed: CUDA "
                           f"error {err}")
    return out


def splitk(a, b, out, launch: dict):
    """The split-K kernel into `out` (B, M, N) as `launch` (plan.
    splitk_launch's dict) says.  Its K splits write (splits, B, M, N)
    partials that colsum's combine kernel sums."""
    bsz, m, k = a.shape
    n = b.shape[2]
    part = out
    if launch["splits"] > 1:
        part = torch.empty((launch["splits"], bsz, m, n), dtype=torch.int32,
                           device=a.device)
    err = _fn("repro_modmatmul_splitk")(
        a.data_ptr(), *a.stride(), b.data_ptr(), *b.stride(), out.data_ptr(),
        part.data_ptr(), bsz, m, n, k, launch["bn"], launch["rg"],
        launch["gx"], launch["kc"], launch["splits"],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"modmatmul splitk kernel launch failed: CUDA "
                           f"error {err}")
    return out


def modmatmul(a, b):
    """(a @ b) mod p on the card; a (M, K), b (K, N), any strides."""
    _check(a, b, False)
    return modmatmul_batched(a[None], b[None])[0]
