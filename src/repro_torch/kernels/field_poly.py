"""Launcher for the CUDA polynomial evaluation (csrc/field_poly.cu).

Replaces the TPU kernel `poly_eval` of src/repro/kernels/field_poly.py:30,
elementwise Horner ghat(z) over F_p in 4096-element VMEM blocks.  Here one
thread evaluates one element with 64-bit products; the input is read
through the tensor's flat index, so any shape goes in unpadded.

Bound on an H100: 8 bytes per element (read z, write the result) over
3.35 TB/s, ~0.11 us per 45,100 elements (the z of one cifar10_case2 step);
at that size a launch costs more than the bytes, which is why the siloed
and fused schedules inline Horner into the gradient kernel instead.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("field_poly").repro_poly_eval
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                                 ctypes.c_int64,
                                                 ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def poly_eval(z, coeffs):
    """sum_t coeffs[t] z^t mod p elementwise on the card; z any shape and
    coeffs (r+1,), contiguous int32 in [0, p) on one cuda device.  Returns
    an int32 tensor of z's shape."""
    if coeffs.dim() != 1 or coeffs.shape[0] < 1:
        raise ValueError(f"poly_eval: coeffs must be (r+1,), got "
                         f"{tuple(coeffs.shape)}")
    for name, t in (("z", z), ("coeffs", coeffs)):
        if t.dtype != torch.int32:
            raise TypeError(f"poly_eval: {name} must be int32, got {t.dtype}")
        if t.device != z.device or t.device.type != "cuda":
            raise ValueError(f"poly_eval: {name} is on {t.device}; both "
                             f"operands must be on one cuda device")
        if not t.is_contiguous():
            raise ValueError(f"poly_eval: {name} must be contiguous")
    if z.numel() >= (1 << 31) * 256:
        raise ValueError(f"poly_eval: {z.numel()} elements exceed the grid")
    out = torch.empty_like(z)
    if z.numel() == 0:
        return out
    err = _fn()(z.data_ptr(), coeffs.data_ptr(), coeffs.shape[0] - 1,
                out.data_ptr(), z.numel(),
                torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"poly_eval kernel launch failed: CUDA error {err}")
    return out
