"""Launcher for the CUDA polynomial evaluation (csrc/field_poly.cu).

Replaces the TPU kernel `poly_eval` of src/repro/kernels/field_poly.py:30,
elementwise Horner ghat(z) over F_p in 4096-element VMEM blocks.  Here
plan.poly_launch picks one of two kernels by length: one thread an
element while that fits one wave of blocks (a short input is a launch and
a round trip), else a grid-stride loop over one wave with 8 elements in
flight a thread and the coefficients in shared memory; both take a lazy
reduction a step.  The input is read through the tensor's flat index, so
any shape goes in unpadded.

Bound on an H100: 8 bytes per element (read z, write the result) over
3.35 TB/s: 0.160 ms at 2^26 elements, ~0.11 us per 45,100 (the z of one
cifar10_case2 step), where a launch costs more than the bytes -- which is
why the coded-gradient kernels and the fused step inline Horner into the
gradient kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .plan import MAX_DEGREE, poly_launch

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("field_poly").repro_poly_eval
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                                 ctypes.c_int64, ctypes.c_int,
                                                 ctypes.c_int,
                                                 ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def poly_eval(z, coeffs):
    """sum_t coeffs[t] z^t mod p elementwise on the card; z any shape and
    coeffs (r+1,), contiguous int32 in [0, p) on one cuda device.  Returns
    an int32 tensor of z's shape."""
    if coeffs.dim() != 1 or not 1 <= coeffs.shape[0] <= MAX_DEGREE + 1:
        raise ValueError(f"poly_eval: coeffs must be (r+1,) with r <= "
                         f"{MAX_DEGREE}, got {tuple(coeffs.shape)}")
    for name, t in (("z", z), ("coeffs", coeffs)):
        if t.dtype != torch.int32:
            raise TypeError(f"poly_eval: {name} must be int32, got {t.dtype}")
        if t.device != z.device or t.device.type != "cuda":
            raise ValueError(f"poly_eval: {name} is on {t.device}; both "
                             f"operands must be on one cuda device")
        if not t.is_contiguous():
            raise ValueError(f"poly_eval: {name} must be contiguous")
    out = torch.empty_like(z)
    if z.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    launch = poly_launch(z.numel(), sms)
    err = _fn()(z.data_ptr(), coeffs.data_ptr(), coeffs.shape[0] - 1,
                out.data_ptr(), z.numel(), launch["ept"], launch["blocks"],
                torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f"poly_eval kernel launch failed: CUDA error {err}")
    return out
