"""Degree-r least-squares polynomial approximation of the sigmoid (Eq. 5).

The paper fits ghat(z) = sum_i c_i z^i by least squares on an interval and
finds r=1 already gives accuracy parity (Section V).  We fit on a uniform
grid over [-B, B] and also expose the quantized field coefficients used
inside the protocol.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import field


def sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


@lru_cache(maxsize=None)
def fit_sigmoid_poly(r: int, bound: float = 10.0, n_grid: int = 2001) -> tuple:
    """Least-squares coefficients c_0..c_r (floats, lowest degree first)."""
    z = np.linspace(-bound, bound, n_grid)
    v = np.vander(z, r + 1, increasing=True)
    coeffs, *_ = np.linalg.lstsq(v, sigmoid(z), rcond=None)
    return tuple(float(c) for c in coeffs)


def poly_eval_float(coeffs, z):
    out = np.zeros_like(z, dtype=np.float64)
    for c in reversed(coeffs):
        out = out * z + c
    return out


def max_abs_error(r: int, bound: float = 10.0) -> float:
    z = np.linspace(-bound, bound, 4001)
    c = fit_sigmoid_poly(r, bound)
    return float(np.max(np.abs(poly_eval_float(c, z) - sigmoid(z))))


def quantized_coeffs(r: int, lx: int, degree_scales, bound: float = 10.0) -> np.ndarray:
    """Field-embedded coefficients for Horner evaluation on quantized inputs.

    If the argument z arrives quantized with scale 2^{sz} (sz =
    degree_scales), then evaluating sum c_i z^i in the field with
    coefficients  c_i * 2^{lx_out - i*sz}  yields the result at scale
    2^{lx_out}.  Caller supplies per-degree scale exponents
    degree_scales = [lx_out - i*sz for i in 0..r]; entries must be >= 0
    (choose lx_out large enough).
    """
    cs = fit_sigmoid_poly(r, bound)
    out = []
    for c, s in zip(cs, degree_scales):
        assert s >= 0, "negative coefficient scale; increase lx_out"
        q = int(round(c * (1 << s)))
        out.append(q % field.P)
    return np.asarray(out, dtype=np.int32)
