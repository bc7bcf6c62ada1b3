"""Fixed-point quantization into F_p (paper Appendix A).

phi(x) = x if x >= 0 else p + x  (two's-complement-style field embedding),
applied to Round(2^lx * x).

The JAX package runs with x64 off, so its float64 inputs reach
`quantize` as float32 and are scaled and rounded (half to even) in float32.
The port casts to float32 first for the same reason: scaling the float64
value instead would round ties differently.
"""

from __future__ import annotations

import torch

from . import field


def quantize(x, lx: int, device=None):
    """Real array (numpy or tensor) -> int32 field elements on `device`.
    Requires |x| * 2^lx < p/2."""
    x = torch.as_tensor(x, device=device).to(torch.float32)
    q = torch.round(x * float(1 << lx)).to(torch.int32)
    return torch.where(q < 0, q + field.P, q)


def dequantize(u, lx: int):
    """Field elements -> float32 (inverse of phi, then unscale).

    Elements above p/2 are interpreted as negatives."""
    return signed_value(u).to(torch.float32) / float(1 << lx)


def signed_value(u):
    """Field -> signed integer representative in (-p/2, p/2]."""
    return torch.where(u > field.P // 2, u - field.P, u)


def quantization_noise_variance(d: int, m: int, k1: int) -> float:
    """The sigma^2 bound of Theorem 1, d * 2^(2 (k1 - 1)) / m^2: the
    variance of the secure truncation's rounding noise on the gradient, in
    the paper's fixed-point units."""
    return d * float(2 ** (2 * (k1 - 1))) / float(m) ** 2
