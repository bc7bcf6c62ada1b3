"""Plain torch versions of the port's kernels (no custom kernel anywhere).

They are the CPU path of kernels/ops.py and the oracles the CUDA kernels
are held against.  CUDA torch has no int64 matmul, so the plain field GEMM
is exact in float64 instead, on either device: `a` splits into 13-bit
limbs, each limb product with b is < 2^13 * 2^26 = 2^39, and a contraction
chunk of 2^13 terms stays below 2^52 -- inside float64's exact-integer
range whatever the summation order -- before it is reduced mod p in int64.
Columns and the contraction are chunked so temporaries stay bounded.
"""

from __future__ import annotations

import math

import torch

from ..core import field
from ..core.labels import Coded, Public

LIMB_BITS = 13
K_CHUNK = 1 << 13              # exact float64 sums of 2^39-bounded products
CHUNK_ELEMS = 1 << 26          # bound on each chunk's temporaries


def modmatmul_batched(a, b):
    """(a[..] @ b[..]) mod p over broadcast leading batch dims; int32 out.
    a (..., M, K), b (..., K, N) int32 in [0, p)."""
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(batch + (m, n), dtype=torch.int32, device=a.device)
    rows = max(1, math.prod(batch) * m)
    kc = max(1, min(K_CHUNK, CHUNK_ELEMS // rows))
    nc = max(1, CHUNK_ELEMS // rows)
    for n0 in range(0, n, nc):
        bn = b[..., n0:n0 + nc]
        acc = torch.zeros(batch + (m, bn.shape[-1]), dtype=torch.int64,
                          device=a.device)
        for k0 in range(0, k, kc):
            ak = a[..., k0:k0 + kc].to(torch.int64)
            bk = bn[..., k0:k0 + kc, :].to(torch.float64)
            hi = torch.matmul((ak >> LIMB_BITS).to(torch.float64), bk)
            lo = torch.matmul((ak & ((1 << LIMB_BITS) - 1)).to(torch.float64),
                              bk)
            acc += (hi.to(torch.int64) % field.P) << LIMB_BITS
            acc += lo.to(torch.int64)
            acc %= field.P
        out[..., n0:n0 + nc] = acc.to(torch.int32)
    return out


def modmatmul(a, b):
    """(a @ b) mod p for a: (M, K), b: (K, N)."""
    assert a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0], (
        a.shape, b.shape)
    return modmatmul_batched(a, b)


def poly_eval(z, coeffs: Public):
    """Horner over F_p, elementwise; coeffs (r+1,) on z's device."""
    return field.evaluate_poly_dyn(coeffs, z)


def coded_gradient(x: Coded, w: Coded, coeffs: Public) -> Coded:
    """f = x^T ghat(x w) for one client: x (m, d), w (d,)."""
    z = modmatmul(x, w[:, None])[:, 0]
    g = field.evaluate_poly_dyn(coeffs, z)
    return modmatmul(x.t(), g[:, None])[:, 0]


def coded_gradient_vmap(x: Coded, w: Coded, coeffs: Public) -> Coded:
    """The per-client loop of coded_gradient over x (N, m, d), w (N, d):
    a second oracle for the batched versions (they must agree element for
    element mod p)."""
    return torch.stack([coded_gradient(xi, wi, coeffs)
                        for xi, wi in zip(x, w)])


def coded_gradient_batched(x: Coded, w: Coded, coeffs: Public) -> Coded:
    """f[n] = x[n]^T ghat(x[n] w[n]) for a vector model w: (N, d)."""
    z = modmatmul_batched(x, w[..., None])               # (N, m, 1)
    g = field.evaluate_poly_dyn(coeffs, z)
    return modmatmul_batched(x.transpose(1, 2), g)[..., 0]   # (N, d)


def coded_gradient_matrix(x: Coded, w: Coded, coeffs: Public) -> Coded:
    """f[n] = x[n]^T ghat(x[n] @ w[n]) for a matrix model w: (N, d, C)."""
    z = modmatmul_batched(x, w)                          # (N, m, C)
    g = field.evaluate_poly_dyn(coeffs, z)
    return modmatmul_batched(x.transpose(1, 2), g)       # (N, d, C)


def fused_step(x, w, coeffs, adv_off, dfull, rvec, base, xty, wsh, radd,
               r0sh, *, q_eta: int, inv2k1: int, k1: int):
    """Phase-by-phase version of the fused COPML step (same operands and
    returns as kernels/fused_step.py): matrix coded gradient, corruption
    offset, decode fold against the zero-scattered decode row, q_eta scale,
    TruncPr masked open (rvec = the reconstruct Lagrange row zero-padded
    over holders) and borrow-folded rescale."""
    f = coded_gradient_matrix(x, w, coeffs)
    return f, fused_epilogue(f, adv_off, dfull, rvec, base, xty, wsh, radd,
                             r0sh, q_eta=q_eta, inv2k1=inv2k1, k1=k1)


def fused_epilogue(f, adv_off, dfull, rvec, base, xty, wsh, radd, r0sh, *,
                   q_eta: int, inv2k1: int, k1: int):
    """The fused step after its gradient f (N, d, C) (kernels/fused_step.py
    epilogue): returns the updated model shares."""
    n = f.shape[0]
    f_adj = field.add(f, adv_off[:, None, None])
    common = modmatmul(dfull[None], f_adj.reshape(n, -1))[0].reshape(
        f.shape[1:])
    xtg = field.add(base, common[None])
    grad = field.sub(xtg, xty)
    scaled = field.mul_scalar(grad, q_eta)
    c_sh = field.add(scaled, radd)
    c_open = modmatmul(rvec[None], c_sh.reshape(n, -1))[0].reshape(
        c_sh.shape[1:])
    c0 = c_open & ((1 << k1) - 1)
    a0 = field.sub(c0[None].expand(c_sh.shape), r0sh)
    delta = field.mul_scalar(field.sub(scaled, a0), inv2k1)
    return field.sub(wsh, delta)
