"""Prime-field arithmetic over F_p, p = 2^26 - 5, on torch tensors.

Field elements are stored as int32 in [0, p) and widened to int64 only
inside a computation: a product of two elements is < 2^52, so `a * b % p`
in int64 is exact, and the canonical representative it returns is the same
bits the JAX package's 13-bit-limb int32 arithmetic produces.  Storage
stays int32 because the setup's share tensors are the port's largest
allocations (int64 would double them).

`matmul` is the field GEMM.  On a CUDA tensor it is the hand-written
`modmatmul` kernel (CUDA torch has no int64 matmul, and the JAX package's
jnp limb form materialises a (4, 4, M, N) float tensor); on a CPU tensor it
is the plain version in kernels/ref.py.
"""

from __future__ import annotations

import numpy as np
import torch

from . import random as jrandom

# The paper's prime for 64-bit CIFAR-10 runs: the largest prime below 2^26
# such that d * (p-1)^2 <= 2^64 - 1 for d = 3072.  2^26 = p + 5.
P_BITS = 26
P = (1 << P_BITS) - 5  # 67108859, prime
_MASK26 = (1 << P_BITS) - 1

FIELD_DTYPE = torch.int32

# Barrett reduction against p: mu = floor(2^32 / p) = 2^6 exactly, so the
# quotient (t * mu) >> 32 is t >> 26 and r = t - q*p lies in [0, 2p).
BARRETT_MU = (1 << 32) // P
_BARRETT_SHIFT = 32 - (BARRETT_MU.bit_length() - 1)   # 26


def _csub(t):
    """Conditional subtract: t in [0, 2p) -> t mod p."""
    return torch.where(t >= P, t - P, t)


def fold26(t):
    """Reduce t in [0, 2^31) to [0, p) using 2^26 = 5 (mod p)."""
    return _csub((t >> P_BITS) * 5 + (t & _MASK26))


def barrett_reduce(t):
    """Barrett-reduce t in [0, 2^31) to [0, p)."""
    return _csub(t - (t >> _BARRETT_SHIFT) * P)


def add(a, b):
    """(a + b) mod p.  a, b in [0, p): the sum fits int32."""
    return _csub(a + b)


def add_(a, b):
    """a = (a + b) mod p in place, with no temporary the size of a (the
    setup's share tensors are the port's largest allocations)."""
    return a.add_(b).remainder_(P)


def sub(a, b):
    """(a - b) mod p."""
    d = a - b
    return torch.where(d < 0, d + P, d)


def neg(a):
    """(-a) mod p."""
    return torch.where(a == 0, a, P - a)


def mul(a, b):
    """(a * b) mod p, exact in int64, stored back as a's dtype."""
    if isinstance(b, torch.Tensor):
        b = b.to(torch.int64)
    return (a.to(torch.int64) * b % P).to(a.dtype)


def mul_scalar(a, c: int):
    """a * c mod p for a public Python int c."""
    return mul(a, int(c) % P)


def pow_const(a, e: int):
    """a ** e mod p for a static exponent, by square-and-multiply."""
    e = int(e)
    assert e >= 0
    result = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        base = mul(base, base)
        e >>= 1
    return result


def inv(a):
    """a^{-1} mod p (Fermat).  Undefined for a == 0."""
    return pow_const(a, P - 2)


# ---------------------------------------------------------------------------
# Host-side exact helpers for public constants (evaluation points are
# public, so Lagrange matrices are computed on the host, exactly: int64
# residues whose pairwise products fit, and Python ints for pow).
# ---------------------------------------------------------------------------

def host_inv(a: int) -> int:
    return pow(int(a) % P, P - 2, P)


def _host_residues(vals) -> np.ndarray:
    """Public ints of any sign or size -> (len,) int64 residues in [0, p)."""
    return np.array([int(v) % P for v in vals], dtype=np.int64).reshape(-1)


def _host_prod(a: np.ndarray) -> np.ndarray:
    """prod_l a[..., l] mod p for int64 a in [0, p), by halving the last
    axis (an odd length's last entry folded into the first; every product
    of two residues fits int64)."""
    while a.shape[-1] > 1:
        h = a.shape[-1] // 2
        half = a[..., :h] * a[..., h:2 * h] % P
        if a.shape[-1] % 2:
            half[..., 0] = half[..., 0] * a[..., -1] % P
        a = half
    return a[..., 0] if a.shape[-1] else np.ones(a.shape[:-1], np.int64)


def _host_prod_but_one(a: np.ndarray) -> np.ndarray:
    """out[..., j] = prod_{l != j} a[..., l] mod p for int64 a in [0, p):
    exclusive prefix times exclusive suffix products, each a doubling scan
    (log2 n vector steps; every product of two residues fits int64)."""
    pre, suf = np.ones_like(a), np.ones_like(a)
    pre[..., 1:], suf[..., :-1] = a[..., :-1], a[..., 1:]
    s = 1
    while s < a.shape[-1]:
        pre[..., s:] = pre[..., s:] * pre[..., :-s] % P
        suf[..., :-s] = suf[..., :-s] * suf[..., s:] % P
        s *= 2
    return pre * suf % P


def host_inv_all(a: np.ndarray) -> np.ndarray:
    """Inverses mod p of int64 residues a (n,), with one pow (batch
    inversion by prefix products); 0 maps to 0, as host_inv(0) does."""
    vals = [v or 1 for v in a.tolist()]
    pre = [1]
    for v in vals:
        pre.append(pre[-1] * v % P)
    inv, out = host_inv(pre[-1]), [0] * len(vals)
    for j in range(len(vals) - 1, -1, -1):
        out[j] = inv * pre[j] % P
        inv = inv * vals[j] % P
    return np.where(a == 0, 0, np.array(out, dtype=np.int64))


def host_lagrange_parts(xs, targets) -> tuple:
    """The barycentric parts of the Lagrange basis over F_p, int64 in
    [0, p): num (m, n), num[t, j] = prod_{l != j} (z_t - x_l) (that is
    l(z_t) / (z_t - x_j) with l(z) = prod_l (z - x_l), with no division,
    so a target on a node needs no case of its own), and the node weights
    w (n,), w_j = 1 / prod_{l != j} (x_j - x_l), inverted together.  A
    zero denominator (a duplicate node) gives w_j = 0, as host_inv(0)
    does.  L[t, j] = num[t, j] * w_j mod p."""
    xs, ts = _host_residues(xs), _host_residues(targets)
    num = _host_prod_but_one((ts[:, None] - xs[None, :]) % P)
    diff = (xs[:, None] - xs[None, :]) % P
    np.fill_diagonal(diff, 1)
    return num, host_inv_all(_host_prod(diff))


def host_lagrange_coeffs(xs, targets) -> np.ndarray:
    """Exact Lagrange basis matrix  L[t, j] = prod_{l != j} (z_t - x_l)/(x_j - x_l)
    over F_p.  xs: interpolation nodes (len n); targets: evaluation points
    (len m).  Returns (m, n) int32 in [0, p)."""
    num, w = host_lagrange_parts(xs, targets)
    return (num * w % P).astype(np.int32)


# ---------------------------------------------------------------------------
# Field GEMM
# ---------------------------------------------------------------------------

def matmul(a, b):
    """(a @ b) mod p for int32 field matrices a: (M, K), b: (K, N)."""
    from ..kernels import ops
    return ops.modmatmul(a, b)


def matvec(a, v):
    """(a @ v) mod p, a: (M, K) v: (K,)."""
    return matmul(a, v[:, None])[:, 0]


def matvec_batched(a, v):
    """(a[i] @ v[i]) mod p for a: (B, M, K), v: (B, K): one batched field
    GEMM with N = 1."""
    from ..kernels import ops
    if a.dim() != 3 or tuple(v.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"matvec_batched: a (B, M, K), v (B, K); got "
                         f"{tuple(a.shape)}, {tuple(v.shape)}")
    return ops.modmatmul_batched(a, v[..., None])[..., 0]


def evaluate_poly(coeffs, x):
    """Horner evaluation of sum_i coeffs[i] * x^i over F_p.

    coeffs: 1-D field array (host), lowest degree first.  x: any shape."""
    coeffs = [int(c) for c in coeffs]
    acc = torch.full_like(x, coeffs[-1])
    for c in reversed(coeffs[:-1]):
        acc = add(mul(acc, x), torch.full_like(x, c))
    return acc


def evaluate_poly_dyn(coeffs, x):
    """Horner with a coefficient tensor on x's device."""
    acc = coeffs[-1].expand(x.shape)
    for i in range(coeffs.shape[0] - 2, -1, -1):
        acc = add(mul(acc, x), coeffs[i].expand(x.shape))
    return acc


def random_field(key, shape, device="cpu"):
    """Uniform elements of F_p: jax.random.randint(key, shape, 0, p)."""
    return jrandom.randint(key, shape, 0, P, device=device)


def random_field_keys(keys, shape, device="cpu"):
    """random_field for each of K keys in one draw: (K,) + shape."""
    return jrandom.randint_keys(keys, shape, 0, P, device=device)


# ---------------------------------------------------------------------------
# numpy uint64 oracles (host-side ground truth for tests)
# ---------------------------------------------------------------------------

def np_mul(a, b):
    return ((a.astype(np.uint64) * b.astype(np.uint64)) % np.uint64(P)).astype(np.int64)


def np_matmul(a, b):
    """Exact field matmul with the paper's 64-bit lazy reduction."""
    a = a.astype(np.uint64)
    b = b.astype(np.uint64)
    k = a.shape[1]
    chunk = 4096
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint64)
    for s in range(0, k, chunk):
        out = (out + (a[:, s:s + chunk] @ b[s:s + chunk, :]) % np.uint64(P)) % np.uint64(P)
    return out.astype(np.int64)
