"""JAX's legacy threefry2x32 key stream, emulated with int64 torch tensors.

COPML's outputs are bit-exact only when every share polynomial, LCC mask
and TruncPr pad is drawn from the same stream the JAX package draws from.
That package uses `jax.random` with the NON-partitionable threefry layout
(`jax_threefry_partitionable=False`), so this module reproduces exactly:

  PRNGKey(seed)   [seed >> 32, seed & 0xFFFFFFFF]            (threefry_seed)
  split(key, n)   hash of iota(2n), reshaped (n, 2)          (_threefry_split_original)
  fold_in(key, x) hash of [0, x]                             (threefry_fold_in)
  randint         two 32-bit draws combined mod span         (random._randint)
  uniform         float32: 23 mantissa bits of a 32-bit draw (random._uniform)
                  bf16: 7 bits of an 8-bit draw              (prng random_bits)
  categorical     argmax(logits + Gumbel(uniform)) in the    (random.categorical)
                  logits' type

A key is a (2,) int64 tensor holding two uint32 words.  Keys are derived
on the host with Python ints (a split is a handful of hashes), so a key
never forces a device sync; only the bulk draws run on the caller's
device.  In the plain version uint32 wraparound and logical shifts are
emulated in int64 with `& 0xFFFFFFFF` masks.

The legacy `random_bits` layout hashes the counter vector iota(n) as two
halves: counter pair q = (q, q + h), h = ceil(n / 2), gives output words q
and h + q; an odd n pads the second half with one counter 0 whose output is
dropped.

On a CUDA device each bulk draw (`_draw`, `bits32`) is one launch of the
hand-written kernel kernels/csrc/threefry.cu (launched by
kernels/threefry.py), which computes the same words in native uint32
arithmetic.  On the CPU it runs the plain
int64 version below (`_draw_plain`, `_bits32_plain`), which the CPU tests
hold to JAX; `_draw_plain` walks the pairs in chunks so that a (7, 9019,
3073) draw never materialises more than a few chunk-sized int64
temporaries.  Each bulk draw is one `obs` span, `random.threefry`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import obs
from ..kernels import threefry as _kernel

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# counter pairs hashed per chunk of a bulk draw (int64 temporaries of
# 8 * _CHUNK bytes each)
_CHUNK = 1 << 23


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32 block (20 rounds) on counter words x0, x1.

    k0, k1: the key's words as Python ints.  x0, x1: Python ints or int64
    tensors in [0, 2^32).  Returns the two hashed words, same kind.
    """
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _words(key) -> tuple:
    key = as_key(key)
    return int(key[0]), int(key[1])


def _key_tensor(w0: int, w1: int) -> torch.Tensor:
    return torch.tensor([w0, w1], dtype=torch.int64)


def as_key(key) -> torch.Tensor:
    """An int seed, a (2,) tensor, or a JAX key's data as a numpy array ->
    the (2,) int64 key tensor."""
    if isinstance(key, int):
        return PRNGKey(key)
    if isinstance(key, torch.Tensor):
        arr = key.detach().cpu().numpy()
    else:
        arr = np.asarray(key)
    arr = arr.astype(np.int64) & M32
    if arr.shape != (2,):
        raise ValueError(f"a threefry key has shape (2,), got {arr.shape}")
    return torch.from_numpy(arr.copy())


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 -- jax's name
    """jax.random.PRNGKey(seed) for an int32 seed (x64 disabled)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 31:
        raise ValueError(f"seed must be in [0, 2^31), got {seed}")
    return _key_tensor(0, seed)


def _hash_counts(k0: int, k1: int, n: int) -> list:
    """The legacy layout's n output words for counters iota(n), as ints."""
    h = (n + 1) // 2
    out = [0] * (2 * h)
    for q in range(h):
        c1 = q + h if q + h < n else 0
        out[q], out[h + q] = threefry2x32(k0, k1, q, c1)
    return out[:n]


def split(key, num: int = 2) -> torch.Tensor:
    """jax.random.split: (num, 2) keys."""
    k0, k1 = _words(key)
    words = _hash_counts(k0, k1, 2 * num)
    return torch.tensor(words, dtype=torch.int64).reshape(num, 2)


def fold_in(key, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data) for a uint32 data word."""
    k0, k1 = _words(key)
    return _key_tensor(*threefry2x32(k0, k1, 0, int(data) & M32))


def randint(key, shape, minval: int, maxval: int, *,
            device="cpu") -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval, dtype=int32).

    jax draws `higher` and `lower` 32-bit words from split(key) and returns
    minval + ((higher % span) * mult + lower % span) % span in uint32
    arithmetic, mult = (2^16 % span)^2 % span.  For every span the protocol
    uses (p and 2^k2) mult wraps to 0 in uint32, and the `higher` draw then
    cannot change the result, so it is skipped.
    """
    shape = tuple(int(s) for s in shape)
    keys = split(key)
    out = _draw(_words(keys[0]), _words(keys[1]), math.prod(shape),
                int(minval), int(maxval), device)
    return out.reshape(shape)


def randint_keys(keys, shape, minval: int, maxval: int, *,
                 device="cpu") -> torch.Tensor:
    """torch.stack([randint(k, shape, minval, maxval) for k in keys]) as
    one draw, a row a key: one kernel launch on the card (a launch a 64
    keys), and on the CPU one pass of elementwise ops with the K keys'
    words as (K, 1) tensors.  keys: (K, 2).  Returns (K,) + shape."""
    shape = tuple(int(s) for s in shape)
    halves = [split(k).tolist() for k in keys]
    out = _draw([tuple(h[0]) for h in halves], [tuple(h[1]) for h in halves],
                math.prod(shape), int(minval), int(maxval), device,
                rows=len(halves))
    return out.reshape((len(halves),) + shape)


def _draw(hi_key, lo_key, n: int, minval: int, maxval: int, device,
          rows: int | None = None) -> torch.Tensor:
    """randint's n words for one key (its halves' words as (k0, k1) Python
    ints; returns (n,)) or for `rows` keys at once (lists of such pairs;
    returns (rows, n)): one kernel launch on a CUDA device, the plain
    int64 version on the CPU."""
    if not -(1 << 31) <= minval <= maxval <= (1 << 31) - 1:
        raise ValueError(f"int32 randint bounds, got [{minval}, {maxval})")
    span = max(maxval - minval, 1)
    mult = (1 << 16) % span
    mult = ((mult * mult) & M32) % span
    with obs.span("random.threefry"):
        if torch.device(device).type == "cuda":
            return _kernel.randint(lo_key, hi_key, n, minval, span, mult,
                                   device, rows)
        return _draw_plain(hi_key, lo_key, n, minval, span, mult, device,
                           rows)


def _draw_plain(hi_key, lo_key, n: int, minval: int, span: int, mult: int,
                device, rows: int | None) -> torch.Tensor:
    """_draw in int64 torch ops, in chunks of _CHUNK counter pairs; a
    `rows` draw's keys ride as (rows, 1) tensors through the same hash."""
    if rows is not None:
        def col(keys, w: int):
            return torch.tensor([[k[w]] for k in keys], dtype=torch.int64,
                                device=device)
        hi_key = (col(hi_key, 0), col(hi_key, 1))
        lo_key = (col(lo_key, 0), col(lo_key, 1))
    lead = () if rows is None else (rows,)
    out = torch.empty(lead + (n,), dtype=torch.int32, device=device)
    h = (n + 1) // 2
    chunk = max(1, _CHUNK // (rows or 1))
    for qs in range(0, h, chunk):
        qe = min(h, qs + chunk)
        c0 = torch.arange(qs, qe, dtype=torch.int64, device=device)
        c1 = c0 + h
        if n % 2 and qe == h:
            c1[-1] = 0                    # the odd count's zero pad
        lo = threefry2x32(*lo_key, c0, c1)
        offs = [w % span for w in lo]
        if mult:
            hi = threefry2x32(*hi_key, c0, c1)
            offs = [((((hw % span) * mult) & M32) + o) & M32
                    for hw, o in zip(hi, offs)]
            offs = [o % span for o in offs]
        out[..., qs:qe] = (offs[0] + minval).to(torch.int32)
        tail = min(qe, n - h) - qs        # second-half words inside [0, n)
        if tail > 0:
            out[..., h + qs:h + qs + tail] = (offs[1][..., :tail]
                                              + minval).to(torch.int32)
    return out


def bits32(key, shape, *, device="cpu") -> torch.Tensor:
    """jax.random.bits(key, shape, uint32): the hash of counters iota(n)
    under the key itself (no split), as int64 words in [0, 2^32); one
    kernel launch on a CUDA device, the plain int64 version on the CPU."""
    k0, k1 = _words(key)
    n = math.prod(shape)
    with obs.span("random.threefry"):
        if torch.device(device).type == "cuda":
            return _kernel.bits32(k0, k1, n, device).reshape(shape)
        return _bits32_plain(k0, k1, n, device).reshape(shape)


def _bits32_plain(k0: int, k1: int, n: int, device) -> torch.Tensor:
    """bits32's (n,) words in int64 torch ops."""
    h = (n + 1) // 2
    c0 = torch.arange(h, dtype=torch.int64, device=device)
    c1 = c0 + h
    if n % 2:
        c1[-1] = 0                        # the odd count's zero pad
    w0, w1 = threefry2x32(k0, k1, c0, c1)
    return torch.cat([w0, w1])[:n]


def bits(key, shape, width: int = 32, *, device="cpu") -> torch.Tensor:
    """jax's legacy random_bits at `width` 8, 16 or 32 bits, as int64
    values in [0, 2^width): ceil(width * n / 32) words are hashed as in
    bits32, and word i gives elements (32/width) * i + j, j = 0, 1, ...,
    as its j-th `width`-bit group counted from the least significant bit;
    the last word's unused groups are dropped."""
    if width not in (8, 16, 32):
        raise ValueError(f"bit width 8, 16 or 32, got {width}")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if width == 32:
        return bits32(key, shape, device=device)
    per = 32 // width
    words = bits32(key, (-(-n // per),), device=device)
    shifts = torch.arange(per, dtype=torch.int64, device=device) * width
    out = (words[:, None] >> shifts) & ((1 << width) - 1)
    return out.reshape(-1)[:n].reshape(shape)


_F32_TINY = float(np.finfo(np.float32).tiny)
_BF16_ONE = 0x3F80


def _round_f32_once(exact_hi, exact_lo):
    """float32(exact_hi + exact_lo) rounded once, to nearest even.

    exact_hi + exact_lo is the exact value (float64 TwoSum pair,
    |exact_lo| below half an ulp of exact_hi).  Casting exact_hi alone can
    round twice: when exact_hi is a float32 midpoint, exact_lo's sign
    decides the side."""
    r = exact_hi.to(torch.float32)
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    dn = torch.nextafter(r, torch.full_like(r, -math.inf))
    rd = r.double()
    at_up = exact_hi == (rd + up.double()) * 0.5
    at_dn = exact_hi == (rd + dn.double()) * 0.5
    r = torch.where(at_up & (exact_lo > 0), up, r)
    return torch.where(at_dn & (exact_lo < 0), dn, r)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            dtype=torch.float32, *, device="cpu") -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype, minval, maxval) for float32
    or bfloat16, as the JAX package's CPU lowering computes it.

    float32: the draw's top 23 bits as the mantissa of a float in [1, 2),
    minus 1; then floats * (hi - lo) + lo with ONE rounding (XLA:CPU
    contracts the multiply-add into an FMA; hi - lo is rounded to float32
    first), floored at lo.  The product of two float32 values is exact in
    float64, the sum is split into its float64 value and exact remainder
    (TwoSum), and _round_f32_once rounds the pair.

    bfloat16: jax draws 8-bit words for a type of fewer than 8 mantissa
    bits; 7 of them (the word >> 1) fill the mantissa of a bf16 in [1, 2).
    Every operation after that is rounded to bf16 (XLA:CPU computes a bf16
    op in float32 and converts back, op by op): - 1, * (hi - lo), + lo,
    max(lo, .)."""
    if dtype == torch.bfloat16:
        return _uniform_bf16(key, shape, minval, maxval, device)
    if dtype != torch.float32:
        raise ValueError(f"uniform draws float32 or bfloat16, not {dtype}")
    raw = bits32(key, shape, device=device)
    one = int(np.array(1.0, np.float32).view(np.int32))
    floats = ((raw >> 9) | one).to(torch.int32).view(torch.float32) - 1.0
    lo32, hi32 = np.float32(minval), np.float32(maxval)
    span = float(np.float32(hi32 - lo32))
    lo = float(lo32)
    prod = floats.double() * span                 # exact
    s = prod + lo
    bv = s - prod                                 # TwoSum remainder
    err = (prod - (s - bv)) + (lo - bv)
    out = _round_f32_once(s, err)
    return torch.clamp_min(out, lo32.item())


def _bf16(x):
    """Round float32 values to bf16 and back (one XLA:CPU bf16 op)."""
    return x.to(torch.bfloat16).float()


def _uniform_bf16(key, shape, minval, maxval, device):
    raw = bits(key, shape, 8, device=device)
    floats = ((raw >> 1) | _BF16_ONE).to(torch.int16).view(torch.bfloat16)
    lo = float(torch.tensor(minval, dtype=torch.bfloat16))
    hi = float(torch.tensor(maxval, dtype=torch.bfloat16))
    span = float(torch.tensor(hi - lo, dtype=torch.float32).to(
        torch.bfloat16))
    x = _bf16(floats.float() - 1.0)
    x = _bf16(x * span)
    x = _bf16(x + lo)
    return torch.clamp_min(x, lo).to(torch.bfloat16)


def gumbel(key, shape, dtype=torch.float32, *, device="cpu") -> torch.Tensor:
    """jax.random.gumbel(key, shape, dtype) in its default "low" mode:
    -log(-log(uniform(tiny, 1))), tiny the dtype's smallest normal.  In
    bfloat16 each log and negation is a float32 op rounded back to bf16,
    as XLA:CPU lowers it."""
    if dtype == torch.bfloat16:
        u = _uniform_bf16(key, shape, _F32_TINY, 1.0, device).float()
        return (-_bf16(torch.log(-_bf16(torch.log(u))))).to(torch.bfloat16)
    u = uniform(key, shape, _F32_TINY, 1.0, dtype, device=device)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits) over the last axis (the Gumbel
    max trick), drawn in the logits' type as jax draws it: float32 or
    bfloat16 (whose noise and sum are bf16, each sum a float32 add
    rounded back)."""
    if logits.dtype == torch.bfloat16:
        g = gumbel(key, tuple(logits.shape), torch.bfloat16,
                   device=logits.device)
        return torch.argmax(_bf16(g.float() + logits.float()), dim=-1)
    g = gumbel(key, tuple(logits.shape), device=logits.device)
    return torch.argmax(g + logits.float(), dim=-1)
