"""kernels/threefry.py on the CPU: the host half of the threefry kernel.

The kernel (csrc/threefry.cu) runs only on a card; tests/test_torch_gpu.py
holds it to the plain version there.  Here: the span's modulo constants
against numpy's `%`, a numpy model of the kernel (its hash, its reduction
and its index map from counter pairs to positions) against core/random.py's
plain draws, the grid, the dispatch (a CUDA draw
goes to the kernel, a CPU draw to the plain version and counts nothing),
and that the wrapper imports and checks its operands without nvcc.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import field, random as jrandom
from repro_torch.kernels import build, ops, threefry

SRC = Path(threefry.__file__).resolve().parents[2]
P = field.P
M32 = 0xFFFFFFFF
#: the field, TruncPr's 2^k2 spans, a large odd span, span 1, and a span
#: whose uint32 multiplier is nonzero (jax's `higher` word counts)
SPANS = (P, 1 << 24, 1 << 25, (1 << 31) - 1, 1, 1000)


def _mult(span: int) -> int:
    m = (1 << 16) % span
    return ((m * m) & M32) % span


def _halves(seed: int):
    return [tuple(h) for h in jrandom.split(jrandom.PRNGKey(seed)).tolist()]


def _hash(k0: int, k1: int, x0, x1):
    """threefry2x32 on uint32 numpy arrays (csrc/threefry.cu `threefry`)."""
    ks = [np.uint32(k0), np.uint32(k1), np.uint32(k0 ^ k1 ^ 0x1BD11BDA)]
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _reduce(words, span: int, magic: int):
    """csrc/threefry.cu `reduce`: uint32 words mod span.  The quotient
    umulhi(w, magic) is floor(w / span) or one short, so the remainder
    w - q * span lies in [0, 2 span) and one conditional subtract lands it
    in [0, span)."""
    w = np.asarray(words, dtype=np.uint64)
    if magic == 0:
        return w & np.uint64(span - 1)
    r = w - ((w * np.uint64(magic)) >> np.uint64(32)) * np.uint64(span)
    return np.where(r >= span, r - np.uint64(span), r)


def _emulate(words, n: int, mode: int, span: int = 1, magic: int = 0,
             mult: int = 0, minval: int = 0, blocks: int | None = None):
    """What csrc/threefry.cu writes, turn by turn: row r of `words` (rows,
    4: lo k0, lo k1, hi k0, hi k1) fills row r of a (rows, n) output, int64
    words for BITS and int32 randint values otherwise, with `blocks` blocks
    a row (default: threefry.grid on 132 SMs)."""
    T, PAIRS = threefry.THREADS, threefry.PAIRS
    words = np.asarray(words, dtype=np.int64).reshape(-1, 4)
    rows, h = len(words), (n + 1) // 2
    blocks = threefry.grid(h, rows, 132) if blocks is None else blocks
    out = np.full((rows, n), -1,
                  np.int64 if mode == threefry.BITS else np.int32)
    with np.errstate(over="ignore"):
        for r, (lk0, lk1, hk0, hk1) in enumerate(words):
            for q0 in range(0, h, blocks * T * PAIRS):
                # every thread of every block, each with its PAIRS pairs
                q = (q0 + np.arange(blocks)[:, None, None] * T * PAIRS
                     + np.arange(PAIRS)[None, :, None] * T
                     + np.arange(T)[None, None, :]).reshape(-1)
                q = q[q < h]
                a = q.astype(np.uint32)
                b = np.where(q + h < n, q + h, 0).astype(np.uint32)
                lo = _hash(int(lk0), int(lk1), a, b)
                hi = _hash(int(hk0), int(hk1), a, b) \
                    if mode == threefry.MAGIC_HI else lo
                vals = []
                for lw, hw in zip(lo, hi):
                    if mode == threefry.BITS:
                        vals.append(lw.astype(np.int64))
                        continue
                    off = _reduce(lw, span, magic)
                    if mode == threefry.MAGIC_HI:
                        t = (_reduce(hw, span, magic) * np.uint64(mult)
                             + off) & np.uint64(M32)
                        off = _reduce(t, span, magic)
                    vals.append(((off + np.uint64(minval & M32))
                                 & np.uint64(M32)).astype(np.uint32)
                                .view(np.int32))
                out[r, q] = vals[0]
                second = q + h < n
                out[r, (q + h)[second]] = vals[1][second]
    return out


@pytest.mark.parametrize("span", SPANS)
def test_mod_constants_reduce_like_numpy(span):
    mode, magic = threefry.mod_constants(span)
    assert mode == (threefry.POW2 if span & (span - 1) == 0
                    else threefry.MAGIC)
    edge = np.array([0, 1, span - 1, span, span + 1, 2 * span - 1,
                     M32, M32 - 1, (M32 // span) * span,
                     (M32 // span) * span - 1, 1 << 31, (1 << 31) - 1],
                    dtype=np.uint64)
    edge = edge[edge <= M32]
    rand = np.random.default_rng(span).integers(0, 1 << 32, size=10 ** 6,
                                                dtype=np.uint64)
    for words in (edge, rand):
        got = _reduce(words, span, magic)
        np.testing.assert_array_equal(got, words % np.uint64(span))
    assert (_mult(span) != 0) == (span == 1000)


def test_mod_constants_refuse_spans_outside_uint32():
    for span in (0, 1 << 32):
        with pytest.raises(ValueError):
            threefry.mod_constants(span)


def _model_randint(lo_keys, hi_keys, n, minval, maxval, blocks=None):
    span = max(maxval - minval, 1)
    mode, magic = threefry.mod_constants(span)
    mult = _mult(span)
    if mult:
        mode = threefry.MAGIC_HI
    words = [(*lo, *hi) for lo, hi in zip(lo_keys, hi_keys)]
    return _emulate(words, n, mode, span, magic, mult, minval, blocks)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 4097])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("bounds", [(0, P), (0, 1 << 25), (5, 1005),
                                    (-(1 << 31), (1 << 31) - 1)])
def test_emulated_kernel_equals_the_plain_draw(n, rows, bounds):
    """The kernel's index map (pairs -> positions, the odd pad, a row a
    key, PAIRS pairs a thread, one block walking all the pairs and the
    default grid) gives the plain version's words."""
    minval, maxval = bounds
    halves = [_halves(11 + r) for r in range(rows)]
    his, los = [h[0] for h in halves], [h[1] for h in halves]
    if rows == 1:
        want = jrandom._draw(his[0], los[0], n, minval, maxval, "cpu")[None]
    else:
        want = jrandom._draw(his, los, n, minval, maxval, "cpu", rows=rows)
    for blocks in (1, None):
        got = _model_randint(los, his, n, minval, maxval, blocks)
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("n", [1, 2, 7, 8, 4097])
def test_emulated_kernel_equals_plain_bits32(n):
    key = jrandom.fold_in(jrandom.PRNGKey(4), 9)
    k0, k1 = (int(w) for w in key)
    want = jrandom.bits32(key, (n,))
    for blocks in (1, 3):
        got = _emulate([k0, k1, 0, 0], n, threefry.BITS, blocks=blocks)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got[0], want.numpy())


def test_emulated_kernel_many_turns():
    """A grid far smaller than the pairs: every block takes several
    grid-stride turns, and the last turn is ragged."""
    lo, hi = _halves(21)
    n = 2 * threefry.THREADS * threefry.PAIRS * 3 + 5
    want = jrandom._draw(hi, lo, n, 0, P, "cpu")
    np.testing.assert_array_equal(
        _model_randint([lo], [hi], n, 0, P, blocks=2)[0], want.numpy())


@pytest.mark.parametrize("h,rows,sms,want", [
    (1, 1, 132, 1), (1024, 1, 132, 1), (1025, 1, 132, 2),
    (10 ** 8, 1, 132, 132 * 8), (10 ** 8, 3, 132, 132 * 8 // 3),
    (10 ** 8, 200, 132, 132 * 8 // 64), (5000, 64, 2, 1)])
def test_grid(h, rows, sms, want):
    assert threefry.grid(h, rows, sms) == want


def test_cpu_draws_launch_nothing():
    ops.reset_launches()
    key = jrandom.PRNGKey(2)
    jrandom.randint(key, (7, 5), 0, P)
    jrandom.randint_keys(jrandom.split(key, 3), (4,), 0, 1000)
    jrandom.bits32(key, (9,))
    jrandom.uniform(key, (3, 3))
    jrandom.categorical(key, torch.zeros(2, 5))
    assert ops.threefry_counts() == {"randint": 0, "randint_keys": 0,
                                     "bits32": 0}
    threefry.LAUNCHES["bits32"] += 1
    ops.reset_launches()
    assert not any(ops.threefry_counts().values())


def test_a_cuda_draw_goes_to_the_kernel(monkeypatch):
    """No fallback: on a CUDA device the draw is the kernel's, and the
    plain version is never reached."""
    calls = []

    def kernel_randint(*args):
        calls.append(("randint", args))
        return torch.zeros(1)

    def kernel_bits32(*args):
        calls.append(("bits32", args))
        return torch.zeros(args[2], dtype=torch.int64)

    def refuse(*args, **kw):
        raise AssertionError("the plain version ran for a cuda device")

    monkeypatch.setattr(threefry, "randint", kernel_randint)
    monkeypatch.setattr(threefry, "bits32", kernel_bits32)
    monkeypatch.setattr(jrandom, "_draw_plain", refuse)
    monkeypatch.setattr(jrandom, "_bits32_plain", refuse)
    key = jrandom.PRNGKey(8)
    lo, hi = _halves(8)[1], _halves(8)[0]
    jrandom._draw(hi, lo, 1, 0, P, "cuda")
    jrandom._draw([hi, hi], [lo, lo], 1, 0, 1000, torch.device("cuda:0"),
                  rows=2)
    jrandom.bits32(key, (3,), device="cuda")
    assert calls[0] == ("randint", (lo, hi, 1, 0, P, 0, "cuda", None))
    assert calls[1][1][:6] == ([lo, lo], [hi, hi], 1, 0, 1000, _mult(1000))
    assert calls[1][1][7] == 2
    assert calls[2][0] == "bits32" and calls[2][1][2] == 3


def test_wrapper_imports_without_nvcc(tmp_path, monkeypatch):
    """core.random imports the wrapper; neither builds nor loads a library
    at import, so both import where no CUDA toolkit is."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", str(SRC))
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()
    code = ("import repro_torch.core.random, repro_torch.kernels.threefry "
            "as t; assert t._FN is None; print(t.ENTRIES)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "randint_keys" in proc.stdout


def test_launch_checks_its_output():
    out = torch.empty(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        threefry._launch(out, "randint", [0, 0, 0, 0], threefry.POW2, 4, 4,
                         0, 0, 0)
    assert not any(threefry.LAUNCHES.values())
