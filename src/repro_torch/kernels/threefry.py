"""Launcher for the threefry draws (csrc/threefry.cu): one launch a draw.

core/random.py sends each bulk draw on a CUDA device here: `randint` for
one key's randint words, `randint_keys` for one row of words per key, and
`bits32` for a key's raw 32-bit words.  The kernel computes JAX's legacy
threefry2x32 stream in native uint32 arithmetic; its words are bit for bit
those of core/random.py's plain int64 version, which stays the CPU path.

Here, on the host: the span's modulo constants (`mod_constants`) and the
grid (`grid`).  LAUNCHES counts the kernel's launches by entry;
kernels/ops.py threefry_counts shows it.

This module imports only torch and kernels/build.py: core/random.py
imports it, so it must not reach kernels/ops.py (ops -> ref -> core.field
-> core.random would be a cycle).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import build

THREADS = 256          # a block's threads (csrc/threefry.cu kThreads)
PAIRS = 4              # counter pairs a thread has in flight (kPairs)
MAX_ROWS = 64          # keys one launch carries (kMaxRows)
WAVE_BLOCKS = 8        # blocks an SM a grid holds at most (2048 threads)
# what a launch writes: raw words, or randint words reduced by a mask, by
# the multiply-high reduction, or by it with jax's `higher` word combined
BITS, POW2, MAGIC, MAGIC_HI = range(4)
ENTRIES = ("randint", "randint_keys", "bits32")
LAUNCHES: collections.Counter = collections.Counter()
M32 = 0xFFFFFFFF
# The kernel's floor on an H100.  A hash is 72 uint32 operations: 20
# rounds of add, funnel rotate and xor, five key injections of two adds,
# two initial adds.  Only its 20 rotations and 20 xors must issue on the
# integer ALU pipe (64 lanes an SM, 16.73e12 ops/s): ptxas issues about
# half of the adds as IMAD on the FMA pipe beside them (chip_smoke.py's
# phase 15 counts the opcodes of the built kernel).  So a draw takes
# ALU_OPS_PAIR operations a counter pair, plus one a word for randint's
# reduction (a mask, or the compare of the multiply-high reduction),
# against the 8 bytes (randint) or 16 (bits32) it writes a pair over
# 3.35 TB/s: it is bound by its operations, by a little.
ALU_OPS_PAIR = 40

_FN = None
_SMS: dict = {}


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("threefry").repro_threefry
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def mod_constants(span: int) -> tuple:
    """(mode, magic) that reduce a word mod `span` in [1, 2^32): POW2 and 0
    for a power of two (the kernel masks with span - 1), else MAGIC and
    floor(2^32 / span)."""
    if not 1 <= span <= M32:
        raise ValueError(f"a uint32 span in [1, 2^32), got {span}")
    if span & (span - 1) == 0:
        return POW2, 0
    return MAGIC, (1 << 32) // span


def grid(h: int, rows: int, sms: int) -> int:
    """Blocks a row for h counter pairs a row: enough to cover the pairs
    in one turn, at most WAVE_BLOCKS waves' worth over the card's SMs
    shared by the launch's rows (a grid-stride loop takes the rest)."""
    chunks = -(-h // (THREADS * PAIRS))
    return max(1, min(chunks, sms * WAVE_BLOCKS // min(rows, MAX_ROWS)))


def _launch(out, entry: str, words: list, mode: int, n: int, span: int,
            magic: int, mult: int, minval: int) -> None:
    dtype = torch.int64 if mode == BITS else torch.int32
    rows = len(words) // 4
    if out.device.type != "cuda":
        raise ValueError(f"threefry: out is on {out.device}, not a cuda "
                         f"device")
    if out.dtype != dtype:
        raise TypeError(f"threefry: out must be {dtype}, got {out.dtype}")
    if not out.is_contiguous() or out.numel() != rows * n:
        raise ValueError(f"threefry: out must be contiguous with {rows} x "
                         f"{n} elements, got {tuple(out.shape)}")
    if not rows or not n:
        return
    dev = out.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    keys = (ctypes.c_uint32 * len(words))(*words)
    err = _fn()(keys, rows, mode, out.data_ptr(), n, span, magic, mult,
                minval, grid((n + 1) // 2, rows, sms),
                torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    LAUNCHES[entry] += -(-rows // MAX_ROWS)


def randint(lo_keys, hi_keys, n: int, minval: int, span: int, mult: int,
            device, rows: int | None = None):
    """random.randint's words on a CUDA device: (n,) int32 for one key's
    halves (lo_keys, hi_keys: (k0, k1) Python ints), or (rows, n) for
    `rows` keys (lists of such pairs).  mult (jax's uint32 multiplier of
    the `higher` word) != 0 hashes the hi keys too."""
    if rows is None:
        lo_keys, hi_keys = [lo_keys], [hi_keys]
    mode, magic = mod_constants(span)
    if mult:
        mode = MAGIC_HI
    words = [w & M32 for lo, hi in zip(lo_keys, hi_keys)
             for w in (*lo, *hi)]
    lead = () if rows is None else (rows,)
    out = torch.empty(lead + (n,), dtype=torch.int32, device=device)
    _launch(out, "randint" if rows is None else "randint_keys", words, mode,
            n, span, magic, mult, minval)
    return out


def bits32(k0: int, k1: int, n: int, device):
    """random.bits32's words on a CUDA device: (n,) int64 in [0, 2^32)."""
    out = torch.empty((n,), dtype=torch.int64, device=device)
    _launch(out, "bits32", [k0 & M32, k1 & M32, 0, 0], BITS, n, 1, 0, 0, 0)
    return out
