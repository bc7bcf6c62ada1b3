"""repro_torch.core.random: bit-equality with jax's legacy threefry stream.

Every JAX reference draw runs under `jax.threefry_partitionable(False)`,
the layout the JAX package's pinned goldens were produced with; the global
flag is never changed (test files share xdist workers).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import field as jfield
from repro_torch.core import field, random as jrandom

SEEDS = (0, 1, 12345, 2 ** 31 - 1)


def _np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    with jax.threefry_partitionable(False):
        jk = jax.random.PRNGKey(seed)
        tk = jrandom.PRNGKey(seed)
        assert np.array_equal(_np(jk), tk.numpy())
        for n in (2, 3, 6):
            assert np.array_equal(_np(jax.random.split(jk, n)),
                                  jrandom.split(tk, n).numpy())
        for data in (0, 1, 7, 2 ** 32 - 1):
            assert np.array_equal(_np(jax.random.fold_in(jk, data)),
                                  jrandom.fold_in(tk, data).numpy())


@pytest.mark.parametrize("shape", [(1,), (5,), (4, 3), (7, 11, 3), (2, 1001)])
@pytest.mark.parametrize("span", [jfield.P, 1 << 24, 1 << 10, 1000])
def test_randint_matches_jax(shape, span):
    """Odd and even sizes; the field span, TruncPr's 2^k2 spans, and a span
    whose uint32 multiplier is nonzero (the `higher` draw matters)."""
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(3)
        want = np.asarray(jax.random.randint(key, shape, 0, span,
                                             dtype=np.int32))
    got = jrandom.randint(jrandom.as_key(np.asarray(key)), shape, 0, span)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_randint_chunked_and_offset(monkeypatch):
    """Chunk boundaries (odd size, pad in the last chunk) and minval != 0."""
    monkeypatch.setattr(jrandom, "_CHUNK", 3)
    with jax.threefry_partitionable(False):
        key = jax.random.fold_in(jax.random.PRNGKey(9), 4)
        want_f = np.asarray(jfield.random_field(key, (7, 5)))
        want_o = np.asarray(jax.random.randint(key, (8, 5), 5, 300,
                                               dtype=np.int32))
    tk = jrandom.as_key(np.asarray(key))
    assert np.array_equal(field.random_field(tk, (7, 5)).numpy(), want_f)
    assert np.array_equal(jrandom.randint(tk, (8, 5), 5, 300).numpy(), want_o)


@pytest.mark.parametrize("shape,span,chunk", [
    ((7, 5), jfield.P, None), ((3, 4), 1000, None), ((1,), 1 << 24, None),
    ((7, 5), jfield.P, 6)])
def test_randint_keys_equals_one_draw_per_key(monkeypatch, shape, span,
                                              chunk):
    """randint_keys (K keys hashed in one pass) equals the JAX package's
    one draw per key: odd sizes, a nonzero uint32 multiplier (span 1000),
    and chunk boundaries (6 counter pairs a chunk over 3 keys)."""
    if chunk is not None:
        monkeypatch.setattr(jrandom, "_CHUNK", chunk)
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(5), 3)
        want = np.stack([np.asarray(jax.random.randint(
            k, shape, 0, span, dtype=np.int32)) for k in keys])
    got = jrandom.randint_keys(torch.from_numpy(_np(keys)), shape, 0, span)
    assert got.dtype == torch.int32 and got.shape == (3,) + shape
    assert np.array_equal(got.numpy(), want)


def test_threefry_scalar_and_tensor_agree():
    x0 = torch.tensor([0, 1, 2 ** 32 - 1], dtype=torch.int64)
    x1 = torch.tensor([5, 0, 2 ** 31], dtype=torch.int64)
    y0, y1 = jrandom.threefry2x32(11, 2 ** 32 - 3, x0, x1)
    for i in range(3):
        assert (int(y0[i]), int(y1[i])) == jrandom.threefry2x32(
            11, 2 ** 32 - 3, int(x0[i]), int(x1[i]))


def test_key_validation():
    with pytest.raises(ValueError):
        jrandom.PRNGKey(-1)
    with pytest.raises(ValueError):
        jrandom.as_key(np.zeros(3, np.uint32))
