"""The port's jax.random emulation (core/random) against jax.random under
the legacy threefry stream, bit for bit: float32 uniform at minvals where
rounding the multiply-add twice differs from once (1e-6, negative), the
8- and 16-bit bit draws, bf16 uniform / gumbel / categorical, and
lm_serving.generate's sampled tokens at bf16 for one arch a family."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm_serving as jserving
from repro.models import model_zoo as jzoo
from repro_torch.configs import registry
from repro_torch.core import random as jrandom
from repro_torch.models import lm_serving, model

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_lm_serving import np_params  # noqa: E402

TINY = float(np.finfo(np.float32).tiny)


def _keys(seed: int):
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(seed)
    return key, jrandom.as_key(np.asarray(key))


@pytest.mark.parametrize("minval", [0.0, 1e-6, TINY, -2.0, -0.3])
@pytest.mark.parametrize("seed", [3, 11])
def test_float32_uniform_rounds_once(minval, seed):
    key, tkey = _keys(seed)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.uniform(key, (7, 613), minval=minval))
    got = jrandom.uniform(tkey, (7, 613), minval).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_round_once_resolves_float32_midpoints():
    """The float64 sum of (product, lo) can sit exactly on a float32
    midpoint while the exact value lies off it: the remainder's sign then
    decides (a plain cast would round to even)."""
    one, ulp = 1.0, float(np.spacing(np.float32(1.0)))
    mid = torch.tensor([one + ulp / 2] * 3, dtype=torch.float64)
    lo = torch.tensor([1e-30, -1e-30, 0.0], dtype=torch.float64)
    got = jrandom._round_f32_once(mid, lo).numpy()
    np.testing.assert_array_equal(
        got, np.array([one + ulp, one, one], np.float32))


@pytest.mark.parametrize("width,dtype", [(8, jnp.uint8), (16, jnp.uint16)])
def test_narrow_bits_equal_jax(width, dtype):
    key, tkey = _keys(5)
    for n in (1, 2, 3, 5, 7, 1001):
        with jax.threefry_partitionable(False):
            want = np.asarray(jax.random.bits(key, (n,), dtype))
        np.testing.assert_array_equal(
            jrandom.bits(tkey, (n,), width).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.7, 3.1), (TINY, 1.0),
                                   (1e-6, 1.0), (-2.0, -0.5)])
def test_bf16_uniform_equals_jax(lo, hi):
    key, tkey = _keys(7)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.uniform(key, (4001,), jnp.bfloat16,
                                             minval=lo, maxval=hi))
    got = jrandom.uniform(tkey, (4001,), lo, hi, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


def test_bf16_gumbel_equals_jax_on_every_uniform_value():
    """A bf16 uniform takes 128 values; 40,001 draws reach all of them, so
    the op-by-op -log(-log(u)) is checked on its whole domain."""
    key, tkey = _keys(3)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.gumbel(key, (40001,), jnp.bfloat16))
    got = jrandom.gumbel(tkey, (40001,), torch.bfloat16)
    u = jrandom.uniform(tkey, (40001,), TINY, 1.0, torch.bfloat16)
    assert len(torch.unique(u)) == 128
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("seed", [3, 11, 12345])
def test_bf16_categorical_equals_jax(seed):
    key, tkey = _keys(seed)
    logits = np.random.default_rng(seed).standard_normal(
        (64, 1000)).astype(np.float32)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.categorical(
            key, jnp.asarray(logits, jnp.bfloat16)))
    got = jrandom.categorical(tkey, torch.from_numpy(logits).to(
        torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), want)


def _bf16(arr: np.ndarray) -> np.ndarray:
    return arr.astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-2b",
                                  "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "whisper-tiny"])
def test_bf16_sampled_tokens_equal_jax(arch):
    """generate(greedy=False) at the SMOKE config's bf16, weights carried
    by params_from_jax (bf16 leaves as bf16, the float32 ones as float32),
    a bf16 frontier: JAX's tokens (one arch a family)."""
    jc, tc = jregistry.smoke_config(arch), registry.smoke_config(arch)
    assert jc.dtype == tc.dtype == "bfloat16"
    table = model.param_table(tc)
    pn = {k: (v if table[k].dtype == "float32" else _bf16(v))
          for k, v in np_params(jc).items()}
    pj = {k: jnp.asarray(v) for k, v in pn.items()}
    pt = model.params_from_jax(tc, pn, "cpu")
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, jc.vocab, (2, 8)).astype(np.int32)
    fs = jzoo._frontier_shape(jc, 2)
    fr = None if fs is None else _bf16(0.5 * rng.standard_normal(fs))
    kw = dict(max_new_tokens=5, cache_len=16 + jc.n_patches, greedy=False,
              temperature=0.7, seed=5)
    with jax.threefry_partitionable(False):
        want, _ = jserving.generate(
            jc, pj, jnp.asarray(prompts), jserving.ServeConfig(**kw),
            frontier=None if fr is None else jnp.asarray(fr))
    got, _ = lm_serving.generate(
        tc, pt, prompts, lm_serving.ServeConfig(**kw),
        frontier=None if fr is None else
        torch.from_numpy(fr.view(np.int16)).view(torch.bfloat16),
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
