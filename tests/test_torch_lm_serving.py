"""The port's lm_serving.generate against the JAX package's, on the CPU at
the SMOKE configs in float32: greedy tokens equal for every LM arch, and
sampled tokens equal under the legacy threefry stream (the port emulates
jax.random's PRNGKey / split / categorical); the device contract of
generate; the port's key stream against jax.random."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import lm_serving as jserving
from repro.models import model as jmodel
from repro.models import model_zoo as jzoo
from repro_torch.configs import registry
from repro_torch.core import random as jrandom
from repro_torch.launch import roofline
from repro_torch.models import lm_serving, model, model_zoo

ARCHS = registry.LM_ARCH_IDS
B, S0, NEW = 2, 8, 5


def np_params(cfg, seed=0) -> dict:
    """Seeded numpy weights following the JAX package's param_table."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, par in sorted(jmodel.param_table(cfg).items()):
        fan_in = par.shape[-2] if len(par.shape) >= 2 else par.shape[-1]
        arr = rng.standard_normal(par.shape).astype(np.float32)
        if par.init == "normal":
            arr *= fan_in ** -0.5
        elif par.init == "alog":
            ns = par.shape[-1]
            arr = np.broadcast_to(np.log(np.arange(1, ns + 1)), par.shape) \
                .astype(np.float32) if ns > 1 else np.zeros(par.shape,
                                                            np.float32)
        else:            # ones / zeros / dtbias, perturbed
            base = {"ones": 1.0, "zeros": 0.0, "dtbias": -2.0}[par.init]
            arr = base + 0.1 * arr
        out[name] = arr
    return out


class Setup:
    """One arch in float32: weights and prompts in both packages."""

    def __init__(self, arch):
        self.jc = jregistry.smoke_config(arch).scaled(dtype="float32")
        self.tc = registry.smoke_config(arch).scaled(dtype="float32")
        pn = np_params(self.jc)
        self.pj = {k: jnp.asarray(v) for k, v in pn.items()}
        self.pt = model.params_from_jax(self.tc, pn, "cpu")
        rng = np.random.default_rng(2)
        self.prompts = rng.integers(0, self.jc.vocab, (B, S0)).astype(
            np.int32)
        fs = jzoo._frontier_shape(self.jc, B)
        self.frontier = None if fs is None else \
            (0.5 * rng.standard_normal(fs)).astype(np.float32)

    def scfg(self, mod, greedy):
        return mod.ServeConfig(max_new_tokens=NEW,
                               cache_len=S0 + NEW + 3 + self.jc.n_patches,
                               greedy=greedy, temperature=0.7, seed=5)

    def both(self, greedy):
        fr = None if self.frontier is None else jnp.asarray(self.frontier)
        with jax.threefry_partitionable(False):
            want, _ = jserving.generate(self.jc, self.pj,
                                        jnp.asarray(self.prompts),
                                        self.scfg(jserving, greedy),
                                        frontier=fr)
        got, stats = lm_serving.generate(self.tc, self.pt, self.prompts,
                                         self.scfg(lm_serving, greedy),
                                         frontier=self.frontier,
                                         device="cpu")
        return np.asarray(want), got, stats


@pytest.fixture(scope="module")
def setups():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = Setup(arch)
        return memo[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_jax(setups, arch):
    want, got, stats = setups(arch).both(greedy=True)
    assert got.dtype == torch.int32 and got.shape == (B, S0 + NEW)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(stats) == {"prefill_s", "decode_s", "tokens_per_s"}
    assert stats["tokens_per_s"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_tokens_equal_jax_legacy_threefry(setups, arch):
    want, got, _ = setups(arch).both(greedy=False)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_needs_a_card_unless_cpu(setups, monkeypatch):
    st = setups("smollm-360m")
    scfg = st.scfg(lm_serving, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_serving.generate(st.tc, st.pt, st.prompts, scfg)
    # weights on the CPU for a run on the card: refused, not run here
    with pytest.raises(ValueError, match="on cpu"):
        lm_serving.generate(st.tc, st.pt, st.prompts, scfg, device="cuda")


def test_bf16_generate_on_the_cpu():
    cfg = registry.smoke_config("qwen3-1.7b")
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.randint(0, cfg.vocab, (3, 6),
                            generator=torch.Generator().manual_seed(1))
    out, stats = lm_serving.generate(
        cfg, params, prompts,
        lm_serving.ServeConfig(max_new_tokens=4, cache_len=16), device="cpu")
    assert out.shape == (3, 10) and torch.equal(out[:, :6],
                                                prompts.to(torch.int32))
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab
    assert stats["prefill_s"] > 0 and stats["decode_s"] > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_copy_prefill_into_cache_matches_jax(arch):
    jc = jregistry.smoke_config(arch).scaled(dtype="float32")
    tc = registry.smoke_config(arch).scaled(dtype="float32")
    rng = np.random.default_rng(3)
    big_j = jzoo.init_cache(jc, B, 20)
    pref_j = jax.tree.map(
        lambda a: rng.standard_normal(
            a.shape[:-3] + (S0,) + a.shape[-2:] if a.ndim >= 5 and
            a.shape[-3] == 20 else a.shape).astype(np.float32), big_j)
    want = jserving._copy_prefill_into_cache(
        jc, jax.tree.map(jnp.asarray, pref_j), big_j, S0)
    got = lm_serving._copy_prefill_into_cache(
        tc, model.caches_from_jax(pref_j, "cpu"),
        model_zoo.init_cache(tc, B, 20, "cpu"), S0)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, want)),
                    jax.tree.leaves(model.caches_to_numpy(got))):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("shape", [(1,), (3, 7), (2, 256)])
def test_uniform_and_categorical_equal_jax(shape):
    tiny = float(np.finfo(np.float32).tiny)
    logits = np.random.default_rng(4).standard_normal(shape).astype(
        np.float32)
    with jax.threefry_partitionable(False):
        key = jax.random.PRNGKey(11)
        _, sub = jax.random.split(key)
        u = np.asarray(jax.random.uniform(sub, shape, minval=tiny))
        c = np.asarray(jax.random.categorical(sub, logits))
        bits = np.asarray(jax.random.bits(sub, shape))
    sub_t = jrandom.split(jrandom.PRNGKey(11))[1]
    np.testing.assert_array_equal(
        jrandom.bits32(sub_t, shape).numpy(), bits.astype(np.int64))
    np.testing.assert_array_equal(jrandom.uniform(sub_t, shape, tiny).numpy(),
                                  u)
    np.testing.assert_array_equal(
        jrandom.categorical(sub_t, torch.from_numpy(logits)).numpy(), c)


def test_lm_bounds_by_hand():
    """launch/roofline's LM step prices on qwen3-1.7b's smoke config
    (dense, GQA) and whisper's (encoder, cross-attention), by hand."""
    cfg = registry.smoke_config("qwen3-1.7b")     # bf16: 2 bytes
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff
    norms = L * (2 * d + 2 * hd) + d
    weights = 2 * (L * layer + v * d + norms)
    b, s0, cache = 3, 10, 40
    ops, nbytes = roofline.lm_decode_work(cfg, b, cache)
    assert nbytes == weights + L * 2 * b * cache * hkv * hd * 2
    assert ops == 2 * b * (L * layer + v * d) + 4 * b * hq * hd * L * cache
    ops, nbytes = roofline.lm_prefill_work(cfg, b, s0)
    assert nbytes == weights + L * 2 * b * s0 * hkv * hd * 2
    assert ops == 2 * (b * s0 * L * layer + b * v * d) + \
        4 * b * hq * hd * L * s0 * (s0 + 1) / 2
    ms, by = roofline.lm_bound(ops, nbytes)
    assert by == "bytes" and ms == nbytes / roofline.HBM_BYTES_PER_S * 1e3
    assert roofline.lm_bound(1e12, 1.0) == (
        1e12 / roofline.BF16_FLOPS_PER_S * 1e3, "operations")
    w = registry.smoke_config("whisper-tiny")
    d, ff, se, le = w.d_model, w.d_ff, w.encoder_seq, w.encoder_layers
    attn = 4 * d * d                               # n_kv == n_heads
    ops_no_enc = roofline.lm_prefill_work(w.scaled(encoder_layers=0), b,
                                          s0)[0]
    ops, _ = roofline.lm_prefill_work(w, b, s0)
    assert ops - ops_no_enc == 2 * b * se * le * (attn + 2 * d * ff) + \
        4 * b * w.n_heads * w.hd * le * se * se


def test_lm_bounds_read_only_the_routable_experts():
    """An MoE step's bytes hold min(n_experts, tokens x top_k) experts a
    layer: a decode batch of one token a sequence reads few of them,
    prefill all."""
    cfg = registry.smoke_config("qwen3-moe-30b-a3b")
    e, k, d, ff, L = (cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff,
                      cfg.n_layers)
    expert = 2 * 3 * d * ff * L                   # bf16 w_gate, w_up, w_down
    dense = roofline._lm_terms(cfg)["weight_bytes"] - e * expert
    kv = L * 2 * cfg.n_kv * cfg.hd * 2            # one position, K and V
    assert 1 * k < e
    for b, cache in ((1, 16), (e, 16)):
        _, nbytes = roofline.lm_decode_work(cfg, b, cache)
        assert nbytes == dense + min(e, b * k) * expert + b * cache * kv
    _, nbytes = roofline.lm_prefill_work(cfg, 1, 8)
    assert nbytes == dense + e * expert + 8 * kv
