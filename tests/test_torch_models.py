"""The port's LM stack (repro_torch.models) against the JAX package's, on
the CPU at the SMOKE configs.

Weights are made with numpy from a seed, following the JAX package's
param_table, and carried to both packages (the port's through
params_from_jax).  Norm weights and biases are perturbed away from their
ones / zeros inits, so that a dropped norm or bias shows.  Tolerances:
float32, |port - JAX| <= 1e-4 x max|JAX| (measured ~1e-6); the configs'
bf16, correlation >= 0.999 over logits and caches for every arch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import common as jcommon
from repro.models import config as jconfig
from repro.models import lm_serving as jserving
from repro.models import model as jmodel
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import registry
from repro_torch.models import common, config, model, model_zoo, moe, ssm
from repro_torch.models import lm_serving

ARCHS = registry.LM_ARCH_IDS
RTOL_F32 = 1e-4            # of max |JAX|
MIN_CORR_BF16 = 0.999
B, S = 2, 12


def np_params(cfg, seed=0) -> dict:
    """numpy weights for `cfg` following the JAX package's param_table
    (float32 values; bf16 parameters get them rounded by the caller)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, par in sorted(jmodel.param_table(cfg).items()):
        noise = 0.1 * rng.standard_normal(par.shape).astype(np.float32)
        if par.init == "normal":
            fan_in = par.shape[-2] if len(par.shape) >= 2 else par.shape[-1]
            arr = rng.standard_normal(par.shape).astype(np.float32) \
                * fan_in ** -0.5
        elif par.init == "ones":
            arr = 1.0 + noise
        elif par.init == "zeros":
            arr = noise
        elif par.init == "alog":
            ns = par.shape[-1]
            arr = np.broadcast_to(np.log(np.arange(1, ns + 1)), par.shape) \
                .astype(np.float32) if ns > 1 else np.zeros(par.shape,
                                                            np.float32)
        else:
            arr = np.full(par.shape, -2.0, np.float32) + noise
        out[name] = arr
    return out


def jax_params(cfg, pn: dict) -> dict:
    table = jmodel.param_table(cfg)
    return {k: jnp.asarray(v, table[k].dtype or cfg.dtype)
            for k, v in pn.items()}


def configs(arch, dtype=None, capacity_factor=None):
    jc, tc = jregistry.smoke_config(arch), registry.smoke_config(arch)
    kw = {}
    if dtype:
        kw["dtype"] = dtype
    if capacity_factor and jc.family == "moe":
        kw["capacity_factor"] = capacity_factor
    return jc.scaled(**kw), tc.scaled(**kw)


def rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def corr(got, want) -> float:
    return float(np.corrcoef(np.asarray(got, np.float32).ravel(),
                             np.asarray(want, np.float32).ravel())[0, 1])


def leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


class Case:
    """One arch at one dtype: the same weights and inputs in both
    packages, and the JAX package's prefill / decode outputs."""

    def __init__(self, arch, dtype):
        self.jc, self.tc = configs(arch, dtype)
        pn = np_params(self.jc)
        self.pj = jax_params(self.jc, pn)
        self.pt = model.params_from_jax(
            self.tc, {k: np.asarray(v) for k, v in self.pj.items()}, "cpu")
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.jc.vocab, (B, S + 1)) \
            .astype(np.int32)
        fs = jzoo._frontier_shape(self.jc, B)
        self.frontier = None if fs is None else \
            (0.5 * rng.standard_normal(fs)).astype(np.float32)
        bj = jzoo.build(self.jc)
        batch = {"tokens": jnp.asarray(self.tokens[:, :S])}
        if self.frontier is not None:
            batch["frontier"] = jnp.asarray(self.frontier, self.jc.jdtype)
        self.logits, pc = jax.jit(bj.prefill_step)(self.pj, batch)
        self.caches = jax.tree.map(np.asarray, pc)
        self.max_seq = S + 8 + self.n_prefix
        c = jserving._copy_prefill_into_cache(
            self.jc, pc, jzoo.init_cache(self.jc, B, self.max_seq), S)
        self.dec_logits, dc = jax.jit(bj.decode_step)(
            self.pj, c, jnp.asarray(self.tokens[:, S:]),
            jnp.asarray(S + self.n_prefix, jnp.int32))
        self.dec_caches = jax.tree.map(np.asarray, dc)

    @property
    def n_prefix(self) -> int:
        return self.jc.n_patches if self.jc.family == "vlm" else 0

    def torch_batch(self, tokens):
        batch = {"tokens": torch.from_numpy(tokens)}
        if self.frontier is not None:
            batch["frontier"] = torch.from_numpy(self.frontier).to(
                self.tc.torch_dtype)
        return batch

    def torch_steps(self):
        """The port's prefill logits and caches, then one decode step's
        logits and caches from the JAX package's prefill caches."""
        bt = model_zoo.build(self.tc)
        logits, pc = bt.prefill_step(self.pt,
                                     self.torch_batch(self.tokens[:, :S]))
        prefill = (logits, model.caches_to_numpy(pc))
        c = lm_serving._copy_prefill_into_cache(
            self.tc, model.caches_from_jax(self.caches, "cpu"),
            model_zoo.init_cache(self.tc, B, self.max_seq, "cpu"), S)
        dl, dc = bt.decode_step(self.pt, c, torch.from_numpy(
            self.tokens[:, S:]), S + self.n_prefix)
        return prefill, (dl, model.caches_to_numpy(dc))


@pytest.fixture(scope="module")
def cases():
    memo = {}

    def get(arch, dtype):
        if (arch, dtype) not in memo:
            memo[arch, dtype] = Case(arch, dtype)
        return memo[arch, dtype]
    return get


# ------------------------------------------------------------ configs, table

@pytest.mark.parametrize("arch", ARCHS)
def test_param_table_and_counts_match_jax(arch):
    jc, tc = configs(arch)
    jt, tt = jmodel.param_table(jc), model.param_table(tc)
    assert list(jt) == list(tt)
    for name in jt:
        assert dataclasses.asdict(jt[name]) == dataclasses.asdict(tt[name]), \
            name
    jfull, tfull = jregistry.get_config(arch), registry.get_config(arch)
    assert tfull.param_count() == jfull.param_count()
    assert tfull.active_param_count() == jfull.active_param_count()
    for prop in ("hd", "d_inner", "dt_rank", "mamba2_heads"):
        assert getattr(tfull, prop) == getattr(jfull, prop), prop
    assert [s.name for s in config.applicable_shapes(tfull)] == \
        [s.name for s in jconfig.applicable_shapes(jfull)]
    assert tfull.torch_dtype == torch.bfloat16


def test_shapes_match_jax():
    assert [dataclasses.asdict(s) for s in config.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in jconfig.ALL_SHAPES]


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "whisper-tiny",
                                  "arctic-480b"])
def test_init_params_follows_the_table(arch):
    _, tc = configs(arch)
    gen = torch.Generator().manual_seed(0)
    params = model.init_params(tc, gen, "cpu")
    again = model.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    table = model.param_table(tc)
    assert list(params) == sorted(table)
    for name, par in table.items():
        t = params[name]
        assert tuple(t.shape) == par.shape, name
        assert t.dtype == (getattr(torch, par.dtype) if par.dtype
                           else torch.bfloat16), name
        assert torch.equal(t, again[name]), name
        tf = t.float()
        if par.init == "ones":
            assert torch.all(tf == 1), name
        elif par.init == "zeros":
            assert torch.all(tf == 0), name
        elif par.init == "dtbias":
            assert torch.all(tf == -2), name
        elif par.init == "alog":
            ns = par.shape[-1]
            want = torch.log(torch.arange(1, ns + 1, dtype=torch.float32))
            assert torch.equal(tf, want.expand(par.shape)), name
        else:
            fan_in = par.shape[-2] if len(par.shape) >= 2 else par.shape[-1]
            assert abs(tf.std().item() * fan_in ** 0.5 - 1) < 0.1, name


def test_params_from_jax_carries_the_jax_init():
    jc, tc = configs("qwen2.5-3b")
    pj = jzoo.build(jc).init_params(jax.random.PRNGKey(0))
    pn = {k: np.asarray(v) for k, v in pj.items()}
    pt = model.params_from_jax(tc, pn, "cpu")
    for name, arr in pn.items():
        assert pt[name].dtype == (torch.float32 if arr.dtype == np.float32
                                  else torch.bfloat16), name
        np.testing.assert_array_equal(pt[name].float().numpy(),
                                      arr.astype(np.float32))
    # a bf16 parameter may come as float32 values
    f32 = dict(pn, embed=pn["embed"].astype(np.float32))
    assert torch.equal(model.params_from_jax(tc, f32, "cpu")["embed"],
                       pt["embed"])
    with pytest.raises(ValueError, match="shape"):
        model.params_from_jax(tc, dict(pn, embed=pn["embed"][:, :-1]),
                              "cpu")
    with pytest.raises(ValueError, match="names"):
        model.params_from_jax(tc, {k: v for k, v in pn.items()
                                   if k != "final_norm"}, "cpu")
    with pytest.raises(ValueError, match="dtype"):
        model.params_from_jax(tc, dict(pn, embed=pn["embed"].astype(
            np.float16)), "cpu")


# -------------------------------------------------------------- common.py

def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def test_rms_norm_rope_and_mlps_match_jax():
    rng = np.random.default_rng(2)
    x, w = _rand(rng, 2, 5, 3, 16), _rand(rng, 16)
    t = torch.from_numpy
    assert rel_err(common.rms_norm(t(x), t(w), 1e-6),
                   jcommon.rms_norm(x, w, 1e-6)) < RTOL_F32
    pos = np.array([[0, 3, 7, 100, 4095]], np.int32)
    assert rel_err(common.rope(t(x), t(pos), 1e6),
                   jcommon.rope(x, pos, 1e6)) < RTOL_F32
    h = _rand(rng, 2, 5, 16)
    wg, wu, wd = _rand(rng, 16, 24), _rand(rng, 16, 24), _rand(rng, 24, 16)
    assert rel_err(common.swiglu(t(h), t(wg), t(wu), t(wd)),
                   jcommon.swiglu(h, wg, wu, wd)) < RTOL_F32
    bi, bo = _rand(rng, 24), _rand(rng, 16)
    assert rel_err(common.gelu_mlp(t(h), t(wg), t(bi), t(wd), t(bo)),
                   jcommon.gelu_mlp(h, wg, bi, wd, bo)) < RTOL_F32


@pytest.mark.parametrize("causal,window,q_offset,skv,chunk", [
    (True, None, 0, 20, 1024),       # one chunk
    (True, None, 0, 20, 8),          # ragged last chunk (JAX pads it)
    (True, 5, 0, 20, 8),             # sliding window
    (False, None, 0, 13, 4),         # non-causal (encoder, cross)
    (True, None, 11, 13, 4),         # q_offset: the last two positions
])
def test_flash_attention_matches_jax(causal, window, q_offset, skv, chunk):
    rng = np.random.default_rng(3)
    sq = skv if q_offset == 0 else skv - q_offset
    q, k, v = (_rand(rng, 2, sq, 4, 8), _rand(rng, 2, skv, 2, 8),
               _rand(rng, 2, skv, 2, 8))
    t = torch.from_numpy
    got = common.flash_attention(t(q), t(k), t(v), causal=causal,
                                 window=window, q_offset=q_offset,
                                 kv_chunk=chunk)
    want = jcommon.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_chunk=chunk)
    assert rel_err(got, want) < RTOL_F32


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(4)
    q, kc, vc = (_rand(rng, 2, 1, 6, 8), _rand(rng, 2, 16, 3, 8),
                 _rand(rng, 2, 16, 3, 8))
    t = torch.from_numpy
    for length in (1, 9, 16):
        assert rel_err(common.decode_attention(t(q), t(kc), t(vc), length),
                       jcommon.decode_attention(q, kc, vc, length)) \
            < RTOL_F32


# ----------------------------------------------------------------- moe.py

@pytest.mark.parametrize("s,cf", [(12, 1.0), (1, 1.25)])
def test_moe_forward_matches_jax_with_drops(s, cf):
    """cf 1.0 at 24 tokens drops tokens; s = 1 (a decode step) takes the
    floor of min(T*k, 4) slots an expert."""
    jc, tc = configs("qwen3-moe-30b-a3b", "float32", cf)
    pn = np_params(jc)
    p = {k[len("layers/"):]: v[0] for k, v in pn.items()
         if k.split("/")[-1] in ("router", "w_gate", "w_up", "w_down")}
    x = _rand(np.random.default_rng(5), B, s, jc.d_model)
    out_j, aux_j = jax.jit(lambda p, x: jmoe.moe_forward(p, x, jc))(p, x)
    out_t, aux_t = moe.moe_forward({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   torch.from_numpy(x), tc)
    assert rel_err(out_t, out_j) < RTOL_F32
    assert abs(float(aux_t) - float(aux_j)) < 1e-5 * float(aux_j)
    t = B * s
    cap = moe.capacity(tc, t)
    assert cap == max(max(1, int(cf * t * tc.top_k / tc.n_experts)),
                      min(t * tc.top_k, 4))
    if s > 1:      # some expert got more than its slots: a token dropped
        gate_i = torch.topk(torch.from_numpy(x.reshape(t, -1)) @
                            torch.from_numpy(p["router"]), tc.top_k).indices
        assert torch.bincount(gate_i.flatten()).max() > cap


# ----------------------------------------------------------------- ssm.py

def _layer0(pn, cfg):
    return {k[len("layers/"):]: v[0] for k, v in pn.items()
            if k.startswith("layers/")}


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_ssm_prefill_and_decode_match_jax(arch):
    jc, tc = configs(arch, "float32")
    p = _layer0(np_params(jc), jc)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    rng = np.random.default_rng(6)
    x, x1 = _rand(rng, B, 20, jc.d_model), _rand(rng, B, 1, jc.d_model)
    if jc.ssm_version == 1:
        jfwd, tfwd = jssm.mamba1_forward, ssm.mamba1_forward
    else:
        def jfwd(p, x, cfg, cache=None):
            return jssm.mamba2_forward(p, x, cfg, cache, chunk=8)

        def tfwd(p, x, cfg, cache=None):
            return ssm.mamba2_forward(p, x, cfg, cache, chunk=8)
    yj, cj = jax.jit(lambda p, x: jfwd(p, x, jc))(p, x)
    yt, ct = tfwd(pt, torch.from_numpy(x), tc)
    assert rel_err(yt, yj) < RTOL_F32
    for a, b in zip(ct, cj):
        assert rel_err(a, b) < RTOL_F32
    # one decode step from the prefill's cache
    dj, dcj = jax.jit(lambda p, x, c: jfwd(p, x, jc, c))(p, x1, cj)
    dt, dct = tfwd(pt, torch.from_numpy(x1), tc, ct)
    assert rel_err(dt, dj) < RTOL_F32
    for a, b in zip(dct, dcj):
        assert rel_err(a, b) < RTOL_F32
    zj = jssm.ssm_decode_cache(jc, B, jnp.float32)
    zt = ssm.ssm_decode_cache(tc, B, torch.float32)
    assert [tuple(a.shape) for a in zt] == [a.shape for a in zj]
    assert [a.dtype for a in zt] == [torch.float32, torch.float32]


def test_ssd_equals_the_scan_and_a_ragged_chunk():
    """The port's SSD form equals its own recurrence, also with a last
    chunk that needs padding, and from a non-zero state."""
    jc, tc = configs("zamba2-2.7b", "float32")
    pt = {k: torch.from_numpy(v) for k, v in _layer0(np_params(jc),
                                                     jc).items()}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_rand(rng, B, 21, jc.d_model))
    y_scan, (cv, h_scan) = ssm.mamba2_forward_scan(pt, x, tc)
    for chunk in (8, 21, 128):
        y, (_, h) = ssm.mamba2_forward(pt, x, tc, chunk=chunk)
        assert rel_err(y, y_scan) < RTOL_F32
        assert rel_err(h, h_scan) < RTOL_F32
    x2 = torch.from_numpy(_rand(rng, B, 9, jc.d_model))
    ya, (_, ha) = ssm.mamba2_forward(pt, x2, tc, (cv, h_scan), chunk=4)
    yb, (_, hb) = ssm.mamba2_forward_scan(pt, x2, tc, (cv, h_scan))
    assert rel_err(ya, yb) < RTOL_F32 and rel_err(ha, hb) < RTOL_F32


def test_encode_frames_matches_jax():
    jc, tc = configs("whisper-tiny", "float32")
    pn = np_params(jc)
    frames = _rand(np.random.default_rng(8), B, jc.encoder_seq, jc.d_model)
    want = jax.jit(lambda p, f: jmodel.encode_frames(jc, p, f))(
        jax_params(jc, pn), frames)
    got = model.encode_frames(tc, model.params_from_jax(tc, pn, "cpu"),
                              torch.from_numpy(frames))
    assert rel_err(got, want) < RTOL_F32


# ------------------------------------------------- prefill and decode steps

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax_f32(cases, arch):
    case = cases(arch, "float32")
    (pl, pc), (dl, dc) = case.torch_steps()
    assert rel_err(pl, case.logits) < RTOL_F32
    assert rel_err(dl, case.dec_logits) < RTOL_F32
    for got, want in ((pc, case.caches), (dc, case.dec_caches)):
        g, w = leaves(got), leaves(want)
        assert [x.shape for x in g] == [x.shape for x in w]
        for a, b in zip(g, w):
            assert rel_err(a, b) < RTOL_F32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_track_jax_bf16(cases, arch):
    case = cases(arch, None)
    (pl, pc), (dl, dc) = case.torch_steps()
    assert pl.dtype == torch.bfloat16
    got = [pl.float(), dl.float()] + leaves(pc) + leaves(dc)
    want = [case.logits, case.dec_logits] + leaves(case.caches) + \
        leaves(case.dec_caches)
    corrs = [corr(g, w) for g, w in zip(got, want)]
    print(f"{arch}: bf16 worst correlation with JAX {min(corrs):.6f}")
    assert min(corrs) >= MIN_CORR_BF16, corrs


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_full_forward(arch):
    """The port alone: prefill of S tokens, then one decode step, gives the
    full forward's logits at S (MoE: capacity 8, so that no token drops
    in either pass)."""
    _, tc = configs(arch, "float32", capacity_factor=8.0)
    params = model.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, tc.vocab, (B, S + 1)))
    fs = model_zoo._frontier_shape(tc, B)
    frontier = None if fs is None else torch.full(fs, 0.01)
    bm = model_zoo.build(tc)
    full, _ = bm.prefill_step(params, {"tokens": tokens,
                                       "frontier": frontier})
    _, caches, pos0 = lm_serving.prefill_into_cache(
        tc, params, {"tokens": tokens[:, :S], "frontier": frontier},
        S + 8 + tc.n_patches)
    dec, _ = bm.decode_step(params, caches, tokens[:, S:], pos0)
    assert rel_err(dec[:, -1], full[:, -1]) < RTOL_F32
