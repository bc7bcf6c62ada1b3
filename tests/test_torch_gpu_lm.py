"""repro_torch's LM serving and training on a CUDA card, against the same
code on the CPU: every LM arch at its SMOKE config in float32 (TF32 off),
prefill and one decode step's logits and caches within 1e-4 of the
largest CPU value, generate's greedy tokens equal; loss_fn's gradients and
one train_step's update and optimizer state within 1e-4 of each leaf's
largest CPU value; lm_batch, float32 uniform at minval 1e-6 and the bf16
Gumbel noise and samples bit for bit.

These tests import no JAX (the card's machine need not have it), are marked
`gpu`, and skip where no card is present.  On a card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_lm.py
"""

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import random as jrandom
from repro_torch.data import pipeline
from repro_torch.models import lm_serving, model, model_zoo
from repro_torch.train import card_check

pytestmark = pytest.mark.gpu

RTOL = 1e-4
B, S = 2, 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _leaves(tree) -> list:
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


def _setup(arch):
    cfg = registry.smoke_config(arch).scaled(dtype="float32")
    params = model.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, S + 1), generator=gen)
    fs = model_zoo._frontier_shape(cfg, B)
    frontier = None if fs is None else 0.5 * torch.randn(fs, generator=gen)
    return cfg, params, tokens, frontier


@pytest.mark.parametrize("arch", registry.LM_ARCH_IDS)
def test_prefill_and_decode_on_the_card_equal_the_cpu(cuda, arch):
    cfg, params, tokens, frontier = _setup(arch)
    bm = model_zoo.build(cfg)
    outs = {}
    for dev in ("cpu", cuda):
        p = {k: v.to(dev) for k, v in params.items()}
        batch = {"tokens": tokens[:, :S].to(dev)}
        if frontier is not None:
            batch["frontier"] = frontier.to(dev)
        logits, pc = bm.prefill_step(p, batch)
        pre = [logits] + _leaves(pc)
        _, caches, pos0 = lm_serving.prefill_into_cache(
            cfg, p, batch, S + 8 + cfg.n_patches)
        dl, dc = bm.decode_step(p, caches, tokens[:, S:].to(dev), pos0)
        outs[str(dev)] = pre + [dl] + _leaves(dc)
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.is_cuda and got.shape == want.shape
        assert _rel(got, want) < RTOL


@pytest.mark.parametrize("arch", registry.LM_ARCH_IDS)
def test_greedy_generate_on_the_card_equals_the_cpu(cuda, arch):
    cfg, params, tokens, frontier = _setup(arch)
    scfg = lm_serving.ServeConfig(max_new_tokens=5,
                                  cache_len=S + 8 + cfg.n_patches)
    want, _ = lm_serving.generate(cfg, params, tokens[:, :S], scfg,
                                  frontier=frontier, device="cpu")
    got, stats = lm_serving.generate(
        cfg, {k: v.to(cuda) for k, v in params.items()}, tokens[:, :S],
        scfg, frontier=frontier)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert stats["tokens_per_s"] > 0


@pytest.mark.parametrize("arch", registry.LM_ARCH_IDS)
def test_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """train/card_check.card_cpu_step: loss_fn's loss and gradients, one
    train_step's loss, gradient norm, update (one float32 ulp of the new
    value allowed an element) and optimizer state, each within RTOL."""
    cfg, params, tokens, frontier = _setup(arch)
    batch = {"tokens": tokens[:, :S], "labels": tokens[:, 1:],
             "mask": torch.ones((B, S))}
    if frontier is not None:
        batch["frontier"] = frontier
    errs = card_check.card_cpu_step(cfg, params, batch)
    assert max(errs.values()) < RTOL, errs


def test_lm_batch_on_the_card_equals_the_cpu(cuda):
    dcfg = pipeline.LmDataConfig(vocab=151936, seq_len=1024, global_batch=8)
    got = pipeline.lm_batch(dcfg, 3, device=cuda)
    want = pipeline.lm_batch(dcfg, 3, device="cpu")
    for k in want:
        assert got[k].is_cuda and torch.equal(got[k].cpu(), want[k]), k


def test_random_draws_on_the_card_equal_the_cpu(cuda):
    key = jrandom.split(jrandom.PRNGKey(11))[1]
    for minval in (1e-6, -2.0):
        got = jrandom.uniform(key, (9, 1001), minval, device=cuda)
        want = jrandom.uniform(key, (9, 1001), minval)
        assert torch.equal(got.cpu(), want), minval
    got = jrandom.gumbel(key, (40001,), torch.bfloat16, device=cuda)
    want = jrandom.gumbel(key, (40001,), torch.bfloat16)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
    logits = torch.randn((64, 1000), generator=torch.Generator()
                         .manual_seed(4)).to(torch.bfloat16)
    assert torch.equal(jrandom.categorical(key, logits.to(cuda)).cpu(),
                       jrandom.categorical(key, logits))
