"""repro_torch's LM serving on a CUDA card, against the same code on the
CPU: every LM arch at its SMOKE config in float32 (TF32 off), prefill and
one decode step's logits and caches within 1e-4 of the largest CPU value,
and generate's greedy tokens equal.

These tests import no JAX (the card's machine need not have it), are marked
`gpu`, and skip where no card is present.  On a card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_lm.py
"""

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.models import lm_serving, model, model_zoo

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
