"""The LM half of the port's launch layer: roofline.model_flops against
the JAX package's, lm_train_work and the optimizer-state bytes by hand,
the dry run's LM cell (its modelled state, work and collective bytes by
hand; one SMOKE step of each kind executed on the CPU)."""

import pytest

from repro.configs import registry as jregistry
from repro.launch import roofline as jroofline
from repro.models.config import ALL_SHAPES as J_SHAPES
from repro_torch.configs import registry
from repro_torch.launch import lm_dryrun, roofline
from repro_torch.models.config import ALL_SHAPES
from repro_torch.sharding import partition


def test_model_flops_equals_jax():
    for arch in registry.LM_ARCH_IDS:
        for js, ts in zip(J_SHAPES, ALL_SHAPES):
            assert roofline.model_flops(registry.get_config(arch), ts) == \
                jroofline.model_flops(jregistry.get_config(arch), js)


def test_lm_train_work_by_hand():
    """qwen3-1.7b's smoke config (dense, GQA, tied embedding, bf16,
    adamw): 3 forwards with every position's logits (4 under remat);
    weights read and gradients written, the float32 moments read and
    written."""
    cfg = registry.smoke_config("qwen3-1.7b")
    d, ff, v, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff
    n_params = L * layer + v * d + L * (2 * d + 2 * hd) + d
    b, s = 3, 10
    fwd = 2 * b * s * (L * layer + v * d) + \
        4 * b * hq * hd * L * s * (s + 1) / 2
    ops, nbytes = roofline.lm_train_work(cfg, b, s, remat=True)
    assert ops == 4 * fwd
    assert roofline.lm_train_work(cfg, b, s, remat=False)[0] == 3 * fwd
    assert roofline.opt_state_bytes(cfg) == 4 * 2 * n_params
    assert nbytes == 2 * 2 * n_params + 2 * 4 * 2 * n_params


def test_adafactor_state_bytes_by_hand():
    cfg = registry.smoke_config("arctic-480b")
    from repro_torch.models.model import param_table
    want = 0
    for par in param_table(cfg).values():
        n = 1
        for x in par.shape:
            n *= x
        want += (n // par.shape[-1] + n // par.shape[-2]) \
            if len(par.shape) >= 2 else n
    assert cfg.optimizer == "adafactor"
    assert roofline.opt_state_bytes(cfg) == 4 * want


def test_lm_cell_model_by_hand():
    """qwen3-1.7b x train_4k x pod: state from the structs; work from
    lm_train_work; the ring formulas of the module docstring."""
    rec = lm_dryrun.model_record("qwen3-1.7b", "train_4k", False)
    cfg = registry.get_config("qwen3-1.7b")
    mesh = lm_dryrun.mesh_lib.make_production_mesh()
    shape = lm_dryrun.SHAPES["train_4k"]
    assert rec["fsdp"] is False and rec["microbatch"] == 32 and \
        rec["loss_chunk"] == 512 and rec["modelled"] is True
    assert rec["bytes_per_rank"]["params"] == lm_dryrun._nbytes(
        partition.param_structs(cfg, mesh))
    assert rec["bytes_per_rank"]["opt_state"] == lm_dryrun._nbytes(
        partition.opt_state_structs(cfg, mesh))
    ops, nbytes = roofline.lm_train_work(cfg, 256, 4096, True)
    assert (rec["ops"], rec["bytes"]) == (ops, nbytes)
    w_rank = roofline._lm_terms(cfg)["weight_bytes"] / 16
    assert rec["coll_bytes_per_rank"]["data"] == 2 * 15 / 16 * w_rank
    tokens = 256 * 4096 / 16
    assert rec["coll_bytes_per_rank"]["model"] == pytest.approx(
        3 * 2 * cfg.n_layers * 2 * 15 / 16 * tokens * cfg.d_model * 2)
    assert rec["compute_s"] == ops / (256 * roofline.BF16_FLOPS_PER_S)
    assert rec["model_flops"] == roofline.model_flops(cfg, shape)
    assert rec["dominant"] in ("compute", "memory", "collective")
    dec = lm_dryrun.model_record("arctic-480b", "decode_32k", True)
    assert dec["fsdp"] is True and "caches" in dec["bytes_per_rank"]


@pytest.mark.parametrize("arch,shape", [("internvl2-2b", "train_4k"),
                                        ("whisper-tiny", "prefill_32k"),
                                        ("zamba2-2.7b", "long_500k"),
                                        ("qwen3-moe-30b-a3b", "decode_32k")])
def test_lm_cell_executes_a_smoke_step_on_the_cpu(arch, shape, capsys):
    rec = lm_dryrun.dryrun_cell(arch, shape, False, execute_ranks=1,
                                device="cpu")
    ex = rec["executed"]
    assert ex["finite"] and ex["device"] == "cpu" and ex["peak_bytes"] is None
    assert ex["kind"] == lm_dryrun.SHAPES[shape].kind
    out = capsys.readouterr().out
    assert out.startswith(f"--- {arch} x {shape} x pod(256) ---")
    assert "executed: SMOKE" in out


def test_lm_cell_skips():
    rec = lm_dryrun.dryrun_cell("qwen3-1.7b", "long_500k", True, 0)
    assert rec["status"] == lm_dryrun.SKIPPED
    rec = lm_dryrun.dryrun_cell("qwen3-1.7b", "smoke", False, 0)
    assert rec["status"].startswith("skipped (no smoke shape")
