"""The port's LM data stream, checkpoints, trainer and LM launch route on
the CPU:

* data/pipeline.lm_batch against the JAX package's, bit for bit, at
  several seeds, steps and host slices (legacy threefry);
* the JAX package's system tests mirrored (tests/test_system.py): the
  loss falls, a restart continues exactly, partial writes are ignored,
  async save then wait, secure aggregation trains;
* a checkpoint written by the JAX package's Checkpointer restores into
  the port (bf16 leaves included);
* train's loss history over 5 steps against the JAX package's trainer
  within 1e-4 relative, from the same weights (the port's init_params
  patched here to return the JAX package's, carried by params_from_jax);
* launch.train --arch <lm> --device cpu; the device contract."""

import shutil
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import pipeline as jpipeline
from repro.models import model_zoo as jzoo
from repro.train import checkpoint as jcheckpoint
from repro.train import trainer as jtrainer
from repro_torch.configs import registry
from repro_torch.core.secure_agg import SecureAggConfig
from repro_torch.data import pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import model
from repro_torch.train import checkpoint, trainer


@pytest.mark.parametrize("seed,step,host_slice,vocab,b,s", [
    (0, 0, None, 151936, 4, 129),
    (3, 7, (2, 3), 1000, 8, 64),
    (5, 11, None, 50, 4, 33),
    (1, 2, (0, 4), 128, 4, 16),
    (2, 123456, (5, 2), 32000, 8, 257),
])
def test_lm_batch_equals_jax(seed, step, host_slice, vocab, b, s):
    jc = jpipeline.LmDataConfig(vocab=vocab, seq_len=s, global_batch=b,
                                seed=seed)
    tc = pipeline.LmDataConfig(vocab=vocab, seq_len=s, global_batch=b,
                               seed=seed)
    with jax.threefry_partitionable(False):
        want = jpipeline.lm_batch(jc, step, host_slice=host_slice)
    got = pipeline.lm_batch(tc, step, host_slice=host_slice, device="cpu")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_trunc_powf_takes_the_c_library_near_integers():
    """int32(powf(u, e)): the float64 power decides away from integers;
    near one the C library's powf (XLA:CPU's) decides."""
    e = np.float32(-1.0 / 1.2)
    u = np.random.default_rng(0).random(200_000).astype(np.float32) + \
        np.float32(1e-6)
    powf = pipeline._libm_powf()
    want = np.array([int(powf(float(x), float(e))) for x in u[:20_000]])
    np.testing.assert_array_equal(pipeline._trunc_powf(u[:20_000], e), want)
    # exact integers: u = 2^-12 gives 2^10 exactly
    u = np.float32([2.0 ** -12])
    assert pipeline._trunc_powf(u, np.float32(-10 / 12)) == \
        int(powf(float(u[0]), float(np.float32(-10 / 12))))


def test_lm_training_reduces_loss():
    cfg = registry.smoke_config("smollm-360m")
    tcfg = trainer.TrainConfig(steps=12, global_batch=4, seq_len=64,
                               log_every=1)
    _, hist = trainer.train(cfg, tcfg, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.98


def test_checkpoint_restart_exact_continuation(tmp_path):
    """8 steps straight == 5 steps, restart, 3 more (the data stream is
    keyed by step): bit for bit on the CPU."""
    cfg = registry.smoke_config("smollm-360m")
    d = str(tmp_path / "ck")
    kw = dict(global_batch=2, seq_len=32, log_every=1, seed=7)
    straight, _ = trainer.train(cfg, trainer.TrainConfig(steps=8, **kw),
                                device="cpu")
    trainer.train(cfg, trainer.TrainConfig(steps=5, ckpt_dir=d,
                                           ckpt_every=4, **kw),
                  device="cpu")
    resumed, hist = trainer.train(
        cfg, trainer.TrainConfig(steps=8, ckpt_dir=d, ckpt_every=100, **kw),
        device="cpu")
    assert hist[0]["step"] == 5
    for k in straight:
        assert torch.equal(straight[k], resumed[k]), k


def test_checkpoint_saves_the_values_at_save_time(tmp_path, monkeypatch):
    """save() copies CPU tensors before its write thread runs: an in-place
    update made while the write is pending (the trainer's next step) does
    not reach the checkpoint, in float32 and bf16."""
    go = threading.Event()
    write = checkpoint.Checkpointer._write

    def held_write(self, *args):
        go.wait(30)
        write(self, *args)
    monkeypatch.setattr(checkpoint.Checkpointer, "_write", held_write)
    ck = checkpoint.Checkpointer(str(tmp_path))
    tree = {"w": torch.arange(6.0), "b": torch.arange(4.0).bfloat16()}
    want = {k: v.clone() for k, v in tree.items()}
    ck.save(1, tree)
    for v in tree.values():
        v.add_(100)
    go.set()
    ck.wait()
    restored, _ = ck.restore(tree)
    for k in want:
        assert torch.equal(restored[k], want[k]), k


def test_intermediate_checkpoint_equals_the_straight_run(tmp_path):
    """A 5-step run checkpoints steps 0, 2 and 4 while it trains on (the
    optimizer updates in place on the CPU); its step 2 holds, leaf for
    leaf, what a straight 3-step run saves at its end, and a run resumed
    from it ends as the 5-step run did."""
    cfg = registry.smoke_config("smollm-360m")
    kw = dict(global_batch=2, seq_len=32, log_every=1, seed=3)
    five, _ = trainer.train(cfg, trainer.TrainConfig(
        steps=5, ckpt_dir=str(tmp_path / "five"), ckpt_every=2, **kw),
        device="cpu")
    trainer.train(cfg, trainer.TrainConfig(
        steps=3, ckpt_dir=str(tmp_path / "three"), ckpt_every=100, **kw),
        device="cpu")
    assert checkpoint.Checkpointer(str(tmp_path / "five")).list_steps() \
        == [0, 2, 4]
    got, want = (sorted((tmp_path / d / "step_0000000002").glob("*.npy"))
                 for d in ("five", "three"))
    assert [f.name for f in got] == [f.name for f in want] and got
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.load(a), np.load(b))
    shutil.rmtree(tmp_path / "five" / "step_0000000004")
    resumed, hist = trainer.train(cfg, trainer.TrainConfig(
        steps=5, ckpt_dir=str(tmp_path / "five"), ckpt_every=100, **kw),
        device="cpu")
    assert hist[0]["step"] == 3
    for k in five:
        assert torch.equal(five[k], resumed[k]), k


def test_checkpoint_ignores_partial_writes(tmp_path):
    ck = checkpoint.Checkpointer(str(tmp_path))
    tree = {"a": torch.arange(4.0)}
    ck.save(3, tree, blocking=True)
    (tmp_path / "step_0000000009").mkdir()     # a crashed write
    restored, step = ck.restore(tree)
    assert step == 3
    assert torch.equal(restored["a"], torch.arange(4.0))


def test_checkpoint_async_then_wait_and_keep(tmp_path):
    ck = checkpoint.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"w": torch.ones((128, 128)) * s, "step": s})
    ck.wait()
    assert ck.list_steps() == [2, 3]
    restored, step = ck.restore({"w": torch.zeros((128, 128)), "step": 0})
    assert step == 3 and restored["step"] == 3
    assert isinstance(restored["step"], int)
    assert torch.equal(restored["w"], torch.full((128, 128), 3.0))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """The JAX package's Checkpointer writes {"params", "opt", "step"}
    (bf16 weights, float32 moments); the port restores it into its own
    tree, leaf for leaf in sorted-key order."""
    jc = jregistry.smoke_config("smollm-360m")
    tc = registry.smoke_config("smollm-360m")
    with jax.threefry_partitionable(False):
        pj = jzoo.build(jc).init_params(jax.random.PRNGKey(4))
    from repro.optim import optimizers as joptim
    sj = jax.tree.map(lambda x: x + 0.5, joptim.make("adamw").init(pj))
    ck = jcheckpoint.Checkpointer(str(tmp_path))
    ck.save(6, {"params": pj, "opt": sj, "step": 6}, blocking=True)
    from repro_torch.optim import optimizers
    tp = model.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    template = {"params": tp, "opt": optimizers.make("adamw").init(tp),
                "step": 0}
    restored, step = checkpoint.Checkpointer(str(tmp_path)).restore(template)
    assert step == 6 and restored["step"] == 6
    for k, v in pj.items():
        got = restored["params"][k]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(v, np.float32), err_msg=k)
    for n in ("m", "v"):
        for k, v in sj[n].items():
            np.testing.assert_array_equal(restored["opt"][n][k].numpy(),
                                          np.asarray(v))


def test_train_history_equals_jax(monkeypatch):
    """5 steps of train, float32 SMOKE smollm, from the JAX trainer's own
    weights: the same losses and gradient norms within 1e-4 relative."""
    jc = jregistry.smoke_config("smollm-360m").scaled(dtype="float32")
    tc = registry.smoke_config("smollm-360m").scaled(dtype="float32")
    kw = dict(steps=5, global_batch=2, seq_len=16, log_every=1, seed=3)
    with jax.threefry_partitionable(False):
        pj = jzoo.build(jc).init_params(jax.random.PRNGKey(3))
        _, want = jtrainer.train(jc, jtrainer.TrainConfig(**kw))
    pn = {k: np.asarray(v) for k, v in pj.items()}
    monkeypatch.setattr(model, "init_params",
                        lambda cfg, gen, device=None:
                        model.params_from_jax(cfg, pn, device))
    _, got = trainer.train(tc, trainer.TrainConfig(**kw), device="cpu")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-4)
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=1e-4)


def test_secure_agg_training_integration():
    cfg = registry.smoke_config("smollm-360m")
    tcfg = trainer.TrainConfig(
        steps=4, global_batch=4, seq_len=32, log_every=1,
        secure_agg=SecureAggConfig(n_clients=4, t=1, lq=14, clip=4.0))
    _, hist = trainer.train_secure(cfg, tcfg, device="cpu")
    assert len(hist) == 4 and np.isfinite(hist[-1]["loss"])


def test_launch_train_lm_route(capsys, tmp_path):
    launch_train.main(["--arch", "smollm-360m", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "16",
                       "--microbatch", "1", "--loss-chunk", "8",
                       "--ckpt", str(tmp_path), "--ckpt-every", "2",
                       "--model-parallel", "1"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1].startswith("final loss: ")
    assert "(smollm-360m, 3 steps)" in out
    assert checkpoint.Checkpointer(str(tmp_path)).list_steps() == [0, 2]
    # the port's trainer runs on one device: a model axis of 2 is refused
    with pytest.raises(SystemExit):
        launch_train.main(["--arch", "smollm-360m", "--device", "cpu",
                           "--steps", "1", "--model-parallel", "2"])
    assert "only 1 is accepted" in capsys.readouterr().err


def test_lm_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.smoke_config("smollm-360m")
    tcfg = trainer.TrainConfig(steps=1, global_batch=2, seq_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.train(cfg, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.lm_batch(pipeline.LmDataConfig(8, 4, 2), 0)
    with pytest.raises(ValueError, match="one device"):
        from repro_torch.core import meshutil
        trainer.train(cfg, tcfg, mesh=meshutil.make_mesh((2, 1),
                                                         ("data", "model")),
                      device="cpu")
