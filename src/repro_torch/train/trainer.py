"""The LM training loop: checkpoint/restart and secure aggregation.

Fault tolerance (the JAX package's train/trainer.py):
  * checkpoint every `ckpt_every` steps and at the last step (async,
    atomic-rename manifests; train/checkpoint.py);
  * a restart picks up the newest complete step and replays the
    deterministic data stream from there (data/pipeline.lm_batch is keyed
    by step), so a resumed run ends where a straight run ends;
  * `train_secure`: N virtual data-parallel clients each compute their
    local gradient, combined by COPML-coded secure aggregation
    (core/secure_agg.py): each client's gradient is private against T
    colluders, and any T+1 of the N holders decode.

Runs on the CUDA card unless device="cpu" is asked for.  The port's
trainer runs on one device: a mesh of more than one device is refused,
and a one-device mesh is made the active one (core/meshutil.set_mesh)
for the step's sharding hints, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..core import meshutil
from ..core import random as jrandom
from ..core import secure_agg
from ..core.protocol import resolve_device
from ..data import pipeline
from ..models import model_zoo as MZ
from ..models.config import ModelConfig
from ..optim import optimizers
from . import checkpoint as ckpt_lib


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    microbatch: int = 0
    loss_chunk: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    secure_agg: Optional[secure_agg.SecureAggConfig] = None


def _init(bm, opt, tcfg: TrainConfig, device: torch.device):
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    params = bm.init_params(gen, device=device)
    return params, opt.init(params)


def train(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, callback=None,
          device=None):
    """Returns (params, metrics_history).  A record is logged every
    `log_every` steps and at the last: step, loss, grad_norm and
    step_time_s (the step's wall time up to its loss on the host)."""
    device = resolve_device(device)
    if mesh is not None and mesh.size > 1:
        raise ValueError(f"the LM trainer runs on one device, not a mesh "
                         f"of {mesh.size}")
    bm = MZ.build(cfg, microbatch=tcfg.microbatch,
                  loss_chunk=tcfg.loss_chunk)
    opt = optimizers.make(cfg.optimizer)
    params, opt_state = _init(bm, opt, tcfg, device)
    start_step = 0
    ckpt = ckpt_lib.Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    if ckpt and ckpt.list_steps():
        restored, _ = ckpt.restore(
            {"params": params, "opt": opt_state, "step": 0})
        params, opt_state = restored["params"], restored["opt"]
        start_step = int(restored["step"]) + 1
        print(f"restored checkpoint, resuming at step {start_step}")

    dcfg = pipeline.LmDataConfig(vocab=cfg.vocab, seq_len=tcfg.seq_len,
                                 global_batch=tcfg.global_batch,
                                 seed=tcfg.seed)
    history = []
    ctx = meshutil.set_mesh(mesh) if mesh is not None else \
        contextlib.nullcontext()
    with ctx:
        for step in range(start_step, tcfg.steps):
            batch = pipeline.lm_batch(dcfg, step, device=device)
            t0 = time.perf_counter()
            params, opt_state, metrics = bm.train_step(
                params, opt_state, batch, step)
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                loss = float(metrics["loss"])
                rec = {"step": step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "step_time_s": time.perf_counter() - t0}
                history.append(rec)
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {rec['grad_norm']:8.3f} "
                      f"dt {rec['step_time_s']:6.2f}s")
                if callback:
                    callback(rec)
                assert np.isfinite(loss), f"loss diverged at step {step}"
            if ckpt and (step % tcfg.ckpt_every == 0
                         or step == tcfg.steps - 1):
                ckpt.save(step, {"params": params, "opt": opt_state,
                                 "step": step})
    if ckpt:
        ckpt.wait()
    return params, history


def client_grads(bm, params: dict, batch: dict, n_clients: int):
    """Each of n_clients' gradients of loss_fn's total on its
    global_batch / n_clients rows: (losses (n,) float32, [grads dict a
    client])."""
    per = batch["tokens"].shape[0] // n_clients
    losses, grads = [], []
    for i in range(n_clients):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        tot, _, g = MZ.value_and_grads(bm.loss_fn, params, mb)
        losses.append(tot)
        grads.append(g)
    return torch.stack(losses), grads


def train_secure(cfg: ModelConfig, tcfg: TrainConfig, device=None):
    """N virtual data-parallel clients, each computing its local gradient;
    the gradients are combined with COPML-coded secure aggregation
    (secure_agg.secure_aggregate under fold_in(PRNGKey(seed), step)), and
    the mean updates the model.  Returns (params, history)."""
    sa = tcfg.secure_agg
    if sa is None:
        raise ValueError("train_secure needs TrainConfig.secure_agg")
    device = resolve_device(device)
    bm = MZ.build(cfg, loss_chunk=tcfg.loss_chunk)
    opt = optimizers.make(cfg.optimizer)
    key = jrandom.PRNGKey(tcfg.seed)
    params, opt_state = _init(bm, opt, tcfg, device)
    dcfg = pipeline.LmDataConfig(vocab=cfg.vocab, seq_len=tcfg.seq_len,
                                 global_batch=tcfg.global_batch,
                                 seed=tcfg.seed)
    history = []
    for step in range(tcfg.steps):
        batch = pipeline.lm_batch(dcfg, step, device=device)
        losses, per_client = client_grads(bm, params, batch, sa.n_clients)
        agg = secure_agg.secure_aggregate(jrandom.fold_in(key, step),
                                          per_client, sa)
        del per_client
        params, opt_state, _ = opt.update(agg, opt_state, params, step)
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            rec = {"step": step, "loss": float(torch.mean(losses))}
            history.append(rec)
            print(f"[secure-agg] step {step:4d} loss {rec['loss']:.4f}")
    return params, history
