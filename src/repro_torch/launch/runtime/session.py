"""Coordinator: spawn workers, deal state, drive open rounds, assemble.

The parent process runs the one-time setup (Phases 1-2, identical to the
jit engine: same key split, same dealer draws) on the run's device, deals
each worker its padded client rows over the SESSION frame, then acts as
the opening barrier of the training loop: per step it gathers every rank's
TruncPr share rows, reconstructs, and broadcasts the public value back
(plus the per-step model opening on history runs).  Afterwards it
reassembles the final CopmlState from the workers' model share rows -- so
the state the caller sees is bit-identical to the in-process engines' --
and merges every node's byte/time counters into the measured_comm record
(the JAX package's keys, plus "workers": each rank's device, kernel
launches by name and by GEMM path, and GEMMs by shape).

On the card the kernels are built before any worker is spawned, and every
worker opens its own CUDA context on the one device.

This is the `proc:N` engine behind api.fit.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

from ...core import quantize, shamir
from ...core import random as jrandom
from ...kernels import build
from . import net, wire
from .config import NetConfig

#: processes a bare "proc" engine spec launches (capped at N clients)
DEFAULT_PROCS = 4
WORKER_MODULE = "repro_torch.launch.runtime.worker"


def _rows(x: torch.Tensor, r: int, n_loc: int) -> torch.Tensor:
    """Rank r's n_loc rows of a client-major tensor, on the host; rows past
    the last client are zeros (the padded clients)."""
    part = x[r * n_loc:(r + 1) * n_loc].cpu()
    if part.shape[0] < n_loc:
        part = torch.cat([part, part.new_zeros(
            (n_loc - part.shape[0],) + tuple(part.shape[1:]))])
    return part


def run_copml_proc(proto, key, client_xs, client_ys, iters: int, *,
                   procs: int | None = None, net_cfg: NetConfig | None = None,
                   subset=None, history: bool = False,
                   timings: dict | None = None) -> tuple:
    """Train `proto` (a Copml on the run's device) over P OS processes on
    real localhost sockets.

    Returns (state, weights, history-or-None, measured_comm) with state,
    weights and history bit-exact to the jit engine.  `timings`, when
    given, receives setup_s (setup, spawn and dealing, up to the START
    barrier) and iters_s (the training loop, up to the last RESULT frame),
    each ending in a device synchronise."""
    cfg = proto.cfg
    n = cfg.n_clients
    P = DEFAULT_PROCS if procs is None else int(procs)
    P = min(P, n)
    if P < 1:
        raise ValueError(f"proc engine needs >= 1 process, got {P}")
    ncfg = NetConfig.from_env() if net_cfg is None else net_cfg
    iters = int(iters)
    subset = None if subset is None else tuple(subset)
    dev = proto.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    if dev.type == "cuda":
        build.build_all()            # never P nvcc runs inside spawn time
    t0 = sync()
    ks, ki = jrandom.split(jrandom.as_key(key))
    state = proto.setup(ks, client_xs, client_ys)   # one-time, in-process
    n_loc = -(-n // P)

    node = net.Node(net.COORD, cfg=ncfg).start()
    # Plain subprocesses (not multiprocessing, never a fork of a process
    # that holds a CUDA context): nothing of the caller's __main__ is
    # re-imported and each client group is an independent OS process
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    workers = [subprocess.Popen(
        [sys.executable, "-m", WORKER_MODULE, str(r), ncfg.host,
         str(node.port)], env=env)
        for r in range(P)]

    def check_workers():
        dead = [r for r, p in enumerate(workers)
                if p.poll() not in (None, 0)]
        if dead:
            raise net.PeerFailure(
                f"worker process(es) {dead} exited "
                f"(exit codes {[workers[r].poll() for r in dead]}); "
                f"see their stderr for the traceback")

    node.liveness = check_workers
    try:
        addrs = {}
        for _ in range(P):
            frm = node.recv(net.LISTEN, timeout=ncfg.spawn_timeout_s)
            info = pickle.loads(frm.payload)
            addrs[frm.src] = (info["host"], info["port"])
        base = dict(cfg=cfg, m=proto.m, d=proto.d, objective=proto.obj,
                    key=ki.numpy().astype(np.uint32), iters=iters,
                    n_procs=P, net=ncfg, subset=subset,
                    history=bool(history), addrs=addrs, device=str(dev))
        for r in range(P):
            node.send(r, net.SESSION, payload=pickle.dumps(dict(
                base, rank=r,
                w_rows=wire.share_payload(_rows(state.w_shares, r, n_loc)),
                coded_rows=wire.share_payload(
                    _rows(state.coded_x, r, n_loc)),
                xty_rows=wire.share_payload(
                    _rows(state.xty_shares, r, n_loc)))))
        for r in range(P):
            node.recv(net.READY, src=r, timeout=ncfg.spawn_timeout_s)
        t1 = sync()
        setup_wall = t1 - t0
        for r in range(P):
            node.send(r, net.START)

        hist_rows = [] if history else None
        for t in range(iters):
            c_full = _gather_rows(node, P, t, net.TAG_TRUNC, dev)[:n]
            c = shamir.reconstruct(c_full, cfg.t, proto.lambdas)
            opened = wire.pack_array(c.cpu().numpy())
            for r in range(P):
                node.send(r, net.OPENED, step=t, tag=net.TAG_TRUNC,
                          payload=opened, phase="trunc_open")
            if history:
                w_full = _gather_rows(node, P, t, net.TAG_HIST, dev)[:n]
                wf = shamir.reconstruct(w_full, cfg.t, proto.lambdas)
                hist_rows.append(quantize.dequantize(wf, cfg.lw))

        results = {}
        result_wire = 0
        for r in range(P):
            frm = node.recv(net.RESULT, src=r)
            # the RESULT payload carries the worker's own send counters,
            # so the worker cannot count this frame itself (fixed point);
            # the coordinator meters the exact bytes it received instead.
            result_wire += wire.HEADER_SIZE + len(frm.payload)
            results[r] = pickle.loads(frm.payload)
            node.send(r, net.BYE)
        w_shares = torch.cat(
            [from_payload(results[r]["w"], dev) for r in range(P)], dim=0)
        t2 = sync()
        state = dataclasses.replace(state, w_shares=w_shares,
                                    step=state.step + iters)
        w = proto.open_model(state)
        for p in workers:
            try:
                p.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
        hist = None
        if history:
            hist = torch.stack(hist_rows) if hist_rows else \
                torch.zeros((0,) + proto.w_shape, dtype=torch.float32)
        if timings is not None:
            timings.update(setup_s=setup_wall, iters_s=t2 - t1)
        measured = _assemble_measured(results, node, P, iters,
                                      time.perf_counter() - t0, setup_wall,
                                      result_wire)
        return state, w, hist, measured
    finally:
        node.stop()
        for p in workers:
            if p.poll() is None:
                p.terminate()
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def from_payload(payload: bytes, dev) -> torch.Tensor:
    """An array payload as a tensor on `dev` (worker.from_payload's twin:
    this module does not import the worker, which runs as __main__)."""
    return torch.from_numpy(np.array(wire.unpack_array(payload))).to(dev)


def _gather_rows(node, P: int, step: int, tag: int, dev):
    """Stack every rank's (n_loc,)+shape OPEN rows into (n_pad,)+shape."""
    return torch.cat(
        [from_payload(node.recv(net.OPEN, src=r, step=step,
                                tag=tag).payload, dev)
         for r in range(P)], dim=0)


def _assemble_measured(results, node, P, iters, wall, setup_wall,
                       result_wire) -> dict:
    """Merge per-node counters: bytes sum over every process (each frame
    is sent exactly once), per-phase seconds take the max over workers
    (the slowest rank is the step's critical path).  `result_wire` is the
    coordinator-metered size of the P RESULT frames, which the workers
    cannot self-count.  "workers" lists each rank's device, its kernel
    launches by name and by GEMM path, and its GEMMs by shape."""
    bytes_by_phase = dict(node.sent_bytes)
    frames_by_phase = dict(node.sent_frames)
    bytes_by_phase["open_model"] = (bytes_by_phase.get("open_model", 0)
                                    + result_wire)
    frames_by_phase["open_model"] = (frames_by_phase.get("open_model", 0)
                                     + P)
    # receiver-side stale-drop counts sum across every process; they are
    # deliberately NOT part of frames_by_phase, which counts sends only
    # and therefore matches the static choreography budget exactly even
    # on degraded runs (a dropped frame was still sent).
    dropped_frames = dict(node.dropped_frames)
    seconds_by_phase: dict = {}
    degraded = 0
    for res in results.values():
        for k, v in res["bytes"].items():
            bytes_by_phase[k] = bytes_by_phase.get(k, 0) + v
        for k, v in res["frames"].items():
            frames_by_phase[k] = frames_by_phase.get(k, 0) + v
        for k, v in res.get("dropped", {}).items():
            dropped_frames[k] = dropped_frames.get(k, 0) + v
        for k, v in res["seconds"].items():
            seconds_by_phase[k] = max(seconds_by_phase.get(k, 0.0), v)
        degraded = max(degraded, res["degraded_steps"])
    return {
        "engine": f"proc:{P}",
        "procs": P,
        "iters": iters,
        "bytes_by_phase": bytes_by_phase,
        "total_bytes": sum(bytes_by_phase.values()),
        "frames_by_phase": frames_by_phase,
        "dropped_frames": dropped_frames,
        "seconds_by_phase": seconds_by_phase,
        "degraded_steps": degraded,
        "setup_wall_s": setup_wall,
        "wall_s": wall,
        "workers": [{k: results[r][k] for k in
                     ("device", "wall_s", "launches", "gemm_paths", "wide",
                      "threefry", "gemms")}
                    for r in range(P)],
    }
