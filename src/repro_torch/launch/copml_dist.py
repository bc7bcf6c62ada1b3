"""COPML on a client mesh of rank processes: the distributed entry point.

The paper's N clients map onto a 1-D ("clients",) mesh of D rank
processes (core/meshutil.ClientMesh): each rank holds a contiguous block
of clients' shares and coded slices, and every exchange of the protocol
is a collective (Copml._train_sharded):

  share distribution (owner -> holder transpose)   -> all-to-all
  model-encoding reconstruction (sum over holders) -> mod-p reduce-scatter
  TruncPr / model opening                          -> all-gather + replicated
                                                      decode

    PYTHONPATH=src python -m repro_torch.launch.copml_dist --devices 4 \\
        --clients 13 --iters 5                  # on the card
    ... --device cpu                            # the plain torch path

trains api.fit(..., engine=sharded) over the mesh, re-trains on one
device with engine="jit", and asserts the two are bit-exact.  --bench
prints CSV rows of the two engines' wall times.  On one card every rank
of a D > 1 mesh runs gloo with its collectives staged through the host.

Dry-run cells (launch/dryrun.py) take the production meshes of 256 and
512 ranks, one client a rank, at these workloads:

  train_4k    -> CIFAR-10 scale (m=9019, d=3073), paper Case 2 at N=mesh size
  prefill_32k -> GISETTE scale (m=6000, d=5000)
  decode_32k  -> pod-scale (m=262144, d=4096)
  smoke       -> tiny (m=416, d=64)
  long_500k   -> skipped (no long-context analogue)

Each cell is (a) a MODEL at the production mesh: per-rank argument bytes
from sharding/partition.copml_state_structs on meta tensors, each
collective's per-rank bytes and each field-kernel launch in closed form
from the rank step's own rules (`rank_step_collectives`,
`rank_step_launches`), priced by launch/roofline.py; and (b) ONE real
step at `execute_ranks` ranks: every rank makes its own rows of a random
state in [0, p) on its device, runs the rank step once, and reports its
peak memory, its launches and the bytes it sent by collective, which must
equal the closed forms at that mesh size.
"""

from __future__ import annotations

import argparse
import collections
import functools
import time

import numpy as np
import torch

from ..core import field, meshutil
from ..core import random as jrandom
from ..api.cli import DEVICES
from ..core.protocol import (Copml, CopmlConfig, CopmlState, _n_pad,
                             _rank_train, case2_params, resolve_device,
                             sharded_overlap_from_env)
from ..sharding import partition
from . import launch_counter as LC
from . import roofline as RL

_SHAPE_MAP = {
    "train_4k": ("cifar10-scale", 9019, 3073),
    "prefill_32k": ("gisette-scale", 6000, 5000),
    "decode_32k": ("pod-scale", 262144, 4096),
    "smoke": ("smoke-scale", 416, 64),
}
SKIPPED = ("skipped (no long-context analogue for secure logistic "
           "regression)")
#: cells whose executed step is held against the single-device step (the
#: others' whole state does not fit one process next to the ranks')
CHECK_SINGLE = ("smoke", "train_4k")


def make_config(n: int, m: int, d: int) -> CopmlConfig:
    k, t = case2_params(n)
    # The truncation depth k1 = 2*lx + cb + log2(m/eta) must stay below
    # log2(p): with the paper's 26-bit field, m beyond ~2^14 forces either
    # coarser quantization or a larger step size; eta scales with m.
    eta = max(1.0, m / 4096.0)
    return CopmlConfig(n_clients=n, k=k, t=t, eta=eta)


def make_protocol(n: int, m: int, d: int, device="cpu") -> Copml:
    return Copml(make_config(n, m, d), m, d, device=device)


# ------------------------------------------- the rank step, in closed form


def _gemm(a, b) -> tuple:
    op = "modmatmul" if a.dim() == 2 else "modmatmul_batched"
    return (op,) + LC.gemm_key(a, b)


def rank_step_launches(proto: Copml, ndev: int, overlap: bool | None = None
                       ) -> collections.Counter:
    """The field-kernel launches of one sharded step on any rank (padding
    keeps n_loc rows everywhere), by LaunchLog key without the phase:
    (op, A's shape, A's strides, B's shape, B's strides) for a GEMM and
    (op, work parameters) for the coded gradient.  Built on meta tensors
    with core/protocol._RankStep's own views, so every stride is the one
    the step passes."""
    overlap = sharded_overlap_from_env() if overlap is None else overlap
    cfg = proto.cfg
    n, k, t, dw = cfg.n_clients, cfg.k, cfg.t, proto.dw
    n_pad = _n_pad(n, ndev)
    n_loc = n_pad // ndev
    mk = -(-proto.m // k)
    meta = functools.partial(torch.empty, dtype=torch.int32, device="meta")
    calls: collections.Counter = collections.Counter()
    pmat_all = meta(n_pad, t)
    pmat_loc = pmat_all[:n_loc]
    # share_rows: the encode's mask (T,) + w_shape, TruncPr's [r] and [r0]
    for numel in (t * dw, dw, dw):
        calls[_gemm(pmat_loc, meta(t, numel))] += 1
    # the LCC encode of every local holder's model share
    calls[_gemm(meta(n, k + t)[None].expand(n_loc, n, k + t),
                meta(n_loc, k + t, dw))] += 1
    wall_loc = meta(n_pad)[:n_loc][None, :]
    if overlap and ndev <= meshutil.NARROW_SHARDS:
        enc = meta(n_loc, n_pad, dw)
        for j in range(ndev):
            calls[_gemm(wall_loc, enc[:, j * n_loc:(j + 1) * n_loc]
                        .reshape(n_loc, -1))] += 1
    else:
        calls[_gemm(wall_loc, meta(n_loc, n * dw))] += 1
    # the local coded gradient
    c = proto.obj.n_outputs
    name = "coded_gradient_matrix" if proto.out_shape else \
        "coded_gradient_batched"
    calls[(name, (n_loc, mk, proto.d, c, len(proto.poly_coeffs) - 1))] += 1
    # the gradient shares: every holder's rows of the local owners'
    cl = meta(t, n_pad, dw)[:, :n_loc].reshape(t, -1)
    if overlap:
        for j in range(ndev):
            calls[_gemm(pmat_all[j * n_loc:(j + 1) * n_loc], cl)] += 1
    else:
        calls[_gemm(pmat_all, cl)] += 1
    # the decode: each holder's R rows against the decode row
    rthr = cfg.recovery_threshold
    calls[_gemm(meta(rthr)[None, None].expand(n_loc, 1, rthr),
                meta(n_loc, rthr, dw))] += 1
    # TruncPr's opening: reconstruct from the first T+1 gathered rows
    calls[_gemm(meta(1, t + 1), meta(t + 1, dw))] += 1
    return calls


def rank_step_collectives(proto: Copml, ndev: int,
                          overlap: bool | None = None,
                          history: bool = False) -> dict:
    """What one rank of a D-rank mesh sends in one sharded step, by
    meshutil's sent_bytes kind: {kind: {"calls": c, "bytes": b}}.  The
    rules of core/protocol._RankStep and core/meshutil: the encode's
    reduce-scatter is the ring when the step overlaps and D <=
    NARROW_SHARDS, else the monolithic one (two, over 13-bit halves, past
    NARROW_SHARDS); the exchange is the ring all-to-all when the step
    overlaps; TruncPr (and a history run's model) opens by all-gather."""
    overlap = sharded_overlap_from_env() if overlap is None else overlap
    n, dw = proto.cfg.n_clients, proto.dw
    n_pad = _n_pad(n, ndev)
    n_loc = n_pad // ndev
    w = 4                                   # bytes a field element
    out = collections.defaultdict(lambda: {"calls": 0, "bytes": 0})

    def add(kind, calls, nbytes):
        if calls and nbytes:
            out[kind]["calls"] += calls
            out[kind]["bytes"] += nbytes

    if overlap and ndev <= meshutil.NARROW_SHARDS:
        add("ring_reduce_scatter", ndev - 1, (ndev - 1) * n_loc * dw * w)
    else:
        limbs = 1 if ndev <= meshutil.NARROW_SHARDS else 2
        add("reduce_scatter", limbs,
            limbs * (n_pad * dw * w * (ndev - 1) // ndev))
    if overlap:
        add("ring_all_to_all", ndev - 1,
            (ndev - 1) * n_loc * n_loc * dw * w)
    else:
        add("all_to_all", 1, n_pad * n_loc * dw * w * (ndev - 1) // ndev)
    opens = 2 if history else 1
    add("all_gather", opens, opens * n_loc * dw * w * (ndev - 1))
    return dict(out)


def _sent(collectives: dict) -> dict:
    return {k: v["bytes"] for k, v in collectives.items()}


def _priced(launches: collections.Counter) -> tuple:
    """(operations, bytes) of a rank_step_launches counter."""
    work = [(LC.launch_work(key), c) for key, c in launches.items()]
    return (sum(o * c for (o, _), c in work),
            sum(b * c for (_, b), c in work))


def _state_bytes(rank_state: CopmlState) -> int:
    return sum(x.numel() * x.element_size() for x in
               (rank_state.w_shares, rank_state.coded_x,
                rank_state.xty_shares))


def model_ops(cfg: CopmlConfig, m: int, dw: int) -> float:
    """Useful operations of one iteration (launch/roofline.py) for a
    model of dw field elements a client."""
    return RL.copml_model_ops(cfg.n_clients, m, dw, cfg.k, cfg.t,
                              cfg.recovery_threshold)


def model_record(shape_name: str, ranks: int, multi_pod: bool) -> dict:
    """The model of one step at a production mesh of `ranks` ranks."""
    tag, m, d = _SHAPE_MAP[shape_name]
    proto = make_protocol(ranks, m, d)
    cfg = proto.cfg
    structs = partition.copml_state_structs(proto, ranks)
    coll = rank_step_collectives(proto, ranks)
    launches = rank_step_launches(proto, ranks)
    o, b = _priced(launches)
    rf = RL.Roofline(name=f"copml/{tag}", chips=ranks, ops=o * ranks,
                     bytes=b * ranks,
                     coll_bytes_per_device=sum(_sent(coll).values()),
                     model_ops=model_ops(proto.cfg, proto.m, proto.dw))
    rec = rf.to_dict()
    rec.update({
        "arch": "copml-logreg", "shape": shape_name, "workload": tag,
        "mesh": "multipod" if multi_pod else "pod", "status": "model",
        "n_clients": cfg.n_clients, "K": cfg.k, "T": cfg.t,
        "recovery_threshold": cfg.recovery_threshold,
        "collectives": {k: v["calls"] for k, v in coll.items()},
        "sent_bytes_per_rank": _sent(coll),
        "launches_per_rank": sum(launches.values()),
        "bytes_per_device": {
            "argument": _state_bytes(structs[0]),
            "output": structs[0].w_shares.numel() * 4,
        },
    })
    return rec


# ------------------------------------------------- the executed step


def fill_client_rows(state: CopmlState, clients, seed: int) -> None:
    """Fill row i of the state's tensors with client clients[i]'s rows of
    a random state in [0, p): each client's from its own generator seeded
    by (seed, client) on the tensors' device, so a rank that makes only
    its own rows gets the bits of the whole state made at once."""
    dev = state.w_shares.device
    for i, c in enumerate(clients):
        g = torch.Generator(device=dev)
        g.manual_seed(seed * 1_000_003 + int(c))
        for x in (state.w_shares, state.coded_x, state.xty_shares):
            x[i].random_(0, field.P, generator=g)


def _zero_state(proto: Copml, rows: int, device) -> CopmlState:
    mk = -(-proto.m // proto.cfg.k)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    return CopmlState(w_shares=z(rows, *proto.w_shape),
                      coded_x=z(rows, mk, proto.d),
                      xty_shares=z(rows, *proto.w_shape))


def _rank_make_rows(rank, handle, spec: dict, seed: int) -> int:
    """(On a mesh rank) make this rank's rows of the random state on its
    device (zero rows past the last client) and keep them, with a Copml
    for the device, under `handle`; returns the state's bytes."""
    dev = rank.device
    proto = Copml(spec["cfg"], spec["m"], spec["d"], device=dev)
    n = proto.cfg.n_clients
    n_loc = _n_pad(n, rank.size) // rank.size
    lo = rank.rank * n_loc
    st = _zero_state(proto, n_loc, dev)
    fill_client_rows(st, range(lo, min(lo + n_loc, n)), seed)
    rank.state[handle] = dict(proto=proto, w=st.w_shares,
                              coded_x=st.coded_x, xty=st.xty_shares)
    rank.sync()
    return _state_bytes(st)


def _rank_step(rank, handle, key, overlap: bool, idx, dvs) -> dict:
    """(On a mesh rank) one sharded step on the rows kept under `handle`
    (core/protocol._rank_train), its field-kernel launches recorded."""
    with LC.LaunchLog(owner=None) as log:
        out = _rank_train(rank, handle, key, 1, False, overlap, idx, dvs,
                          None)
    out["launch_keys"] = collections.Counter(
        {k[1:]: c for k, c in log.calls.items()})
    out["launch_keys"].update({k[1:]: c for k, c in log.kernels.items()})
    out["launch_rows"] = LC.launch_rows(log)
    if rank.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def execute_cell(proto: Copml, ranks: int, seed: int = 0,
                 check_single: bool = False) -> dict:
    """One real sharded step of `proto` (built on the run's device) on a
    mesh of `ranks` ranks; see the module doc.  Raises when a rank's bytes
    by collective or its launches differ from the closed forms, or, with
    `check_single`, when the step's model shares differ from the
    single-device step's on the same state."""
    dev = proto.device
    mesh = meshutil.client_mesh(ranks, dev)
    cfg = proto.cfg
    n, rthr = cfg.n_clients, cfg.recovery_threshold
    handle = mesh.new_handle()
    t0 = time.perf_counter()
    held = mesh.run(_rank_make_rows, handle,
                    dict(cfg=cfg, m=proto.m, d=proto.d), seed)
    make_s = time.perf_counter() - t0
    key = jrandom.PRNGKey(seed)
    idx, dvs, _ = proto._decode_row(None)
    overlap = sharded_overlap_from_env()
    t0 = time.perf_counter()
    out = mesh.run(_rank_step, handle, key.numpy(), overlap,
                   idx.cpu().expand(1, rthr), dvs.cpu().expand(1, rthr))
    step_s = time.perf_counter() - t0
    reports = [o["report"] for o in out]
    want_coll = rank_step_collectives(proto, ranks, overlap)
    want_launches = rank_step_launches(proto, ranks, overlap)
    for r, o in zip(reports, out):
        got = {k: v for k, v in r["sent_bytes"].items() if v}
        if got != _sent(want_coll):
            raise AssertionError(
                f"rank {r['rank']} sent {got}; the closed form at {ranks} "
                f"ranks gives {_sent(want_coll)}")
        if o["launch_keys"] != want_launches:
            raise AssertionError(
                f"rank {r['rank']} launched {dict(o['launch_keys'])}; the "
                f"closed form gives {dict(want_launches)}")
    rec = {"ranks": ranks, "device": str(dev), "backend": mesh.backend,
           "state_bytes_per_rank": held, "make_rows_s": make_s,
           "step_s": step_s, "overlap": overlap,
           "rank_iters_s": [r["iters_s"] for r in reports],
           "peak_bytes": [r["peak_bytes"] for r in reports],
           "sent_bytes": [r["sent_bytes"] for r in reports],
           "sent_bytes_closed_form": _sent(want_coll),
           "launches": [r["launches"] for r in reports],
           "gemm_paths": [r["gemm_paths"] for r in reports]}
    o_sum = sum(LC.work(o["launch_rows"])[0] for o in out)
    b_sum = sum(LC.work(o["launch_rows"])[1] for o in out)
    rf = RL.Roofline(name="copml/executed", chips=ranks, ops=o_sum,
                     bytes=b_sum,
                     coll_bytes_per_device=LC.collective_bytes(
                         reports)["per_device"],
                     model_ops=model_ops(proto.cfg, proto.m, proto.dw))
    rec["roofline"] = rf.to_dict()
    if check_single:
        w_pad = torch.cat([o["w"] for o in out])
        state = _zero_state(proto, n, dev)
        fill_client_rows(state, range(n), seed)
        want = proto.iteration(jrandom.fold_in(key, 0), state)
        # seclint: allow[SEC002] reason=engine check on random test rows
        if not torch.equal(w_pad[:n], want.w_shares.cpu()):
            raise AssertionError("the sharded step's model shares differ "
                                 "from the single-device step's")
        rec["bit_equal_single_device"] = True
    return rec


def dryrun_cell(shape_name: str, ranks: int, multi_pod: bool,
                execute_ranks: int = 4, device=None, seed: int = 0) -> dict:
    """One dry-run cell: the model at the production mesh of `ranks`
    ranks, and (execute_ranks > 0) one real step at execute_ranks ranks
    on `device` (the card unless the caller asks for the CPU)."""
    mesh_name = "multipod" if multi_pod else "pod"
    if shape_name not in _SHAPE_MAP:
        return {"arch": "copml-logreg", "shape": shape_name,
                "mesh": mesh_name, "status": SKIPPED}
    rec = model_record(shape_name, ranks, multi_pod)
    print(f"--- copml-logreg[{rec['workload']}] x {mesh_name}({ranks}) "
          f"N={rec['n_clients']} K={rec['K']} T={rec['T']} "
          f"R={rec['recovery_threshold']} ---")
    bpd = rec["bytes_per_device"]
    print(f"model: args={bpd['argument'] / 2 ** 30:.4f}GiB a rank, "
          f"collectives {rec['collectives']}, sent a rank "
          f"{rec['sent_bytes_per_rank']}")
    print(f"model roofline: compute={rec['compute_s'] * 1e3:.4f}ms "
          f"memory={rec['memory_s'] * 1e3:.4f}ms "
          f"collective={rec['collective_s'] * 1e3:.4f}ms "
          f"dominant={rec['dominant']}")
    if execute_ranks:
        tag, m, d = _SHAPE_MAP[shape_name]
        proto = make_protocol(ranks, m, d, device=resolve_device(device))
        ex = execute_cell(proto, execute_ranks, seed,
                          check_single=shape_name in CHECK_SINGLE)
        rec["executed"] = ex
        peaks = [p for p in ex["peak_bytes"] if p is not None]
        peak = f"{max(peaks) / 2 ** 30:.3f}GiB" if peaks else \
            "not measured (CPU)"
        erf = ex["roofline"]
        held = ex["state_bytes_per_rank"][0] / 2 ** 30
        print(f"executed: {execute_ranks} ranks on {ex['device']} "
              f"({ex['backend']}), state {held:.4f}GiB a rank, peak "
              f"{peak} a rank, step {ex['step_s']:.3f}s, "
              f"sent a rank {ex['sent_bytes_closed_form']} (= closed form)"
              + (", bit-equal to the single-device step"
                 if ex.get("bit_equal_single_device") else ""))
        print(f"executed roofline ({execute_ranks} cards): "
              f"compute={erf['compute_s'] * 1e3:.4f}ms "
              f"memory={erf['memory_s'] * 1e3:.4f}ms "
              f"collective={erf['collective_s'] * 1e3:.4f}ms "
              f"dominant={erf['dominant']}")
    return rec


# ------------------------------------------------------------------ CLI


def _workload(args):
    """Ad-hoc api workload for the CLI's (m, d, clients) arguments."""
    from .. import api
    return api.Workload(
        name=f"cli_m{args.m}_d{args.d}_n{args.clients}", m=args.m, d=args.d,
        cfg=make_config(args.clients, args.m, args.d), iters=args.iters)


def run_parity(args) -> tuple:
    """Train sharded on the client mesh, re-train single-device, compare;
    returns both TrainResults (sharded, jit).

    Both runs go through api.fit; only the engine differs.  With
    --straggle-p the SAME seeded FaultPlan is replayed by both engines."""
    from .. import api
    wl = _workload(args)
    cfg = wl.cfg
    mesh = meshutil.client_mesh(args.devices, args.device)
    plan = None
    if args.straggle_p is not None:
        # the SAME threshold api.fit's plan validation enforces
        thr = api.PROTOCOLS["copml"].fault_threshold(wl)
        plan = api.FaultPlan.random(
            cfg.n_clients, args.iters, seed=args.fault_seed,
            straggle_p=args.straggle_p, min_available=thr)
        print(plan.describe(thr))
    print(f"COPML distributed: N={cfg.n_clients} clients over "
          f"{mesh.size} ranks ({mesh.backend} on {mesh.device}), K={cfg.k} "
          f"T={cfg.t} R={cfg.recovery_threshold}, {args.iters} iterations")
    res_s = api.fit(wl, "copml", api.EngineSpec("sharded", mesh=mesh),
                    key=args.seed, iters=args.iters, history=False,
                    faults=plan, device=args.device)
    res_j = api.fit(wl, "copml", "jit", key=args.seed, iters=args.iters,
                    history=False, faults=plan, device=args.device)
    np.testing.assert_array_equal(res_s.weights, res_j.weights)
    np.testing.assert_array_equal(res_s.state.w_shares.cpu().numpy(),
                                  res_j.state.w_shares.cpu().numpy())
    print(f"bit-exact: sharded == jit  "
          f"(sharded {res_s.wall_time_s:.2f}s, "
          f"single {res_j.wall_time_s:.2f}s)")
    return res_s, res_j


def run_bench(args, report=print) -> None:
    """Sharded-vs-single-device wall time, interleaved best-of-reps (both
    warm).  On one card the ranks time-slice it and stage collectives
    through the host: this measures protocol and collective overhead, not
    multi-GPU scaling."""
    from .. import api
    wl = _workload(args)
    mesh = meshutil.client_mesh(args.devices, args.device)
    engines = (("train_jit_1dev", "jit"),
               (f"train_sharded_{mesh.size}dev",
                api.EngineSpec("sharded", mesh=mesh)))
    best = {}
    for name, eng in engines:                   # warm
        api.fit(wl, "copml", eng, key=args.seed, iters=args.iters,
                history=False, device=args.device)
        best[name] = float("inf")
    for _ in range(args.reps):                  # interleaved best-of-reps
        for name, eng in engines:
            res = api.fit(wl, "copml", eng, key=args.seed, iters=args.iters,
                          history=False, device=args.device)
            best[name] = min(best[name], res.wall_time_s)
    base = best[engines[0][0]]
    for name, _ in engines:
        dt = best[name]
        report(f"copml_dist/{name}_{args.iters}it,{dt * 1e6:.1f},"
               f"{base / dt:.2f}x_vs_1dev")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh size (default: one rank a card, or one on "
                         "the CPU)")
    ap.add_argument("--clients", type=int, default=13)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--m", type=int, default=832)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggle-p", type=float, default=None,
                    help="replay a seeded FaultPlan (mid-training churn) "
                         "on both engines of the parity demo")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--bench", action="store_true",
                    help="print benchmark CSV rows instead of the parity demo")
    ap.add_argument("--device", choices=DEVICES, default="cuda",
                    help="run on the CUDA card (the default) or on the CPU "
                         "(the kernels' plain torch versions)")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("copml_dist: no CUDA device is available; pass "
                         "--device cpu to run the plain torch path")
    if args.devices is None:
        args.devices = max(1, torch.cuda.device_count()) \
            if args.device == "cuda" else 1
    if args.bench:
        run_bench(args)
    else:
        run_parity(args)


if __name__ == "__main__":
    main()
