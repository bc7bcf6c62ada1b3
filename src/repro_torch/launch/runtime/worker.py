"""Worker process: one COPML client group's compute + socket collectives.

Each worker owns `n_loc = ceil(N / P)` consecutive clients (the last rank's
trailing rows zero-padded) and runs the JAX package's worker step on the
run's device, with every cross-group contraction done over sockets:

    reduce-scatter (model encode)   peer-to-peer ENC partial rows,
                                    chained field.add (exact mod-p sum)
    all_to_all (gradient shares)    peer-to-peer SHARE blocks
    all_gather + open (TruncPr)     OPEN rows to the coordinator,
                                    OPENED broadcast back

Bit-exactness with the jit engine: every random draw is replicated dealer
randomness (same key, full global shape on every process, this rank's rows
sliced out of it) and every cross-process contraction is an exact mod-p
linear reduction.  The decode subset may differ per step (whichever
owners' blocks arrive before the deadline); LCC decoding is exact
polynomial interpolation, so any R-subset yields identical values.

Phase 3 is the siloed coded-gradient kernel (`Copml.local_gradient`) and
Phase 4 separate field ops.  Every field GEMM of the loop is
counted by shapes and strides (`step_gemms` lists what one step makes) and
reported with the kernels' launch counts in the RESULT frame.

    python -m repro_torch.launch.runtime.worker RANK HOST PORT
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import pickle
import time
import traceback

import numpy as np
import torch

from ...core import field, shamir, truncation
from ...core import random as jrandom
from ...core.protocol import Copml
from ...kernels import ops
from . import net, wire


class _PhaseClock:
    """Cumulative wall time per protocol phase; `sync` (the device's
    synchronise, or nothing on the CPU) ends each phase, so a phase's
    kernels are charged to it and not to the next blocking copy."""

    def __init__(self, sync):
        self.seconds: dict = {}
        self._sync = sync

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[phase] = (self.seconds.get(phase, 0.0)
                                   + time.perf_counter() - t0)


def gemm_key(a, b) -> tuple:
    """(op, A's shape, A's strides, B's shape, B's strides) of one field
    GEMM: op is "modmatmul" for 2-D operands, else "modmatmul_batched"."""
    op = "modmatmul" if a.dim() == 2 else "modmatmul_batched"
    return (op, tuple(a.shape), tuple(a.stride()), tuple(b.shape),
            tuple(b.stride()))


class _Gemms:
    """The loop's field GEMMs: dispatched to kernels/ops, counted by
    gemm_key."""

    def __init__(self):
        self.calls: collections.Counter = collections.Counter()

    def __call__(self, a, b):
        key = gemm_key(a, b)
        self.calls[key] += 1
        return getattr(ops, key[0])(a, b)


def step_gemms(n: int, k: int, t: int, dw: int, procs: int,
               rthr: int) -> collections.Counter:
    """The field GEMMs one training step of a worker makes, by gemm_key,
    for N clients, K, T, a model of dw field elements, P processes and
    recovery threshold R; the same on every rank (padding keeps n_loc rows
    everywhere).  Built on meta tensors with the step's own views, so each
    stride is the one the step passes."""
    p = min(procs, n)
    n_loc = -(-n // p)
    n_pad = n_loc * p
    meta = functools.partial(torch.empty, dtype=torch.int32, device="meta")
    calls: collections.Counter = collections.Counter()
    pmat = meta(n_pad, t)
    # share_rows: the model encode's mask (T,) + w_shape, TruncPr's [r], [r0]
    for numel in (t * dw, dw, dw):
        calls[gemm_key(pmat[:n_loc], meta(t, numel))] += 1
    # the LCC encode of every local holder's model share
    calls[gemm_key(meta(n, k + t)[None].expand(n_loc, n, k + t),
                   meta(n_loc, k + t, dw))] += 1
    # the encode's reduce-scatter: one segment per rank
    enc, wall = meta(n_loc, n_pad, dw), meta(n_pad)[:n_loc]
    for s in range(p):
        calls[gemm_key(wall[None, :], enc[:, s * n_loc:(s + 1) * n_loc]
                       .reshape(n_loc, -1))] += 1
    # the gradient shares: one holder block per rank
    cl = meta(t, n_pad, dw)[:, :n_loc]
    for s in range(p):
        calls[gemm_key(pmat[s * n_loc:(s + 1) * n_loc],
                       cl.reshape(t, -1))] += 1
    # the decode: each holder's R rows against the decode row
    calls[gemm_key(meta(rthr)[None, None].expand(n_loc, 1, rthr),
                   meta(n_loc, rthr, dw))] += 1
    return calls


def _device(name: str) -> torch.device:
    """The session's device; a worker told to use the card that cannot
    see one fails (it never falls back to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the session runs on {name}, but this worker "
                           f"process sees no CUDA device")
    if dev.type == "cpu":
        # one thread a worker: P workers share the host's cores, and every
        # value is an exact int, so the thread count cannot change a bit
        torch.set_num_threads(1)
    return dev


def from_payload(payload: bytes, dev) -> torch.Tensor:
    """An array payload as a tensor on `dev`.  unpack_array returns a
    read-only view of the frame, so it is copied first."""
    return torch.from_numpy(np.array(wire.unpack_array(payload))).to(dev)


def worker_entry(rank: int, coord_host: str, coord_port: int):
    """Worker main: handshake, run the session, report, exit.

    Launched as `python -m repro_torch.launch.runtime.worker RANK HOST
    PORT` (a plain subprocess: nothing of the parent's __main__ is
    re-imported, and CUDA is never forked)."""
    node = net.Node(rank)
    node.start(listen=True)
    try:
        node.connect(net.COORD, coord_host, coord_port)
        node.send(net.COORD, net.LISTEN, payload=pickle.dumps(
            {"host": node.cfg.host, "port": node.port}))
        sess = pickle.loads(
            node.recv(net.SESSION, src=net.COORD, retries=1,
                      timeout=node.cfg.spawn_timeout_s).payload)
        node.configure(sess["net"])
        _run_session(node, sess)
        node.recv(net.BYE, src=net.COORD)
    except net.PeerFailure:
        raise SystemExit(1)          # the coordinator already knows
    except Exception:  # noqa: BLE001 -- report ANY failure upstream
        try:
            # ERR is a plain UTF-8 JSON control frame (never pickle: the
            # coordinator must not unpickle an error report)
            node.send(net.COORD, net.ERR, payload=json.dumps(
                {"rank": rank, "error": traceback.format_exc()},
            ).encode("utf-8"))
            time.sleep(0.2)          # let the frame flush before exit
        except Exception:  # noqa: BLE001
            pass
        raise SystemExit(1)
    finally:
        node.stop()


def _run_session(node: net.Node, sess: dict):
    t_start = time.perf_counter()
    rank = node.rank
    dev = _device(sess["device"])
    proto = Copml(sess["cfg"], sess["m"], sess["d"],
                  objective=sess["objective"], device=dev)
    cfg = proto.cfg
    n, P = cfg.n_clients, sess["n_procs"]
    n_loc = -(-n // P)
    n_pad = n_loc * P
    t_, kk, dw, w_shape = cfg.t, cfg.k, proto.dw, proto.w_shape
    lo = rank * n_loc
    rthr = cfg.recovery_threshold
    iters, history = sess["iters"], sess["history"]
    forced = sess["subset"]          # decode subset pinned by the caller
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    def real_count(r):
        """Non-padded clients owned by rank r (trailing rank may own
        fewer when P does not divide N)."""
        return max(0, min(n_loc, n - r * n_loc))

    # full-mesh links: rank i dials every lower rank, higher ranks dial us
    for peer in range(P):
        if peer < rank:
            host, port = sess["addrs"][peer]
            node.connect(peer, host, port)

    # public per-client constants, zero-padded to n_pad rows
    pmat_np = np.zeros((n_pad, t_), np.int32)
    pmat_np[:n] = shamir._power_matrix(tuple(proto.lambdas), t_)
    wall_np = np.zeros((n_pad,), np.int32)
    wall_np[:n] = shamir._recon_matrix(tuple(proto.lambdas))[0]
    pmat_all = torch.from_numpy(pmat_np).to(dev)
    pmat_loc = pmat_all[lo:lo + n_loc]
    wall_loc = torch.from_numpy(wall_np).to(dev)[lo:lo + n_loc]
    enc_mat = proto._enc[None].expand(n_loc, n, kk + t_)

    w_loc = from_payload(sess["w_rows"], dev)
    coded_x = from_payload(sess["coded_rows"], dev)
    xty_loc = from_payload(sess["xty_rows"], dev)
    key = jrandom.as_key(sess["key"])
    node.send(net.COORD, net.READY)
    node.recv(net.START, src=net.COORD,
              timeout=node.cfg.spawn_timeout_s, retries=1)

    clock = _PhaseClock(sync)
    gemm = _Gemms()
    dvec_cache: dict = {}
    degraded = 0
    ops.reset_launches()

    def share_rows(keyc, secret):
        """This rank's holder rows of shamir.share(keyc, secret, t, n):
        replicated coefficient draw, shard-local power-matrix rows."""
        coeffs = field.random_field(keyc, (t_,) + tuple(secret.shape), dev)
        mix = gemm(pmat_loc, coeffs.reshape(t_, -1))
        return field.add(mix.reshape((n_loc,) + tuple(secret.shape)),
                         secret[None])

    def open_via_coord(c_sh, step):
        """TruncPr's masked opening: gather at the coordinator, get the
        reconstruction broadcast back (the OPEN barrier round)."""
        with clock("trunc_open"):
            node.send(net.COORD, net.OPEN, step=step, tag=net.TAG_TRUNC,
                      payload=wire.share_payload(c_sh.cpu()),
                      phase="trunc_open")
            frm = node.recv(net.OPENED, src=net.COORD, step=step,
                            tag=net.TAG_TRUNC)
        return from_payload(frm.payload, dev)

    def encode_model(k1_, w_c, step):
        """Per-iteration model encode; the reconstruct-from-all-holders
        contraction runs as a socket reduce-scatter: each rank weights
        its own holders' encodings, sends peer s the partial for s's
        clients, and field.adds the partials it receives (chained exact
        mod-p addition).  Each peer's partial is computed just before its
        send, so peer s's frame is on the wire while the GEMM for peer
        s+1 runs."""
        with clock("encode"):
            kv, ks_ = jrandom.split(k1_)
            v = field.random_field(kv, (t_,) + w_shape, dev)
            v_sh = share_rows(ks_, v)
            w_flat = w_c.reshape(n_loc, 1, dw)
            stacked = torch.cat([w_flat.expand(n_loc, kk, dw),
                                 v_sh.reshape(n_loc, t_, dw)], dim=1)
            enc = gemm(enc_mat, stacked)                     # (n_loc, N, dw)
            if n_pad > n:
                enc = torch.cat([enc, enc.new_zeros(n_loc, n_pad - n, dw)],
                                dim=1)

            def seg(s):
                sl = enc[:, s * n_loc:(s + 1) * n_loc]
                return gemm(wall_loc[None, :],
                            sl.reshape(n_loc, -1)).reshape(n_loc, dw)

            for s in range(P):
                if s == rank:
                    continue
                node.send(s, net.ENC, step=step,
                          payload=wire.share_payload(seg(s).cpu()),
                          phase="encode")
            acc = seg(rank)
            for s in range(P):
                if s == rank:
                    continue
                frm = node.recv(net.ENC, src=s, step=step)
                acc = field.add(acc, from_payload(frm.payload, dev))
        return acc                                           # (n_loc, dw)

    def collect_blocks(blocks, step):
        """Gather SHARE blocks and pick this step's decode subset from
        what actually ARRIVED -- straggling emerges from the network.

        With a pinned subset, wait (recv timeout policy) for exactly the
        ranks covering it.  Otherwise wait for everyone, but once >= R
        real owners are in hand, give the rest decode_timeout_s (or the
        recv budget) before decoding from the survivors."""
        nonlocal degraded
        if forced is not None:
            for s in sorted({g // n_loc for g in forced} - set(blocks)):
                frm = node.recv(net.SHARE, src=s, step=step)
                blocks[s] = from_payload(frm.payload, dev)
            return tuple(forced)[:rthr]
        cfg_net = node.cfg
        soft = None if cfg_net.decode_timeout_s is None else (
            time.monotonic() + cfg_net.decode_timeout_s)
        hard = time.monotonic() + (cfg_net.recv_timeout_s
                                   * max(1, cfg_net.recv_retries))
        while len(blocks) < P:
            covered = sum(real_count(s) for s in blocks)
            now = time.monotonic()
            if covered >= rthr and (now >= hard
                                    or (soft is not None and now >= soft)):
                degraded += 1
                break
            if covered < rthr and now >= hard:
                raise net.NodeTimeout(
                    f"rank {rank}: only {covered} of the {rthr} owner "
                    f"blocks needed to decode step {step} arrived")
            frm = node.recv_any(net.SHARE, step, timeout=0.01)
            if frm is not None:
                blocks[frm.src] = from_payload(frm.payload, dev)
        owners = sorted(g for s in blocks
                        for g in range(s * n_loc, s * n_loc + real_count(s)))
        return tuple(owners[:rthr])

    def decode_update(k2_, w_c, f_loc, step):
        """Phase 4: share the coded gradients (all_to_all over sockets),
        decode locally from the arrived subset, TruncPr update."""
        kf, kt = jrandom.split(k2_)
        # replicated global sharing-polynomial draw, own columns kept
        coeffs = field.random_field(kf, (t_, n) + w_shape, dev)
        coeffs = coeffs.reshape(t_, n, dw)
        if n_pad > n:
            coeffs = torch.cat(
                [coeffs, coeffs.new_zeros(t_, n_pad - n, dw)], dim=1)
        cl = coeffs[:, lo:lo + n_loc]
        f_flat = f_loc.reshape(n_loc, dw)

        def mine_block(s):
            # holder rows owned by rank s, built just before the send so
            # the SHARE frame for s rides the wire while s+1's block GEMM
            # runs
            mixs = gemm(pmat_all[s * n_loc:(s + 1) * n_loc],
                        cl.reshape(t_, -1))
            return field.add(mixs.reshape(n_loc, n_loc, dw), f_flat[None])

        with clock("exchange"):
            for s in range(P):
                if s == rank:
                    continue
                node.send(s, net.SHARE, step=step,
                          payload=wire.share_payload(mine_block(s).cpu()),
                          phase="exchange")
            blocks = {rank: mine_block(rank)}
            sub = collect_blocks(blocks, step)
        if sub not in dvec_cache:
            dvec_cache[sub] = torch.from_numpy(proto._decode_vec(sub)).to(dev)
        dvt = dvec_cache[sub]
        evals = torch.stack(
            [blocks[g // n_loc][:, g - (g // n_loc) * n_loc] for g in sub],
            dim=1)                                        # (n_loc, R, dw)
        xtg = gemm(dvt[None, None].expand(n_loc, 1, len(sub)), evals)
        grad = field.sub(xtg.reshape((n_loc,) + w_shape), xty_loc)
        scaled = field.mul_scalar(grad, proto.q_eta)
        delta = truncation.trunc_pr_core(
            kt, scaled, proto.k1, proto.k2, share=share_rows,
            open_=lambda c_sh: open_via_coord(c_sh, step))
        return field.sub(w_c, delta)

    for t in range(iters):
        k1_, k2_ = jrandom.split(jrandom.fold_in(key, t))
        coded_w = encode_model(k1_, w_loc, t)
        with clock("gradient"):
            f_loc = proto.local_gradient(coded_x, coded_w)   # LOCAL
        w_loc = decode_update(k2_, w_loc, f_loc, t)
        if history:
            with clock("open_model"):
                node.send(net.COORD, net.OPEN, step=t, tag=net.TAG_HIST,
                          payload=wire.share_payload(w_loc.cpu()),
                          phase="open_model")

    with clock("open_model"):
        node.send(net.COORD, net.RESULT, payload=pickle.dumps({
            "w": wire.share_payload(w_loc[:real_count(rank)].cpu()),
            "seconds": dict(clock.seconds),
            "bytes": dict(node.sent_bytes),
            "frames": dict(node.sent_frames),
            "dropped": dict(node.dropped_frames),
            "degraded_steps": degraded,
            "wall_s": time.perf_counter() - t_start,
            "device": str(w_loc.device),
            "launches": ops.launch_counts(),
            "gemm_paths": ops.gemm_path_counts(),
            "wide": ops.wide_counts(),
            "threefry": ops.threefry_counts(),
            "gemms": sorted([*k, c] for k, c in gemm.calls.items()),
        }), phase="open_model")


def main(argv=None):
    import sys
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 3:
        raise SystemExit("usage: python -m repro_torch.launch.runtime.worker "
                         "RANK HOST PORT")
    worker_entry(int(args[0]), args[1], int(args[2]))


if __name__ == "__main__":
    main()
