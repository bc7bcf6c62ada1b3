"""COPML: the training protocol (paper Algorithm 1) over N virtual clients.

One process simulates all N clients; every share tensor carries the client
axis first.  Per iteration the model is Lagrange-encoded from its shares,
then Phases 3+4 (coded gradient, decode, secure truncated update) run as
one `ops.fused_step` call.  A fault plan's per-step decode subsets and
adversaries (api/faults.FaultPlan) enter that call as its decode row and
corruption offsets.

The sharded engine (`Copml._train_sharded`) splits the client axis over a
core/meshutil ClientMesh of D rank processes: each rank holds only its
clients' shares and coded rows, and the protocol's EXCHANGE and OPEN steps
are real collectives.  Its ranks, like the proc engine's workers
(launch/runtime/worker), run the siloed Phases 3 and 4: the coded-gradient
kernels (`Copml.local_gradient`), then share, decode and TruncPr as
separate field ops (`_RankStep.decode_update`).  It gives the bits of the
in-process engines.

Fixed-point scale plumbing (paper Appendix A):

  X quantized at 2^lx, w at 2^lw  =>  z = Xw at lz = lx+lw.
  ghat coefficients quantized so ghat(z) comes out at lg = lz + cb.
  coded gradient  f = X~^T ghat(X~ w~)  at s_grad = lx + lg.
  update: multiply by public  q_eta ~= (eta/m) * 2^e, then TruncPr by
  2^{k1}, k1 = s_grad + e - lw, returning to scale lw.

Every value is a canonical int32 in [0, p) and every random draw comes from
core/random's emulation of the JAX package's key stream, so each phase is
bit-identical to the JAX package's on the same key.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from .. import obs
from ..kernels import ops
from . import (field, lagrange, meshutil, mpc, objectives, quantize, shamir,
               truncation)
from . import random as jrandom
from .labels import Coded, Opened, Public, Share


@dataclasses.dataclass(frozen=True)
class CopmlConfig:
    n_clients: int
    k: int                   # parallelization (dataset split)
    t: int                   # privacy threshold
    r: int = 1               # sigmoid polynomial degree
    eta: float = 1.0
    # fixed-point scales
    lx: int = 2
    lw: int = 3
    cb: int = 6
    k1: int | None = None
    k2: int = 24
    mag_bits: int = 10       # headroom for |X^T(ghat-y)| true magnitude
    sigmoid_bound: float = 10.0
    mpc_mul: str = "bh08"    # "bh08" | "bgw"

    @property
    def lz(self) -> int:
        return self.lx + self.lw

    @property
    def lg(self) -> int:
        return self.lz + self.cb

    @property
    def s_grad(self) -> int:
        return self.lx + self.lg

    @property
    def recovery_threshold(self) -> int:
        return lagrange.recovery_threshold(self.r, self.k, self.t)

    def validate(self):
        assert self.n_clients >= self.recovery_threshold, (
            f"N={self.n_clients} < recovery threshold "
            f"{self.recovery_threshold} = (2r+1)(K+T-1)+1")
        assert self.n_clients >= 2 * self.t + 1, "MPC mult needs N >= 2T+1"
        assert self.mag_bits + self.s_grad + 2 <= field.P_BITS, (
            "fixed-point budget exceeds field size")


# Corruption offset added to an adversarial client's coded gradient (the
# fused step's adv_off operand); it must exceed TruncPr's 2^k1 rescale to
# stay visible in the model.
ADV_OFFSET = 1 << 20

def sharded_overlap_from_env() -> bool:
    """REPRO_SHARDED_OVERLAP: "1" (default) streams the sharded step's two
    EXCHANGE collectives around rings; "0" takes the monolithic ones."""
    return os.environ.get("REPRO_SHARDED_OVERLAP", "1") != "0"


def case1_params(n: int, r: int = 1) -> tuple:
    """Paper Case 1 (max parallelization): K = floor((N-1)/(2r+1)), T = 1."""
    return max(1, (n - 1) // (2 * r + 1)), 1


def case2_params(n: int, r: int = 1) -> tuple:
    """Paper Case 2 (equal split between parallelization and privacy):
    K+T-1 = floor((N-1)/(2r+1)) with T taking roughly half of it; at r=1
    T = floor((N-3)/6), K = floor((N+2)/3) - T.  Raises ValueError when no
    valid equal split exists."""
    if r < 1:
        raise ValueError(f"polynomial degree r must be >= 1, got {r}")
    deg = 2 * r + 1
    t = max(1, (n - 3) // (2 * deg))
    k = max(1, (n + 2 * r) // deg - t)
    if deg * (k + t - 1) + 1 > n:
        raise ValueError(
            f"case 2 has no valid (K, T) for N={n}, r={r}: the recovery "
            f"threshold {deg * (k + t - 1) + 1} = (2r+1)(K+T-1)+1 exceeds N")
    return k, t


def derive_update_constants(cfg: CopmlConfig, m: int) -> tuple:
    """(q_eta, e, k1, k2): eta/m ~= q_eta / 2^e, q_eta a small public int."""
    e = int(round(math.log2(m / cfg.eta))) + 1
    q_eta = max(1, int(round(cfg.eta / m * (1 << e))))
    k1 = cfg.k1 if cfg.k1 is not None else cfg.s_grad + e - cfg.lw
    k2 = max(cfg.k2, min(field.P_BITS - 1, k1 + 1))
    assert 0 < k1 < k2 <= field.P_BITS - 1, (k1, k2)
    return q_eta, e, k1, k2


@dataclasses.dataclass
class CopmlState:
    """Everything clients hold after the one-time setup (w_shape is (d,) or
    (d, C))."""
    w_shares: Share              # (N,) + w_shape   Shamir shares of w^(t)
    coded_x: Coded               # (N, mk, d)       clear coded slices X~_i
    xty_shares: Share            # (N,) + w_shape   shares of X^T y (lx+lg)
    step: int = 0


def state_from_numpy(w_shares, coded_x, xty_shares, step=0,
                     device="cpu") -> CopmlState:
    """A CopmlState from numpy arrays (e.g. the JAX package's state fields
    passed through np.asarray)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.int32)).to(device)
    return CopmlState(w_shares=t(w_shares), coded_x=t(coded_x),
                      xty_shares=t(xty_shares), step=int(np.asarray(step)))


def _client_tensor(x) -> torch.Tensor:
    """A tensor over one client's rows: a C-contiguous host array in native
    byte order is viewed where it lies (torch.from_numpy); any other host
    array or tensor is first copied into a contiguous one.  A tensor on a
    card is taken as it is."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            return x
        return x.contiguous()
    a = np.asarray(x)
    if not (a.flags.c_contiguous and a.dtype.isnative):
        a = np.ascontiguousarray(a, a.dtype.newbyteorder("="))
    with warnings.catch_warnings():
        # the view is only read
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        return torch.from_numpy(a)


def stage_rows(client_xs: Sequence, d: int, device) -> torch.Tensor:
    """The clients' (m_j, d) rows as one float32 (m, d) tensor on `device`,
    each client's rows copied from the caller's array straight into its
    row slice: no host array of all the rows is made.  A float32 client is
    one host-to-device copy; any other dtype is copied as it is and cast
    on the device (float64 rounds to the nearest float32, integers and
    float16 are exact), so the rows are np.concatenate's rows cast to
    float32 for any clients it accepts.  No copy waits for the device."""
    device = torch.device(device)
    srcs = []
    for j, x in enumerate(client_xs):
        src = _client_tensor(x)
        if src.dim() != 2 or src.shape[1] != d:
            raise ValueError(f"client {j}'s rows have shape "
                             f"{tuple(src.shape)}; expected (m_{j}, {d})")
        srcs.append(src)
    rows = torch.empty((sum(s.shape[0] for s in srcs), d),
                       dtype=torch.float32, device=device)
    lo = 0
    for src in srcs:
        hi = lo + src.shape[0]
        if hi > lo:
            if (src.device.type == "cpu" and device.type != "cpu"
                    and src.dtype != torch.float32):
                src = src.to(device, non_blocking=True)
            rows[lo:hi].copy_(src, non_blocking=True)
        lo = hi
    return rows


def resolve_device(device=None) -> torch.device:
    """The run's device: `device` if given, else the CUDA card; raises when
    no card is present and the caller did not ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain torch path on the CPU")
    return torch.device("cuda")


class Copml:
    """COPML protocol driver on one device.

    `objective` (core/objectives.SecureObjective, default binary logistic)
    supplies the ghat coefficients, target embedding, model shape and
    update constants; every phase is shape-polymorphic over the model's
    trailing dims."""

    def __init__(self, cfg: CopmlConfig, m: int, d: int, objective=None,
                 device=None):
        cfg.validate()
        self.cfg = cfg
        self.m, self.d = m, d
        self.device = resolve_device(device)
        self.obj = objectives.BINARY_LOGISTIC if objective is None \
            else objective
        self.obj.validate_cfg(cfg)
        self.out_shape = self.obj.out_shape
        self.w_shape = (d,) + self.out_shape
        self.dw = d * self.obj.n_outputs
        n, k, t = cfg.n_clients, cfg.k, cfg.t
        self.alphas, self.betas = lagrange.default_points(n, k, t)
        self.lambdas = tuple(range(k + t + 1 + n, k + t + 1 + 2 * n))
        self.q_eta, self.e, self.k1, self.k2 = self.obj.update_constants(
            cfg, m)
        self.poly_coeffs = self.obj.field_coeffs(cfg)       # host int32
        self._mul = mpc.mul_bh08 if cfg.mpc_mul == "bh08" else mpc.mul_bgw
        dev = self.device
        self._coeffs = torch.from_numpy(self.poly_coeffs).to(dev)
        self._enc = torch.from_numpy(
            lagrange.encode_matrix(self.alphas, self.betas)).to(dev)
        rvec = np.zeros(n, np.int32)
        rvec[: t + 1] = shamir.recon_weights(self.lambdas, tuple(range(t + 1)))
        self._rvec = torch.from_numpy(rvec).to(dev)
        self._zeros_n = torch.zeros(n, dtype=torch.int32, device=dev)
        self._decode_rows: dict = {}

    # ------------------------------------------------------------------ setup

    def setup(self, key, client_xs: Sequence, client_ys: Sequence) -> CopmlState:
        """Phases 1-2 (one-time): quantize, secret-share, LCC-encode, X^T y.

        client_xs[j]: (m_j, d) float arrays; client_ys[j]: (m_j,) labels."""
        cfg, n, dev = self.cfg, self.cfg.n_clients, self.device
        keys = jrandom.split(key, 6)

        # Phase 1 (LOCAL): quantize into F_p
        with obs.span("setup.rows"):
            xq, yq = self.quantize_rows(client_xs, client_ys)

        # Phase 2a (EXCHANGE): Shamir-share every client's data
        with obs.span("setup.share"):
            x_shares = shamir.share(keys[0], xq, cfg.t, n, self.lambdas)
            y_shares = shamir.share(keys[1], yq, cfg.t, n, self.lambdas)
        del xq

        # Phase 2b/c: partition rows into K blocks, add T masks, LCC-encode,
        # reconstruct each client's coded slice.  Reconstruction reads only
        # the first T+1 holders, so only their encodings are formed, one
        # holder at a time (the values are those of the all-holder
        # encoding, at 8/50 of its memory for the paper's case 2).
        with obs.span("setup.lcc"):
            per = -(-x_shares.shape[1] // cfg.k)
            holders = cfg.t + 1
            z = field.random_field(keys[2], (cfg.t, per, self.d), dev)
            z_shares = shamir.share(keys[3], z, cfg.t, n, self.lambdas,
                                    holders=holders)      # (T+1, T, mk, d)
            del z
            enc = torch.empty((holders, n, per, self.d), dtype=torch.int32,
                              device=dev)
            for h in range(holders):
                blocks, _ = lagrange.partition_rows(x_shares[h], cfg.k)
                enc[h] = lagrange._lcc_encode_with(self._enc, blocks,
                                                   z_shares[h])
            del blocks, z_shares
            coded_x = shamir.reconstruct(enc, cfg.t, self.lambdas)
            del enc                                       # coded_x (N, mk, d)

        # Phase 2d: X^T y via one secure matmul; a matrix objective
        # contracts against all C target columns at once
        y_mat = y_shares if self.out_shape else y_shares[..., None]
        with obs.span("setup.xty"):
            xty_shares = self._mul(
                keys[4], x_shares.transpose(1, 2), y_mat,
                cfg.t, matmul=True, points=self.lambdas)  # (N, d, C')
        if not self.out_shape:
            xty_shares = xty_shares[..., 0]
        del x_shares

        # model init within MPC: w^(0) = 0 shared
        w_shares = shamir.share(
            keys[5], torch.zeros(self.w_shape, dtype=field.FIELD_DTYPE,
                                 device=dev), cfg.t, n, self.lambdas)
        return CopmlState(w_shares=w_shares, coded_x=coded_x,
                          xty_shares=xty_shares.contiguous(), step=0)

    def quantize_rows(self, client_xs: Sequence,
                      client_ys: Sequence) -> tuple:
        """Phase 1 (LOCAL): the clients' rows and targets quantized into F_p
        on the device, (xq (m, d), yq (m,) + out_shape).  The rows reach
        the device through stage_rows, one copy a client into one buffer,
        and are quantized there at once."""
        rows = stage_rows(client_xs, self.d, self.device)
        xq = quantize.quantize(rows, self.cfg.lx, self.device)
        del rows
        targets = self.obj.prepare_targets(
            np.concatenate([np.asarray(y) for y in client_ys], axis=0))
        yq = quantize.quantize(np.asarray(targets, np.float32), self.cfg.lg,
                               self.device)
        return xq, yq

    # ------------------------------------------------------- one GD iteration

    def encode_model(self, key, w_shares: Share) -> Coded:
        """Phase 2 per-iteration: Lagrange-encode w from its shares.

        v(beta_k) = w for all k in [K]; T random vectors pad the tail.  Each
        holder encodes its shares for every owner (one batched GEMM against
        the broadcast encode matrix), then every owner's coded model is
        reconstructed from all N holders."""
        cfg, n = self.cfg, self.cfg.n_clients
        kv, ks = jrandom.split(key)
        v = field.random_field(kv, (cfg.t,) + self.w_shape, self.device)
        v_shares = shamir.share(ks, v, cfg.t, n, self.lambdas)
        w_flat = w_shares.reshape(n, 1, self.dw)
        v_flat = v_shares.reshape(n, cfg.t, self.dw)
        stacked = torch.cat([w_flat.expand(n, cfg.k, self.dw), v_flat],
                            dim=1)                       # (N_h, K+T, dw)
        enc_mat = self._enc[None].expand(n, n, cfg.k + cfg.t)
        enc = ops.modmatmul_batched(enc_mat, stacked)    # (N_h, N_o, dw)
        return shamir.reconstruct(enc, cfg.t, self.lambdas, subset="all")

    def local_gradient(self, coded_x: Coded, coded_w: Coded) -> Coded:
        """Phase 3 (LOCAL): f(X~_i, w~_i) = X~_i^T ghat(X~_i w~_i) for all N
        clients in one kernel launch; a matrix objective's coded model
        reshapes to (N, d, C) and takes the class-batched kernel."""
        if not self.out_shape:
            return ops.coded_gradient_batched(coded_x, coded_w, self._coeffs)
        w_mat = coded_w.reshape(coded_w.shape[0], self.d, self.obj.n_outputs)
        return ops.coded_gradient_matrix(coded_x, w_mat, self._coeffs)

    def _decode_vec(self, subset) -> Public:
        """Host-side (R,) decode row: sum_k D[k, :] over the K decode-matrix
        rows, mod p, in the barycentric form without forming D:
        dvec_j = w_j * sum_k prod_{l != j} (beta_k - alpha_l)."""
        num, w = field.host_lagrange_parts(
            [self.alphas[i] for i in subset], self.betas[: self.cfg.k])
        return (num.sum(axis=0) % field.P * w % field.P).astype(np.int32)

    def _decode_row(self, subset):
        """(subset_idx, dvec, dfull) device tensors of a static subset (None
        = the first R clients), cached per subset: the R indices, their
        decode row, and the row zero-scattered over all N clients."""
        rthr = self.cfg.recovery_threshold
        subset = tuple(range(rthr)) if subset is None else \
            tuple(subset)[:rthr]
        if subset not in self._decode_rows:
            idx = torch.tensor(subset, dtype=torch.int64, device=self.device)
            dvec = torch.from_numpy(self._decode_vec(subset)).to(self.device)
            self._decode_rows[subset] = (
                idx, dvec, self._zeros_n.index_put((idx,), dvec))
        return self._decode_rows[subset]

    def _fused_iteration(self, key, state: CopmlState, coded_w: Coded,
                         subset=None, *, subset_idx=None, dvec=None,
                         adv=None) -> CopmlState:
        """Phases 3+4 as ONE kernels/ops.fused_step call.

        `mix` is shamir.share(kf, ZEROS), the value-independent masking term
        of the coded gradients' sharing, so holder h's decode splits into
        base[h] = dfull @ mix[h] (formed here) plus the holder-independent
        dfull @ f_adj (formed in the kernel).  TruncPr's r/[r]/[r0] come
        from trunc_pr_randomness with trunc_pr_core's split arity and draw
        shapes.  The decode subset enters as the zero-scattered (N,) row
        `dfull`, from a static subset or from (subset_idx, dvec); `adv`
        (N,) bool adds ADV_OFFSET to those clients' gradients."""
        cfg, n, dev = self.cfg, self.cfg.n_clients, self.device
        kf, kt = jrandom.split(key)
        if subset_idx is None:
            dfull = self._decode_row(subset)[2]
        else:
            assert dvec is not None, "subset_idx needs its decode row dvec"
            dfull = self._zeros_n.index_put((subset_idx,), dvec)
        adv_off = self._zeros_n if adv is None else \
            torch.where(adv, ADV_OFFSET, self._zeros_n)

        with obs.span("step.masks"):
            mix = shamir.share(
                kf, torch.zeros((n,) + self.w_shape, dtype=field.FIELD_DTYPE,
                                device=dev), cfg.t, n, self.lambdas)
            base = ops.modmatmul_batched(
                dfull[None, None].expand(n, 1, n), mix.view(n, n, self.dw))
            r_sh, r0_sh = truncation.trunc_pr_randomness(
                kt, self.w_shape, self.k1, self.k2,
                lambda k, s: shamir.share(k, s, cfg.t, n, self.lambdas), dev)
            radd = field.add(r_sh, torch.full_like(r_sh, 1 << (self.k2 - 1)))

        mat = (n, self.d, self.obj.n_outputs)
        _, new_w = ops.fused_step(
            state.coded_x, coded_w.reshape(mat), self._coeffs, adv_off,
            dfull, self._rvec, base.reshape(mat),
            state.xty_shares.reshape(mat), state.w_shares.reshape(mat),
            radd.reshape(mat), r0_sh.reshape(mat),
            q_eta=self.q_eta, inv2k1=field.host_inv(1 << self.k1), k1=self.k1)
        return dataclasses.replace(
            state, w_shares=new_w.reshape((n,) + self.w_shape),
            step=state.step + 1)

    def iteration(self, key, state: CopmlState,
                  subset: Sequence[int] | None = None, *,
                  subset_idx=None, dvec=None, adv=None) -> CopmlState:
        """One GD iteration: encode the model, then the fused Phases 3+4."""
        k1_, k2_ = jrandom.split(key)
        with obs.span("step.encode"):
            coded_w = self.encode_model(k1_, state.w_shares)
        return self._fused_iteration(k2_, state, coded_w, subset,
                                     subset_idx=subset_idx, dvec=dvec,
                                     adv=adv)

    # ------------------------------------------------------ fault schedules

    def plan_constants(self, step_subsets) -> tuple:
        """A fault plan's per-step decode subsets -> (iters, R) int64 index
        and int32 decode-row tensors on the device (one exact Lagrange row
        per distinct subset)."""
        return shamir.step_subset_arrays(
            step_subsets, self.cfg.recovery_threshold, self._decode_vec,
            self.device)

    def _fault_xs(self, step_subsets, adversaries, iters: int, subset=None):
        """(idx, dvec, adv-or-None) per-step inputs of a faulty run, or
        None for a fault-free one."""
        if step_subsets is None:
            assert adversaries is None, "adversaries need step_subsets"
            return None
        if subset is not None:
            raise ValueError("subset and step_subsets are mutually "
                             "exclusive: the plan chooses each step's "
                             "decode subset")
        assert len(step_subsets) == iters, (len(step_subsets), iters)
        with obs.span("setup.faults"):
            idx, dvs = self.plan_constants(step_subsets)
            adv = None
            if adversaries is not None and np.asarray(adversaries).any():
                adv = np.array(adversaries, bool)    # a writable copy
                assert adv.shape == (iters, self.cfg.n_clients), adv.shape
                adv = torch.from_numpy(adv).to(self.device)
        return idx, dvs, adv

    # ------------------------------------------------------------------ train

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def train(self, key, client_xs, client_ys, iters: int,
              subset: Sequence[int] | None = None,
              history: bool = False, timings: dict | None = None,
              step_subsets=None, adversaries=None, callback=None) -> tuple:
        """Setup + `iters` GD iterations with the JAX package's key schedule
        (split(key) -> (ks, ki); step t uses fold_in(ki, t)).

        step_subsets / adversaries carry a fault plan: per-step decode
        subsets and an (iters, N) corruption mask, compiled once into
        device tensors before the setup (the `setup.faults` span).
        `timings`, when given, receives setup_s and iters_s: wall seconds
        of the setup and of the iteration loop, each ending in a device
        synchronise; spans: the run's obs spans (setup.*, train.step and
        the phases inside it), path -> [count, host seconds]; and counts:
        this run's coded-gradient launches by route (ops.gradient_counts),
        the difference across the run of the process's counters.
        `callback(t, w)`, when given, receives the opened model after step
        t.  Returns (state, w, history (iters,) + w_shape or None)."""
        subset = None if subset is None else tuple(subset)
        iters = int(iters)
        counts0 = ops.gradient_counts()
        rec = obs.Recorder()
        with rec if timings is not None else contextlib.nullcontext():
            faults = self._fault_xs(step_subsets, adversaries, iters, subset)
            t0 = self._sync()
            ks, ki = jrandom.split(jrandom.as_key(key))
            state = self.setup(ks, client_xs, client_ys)
            t1 = self._sync()
            hist = []
            for t in range(iters):
                with obs.span("train.step"):
                    kw = {}
                    if faults is not None:
                        idx, dvs, adv = faults
                        kw = dict(subset_idx=idx[t], dvec=dvs[t],
                                  adv=None if adv is None else adv[t])
                    state = self.iteration(jrandom.fold_in(ki, t), state,
                                           subset, **kw)
                    if history or callback is not None:
                        with obs.span("step.open"):
                            w_t = self.open_model(state)
                        if history:
                            hist.append(w_t)
                        if callback is not None:
                            callback(t, w_t)
            t2 = self._sync()
        if timings is not None:
            counts = {k: v - counts0[k]
                      for k, v in ops.gradient_counts().items()}
            timings.update(setup_s=t1 - t0, iters_s=t2 - t1, spans=rec.spans,
                           counts=counts)
        w = self.open_model(state)
        if not history:
            return state, w, None
        hist = torch.stack(hist) if hist else \
            torch.zeros((0,) + self.w_shape, dtype=torch.float32)
        return state, w, hist

    def open_model(self, state: CopmlState) -> Opened:
        """Reconstruct and dequantize the model."""
        w_field = mpc.open_shares(state.w_shares, self.cfg.t, self.lambdas)
        return quantize.dequantize(w_field, self.cfg.lw)

    # -------------------------------------------- deprecated engine methods
    #
    # The JAX package's train_* methods, kept as shims: each warns and
    # forwards to api.protocols.run_copml_engine, the dispatch api.fit runs.

    def _deprecated(self, engine_label: str):
        warnings.warn(
            f"Copml.train_{engine_label} is deprecated; use "
            f"repro_torch.api.fit(workload, 'copml', "
            f"engine='{engine_label}')", DeprecationWarning, stacklevel=3)
        from ..api.protocols import run_copml_engine
        return run_copml_engine

    def train_jit(self, key, client_xs, client_ys, iters: int,
                  subset: Sequence[int] | None = None,
                  history: bool = False) -> tuple:
        """Deprecated: api.fit(..., engine="jit").  Returns (state, w) or
        (state, w, history)."""
        run = self._deprecated("jit")
        state, w, hist = run(self, "jit", key, client_xs, client_ys,
                             int(iters), subset=subset, history=history)
        return (state, w, hist) if history else (state, w)

    def train_eager(self, key, client_xs, client_ys, iters: int,
                    subset: Sequence[int] | None = None,
                    callback=None) -> tuple:
        """Deprecated: api.fit(..., engine="eager"); `callback(t, w)`
        receives the opened model after each step.  Returns (state, w)."""
        run = self._deprecated("eager")
        state, w, _ = run(self, "eager", key, client_xs, client_ys,
                          int(iters), subset=subset, callback=callback)
        return state, w

    def train_sharded(self, key, client_xs, client_ys, iters: int,
                      mesh=None, subset: Sequence[int] | None = None,
                      history: bool = False) -> tuple:
        """Deprecated: api.fit(..., engine="sharded") on `mesh` (None: one
        rank per card, or one on the CPU).  Returns (state, w) or (state,
        w, history)."""
        run = self._deprecated("sharded")
        state, w, hist = run(self, "sharded" if mesh is None else mesh, key,
                             client_xs, client_ys, int(iters), subset=subset,
                             history=history)
        return (state, w, hist) if history else (state, w)

    # ----------------------------------------------------- distributed engine

    def _train_sharded(self, key, client_xs, client_ys, iters: int,
                       mesh=None, subset: Sequence[int] | None = None,
                       history: bool = False, step_subsets=None,
                       adversaries=None, timings: dict | None = None) -> tuple:
        """`train` with the client axis split over a meshutil.ClientMesh.

        Each of the mesh's D ranks holds only its clients' model shares,
        coded rows and X^T y shares, and each protocol step becomes the
        collective its MPC character implies:

          LOCAL     Phase-3 coded gradients, share-level add/mul-by-public
                    -> per-rank compute, no communication
          EXCHANGE  share_batch's owner->holder share distribution
                    -> all-to-all; the model encoding's reconstruct
                    -> mod-p reduce-scatter
          OPEN      TruncPr's masked opening, the per-step model opening
                    -> all-gather + replicated reconstruct

        The bits are train's: the per-step key schedule is the same, every
        random draw is replicated (same key, same full shape on every rank,
        the paper's offline dealer), and the only cross-rank contractions
        are mod-p linear reductions whose partials recombine to the same
        canonical representative.  The setup runs once here, on this
        Copml's device; the client axis is zero-padded to a multiple of D,
        and padded clients carry zero Lagrange weight and a zero sharing
        row.  REPRO_SHARDED_OVERLAP (default "1") streams the two EXCHANGE
        collectives around rings; "0" takes the monolithic collectives.

        Returns (state, w, history-or-None) as train does.  `timings`
        receives setup_s (the setup and the dealing) and iters_s, each
        ending when every rank has synchronised, and `ranks`: each rank's
        device, backend, kernel launches by name and by GEMM path, peak
        device memory, bytes sent by collective, and loop seconds."""
        mesh = meshutil.client_mesh(None, self.device) if mesh is None \
            else mesh
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's ranks run on {mesh.device}; this "
                             f"Copml runs on {self.device}")
        n, iters = self.cfg.n_clients, int(iters)
        subset = None if subset is None else tuple(subset)
        faults = self._fault_xs(step_subsets, adversaries, iters, subset)
        t0 = self._sync()
        ks, ki = jrandom.split(jrandom.as_key(key))
        state = self.setup(ks, client_xs, client_ys)        # once, here
        handle, n_pad = self._deal_sharded(mesh, state)
        t1 = time.perf_counter()
        w_pad, hist, reports = self._run_sharded(
            mesh, handle, n_pad, ki, iters, history, subset, faults)
        t2 = time.perf_counter()
        if timings is not None:
            timings.update(setup_s=t1 - t0, iters_s=t2 - t1, ranks=reports)
        state = dataclasses.replace(state, w_shares=w_pad[:n],
                                    step=state.step + iters)
        return state, self.open_model(state), hist

    def sharded_step(self, mesh, subset: Sequence[int] | None = None):
        """One sharded GD iteration as fn(w, coded_x, xty, key) over PADDED
        (n_pad, ...) client arrays on this Copml's device, returning the
        padded model shares; returns (fn, n_pad)."""
        subset = None if subset is None else tuple(subset)

        def fn(w, coded_x, xty, key):
            n = self.cfg.n_clients
            state = CopmlState(w_shares=w[:n], coded_x=coded_x[:n],
                               xty_shares=xty[:n])
            handle, n_pad = self._deal_sharded(mesh, state)
            return self._run_sharded(mesh, handle, n_pad,
                                     jrandom.as_key(key), 1, False, subset,
                                     None)[0]

        return fn, _n_pad(self.cfg.n_clients, mesh.size)

    def _deal_sharded(self, mesh, state: CopmlState) -> tuple:
        """Give rank r its n_loc rows of the state's client-major tensors
        (zero rows past the last client), kept on its device under a fresh
        handle; returns (handle, n_pad) once every rank holds them."""
        n_pad = _n_pad(self.cfg.n_clients, mesh.size)
        n_loc = n_pad // mesh.size
        rows = [_pad_clients(x.cpu(), n_pad).split(n_loc)
                for x in (state.w_shares, state.coded_x, state.xty_shares)]
        handle = mesh.new_handle()
        spec = dict(cfg=self.cfg, m=self.m, d=self.d, objective=self.obj)
        mesh.run(_rank_deal, handle, spec,
                 per_rank=[[r[i] for r in rows] for i in range(mesh.size)])
        return handle, n_pad

    def _run_sharded(self, mesh, handle, n_pad: int, key, iters: int,
                     history: bool, subset, faults) -> tuple:
        """Run `iters` steps on the ranks holding `handle`; returns (padded
        model shares on this device, history or None, rank reports)."""
        rthr = self.cfg.recovery_threshold
        if faults is None:
            idx, dvs, _ = self._decode_row(subset)
            idx = idx.cpu().expand(iters, rthr)
            dvs = dvs.cpu().expand(iters, rthr)
            adv = None
        else:
            idx, dvs, adv = (None if x is None else x.cpu() for x in faults)
            if adv is not None:
                # replicated (iters, n_pad) mask; padded clients honest
                adv = _pad_clients(adv, n_pad, dim=1)
        overlap = sharded_overlap_from_env()
        out = mesh.run(_rank_train, handle, jrandom.as_key(key).numpy(),
                       int(iters), bool(history), overlap, idx, dvs, adv)
        w_pad = torch.cat([o["w"] for o in out]).to(self.device)
        hist = None if not history else out[0]["hist"].to(self.device)
        return w_pad, hist, [o["report"] for o in out]


def _n_pad(n: int, ndev: int) -> int:
    """The client axis padded to a multiple of the mesh size."""
    return -(-n // ndev) * ndev


def _pad_clients(arr, n_pad: int, dim: int = 0):
    """Zero-pad the client axis `dim` to n_pad rows (mesh divisibility)."""
    n = arr.shape[dim]
    if n == n_pad:
        return arr
    shape = list(arr.shape)
    shape[dim] = n_pad - n
    return torch.cat([arr, arr.new_zeros(shape)], dim=dim)


# ---------------------------------------------- the sharded engine's ranks
#
# Module-level so a ClientMesh can send them to its ranks by name.


def _rank_deal(rank, handle, spec: dict, w_rows, coded_rows, xty_rows):
    """Keep this rank's client rows, and a Copml for its device."""
    dev = rank.device
    rank.state[handle] = dict(
        proto=Copml(spec["cfg"], spec["m"], spec["d"],
                    objective=spec["objective"], device=dev),
        w=w_rows.to(dev), coded_x=coded_rows.to(dev), xty=xty_rows.to(dev))
    rank.sync()


class _RankStep:
    """One rank's share of a sharded COPML step (the JAX package's
    shard_map body): n_loc consecutive clients of the padded axis."""

    def __init__(self, rank, proto: Copml, overlap: bool):
        cfg = proto.cfg
        self.rank, self.proto, self.dev = rank, proto, rank.device
        self.n, self.t = cfg.n_clients, cfg.t
        self.ndev = rank.size
        self.n_pad = _n_pad(self.n, self.ndev)
        self.n_loc = self.n_pad // self.ndev
        self.lo = rank.rank * self.n_loc
        self.w_shape, self.dw = proto.w_shape, proto.dw
        # ring forms need the raw int32 sum of D partials not to wrap
        self.ring_encode = overlap and self.ndev <= meshutil.NARROW_SHARDS
        self.ring_exchange = overlap
        # public per-client constants, zero-padded so padded clients carry
        # zero Lagrange weight and a zero sharing polynomial
        pmat = np.zeros((self.n_pad, self.t), np.int32)
        pmat[:self.n] = shamir._power_matrix(tuple(proto.lambdas), self.t)
        wall = np.zeros((self.n_pad,), np.int32)
        wall[:self.n] = shamir._recon_matrix(tuple(proto.lambdas))[0]
        self.pmat_all = torch.from_numpy(pmat).to(self.dev)
        self.pmat_loc = self.pmat_all[self.lo:self.lo + self.n_loc]
        self.wall_loc = torch.from_numpy(wall).to(self.dev)[
            self.lo:self.lo + self.n_loc]
        self.enc_mat = proto._enc[None].expand(self.n_loc, self.n,
                                               cfg.k + self.t)

    def share_rows(self, keyc, secret):
        """This rank's holder rows of shamir.share(keyc, secret, t, n): the
        coefficient draw is replicated (the same key on every rank), only
        the power-matrix rows are local, so each row has the global
        share's bits."""
        coeffs = field.random_field(keyc, (self.t,) + tuple(secret.shape),
                                    self.dev)
        mix = ops.modmatmul(self.pmat_loc, coeffs.reshape(self.t, -1))
        return field.add(mix.reshape((self.n_loc,) + tuple(secret.shape)),
                         secret[None])

    def encode_model(self, key, w_loc):
        """Phase 2 per iteration, holder-sharded: the (T,) + w_shape draw
        is replicated; each local holder LCC-encodes its model share for
        every owner, and the reconstruct from ALL holders is a mod-p
        reduce-scatter of the weighted partials."""
        n_loc, dw = self.n_loc, self.dw
        kv, ks_ = jrandom.split(key)
        v = field.random_field(kv, (self.t,) + self.w_shape, self.dev)
        v_sh = self.share_rows(ks_, v)                  # (n_loc, T) + w
        stacked = torch.cat([w_loc.reshape(n_loc, 1, dw).expand(
            n_loc, self.proto.cfg.k, dw), v_sh.reshape(n_loc, self.t, dw)],
            dim=1)
        enc = ops.modmatmul_batched(self.enc_mat, stacked)  # (n_loc, N, dw)
        if self.ring_encode:
            enc = _pad_clients(enc, self.n_pad, dim=1)

            def seg(j):
                # rank j's rows of the weighted partial, made just before
                # the hop that carries them
                sl = enc[:, j * n_loc:(j + 1) * n_loc]
                return ops.modmatmul(self.wall_loc[None, :],
                                     sl.reshape(n_loc, -1)).reshape(n_loc, dw)

            return meshutil.ring_reduce_scatter_mod(seg, self.rank)
        part = ops.modmatmul(self.wall_loc[None, :],
                             enc.reshape(n_loc, -1)).reshape(self.n, dw)
        return meshutil.psum_scatter_mod(_pad_clients(part, self.n_pad),
                                         self.rank)      # (n_loc, dw)

    def open_(self, c_loc):
        """OPEN: all-gather every rank's share rows, reconstruct."""
        c_full = meshutil.all_gather_clients(c_loc, self.rank)[:self.n]
        return shamir.reconstruct(c_full, self.t, self.proto.lambdas)

    def decode_update(self, key, w_loc, xty_loc, f_loc, sub_idx, dvec):
        """Phase 4: the owner->holder exchange as an all-to-all, a local
        decode per holder from the R owners `sub_idx` (decode row `dvec`),
        then TruncPr with its masked value opened by all-gather."""
        proto, n_loc, dw, t = self.proto, self.n_loc, self.dw, self.t
        kf, kt = jrandom.split(key)
        # the sharing-polynomial draw spans ALL owners (replicated dealer
        # randomness, the global (T, N) + w_shape draw's bits); each rank
        # keeps its own owners' columns and deals shares to every holder
        coeffs = field.random_field(kf, (t, self.n) + self.w_shape, self.dev)
        coeffs = _pad_clients(coeffs.reshape(t, self.n, dw), self.n_pad,
                              dim=1)
        cl = coeffs[:, self.lo:self.lo + n_loc]            # (T, n_loc, dw)
        f_flat = f_loc.reshape(n_loc, dw)
        if self.ring_exchange:
            def blk(j):
                # holder rows owned by rank j, built just before their hop
                mix = ops.modmatmul(self.pmat_all[j * n_loc:(j + 1) * n_loc],
                                    cl.reshape(t, -1))
                return field.add(mix.reshape(n_loc, n_loc, dw), f_flat[None])

            blocks = meshutil.ring_all_to_all(blk, self.rank)
            # (src, n_loc holders, n_loc owners, dw) -> owner-major
            per_holder = blocks.transpose(0, 1).reshape(n_loc, self.n_pad, dw)
        else:
            mix = ops.modmatmul(self.pmat_all, cl.reshape(t, -1))
            mine = field.add(mix.reshape(self.n_pad, n_loc, dw), f_flat[None])
            per_holder = meshutil.all_to_all_clients(mine, self.rank)
        # (n_loc holders, n_pad owners, dw): decode locally per holder
        evals = per_holder.index_select(1, sub_idx)         # (n_loc, R, dw)
        r = evals.shape[1]
        xtg = ops.modmatmul_batched(dvec[None, None].expand(n_loc, 1, r),
                                    evals)
        grad = field.sub(xtg.reshape((n_loc,) + self.w_shape), xty_loc)
        scaled = field.mul_scalar(grad, proto.q_eta)
        delta = truncation.trunc_pr_core(kt, scaled, proto.k1, proto.k2,
                                         share=self.share_rows,
                                         open_=self.open_)
        return field.sub(w_loc, delta)

    def open_w(self, w_loc):
        """The per-step model opening of a history run."""
        w = self.open_(w_loc)
        return quantize.dequantize(w, self.proto.cfg.lw)


def _rank_train(rank, handle, key, iters: int, history: bool, overlap: bool,
                idx, dvs, adv) -> dict:
    """Run `iters` sharded steps on the rows dealt under `handle`: step t
    decodes from owners idx[t] with row dvs[t], and the clients adv[t]
    (of the padded axis, or None) add ADV_OFFSET to their coded gradient.
    Returns this rank's final model share rows, the history (rank 0's; it
    is replicated) and the rank's report."""
    st = rank.state.pop(handle)
    proto, dev = st["proto"], rank.device
    step = _RankStep(rank, proto, overlap)
    lo, n_loc = step.lo, step.n_loc
    w_loc, coded_x, xty = st["w"], st["coded_x"], st["xty"]
    idx, dvs = idx.to(dev), dvs.to(dev)
    if adv is not None:
        adv = adv[:, lo:lo + n_loc].to(dev)
    ops.reset_launches()
    rank.sent_bytes.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = []
    for t in range(iters):
        k1_, k2_ = jrandom.split(jrandom.fold_in(key, t))
        coded_w = step.encode_model(k1_, w_loc)
        f_loc = proto.local_gradient(coded_x, coded_w)      # LOCAL
        if adv is not None:
            adv_b = adv[t].reshape((n_loc,) + (1,) * len(proto.w_shape))
            f_loc = torch.where(adv_b, field.add(f_loc, ADV_OFFSET), f_loc)
        w_loc = step.decode_update(k2_, w_loc, xty, f_loc, idx[t], dvs[t])
        if history:
            hist.append(step.open_w(w_loc))
    rank.sync()
    report = dict(
        rank=rank.rank, device=str(dev), backend=rank.backend,
        iters_s=time.perf_counter() - t0, launches=ops.launch_counts(),
        gemm_paths=ops.gemm_path_counts(), wide=ops.wide_counts(),
        threefry=ops.threefry_counts(),
        peak_bytes=torch.cuda.max_memory_allocated(dev)
        if dev.type == "cuda" else None,
        sent_bytes=dict(rank.sent_bytes))
    out_hist = None
    if history and rank.rank == 0:
        out_hist = torch.stack(hist).cpu() if hist else \
            torch.zeros((0,) + proto.w_shape, dtype=torch.float32)
    return dict(w=w_loc.cpu(), hist=out_hist, report=report)
