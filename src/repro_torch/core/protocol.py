"""COPML: the training protocol (paper Algorithm 1) over N virtual clients.

One process simulates all N clients; every share tensor carries the client
axis first.  Per iteration the model is Lagrange-encoded from its shares,
then Phases 3+4 (coded gradient, decode, secure truncated update) run on
one of two schedules, chosen by REPRO_FUSED_STEP when a Copml is built:

  "1" (default), "kernel"  fused: one `ops.fused_step` call;
  "0"                      siloed: `local_gradient` (the coded-gradient
                           kernels) then `decode_and_update` (share, decode,
                           TruncPr as separate field ops).

Both give the same bits.  A fault plan's per-step decode subsets and
adversaries (api/faults.FaultPlan) run on either.

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

import dataclasses
import math
import os
import time
from typing import Sequence

import numpy as np
import torch

from ..kernels import ops
from . import field, lagrange, mpc, objectives, quantize, shamir, truncation
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

FUSED_MODES = ("0", "1", "kernel")


def fused_mode_from_env() -> str:
    """REPRO_FUSED_STEP: "0" siloed schedule; "1" (default) or "kernel" the
    fused step (on CUDA both are the fused_step kernel)."""
    mode = os.environ.get("REPRO_FUSED_STEP", "1")
    if mode not in FUSED_MODES:
        raise ValueError(f"REPRO_FUSED_STEP={mode!r}: expected one of "
                         f"{FUSED_MODES}")
    return mode


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
        self.fused_mode = fused_mode_from_env()
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
        xq = quantize.quantize(np.concatenate(
            [np.asarray(x) for x in client_xs], axis=0), cfg.lx, dev)
        targets = self.obj.prepare_targets(
            np.concatenate([np.asarray(y) for y in client_ys], axis=0))
        yq = quantize.quantize(np.asarray(targets, np.float32), cfg.lg, dev)

        # Phase 2a (EXCHANGE): Shamir-share every client's data
        x_shares = shamir.share(keys[0], xq, cfg.t, n, self.lambdas)
        y_shares = shamir.share(keys[1], yq, cfg.t, n, self.lambdas)
        del xq

        # Phase 2b/c: partition rows into K blocks, add T masks, LCC-encode,
        # reconstruct each client's coded slice.  Reconstruction reads only
        # the first T+1 holders, so only their encodings are formed, one
        # holder at a time (the values are those of the all-holder
        # encoding, at 8/50 of its memory for the paper's case 2).
        per = -(-x_shares.shape[1] // cfg.k)
        holders = cfg.t + 1
        z = field.random_field(keys[2], (cfg.t, per, self.d), dev)
        z_shares = shamir.share(keys[3], z, cfg.t, n, self.lambdas,
                                holders=holders)          # (T+1, T, mk, d)
        del z
        enc = torch.empty((holders, n, per, self.d), dtype=torch.int32,
                          device=dev)
        for h in range(holders):
            blocks, _ = lagrange.partition_rows(x_shares[h], cfg.k)
            enc[h] = lagrange.lcc_encode(blocks, z_shares[h], self.alphas,
                                         self.betas)
        del blocks, z_shares
        coded_x = shamir.reconstruct(enc, cfg.t, self.lambdas)  # (N, mk, d)
        del enc

        # Phase 2d: X^T y via one secure matmul; a matrix objective
        # contracts against all C target columns at once
        y_mat = y_shares if self.out_shape else y_shares[..., None]
        xty_shares = self._mul(
            keys[4], x_shares.transpose(1, 2), y_mat,
            cfg.t, matmul=True, points=self.lambdas)     # (N, d, C')
        if not self.out_shape:
            xty_shares = xty_shares[..., 0]
        del x_shares

        # model init within MPC: w^(0) = 0 shared
        w_shares = shamir.share(
            keys[5], torch.zeros(self.w_shape, dtype=field.FIELD_DTYPE,
                                 device=dev), cfg.t, n, self.lambdas)
        return CopmlState(w_shares=w_shares, coded_x=coded_x,
                          xty_shares=xty_shares.contiguous(), step=0)

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

    def decode_and_update(self, key, state: CopmlState, f_values: Coded,
                          subset: Sequence[int] | None = None, *,
                          subset_idx=None, dvec=None) -> CopmlState:
        """Phase 4: share f, decode on shares, secure model update.

        The decode subset is a static `subset` tuple, or `subset_idx` (R,)
        int64 indices on the device with the matching `dvec` (R,) decode
        row (a fault plan's per-step form)."""
        cfg, n = self.cfg, self.cfg.n_clients
        kf, kt = jrandom.split(key)
        if subset_idx is None:
            subset_idx, dvec, _ = self._decode_row(subset)
        else:
            assert dvec is not None, "subset_idx needs its decode row dvec"

        # EXCHANGE: each client shares its local result; the owner<->holder
        # swap is a view of the (holder, owner) share tensor
        f_shares = shamir.share_batch(kf, f_values, cfg.t, n,
                                      self.lambdas)  # (N_owner, N_holder, ..)
        per_holder = f_shares.transpose(0, 1).reshape(n, n, self.dw)
        # each holder decodes from its R rows: the sum over the K decode
        # rows folded into one (R,) row, one batched GEMM for all holders
        evals = per_holder.index_select(1, subset_idx)      # (N_h, R, dw)
        r = evals.shape[1]
        xtg = ops.modmatmul_batched(dvec[None, None].expand(n, 1, r), evals)
        xtg_shares = xtg.reshape((n,) + self.w_shape)

        # LOCAL: gradient shares; then secure update with TruncPr
        grad_shares = field.sub(xtg_shares, state.xty_shares)
        scaled = field.mul_scalar(grad_shares, self.q_eta)
        delta_shares = truncation.trunc_pr(
            kt, scaled, self.k1, self.k2, cfg.t, self.lambdas)  # scale lw
        new_w = field.sub(state.w_shares, delta_shares)
        return dataclasses.replace(state, w_shares=new_w, step=state.step + 1)

    def _decode_vec(self, subset) -> Public:
        """Host-side (R,) decode row: sum_k D[k, :] over the K decode-matrix
        rows, mod p."""
        sub_alphas = [self.alphas[i] for i in subset]
        dmat = lagrange.decode_matrix(
            sub_alphas, self.betas[: self.cfg.k]).astype(np.int64)
        return (dmat.sum(axis=0) % field.P).astype(np.int32)

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
        k1_, k2_ = jrandom.split(key)
        coded_w = self.encode_model(k1_, state.w_shares)
        if self.fused_mode != "0":
            return self._fused_iteration(k2_, state, coded_w, subset,
                                         subset_idx=subset_idx, dvec=dvec,
                                         adv=adv)
        f_values = self.local_gradient(state.coded_x, coded_w)
        if adv is not None:
            # adversarial clients contribute a CORRUPTED coded gradient; the
            # fault plan keeps them out of subset_idx
            adv_b = adv.reshape((adv.shape[0],) + (1,) * len(self.w_shape))
            f_values = torch.where(adv_b, field.add(f_values, ADV_OFFSET),
                                   f_values)
        return self.decode_and_update(k2_, state, f_values, subset,
                                      subset_idx=subset_idx, dvec=dvec)

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
        idx, dvs = self.plan_constants(step_subsets)
        adv = None
        if adversaries is not None and np.asarray(adversaries).any():
            adv = np.array(adversaries, bool)        # a writable copy
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
              step_subsets=None, adversaries=None) -> tuple:
        """Setup + `iters` GD iterations with the JAX package's key schedule
        (split(key) -> (ks, ki); step t uses fold_in(ki, t)).

        step_subsets / adversaries carry a fault plan: per-step decode
        subsets and an (iters, N) corruption mask, compiled once into
        device tensors before the setup.  `timings`, when given, receives
        setup_s and iters_s: wall seconds of the setup and of the iteration
        loop, each ending in a device synchronise.  Returns (state, w,
        history (iters,) + w_shape or None)."""
        subset = None if subset is None else tuple(subset)
        iters = int(iters)
        faults = self._fault_xs(step_subsets, adversaries, iters, subset)
        t0 = self._sync()
        ks, ki = jrandom.split(jrandom.as_key(key))
        state = self.setup(ks, client_xs, client_ys)
        t1 = self._sync()
        hist = []
        for t in range(iters):
            kw = {}
            if faults is not None:
                idx, dvs, adv = faults
                kw = dict(subset_idx=idx[t], dvec=dvs[t],
                          adv=None if adv is None else adv[t])
            state = self.iteration(jrandom.fold_in(ki, t), state, subset,
                                   **kw)
            if history:
                hist.append(self.open_model(state))
        t2 = self._sync()
        if timings is not None:
            timings.update(setup_s=t1 - t0, iters_s=t2 - t1)
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
