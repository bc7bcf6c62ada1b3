"""Benchmark protocols from the paper's Section V, on torch.

1. The float trainers -- conventional logistic regression (Fig. 4
   baseline), its degree-r polynomial-sigmoid twin, and the
   objective-generic pair.  Each has an "eager" form (float64, the JAX
   package's numpy loop) and a "scan" form (float32, the JAX package's
   compiled lax.scan); here both run as one torch loop on the run's
   device.  The products are plain torch.matmul in full float32 / float64
   (no TF32: it would move the float32 trainers far from the reference).
2. MpcBaseline -- the [BGW88]/[BH08] MPC training baselines with the
   paper's subgroup optimization (Appendix D): clients are split into G=3
   subgroups; subgroup i holds Shamir shares of one third of X and computes
   its sub-gradient *entirely in the share domain* -- every matmul and the
   polynomial sigmoid require secure multiplications with degree reduction,
   which is exactly the communication the paper's Table I shows dominating.
   Every draw follows the JAX package's key schedule, quirks included, so
   shares and opened weights are bit-equal to it.

The MPC baseline shares COPML's quantization/truncation machinery so the
accuracy comparison isolates the *protocol* difference, as in the paper.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import field, mpc, objectives, quantize, shamir, sigmoid_approx, \
    truncation
from . import random as jrandom
from .labels import Opened, Share
from .protocol import CopmlConfig, resolve_device


def sync_clock(device: torch.device) -> float:
    """Host seconds after the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def to_device(a, dtype, device) -> torch.Tensor:
    """A numpy array (copied, so read-only dataset arrays are fine) or a
    tensor (moved only if it is elsewhere) as `dtype` on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.array(a, dtype=_NP[dtype])).to(device)


_NP = {torch.float64: np.float64, torch.float32: np.float32}


def sigmoid(z):
    """The JAX package's numpy sigmoid formula (the float64 trainer)."""
    return 1.0 / (1.0 + torch.exp(-z))


def horner(coeffs, z):
    """sum_i coeffs[i] z^i from the top coefficient down (the JAX
    package's float Horner: a full tensor of the top coefficient, then
    acc * z + c)."""
    acc = torch.full_like(z, float(coeffs[-1]))
    for c in coeffs[-2::-1]:
        acc = acc * z + float(c)
    return acc


def gd(x, targets, w, eta: float, iters: int, ghat, callback=None):
    """w <- w - eta/m X^T (ghat(X w) - targets), `iters` times; callback(t,
    w) after every step (w is rebound each step, never updated in place)."""
    m = x.shape[0]
    for t in range(iters):
        w = w - (eta / m) * (x.T @ (ghat(x @ w) - targets))
        if callback is not None:
            callback(t, w)
    return w


def _float_run(x, y, eta, iters, ghat, dtype, callback, device, timings,
               w_shape=None):
    """Upload (x, targets y) as `dtype` (timed as setup), then gd from a
    zero model of `w_shape` (default (d,))."""
    dev = resolve_device(device)
    t0 = sync_clock(dev)
    x = to_device(x, dtype, dev)
    y = to_device(y, dtype, dev)
    w = torch.zeros(w_shape or (x.shape[1],), dtype=dtype, device=dev)
    t1 = sync_clock(dev)
    w = gd(x, y, w, eta, iters, ghat, callback)
    t2 = sync_clock(dev)
    if timings is not None:
        timings.update(setup_s=t1 - t0, iters_s=t2 - t1)
    return w


def history_recorder(history: bool):
    """(rows, callback) collecting every step's model on the device."""
    if not history:
        return None, None
    rows: list = []
    return rows, lambda t, w: rows.append(w)


def stacked(rows, w):
    """The recorded rows as one (iters,) + w.shape tensor (None stays None)."""
    if rows is None:
        return None
    return torch.stack(rows) if rows else w.new_zeros((0,) + tuple(w.shape))


def float_logreg(x, y, eta: float, iters: int, callback=None, *,
                 device=None, timings=None):
    """Conventional full-batch GD logistic regression (paper Fig. 4), in
    float64 on the device."""
    return _float_run(x, y, eta, iters, sigmoid, torch.float64, callback,
                      device, timings)


def float_poly_logreg(x, y, eta: float, iters: int, r: int = 1,
                      bound: float = 10.0, callback=None, *, device=None,
                      timings=None):
    """Float GD with the degree-r polynomial sigmoid -- isolates the
    approximation error from the quantization error (float64)."""
    coeffs = sigmoid_approx.fit_sigmoid_poly(r, bound)
    return _float_run(x, y, eta, iters, lambda z: horner(coeffs, z),
                      torch.float64, callback, device, timings)


def _float_scan(x, y, eta, iters, ghat, history, device, timings, **kw):
    rows, cb = history_recorder(history)
    w = _float_run(x, y, eta, iters, ghat, torch.float32, cb, device,
                   timings, **kw)
    return w, stacked(rows, w)


def float_logreg_scan(x, y, eta: float, iters: int, history: bool = True, *,
                      device=None, timings=None):
    """float_logreg in float32 (the JAX package's jit engine);
    (w, history-or-None)."""
    return _float_scan(x, y, eta, iters, torch.sigmoid, history, device,
                       timings)


def float_poly_logreg_scan(x, y, eta: float, iters: int, r: int = 1,
                           bound: float = 10.0, history: bool = True, *,
                           device=None, timings=None):
    """float_poly_logreg in float32; (w, history-or-None)."""
    coeffs = sigmoid_approx.fit_sigmoid_poly(r, bound)
    return _float_scan(x, y, eta, iters, lambda z: horner(coeffs, z),
                       history, device, timings)


# -------------------------------------------- objective-generic float GD
#
# The float / poly_float protocols for every objective other than binary
# logistic: the model may be a (d,) vector or a (d, C) matrix; the gradient
# is always X^T (g(XW) - Y) / m with g the exact activation or its degree-r
# polynomial fit, columnwise -- the float twin of the coded pipeline.


def _objective_ghat(obj, poly: bool, r: int, bound: float):
    if not poly:
        return obj.act_torch
    coeffs = obj.float_coeffs(r, bound)
    return lambda z: horner(coeffs, z)


def float_objective_train(obj, x, y, eta: float, iters: int, callback=None,
                          *, poly: bool = False, r: int = 1,
                          bound: float = 10.0, device=None, timings=None):
    """Plaintext GD for any SecureObjective (float64)."""
    return _float_run(x, obj.prepare_targets(y), eta, iters,
                      _objective_ghat(obj, poly, r, bound), torch.float64,
                      callback, device, timings,
                      w_shape=obj.w_shape(np.shape(x)[1]))


def float_objective_scan(obj, x, y, eta: float, iters: int,
                         history: bool = True, *, poly: bool = False,
                         r: int = 1, bound: float = 10.0, device=None,
                         timings=None):
    """float_objective_train in float32; (w, history-or-None)."""
    return _float_scan(x, obj.prepare_targets(y), eta, iters,
                       _objective_ghat(obj, poly, r, bound), history, device,
                       timings, w_shape=obj.w_shape(np.shape(x)[1]))


# ------------------------------------------------------------ MPC baseline


@dataclasses.dataclass
class MpcState:
    w_shares: Share            # (N_g, d, C') model shares (all groups share)
    x_shares: Share            # (G, N_g, m/G, d) per-subgroup data shares
    xty_shares: Share          # (G, N_g, d, C')
    step: int = 0


def mpc_state_from_numpy(w_shares, x_shares, xty_shares, step=0,
                         device="cpu") -> MpcState:
    """An MpcState from numpy arrays (e.g. the JAX package's MpcState
    fields passed through np.asarray)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.int32)).to(device)
    return MpcState(w_shares=t(w_shares), x_shares=t(x_shares),
                    xty_shares=t(xty_shares), step=int(np.asarray(step)))


class MpcBaseline:
    """Secret-shared GD per Appendix D (G subgroups), objective-generic.

    The model always carries a trailing output axis C' (= 1 for the vector
    objectives, C for multi-class one-vs-rest), so every secure matmul and
    the share-domain Horner chain are written once.  Only per*G = (m//G)*G
    rows are used; each subgroup has n_g = N//G clients."""

    def __init__(self, cfg: CopmlConfig, m: int, d: int, groups: int = 3,
                 scheme: str = "bh08", objective=None, device=None):
        self.cfg, self.m, self.d, self.g = cfg, m, d, groups
        self.device = resolve_device(device)
        self.obj = objectives.BINARY_LOGISTIC if objective is None \
            else objective
        self.obj.validate_cfg(cfg)
        self.c_out = self.obj.n_outputs          # trailing model axis C'
        self.n_g = cfg.n_clients // groups      # clients per subgroup
        assert self.n_g >= 2 * cfg.t + 1, "subgroup too small for 2T+1"
        self.lambdas = tuple(range(1, self.n_g + 1))
        self.q_eta, self.e, self.k1, self.k2 = self.obj.update_constants(
            cfg, m)
        self.poly_coeffs = self.obj.field_coeffs(cfg)
        self._mul = mpc.mul_bh08 if scheme == "bh08" else mpc.mul_bgw
        self.scheme = scheme

    def setup(self, key, x, y) -> MpcState:
        """Quantize and share each subgroup's rows, and form X^T y by one
        secure matmul per subgroup.  keys[2g] both shares X_g and drives
        X^T y's multiplication: the JAX package reuses that key, and so
        does this port, to stay bit-equal."""
        cfg, dev = self.cfg, self.device
        per = self.m // self.g
        keys = jrandom.split(key, 2 * self.g + 1)
        xq = quantize.quantize(np.array(x[: per * self.g], np.float32),
                               cfg.lx, dev)
        targets = self.obj.prepare_targets(np.asarray(y)[: per * self.g])
        yq = quantize.quantize(np.array(targets, np.float32), cfg.lg, dev)
        xg = xq.view(self.g, per, self.d)
        yg = yq.view((self.g, per) + self.obj.out_shape)
        x_shares = torch.empty((self.g, self.n_g, per, self.d),
                               dtype=field.FIELD_DTYPE, device=dev)
        xty = torch.empty((self.g, self.n_g, self.d, self.c_out),
                          dtype=field.FIELD_DTYPE, device=dev)
        for gi in range(self.g):
            x_shares[gi] = shamir.share(keys[2 * gi], xg[gi], cfg.t,
                                        self.n_g, self.lambdas)
            ys = shamir.share(keys[2 * gi + 1], yg[gi], cfg.t, self.n_g,
                              self.lambdas)
            ys_mat = ys if self.obj.out_shape else ys[..., None]
            xty[gi] = self._mul(keys[2 * gi], x_shares[gi].transpose(1, 2),
                                ys_mat, cfg.t, matmul=True,
                                points=self.lambdas)      # (N_g, d, C')
        del xq
        w = shamir.share(keys[-1],
                         torch.zeros((self.d, self.c_out),
                                     dtype=field.FIELD_DTYPE, device=dev),
                         cfg.t, self.n_g, self.lambdas)
        return MpcState(w_shares=w.contiguous(), x_shares=x_shares,
                        xty_shares=xty)

    def iteration(self, key, state: MpcState) -> MpcState:
        """One GD step fully in the share domain (per subgroup), then
        aggregate sub-gradients (local add) and secure-truncate-update."""
        cfg = self.cfg
        keys = jrandom.split(key, self.g + 1)
        grad_shares = None
        for gi in range(self.g):
            xs = state.x_shares[gi]                       # (N_g, mG, d)
            # Z = X W : secure matmul (degree reduction!), all C' columns
            z = self._mul(keys[gi], xs, state.w_shares, cfg.t, matmul=True,
                          points=self.lambdas)            # (N_g, mG, C')
            # ghat(Z) in the share domain: Horner => r secure mults
            acc = torch.full_like(z, int(self.poly_coeffs[-1]))
            for ci in range(len(self.poly_coeffs) - 2, -1, -1):
                acc = self._mul(jrandom.fold_in(keys[gi], ci), acc, z,
                                cfg.t, points=self.lambdas)
                acc = mpc.add_public(acc, int(self.poly_coeffs[ci]))
            # X^T ghat : secure matmul
            xtg = self._mul(jrandom.fold_in(keys[gi], 99),
                            xs.transpose(1, 2), acc, cfg.t, matmul=True,
                            points=self.lambdas)          # (N_g, d, C')
            g_sh = field.sub(xtg, state.xty_shares[gi])
            grad_shares = g_sh if grad_shares is None else field.add(
                grad_shares, g_sh)
        scaled = field.mul_scalar(grad_shares, self.q_eta)
        delta = truncation.trunc_pr(keys[-1], scaled, self.k1, self.k2,
                                    cfg.t, self.lambdas)
        return dataclasses.replace(
            state, w_shares=field.sub(state.w_shares, delta),
            step=state.step + 1)

    def train(self, key, x, y, iters: int, callback=None,
              timings: dict | None = None):
        """Setup + `iters` iterations with the JAX package's key schedule
        (split(key) -> (ks, ki); step t uses fold_in(ki, t)); callback(t,
        opened model) after every step.  `timings` receives setup_s and
        iters_s (each ending in a device synchronise).  Returns (state,
        opened model)."""
        t0 = sync_clock(self.device)
        ks, ki = jrandom.split(jrandom.as_key(key))
        state = self.setup(ks, x, y)
        t1 = sync_clock(self.device)
        for t in range(int(iters)):
            state = self.iteration(jrandom.fold_in(ki, t), state)
            if callback is not None:
                callback(t, self.open_model(state))
        t2 = sync_clock(self.device)
        if timings is not None:
            timings.update(setup_s=t1 - t0, iters_s=t2 - t1)
        return state, self.open_model(state)

    def train_scan(self, key, x, y, iters: int, history: bool = False,
                   timings: dict | None = None):
        """The JAX package's jit engine: the same loop as train() (both are
        bit-exact there too).  Returns (state, w[, history])."""
        rows, cb = history_recorder(history)
        state, w = self.train(key, x, y, iters, callback=cb, timings=timings)
        return (state, w, stacked(rows, w)) if history else (state, w)

    def open_model(self, state: MpcState) -> Opened:
        w = mpc.open_shares(state.w_shares, self.cfg.t, self.lambdas)
        w = quantize.dequantize(w, self.cfg.lw)       # (d, C')
        return w[..., 0] if not self.obj.out_shape else w
