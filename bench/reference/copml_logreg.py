"""Plain reference for COPML logistic regression (So, Guler, Avestimehr,
NeurIPS 2020, Algorithm 1 and Appendix A), in plain PyTorch.

COPML's secret sharing and Lagrange coding are exact over F_p, so every
value the protocol opens is a plain fixed-point computation on the
quantized data; only TruncPr's rounding is random.  Step t of gradient
descent on the opened model w_t (scale 2^lw) is

  z      = X_q w_t                          (scale lz = lx + lw)
  g1     = ghat_q(z) = sum_i c_i z^i        (scale lg = lz + cb, mod p)
  g      = X_q^T g1 - X_q^T y_q             (scale s_grad = lx + lg)
  a      = q_eta * g                        (signed representative)
  w_t+1  = w_t - (floor(a / 2^k1) + s),     s in {0, 1},
           P(s = 1) = (a mod 2^k1) / 2^k1   (TruncPr, Catrina-Saxena)

with every product taken mod p.  The reference works out the quantized
data, the sigmoid fit and the update constants again from the
configuration, follows a job from its opened models step by step, and
holds each step's update to {floor, floor + 1}: an exact check of setup
(through the coded rows every gradient reads), each step's coded gradient,
decode, TruncPr and the open.  At these scales a step moves a weight by a
small fraction of its last bit, so the update is mostly the rounding bit
itself, and the training cells hold the bits to their law as well:

  drift_z  each weight's drift D_j = sum over steps of (s - frac), with
           variance V_j = sum of frac (1 - frac): sum_j (D_j^2 - V_j) over
           its standard deviation sqrt(sum_j (W_j + 2 V_j^2)), W_j the
           summed fourth cumulants -- a standard normal for sound
           roundings, and large where the steps drift from the reference's
           (a step that leaves the model unchanged, a gradient of half the
           rows) though each step stays within {floor, floor + 1}.

Served queries are scored as X_q w_q mod p against the served model (the
model the set-up's job trained, judged by the same step check first).

Integer products are formed in float64, which is exact while every partial
sum stays below 2^53; the bounds are asserted.  Nothing here imports the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: each compared number's limit (PERF.md gives the readings behind each)
LIMITS = {
    "step_gap": 0,            # LSBs outside {floor, floor + 1}, worst step
    "drift_z": 8.0,           # weights' drift from the reference, in sd
    "logit_gap": 0,           # LSBs between a served logit and the reference
    "decision_mismatch": 0,   # served decisions unlike the reference's
}
EXACT = 2.0 ** 53


class Fixed:
    """The configuration's field, scales, sigmoid fit and update constants."""

    def __init__(self, cfg: dict, lx: int | None = None):
        self.p = int(cfg["field_p"])
        self.p_bits = self.p.bit_length()
        self.lx = int(cfg["lx"]) if lx is None else lx
        self.lx_stated = int(cfg["lx"])
        self.lw, self.cb, self.r = int(cfg["lw"]), int(cfg["cb"]), int(cfg["r"])
        self.lz = self.lx_stated + self.lw
        self.lg = self.lz + self.cb
        s_grad = self.lx_stated + self.lg
        m, eta = int(cfg["m"]), float(cfg["eta"])
        self.e = int(round(math.log2(m / eta))) + 1
        self.q_eta = max(1, int(round(eta / m * (1 << self.e))))
        self.k1 = s_grad + self.e - self.lw
        self.k2 = max(int(cfg["k2"]), min(self.p_bits - 1, self.k1 + 1))
        assert 0 < self.k1 < self.k2 <= self.p_bits - 1
        coeffs = sigmoid_fit(self.r, float(cfg["sigmoid_bound"]),
                             int(cfg["sigmoid_grid"]))
        self.coeffs = [int(round(c * (1 << (self.lg - i * self.lz)))) % self.p
                       for i, c in enumerate(coeffs)]

    def quantize(self, x: torch.Tensor, scale: int) -> torch.Tensor:
        """Round(2^scale x) half to even in float32, as signed float64."""
        q = torch.round(x.to(torch.float32) * float(1 << scale))
        return q.to(torch.float64)

    def data(self, x: torch.Tensor) -> torch.Tensor:
        """X_q at the stated scale lx; at a lower precision (self.lx <
        lx_stated) the rows are rounded to self.lx fractional bits first
        and expressed at the stated scale."""
        return self.quantize(x, self.lx) * float(1 << (self.lx_stated
                                                      - self.lx))

    def signed(self, u: torch.Tensor) -> torch.Tensor:
        u = torch.remainder(u, self.p)
        return torch.where(u > self.p // 2, u - self.p, u)

    def ghat(self, z: torch.Tensor) -> torch.Tensor:
        """Horner's rule over F_p on int64 z."""
        z = torch.remainder(z, self.p)
        out = torch.zeros_like(z)
        for c in reversed(self.coeffs):
            out = torch.remainder(out * z + c, self.p)
        return out


def sigmoid_fit(r: int, bound: float, grid: int) -> list:
    """Eq. 5: least-squares degree-r fit of the sigmoid on `grid` uniform
    points over [-bound, bound]."""
    z = np.linspace(-bound, bound, grid)
    v = np.vander(z, r + 1, increasing=True)
    c, *_ = np.linalg.lstsq(v, 1.0 / (1.0 + np.exp(-z)), rcond=None)
    return [float(a) for a in c]


class Reference:
    """The plain computation over one run's data, on `device`."""

    def __init__(self, cfg: dict, x: np.ndarray, y: np.ndarray, device,
                 lx: int | None = None):
        self.f = Fixed(cfg, lx)
        self.device = device
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        self.xq = self.f.data(xt)                              # (m, d)
        yq = self.f.quantize(torch.from_numpy(np.asarray(y)).to(device),
                             self.f.lg)
        self.xmax = float(self.xq.abs().max())
        m, d = self.xq.shape
        half_p = float(self.f.p // 2)
        assert self.xmax * half_p * max(m, d) < EXACT, "float64 not exact"
        self.xty = torch.remainder((self.xq.T @ yq).to(torch.int64),
                                   self.f.p)                   # (d,)

    # --------------------------------------------------------------- train

    def step_readings(self, hist: np.ndarray, w: np.ndarray) -> dict:
        """Hold each of a job's steps to the update its opened model
        implies.  hist (steps, d) and w (d,) are the job's opened models."""
        f, dev = self.f, self.device
        lsb = float(1 << f.lw)
        wq = torch.from_numpy(np.round(np.asarray(hist, np.float64) * lsb)
                              ).to(dev).to(torch.int64)        # (steps, d)
        prev = torch.cat([torch.zeros_like(wq[:1]), wq[:-1]])
        z = (self.xq @ f.signed(prev).T.to(torch.float64)).to(torch.int64)
        g1 = f.signed(f.ghat(z)).to(torch.float64)             # (m, steps)
        xtg = torch.remainder((self.xq.T @ g1).to(torch.int64), f.p)
        g = torch.remainder(xtg - self.xty[:, None], f.p)      # (d, steps)
        a = f.signed(g * f.q_eta)
        fl = torch.div(a, 1 << f.k1, rounding_mode="floor")
        frac = (a - fl * (1 << f.k1)).to(torch.float64) / float(1 << f.k1)
        delta = f.signed((prev - wq).T)                        # (d, steps)
        s = delta - fl
        gap = torch.maximum(-s, s - 1).clamp_min(0).max()
        final = torch.from_numpy(np.round(np.asarray(w, np.float64) * lsb)
                                 ).to(dev).to(torch.int64)
        gap = max(int(gap), int((final - wq[-1]).abs().max()))
        ok = (s == 0) | (s == 1)
        dev_ = torch.where(ok, s.to(torch.float64) - frac, 0.0)
        var_ = torch.where(ok, frac * (1 - frac), 0.0)
        d_j, v_j = dev_.sum(1), var_.sum(1)
        w_j = (var_ * (1 - 6 * var_)).sum(1)
        return dict(step_gap=gap, drift=float((d_j ** 2 - v_j).sum()),
                    drift_var=float((w_j + 2 * v_j ** 2).sum()))

    # --------------------------------------------------------------- serve

    def logits(self, w: np.ndarray, queries: np.ndarray) -> tuple:
        """(float32 logits as the server dequantizes them, decisions) of
        `queries` against the model `w`, in blocks of rows."""
        f, dev = self.f, self.device
        wq = torch.from_numpy(np.round(np.asarray(w, np.float64)
                                       * (1 << f.lw))).to(dev)
        assert float(wq.abs().max()) <= f.p // 2
        out = []
        for lo in range(0, len(queries), 4096):
            xq = f.data(torch.from_numpy(queries[lo:lo + 4096]).to(dev))
            assert float(xq.abs().max()) * (f.p // 2) * xq.shape[1] < EXACT
            out.append(f.signed((xq @ wq).to(torch.int64)).cpu())
        z = torch.cat(out).numpy()
        logits = z.astype(np.float32) / np.float32(1 << f.lz)
        return logits, (z > 0).astype(np.int32)


# ------------------------------------------------------------- judgements


def judge_jobs(ref: Reference, jobs: list) -> dict:
    """step_gap (worst over the jobs) and drift_z over all their
    roundings."""
    readings = [ref.step_readings(j["hist"], j["w"]) for j in jobs]
    drift = sum(r["drift"] for r in readings)
    dvar = sum(r["drift_var"] for r in readings)
    return dict(step_gap=max(r["step_gap"] for r in readings),
                drift_z=drift / math.sqrt(dvar) if dvar else 0.0)


def judge_queries(ref: Reference, w, pool: np.ndarray, index: np.ndarray,
                  logits: np.ndarray, decisions: np.ndarray,
                  answered: np.ndarray) -> dict:
    """Every answered query of the window (one never answered counts as
    failed): index[q] is its row of `pool`; logits / decisions / answered
    are what the server gave it."""
    ref_logits, ref_dec = ref.logits(w, pool)
    got = answered.astype(bool)
    want_l, want_d = ref_logits[index][got], ref_dec[index][got]
    scale = np.float32(1 << ref.f.lz)
    gap = np.abs(logits[got].astype(np.float64) - want_l) * float(scale)
    return dict(logit_gap=float(gap.max()) if gap.size else 0.0,
                decision_mismatch=int((decisions[got] != want_d).sum()))


# ----------------------------------------------------------------- control


def control_job(cfg: dict, x: np.ndarray, y: np.ndarray, gen, device,
                lx: int) -> dict:
    """The reference put in the program's place at a lower precision (the
    data at `lx` fractional bits): a job's opened trajectory with TruncPr's
    rounding drawn from `gen`."""
    ref = Reference(cfg, x, y, device, lx=lx)
    f = ref.f
    w = torch.zeros(ref.xq.shape[1], dtype=torch.int64, device=device)
    hist = []
    for _ in range(int(cfg["iters"])):
        z = (ref.xq @ w.to(torch.float64)).to(torch.int64)
        g1 = f.signed(f.ghat(z)).to(torch.float64)
        xtg = torch.remainder((ref.xq.T @ g1).to(torch.int64), f.p)
        a = f.signed(torch.remainder(xtg - ref.xty, f.p) * f.q_eta)
        fl = torch.div(a, 1 << f.k1, rounding_mode="floor")
        frac = (a - fl * (1 << f.k1)).to(torch.float64) / float(1 << f.k1)
        s = (torch.rand(frac.shape, generator=gen, device=device,
                        dtype=torch.float64) < frac).to(torch.int64)
        w = f.signed(w - (fl + s))
        hist.append(w.to(torch.float32) / float(1 << f.lw))
    hist = torch.stack(hist).cpu().numpy()
    return dict(w=hist[-1].copy(), hist=hist, timings={})
