"""Plain reference for one-vs-rest COPML: C logistic columns of one (d, C)
model trained together on the same rows, in plain PyTorch.

Each column is copml_logreg's fixed-point gradient descent on its own
targets (`copml_logreg.py` gives the update and its check); what changes
is only the model's trailing class axis.  Step t on the opened model W_t
(d, C) at scale 2^lw is

  Z      = X_q W_t                          (m, C), scale lz
  G1     = ghat_q(Z)                        every element, mod p
  G      = X_q^T G1 - X_q^T Y_q             (d, C), Y_q the targets at lg
  W_t+1  = W_t - (floor(q_eta G / 2^k1) + s),  s in {0, 1} an element

with Y the one-hot embedding of the integer labels (C >= 2), or the
binary labels themselves as one column where the configuration names no
`n_classes` (C = 1: the reference then judges copml_logreg's jobs alike).
Every element's update must be floor + {0, 1} (`step_gap`, exact), and
`drift_z` holds TruncPr's bits of all d * C weights to their law.

Integer products are formed in float64 in blocks of the contraction
whose partial sums stay below 2^53, so they are exact at any m and d.
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import copml_logreg
from reference.copml_logreg import EXACT, Fixed

#: each compared number's limit, copml_logreg's (PERF.md gives the readings)
LIMITS = {k: copml_logreg.LIMITS[k] for k in ("step_gap", "drift_z")}

judge_jobs = copml_logreg.judge_jobs


def field_matmul(a: torch.Tensor, b: torch.Tensor, amax: float,
                 bmax: float, p: int) -> torch.Tensor:
    """(a @ b) mod p as int64 in [0, p), for float64 integer matrices whose
    entries are at most amax and bmax in magnitude: the contraction is cut
    into blocks whose partial sums stay below 2^53."""
    k = a.shape[1]
    step = max(1, int(EXACT // max(1.0, amax * bmax)) - 1)
    out = None
    for lo in range(0, k, step):
        part = torch.remainder((a[:, lo:lo + step] @ b[lo:lo + step]
                                ).to(torch.int64), p)
        out = part if out is None else torch.remainder(out + part, p)
    return out


class Reference:
    """The plain computation over one run's rows and labels, on `device`."""

    def __init__(self, cfg: dict, x: np.ndarray, y: np.ndarray, device,
                 lx: int | None = None):
        self.f = f = Fixed(cfg, lx)
        self.c = int(cfg.get("n_classes", 1))
        self.device = device
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
        self.xq = f.data(xt)                                   # (m, d)
        self.xmax = float(self.xq.abs().max())
        labels = torch.from_numpy(np.array(y)).to(device)
        if self.c == 1:
            targets = labels.to(torch.float32)[:, None]
        else:
            idx = labels.to(torch.int64)
            assert int(idx.min()) >= 0 and int(idx.max()) < self.c
            targets = torch.nn.functional.one_hot(idx, self.c).to(
                torch.float32)
        yq = f.quantize(targets, f.lg)                         # (m, C)
        self.xty = field_matmul(self.xq.T, yq, self.xmax,
                                float(yq.abs().max()), f.p)    # (d, C)

    def gradient_terms(self, w: torch.Tensor) -> tuple:
        """(floor(a / 2^k1), frac) of the update at the signed int64
        models w (d, n): a = q_eta (X_q^T ghat(X_q w) - X_q^T Y_q)."""
        f, half_p = self.f, float(self.f.p // 2)
        z = field_matmul(self.xq, w.to(torch.float64), self.xmax, half_p,
                         f.p)                                  # (m, n)
        g1 = f.signed(f.ghat(z)).to(torch.float64)
        xtg = field_matmul(self.xq.T, g1, self.xmax, half_p, f.p)
        n = w.shape[1]
        xty = self.xty.repeat(1, n // self.c)
        a = f.signed(torch.remainder(xtg - xty, f.p) * f.q_eta)
        fl = torch.div(a, 1 << f.k1, rounding_mode="floor")
        frac = (a - fl * (1 << f.k1)).to(torch.float64) / float(1 << f.k1)
        return fl, frac

    def step_readings(self, hist: np.ndarray, w: np.ndarray) -> dict:
        """Hold each of a job's steps, every element of the model, to the
        update its opened model implies.  hist (steps, d, C) and w (d, C)
        are the job's opened models ((steps, d) and (d,) at C = 1)."""
        f, dev, c = self.f, self.device, self.c
        lsb = float(1 << f.lw)
        hist = np.asarray(hist, np.float64)
        steps, d = hist.shape[:2]
        wq = torch.from_numpy(np.round(hist.reshape(steps, d, c) * lsb)
                              ).to(dev).to(torch.int64)        # (S, d, C)
        prev = torch.cat([torch.zeros_like(wq[:1]), wq[:-1]])
        cols = f.signed(prev).permute(1, 0, 2).reshape(d, steps * c)
        fl, frac = self.gradient_terms(cols)                   # (d, S * C)
        delta = f.signed(prev - wq).permute(1, 0, 2).reshape(d, steps * c)
        s = delta - fl
        gap = torch.maximum(-s, s - 1).clamp_min(0).max()
        final = torch.from_numpy(np.round(
            np.asarray(w, np.float64).reshape(d, c) * lsb)).to(dev).to(
            torch.int64)
        gap = max(int(gap), int((final - wq[-1]).abs().max()))
        ok = (s == 0) | (s == 1)
        dev_ = torch.where(ok, s.to(torch.float64) - frac, 0.0)
        var_ = torch.where(ok, frac * (1 - frac), 0.0)
        # a weight's drift sums over its steps: (d, S, C) -> (d, C)
        d_j = dev_.view(d, steps, c).sum(1)
        v_j = var_.view(d, steps, c).sum(1)
        w_j = (var_ * (1 - 6 * var_)).view(d, steps, c).sum(1)
        return dict(step_gap=gap, drift=float((d_j ** 2 - v_j).sum()),
                    drift_var=float((w_j + 2 * v_j ** 2).sum()))


# ----------------------------------------------------------------- control


def control_job(cfg: dict, x: np.ndarray, y: np.ndarray, gen, device,
                lx: int) -> dict:
    """The reference put in the program's place at a lower precision (the
    rows at `lx` fractional bits): a job's opened (steps, d, C) trajectory
    with TruncPr's rounding drawn from `gen`."""
    ref = Reference(cfg, x, y, device, lx=lx)
    f = ref.f
    w = torch.zeros((ref.xq.shape[1], ref.c), dtype=torch.int64,
                    device=device)
    hist = []
    for _ in range(int(cfg["iters"])):
        fl, frac = ref.gradient_terms(w)
        s = (torch.rand(frac.shape, generator=gen, device=device,
                        dtype=torch.float64) < frac).to(torch.int64)
        w = f.signed(w - (fl + s))
        hist.append(w.to(torch.float32) / float(1 << f.lw))
    hist = torch.stack(hist).cpu().numpy()
    return dict(w=hist[-1].copy(), hist=hist, timings={})
