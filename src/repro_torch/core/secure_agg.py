"""COPML-coded secure gradient aggregation, and the secure_agg protocol.

What transfers from the paper's technique to any model is the aggregation
step: per-client gradients g_1..g_N are only ever *summed*, a degree-1
polynomial.  Each client clips, quantizes and Shamir-shares its gradient;
each holder sums the shares it receives (a local field add); any T+1
holders' sums reconstruct the total, and TruncPr secure truncation by
2^k1, k1 = round(log2 N), brings it back as the mean (rescaled by
2^k1 / N) without opening the sum first.

The secure_agg protocol trains with gradient privacy ONLY: each client
computes its local float gradient in the clear (float32 einsums on the
run's device) and the exchange is the aggregation round above.  The model
itself is public every step.

Every draw follows the JAX package's key schedule (per-client keys from
split(key, N+1), shares at the default points, TruncPr on the last key),
so an aggregation round gives the JAX package's field values bit for bit
on the same float gradients.  The N clients' share polynomials are drawn
in one pass (random.randint_keys), the same bits as one draw per key.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from . import field, quantize, shamir, truncation
from . import random as jrandom
from . import baselines
from .baselines import sync_clock, to_device
from .labels import Opened, Share
from .protocol import resolve_device


@dataclasses.dataclass(frozen=True)
class SecureAggConfig:
    n_clients: int            # hosts on the data axis
    t: int = 1                # privacy threshold
    k: int = 1                # gradient-chunk parallelization
    lq: int = 16              # gradient fixed-point fractional bits
    clip: float = 8.0         # pre-quantization gradient clip (range bound)
    k2: int = 24

    def validate(self):
        assert self.n_clients >= self.t + 1
        assert self.clip * (1 << self.lq) * self.n_clients < field.P // 2, (
            "sum range exceeds field; lower lq or clip")


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple
    dtype: torch.dtype


def flatten_grads(grads) -> tuple:
    """A pytree of tensors (dicts in sorted key order, lists, tuples) ->
    (flat float32 vector, meta for unflatten_grads)."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(torch.as_tensor(node))
        return _Leaf(tuple(leaves[-1].shape), leaves[-1].dtype)

    meta = walk(grads)
    return torch.cat([leaf.reshape(-1).to(torch.float32)
                      for leaf in leaves]), meta


def unflatten_grads(flat, meta):
    off = 0

    def walk(node):
        nonlocal off
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        n = math.prod(node.shape)
        out = flat[off:off + n].reshape(node.shape).to(node.dtype)
        off += n
        return out

    return walk(meta)


def _clip_quantize(g, cfg: SecureAggConfig):
    return quantize.quantize(torch.clamp(g, -cfg.clip, cfg.clip), cfg.lq)


def encode_local(key, grad_flat, cfg: SecureAggConfig) -> Share:
    """Client-side: clip, quantize, Shamir-share own gradient (L,) at the
    default points.  Returns (N, L) shares -- row i goes to holder i."""
    return encode_all(torch.stack([jrandom.as_key(key)]), grad_flat[None],
                      cfg)[0]


def encode_all(keys, grads, cfg: SecureAggConfig) -> Share:
    """encode_local for J owners at once: grads (J, L), keys (J, 2) ->
    (owner, holder, L), bit-equal to stacking encode_local(keys[j],
    grads[j]) (shamir.share's draw and power-matrix product, per key): one
    draw of every owner's share polynomial and one GEMM against the public
    power matrix."""
    cfg.validate()
    n, t = cfg.n_clients, cfg.t
    q = _clip_quantize(grads, cfg)                             # (J, L)
    coeffs = field.random_field_keys(keys, (t,) + tuple(q.shape[1:]),
                                     q.device)                 # (J, T, L)
    pmat = shamir.power_matrix(shamir.default_eval_points(n), t, q.device)
    mix = field.matmul(pmat, coeffs.transpose(0, 1).reshape(t, -1))
    mix = mix.view(n, q.shape[0], -1).transpose(0, 1)          # (own, hold, L)
    return field.add(mix, q[:, None])


def aggregate_shares(all_shares: Share) -> Share:
    """Holder-side: sum incoming shares (LOCAL -- field add only).

    all_shares: (N_owner, ...) rows received by one holder, or (N_owner,
    N_holder, L) for every holder at once.  Returns the share of sum_j g_j
    (the owner axis summed)."""
    return (all_shares.to(torch.int64).sum(0) % field.P).to(all_shares.dtype)


def decode_mean(key, sum_shares: Share, cfg: SecureAggConfig,
                subset: Sequence[int] | None = None, sel=None) -> Opened:
    """Reconstruct sum from any T+1 shares, secure-truncate to the mean.

    sum_shares: (N_holder, L) shares of the sum.  Uses TruncPr with
    k1 = log2(N) so the opened value is mean = sum / N with stochastic
    rounding.  sel: optional (idx (T+1,), weights (T+1,)) per-step share
    selection (shamir.reconstruct_dyn) -- a fault plan's T+1-of-N holder
    choice; `subset` stays the static alternative."""
    n = cfg.n_clients
    k1 = max(1, int(round(math.log2(n))))
    eff_n = 1 << k1                                  # exact power-of-two divisor
    # TruncPr needs the biased value within 2^k2 <= 2^25; the sum's range is
    # N * clip * 2^lq, so derive k2 from it:
    k2 = min(field.P_BITS - 1,
             int(math.ceil(math.log2(cfg.clip * (1 << cfg.lq) * n))) + 2)
    truncated = truncation.trunc_pr(key, sum_shares, k1, k2, cfg.t)
    if sel is not None:
        opened = shamir.reconstruct_dyn(truncated, sel[0], sel[1])
    else:
        opened = shamir.reconstruct(truncated, cfg.t, subset=subset)
    return quantize.dequantize(opened, cfg.lq) * (eff_n / n)


def selection_arrays(cfg: SecureAggConfig, step_subsets, device="cpu") -> tuple:
    """A fault plan's per-step holder subsets -> the (iters, T+1) gather
    index and Lagrange-weight tensors decode_mean's `sel` reads (weights
    computed once per distinct subset)."""
    points = shamir.default_eval_points(cfg.n_clients)
    return shamir.step_subset_arrays(
        step_subsets, cfg.t + 1,
        lambda sub: shamir.recon_weights(points, sub), device)


def secure_aggregate(key, grads_per_client, cfg: SecureAggConfig,
                     subset: Sequence[int] | None = None):
    """The full round trip over a list of N gradient pytrees (same
    structure); returns the privacy-preserving mean gradient pytree."""
    flats, metas = zip(*(flatten_grads(g) for g in grads_per_client))
    mean = _secure_mean_step(key, torch.stack(flats), cfg, subset)
    return unflatten_grads(mean, metas[0])


# --------------------------------------------- secure-agg logistic regression


def _padded_clients(client_xs, client_ys, objective=None, device="cpu"):
    """Stack ragged per-client rows into (N, mmax, d) + a row mask, float32
    on `device`.  `objective` owns the target embedding: targets are
    (N, mmax) + out_shape."""
    n = len(client_xs)
    sizes = [int(np.asarray(x).shape[0]) for x in client_xs]
    mmax, d = max(sizes), int(np.asarray(client_xs[0]).shape[1])
    out_shape = () if objective is None else objective.out_shape
    xs = np.zeros((n, mmax, d), np.float32)
    ys = np.zeros((n, mmax) + out_shape, np.float32)
    mask = np.zeros((n, mmax), np.float32)
    for j, (x, y) in enumerate(zip(client_xs, client_ys)):
        xs[j, : sizes[j]] = np.asarray(x, np.float32)
        yj = np.asarray(y, np.float32) if objective is None else \
            objective.prepare_targets(np.asarray(y))
        ys[j, : sizes[j]] = yj
        mask[j, : sizes[j]] = 1.0
    return (to_device(xs, torch.float32, device),
            to_device(ys, torch.float32, device),
            to_device(mask, torch.float32, device))


def _client_mean_grads(xs, ys, mask, w, objective=None):
    """Per-client MEAN gradients over the padded rows: (N, d) for a (d,)
    vector model, (N, d, C) for a (d, C) matrix model (columnwise
    one-vs-rest).  Default objective = binary logistic (sigmoid)."""
    act = torch.sigmoid if objective is None else objective.act_torch
    if w.dim() == 1:
        z = torch.einsum("nmd,d->nm", xs, w)
        err = (act(z) - ys) * mask
        g = torch.einsum("nmd,nm->nd", xs, err)
        return g / torch.sum(mask, dim=1, keepdim=True)
    z = torch.einsum("nmd,dc->nmc", xs, w)
    err = (act(z) - ys) * mask[..., None]
    g = torch.einsum("nmd,nmc->ndc", xs, err)
    return g / torch.sum(mask, dim=1)[:, None, None]


def _secure_mean_step(key, g, cfg: SecureAggConfig, subset,
                      sel=None) -> Opened:
    """One aggregation round on (N, L) gradients: the key schedule and field
    values of secure_aggregate over [{'g': g[j]}] pytrees."""
    keys = jrandom.split(key, cfg.n_clients + 1)
    shares = encode_all(keys[: cfg.n_clients], g, cfg)   # (owner, holder, L)
    return decode_mean(keys[cfg.n_clients], aggregate_shares(shares), cfg,
                       subset, sel)


def secure_step(key, xs, ys, mask, w, cfg: SecureAggConfig, eta: float,
                subset=None, sel=None, objective=None):
    """One GD step: clear per-client gradients, one aggregation round,
    w - eta * mean."""
    g = _client_mean_grads(xs, ys, mask, w, objective)
    mean = _secure_mean_step(key, g.reshape(cfg.n_clients, -1), cfg, subset,
                             sel)
    return w - eta * mean.reshape(w.shape).to(torch.float32)


def _train(key, client_xs, client_ys, cfg, eta, iters, subset, callback,
           step_subsets, objective, device, timings):
    cfg.validate()
    dev = resolve_device(device)
    t0 = sync_clock(dev)
    xs, ys, mask = _padded_clients(client_xs, client_ys, objective, dev)
    sel = None if step_subsets is None else \
        selection_arrays(cfg, step_subsets, dev)
    subset = None if subset is None else tuple(subset)
    w_shape = (xs.shape[2],) if objective is None else \
        objective.w_shape(xs.shape[2])
    w = torch.zeros(w_shape, dtype=torch.float32, device=dev)
    key = jrandom.as_key(key)
    t1 = sync_clock(dev)
    for t in range(int(iters)):
        sel_t = None if sel is None else (sel[0][t], sel[1][t])
        w = secure_step(jrandom.fold_in(key, t), xs, ys, mask, w, cfg, eta,
                        subset, sel_t, objective)
        if callback is not None:
            callback(t, w)
    t2 = sync_clock(dev)
    if timings is not None:
        timings.update(setup_s=t1 - t0, iters_s=t2 - t1)
    return w


def secure_logreg(key, client_xs, client_ys, cfg: SecureAggConfig,
                  eta: float, iters: int,
                  subset: Sequence[int] | None = None, callback=None,
                  step_subsets=None, objective=None, *, device=None,
                  timings=None):
    """Eager engine: one aggregation round per GD step (step t on
    fold_in(key, t)).  Each client's local gradient is its mean gradient,
    so the decoded mean-of-means equals the full-batch gradient (up to
    split raggedness).  `step_subsets` (a fault plan's per-step T+1 holder
    choices) overrides `subset` every round.  callback(t, w) gets the
    device tensor.  Returns the final model (d,) or (d, C) on the
    device."""
    return _train(key, client_xs, client_ys, cfg, eta, iters, subset,
                  callback, step_subsets, objective, device, timings)


def secure_logreg_scan(key, client_xs, client_ys, cfg: SecureAggConfig,
                       eta: float, iters: int,
                       subset: Sequence[int] | None = None,
                       history: bool = True, step_subsets=None,
                       objective=None, *, device=None, timings=None):
    """The JAX package's jit engine: the same loop as secure_logreg.
    Returns (w, history (iters,) + w's shape, or None)."""
    rows, cb = baselines.history_recorder(history)
    w = _train(key, client_xs, client_ys, cfg, eta, iters, subset, cb,
               step_subsets, objective, device, timings)
    return w, baselines.stacked(rows, w)
