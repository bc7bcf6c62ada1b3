"""Mixture-of-experts layer: top-k routing with cumsum capacity dispatch.

Memory is O(E*C*d + T*k*d); no (T, E, C) one-hot tensor is ever built.
Tokens past an expert's capacity are dropped (standard "dropping" MoE);
a Switch-style aux load-balance loss keeps the router near-uniform.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common


def capacity(cfg, t: int) -> int:
    """Slots an expert holds for t tokens: max(1, int(cf*t*k/E)), and at
    least min(t*k, 4), so that decode steps (t = batch) do not drop below
    a few slots an expert (Python's int truncates, as the JAX package's)."""
    cap = max(1, int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))
    return max(cap, min(t * cfg.top_k, 4))


def moe_forward(p, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    p keys: router (d, E), w_gate/w_up (E, d, ff), w_down (E, ff, d).
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)

    router = p["router"]
    dt = torch.promote_types(xf.dtype, router.dtype)
    logits = torch.matmul(xf.to(dt), router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, k, dim=-1)             # (T, k)
    gate_w = gate_w / torch.clamp(gate_w.sum(dim=-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style)
    density = torch.mean(F.one_hot(gate_i[:, 0], e).float(), dim=0)
    aux = e * torch.sum(density * torch.mean(probs, dim=0))

    # cumsum-based capacity dispatch (no global sort)
    cap = capacity(cfg, t)
    oh = F.one_hot(gate_i, e)                                 # (T, k, E)
    oh_tok = oh.sum(dim=1)                                    # (T, E)
    csum = torch.cumsum(oh_tok, dim=0) - oh_tok               # exclusive
    intra = torch.cumsum(oh, dim=1) - oh                      # within-token
    pos = torch.gather(csum[:, None, :] + intra, 2,
                       gate_i[..., None])[..., 0]             # (T, k)
    keep = pos < cap
    pos_c = torch.where(keep, pos, 0)

    buf = torch.zeros((e, cap, d), dtype=x.dtype, device=x.device)
    upd = torch.where(keep[..., None], xf[:, None, :], 0).to(x.dtype)
    buf.index_put_((gate_i, pos_c), upd, accumulate=True)     # (E, C, d)

    h = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    y = torch.bmm(common.silu(h) * u, p["w_down"])

    gathered = y[gate_i, pos_c]                               # (T, k, d)
    wts = torch.where(keep, gate_w, 0.0)[..., None].to(x.dtype)
    # XLA fuses the weighting into the sum: the products stay float32 and
    # only the sum is rounded to x's type
    out = torch.sum(gathered.float() * wts.float(), dim=1).to(x.dtype)
    return out.reshape(b, s, d), aux
