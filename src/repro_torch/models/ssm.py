"""Selective state-space blocks: Mamba1 (falcon-mamba) and Mamba2/SSD (zamba2).

Prefill runs the recurrence over time (Mamba1, and Mamba2's reference
path) or the SSD chunked-matmul form (Mamba2).  The JAX package splits the
time scan into rematerialized chunks to bound what its backward pass
stores; serving has no backward pass, so the port scans step by step.
Decode carries (conv_state, ssm_state), float32 state, and is O(1) in
context length.
"""

from __future__ import annotations

import math

from typing import Optional

import torch
import torch.nn.functional as F

from . import common


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x: (B, S, C); w: (K, C).

    cache: (B, K-1, C) previous inputs for decode continuity.
    Returns (y (B, S, C), new_cache (B, K-1, C)).
    """
    k = w.shape[0]
    if cache is None:
        cache = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([cache, x], dim=1)
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
    new_cache = xp[:, -(k - 1):, :] if k > 1 else cache
    return y, new_cache


def _ssm_scan(decay, inp, h0):
    """h_t = decay_t * h_{t-1} + inp_t, scanned over axis 1 (time).

    decay, inp: (B, S, ...state dims) (decay may be a broadcast view);
    h0: (B, ...).  Returns (ys (B, S, ...), h_S).
    """
    s = inp.shape[1]
    h = h0
    if torch.is_grad_enabled():             # autograd: no in-place writes
        hs = []
        for t in range(s):
            h = decay[:, t] * h + inp[:, t]
            hs.append(h)
        return torch.stack(hs, dim=1), h
    ys = torch.empty(inp.shape, dtype=inp.dtype, device=inp.device)
    for t in range(s):
        h = decay[:, t] * h + inp[:, t]
        ys[:, t] = h
    return ys, h


def mamba1_forward(p, x, cfg, cache=None):
    """Mamba1 block.  x: (B, S, d_model).  cache: None or (conv, h).

    p keys: in_proj (d, 2di), conv_w (K, di), x_proj (di, dt_rank+2N),
    dt_proj (dt_rank, di), dt_bias (di,), a_log (di, N), dvec (di,),
    out_proj (di, d).
    """
    di, ns = cfg.d_inner, cfg.ssm_state
    xz = torch.matmul(x, p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)
    conv_cache = cache[0] if cache is not None else None
    xin, new_conv = _causal_conv(xin, p["conv_w"], conv_cache)
    xin = common.silu(xin)

    proj = torch.matmul(xin, p["x_proj"])
    dt_low, bmat, cmat = torch.split(
        proj, [cfg.dt_rank, ns, proj.shape[-1] - cfg.dt_rank - ns], dim=-1)
    dt = _softplus(torch.matmul(dt_low, p["dt_proj"]) + p["dt_bias"])
    a = -torch.exp(p["a_log"].float())                        # (di, N)
    decay = torch.exp(dt.float()[..., None] * a)              # (B,S,di,N)
    inp = (dt * xin).float()[..., None] * \
        bmat.float()[..., None, :]                            # (B,S,di,N)

    h0 = cache[1] if cache is not None else \
        torch.zeros((x.shape[0], di, ns), dtype=torch.float32,
                    device=x.device)
    hs, h_last = _ssm_scan(decay, inp, h0)
    y = torch.einsum("bsen,bsn->bse", hs, cmat.float())
    y = y.to(x.dtype) + xin * p["dvec"]
    y = y * common.silu(z)
    out = torch.matmul(y, p["out_proj"])
    return out, (new_conv, h_last)


def _mamba2_proj(p, x, cfg, cache):
    """Shared projections for both mamba2 execution paths."""
    nh = cfg.mamba2_heads
    hd = cfg.d_inner // nh
    xz = torch.matmul(x, p["in_proj"])
    xin, z = torch.chunk(xz, 2, dim=-1)
    conv_cache = cache[0] if cache is not None else None
    xin, new_conv = _causal_conv(xin, p["conv_w"], conv_cache)
    xin = common.silu(xin)
    xh = xin.reshape(xin.shape[0], xin.shape[1], nh, hd)      # (B,S,nh,hd)
    bmat = torch.matmul(x, p["b_proj"]).float()
    cmat = torch.matmul(x, p["c_proj"]).float()
    dt = _softplus(torch.matmul(x, p["dt_proj"]) + p["dt_bias"]).float()
    a = -torch.exp(p["a_log"].float())                        # (nh,)
    return xh, z, bmat, cmat, dt, a, new_conv


def _mamba2_finish(p, x, xh, z, y, cfg):
    y = y.to(x.dtype) + xh * p["dvec"][None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], -1) * common.silu(z)
    return torch.matmul(y, p["out_proj"])


def mamba2_forward_scan(p, x, cfg, cache=None):
    """Mamba2 reference path: explicit state recurrence (decode + oracle).

    Materializes the (B,S,nh,hd,ns) input tensor: fine for S=1 decode."""
    ns, nh = cfg.ssm_state, cfg.mamba2_heads
    hd = cfg.d_inner // nh
    xh, z, bmat, cmat, dt, a, new_conv = _mamba2_proj(p, x, cfg, cache)
    decay = torch.exp(dt * a)                                 # (B,S,nh)
    decay = decay[..., None, None].expand(decay.shape + (hd, ns))
    inp = (dt[..., None] * xh.float())[..., None] * \
        bmat[..., None, None, :]                              # (B,S,nh,hd,N)
    h0 = cache[1] if cache is not None else \
        torch.zeros((x.shape[0], nh, hd, ns), dtype=torch.float32,
                    device=x.device)
    hs, h_last = _ssm_scan(decay, inp, h0)
    y = torch.einsum("bshpn,bsn->bshp", hs, cmat)
    out = _mamba2_finish(p, x, xh, z, y, cfg)
    return out, (new_conv, h_last)


def mamba2_forward(p, x, cfg, cache=None, chunk: int = 128):
    """Mamba2 block via the SSD chunked-matmul algorithm.

    Chunk-local (c x c) score matmuls plus an S/c-step state recurrence;
    equals mamba2_forward_scan to f32 tolerance.
    """
    if x.shape[1] == 1:                       # decode: one recurrence step
        return mamba2_forward_scan(p, x, cfg, cache)
    ns, nh = cfg.ssm_state, cfg.mamba2_heads
    hd = cfg.d_inner // nh
    xh, z, bmat, cmat, dt, a, new_conv = _mamba2_proj(p, x, cfg, cache)
    b, s = x.shape[0], x.shape[1]
    c = min(chunk, s)
    pad = (-s) % c
    xhp, bp, cp, dtp = xh.float(), bmat, cmat, dt
    if pad:
        def padf(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        xhp, bp, cp, dtp = map(padf, (xhp, bp, cp, dtp))
    nc = (s + pad) // c

    def shp(t):
        return t.reshape((b, nc, c) + tuple(t.shape[2:]))
    xc, bc, cc, dtc = map(shp, (xhp, bp, cp, dtp))
    loga = dtc * a                                            # (B,nc,c,nh)
    la = torch.cumsum(loga, dim=2)                            # inclusive
    bx = dtc[..., None] * xc                                  # (B,nc,c,nh,hd)

    # intra-chunk: y[i] += sum_{j<=i} exp(la_i - la_j) (C_i.B_j) bx_j
    cb = torch.einsum("bkin,bkjn->bkij", cc, bc)              # (B,nc,c,c)
    diff = la[:, :, :, None, :] - la[:, :, None, :, :]        # (B,nc,i,j,nh)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=x.device))
    # the upper triangle is masked BEFORE the exp: exp(-inf) = 0 gives the
    # JAX package's values, and its gradient stays 0 where exp(diff) would
    # overflow (the JAX package masks after the exp, so its gradient is
    # 0 * inf = NaN once a chunk's decay sum passes ~88)
    scores = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                   -math.inf)) * cb[..., None]
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", scores, bx)

    # per-chunk state contribution + inter-chunk recurrence
    dec_end = torch.exp(la[:, :, -1:, :] - la)                # (B,nc,c,nh)
    s_k = torch.einsum("bkjh,bkjhp,bkjn->bkhpn", dec_end, bx, bc)
    a_k = torch.exp(la[:, :, -1, :])                          # (B,nc,nh)
    h = cache[1] if cache is not None else \
        torch.zeros((b, nh, hd, ns), dtype=torch.float32, device=x.device)
    h_prevs = []
    for kk in range(nc):
        h_prevs.append(h)                                     # h before chunk
        h = a_k[:, kk, :, None, None] * h + s_k[:, kk]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,nh,hd,ns)
    y_inter = torch.einsum("bkih,bkin,bkhpn->bkihp",
                           torch.exp(la), cc, h_prevs)
    y = (y_intra + y_inter).reshape(b, nc * c, nh, hd)[:, :s]
    out = _mamba2_finish(p, x, xh, z, y, cfg)
    return out, (new_conv, h)


def ssm_decode_cache(cfg, batch: int, dtype, device=None):
    """Zero cache for one layer: (conv_state, ssm_state)."""
    di = cfg.d_inner
    conv = torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype,
                       device=device)
    if cfg.ssm_version == 1:
        h = torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                        device=device)
    else:
        nh = cfg.mamba2_heads
        h = torch.zeros((batch, nh, di // nh, cfg.ssm_state),
                        dtype=torch.float32, device=device)
    return conv, h
