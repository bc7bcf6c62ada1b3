"""Shared transformer building blocks (plain torch).

Attention is flash-style, as in the JAX package: an online-softmax loop
over KV chunks, so prefill never materializes the (Sq, Skv) score matrix.
Norms and softmax statistics are float32 whatever the working type.

The JAX package's score and value products ask XLA for a float32 result
(`preferred_element_type`); torch's matmul returns its inputs' type, so
`_dot_f32` widens both operands first.  A product of two bf16 values is
exact in float32, so this is the same float32 product, summed in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

DEFAULT_KV_CHUNK = 1024


def _dot_f32(eq: str, a, b):
    """einsum(eq, a, b) computed and returned in float32 (jnp.einsum's
    preferred_element_type=float32)."""
    return torch.einsum(eq, a.float(), b.float())


def rms_norm(x, weight, eps: float):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    # log(theta) / half in float32, as a host scalar (no device copy)
    step = float(np.log(np.float32(theta)) / np.float32(half))
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device) * step)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def _chunk_attn(q, k, v, mask, scale):
    """One KV chunk: q (B,Sq,Hk,G,hd), k/v (B,C,Hk,hd), mask (Sq,C) or None.

    Returns (scores_max (B,Sq,Hk,G), exp-sum, weighted-V partial) in f32.
    """
    s = _dot_f32("bqkgh,bckh->bqkgc", q, k) * scale
    if mask is not None:
        s = torch.where(mask[None, :, None, None, :], s, -math.inf)
    m = torch.amax(s, dim=-1)
    # guard fully-masked rows
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    l = torch.sum(p, dim=-1)
    o = _dot_f32("bqkgc,bckh->bqkgh", p.to(v.dtype), v)
    return m_safe, l, o


def flash_attention(q, k, v, *, causal: bool,
                    window: Optional[int] = None,
                    q_offset: int = 0,
                    kv_chunk: int = DEFAULT_KV_CHUNK):
    """Online-softmax attention over KV chunks.

    q: (B, Sq, Hq, hd);  k, v: (B, Skv, Hkv, hd);  GQA via head grouping.
    q_offset: absolute position of q[0] (decode: Skv-1 typically).
    Never materializes (Sq, Skv); peak transient is (B, Sq, Hq, kv_chunk).
    The JAX package pads K/V to whole chunks and masks the padding out;
    here the last chunk is sliced short, which drops the same keys.
    """
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, hd)
    scale = 1.0 / (hd ** 0.5)
    kv_chunk = min(kv_chunk, skv)
    n_chunks = -(-skv // kv_chunk)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m_run = torch.full((b, sq, hkv, g), -1e30, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=q.device)
    o_run = torch.zeros((b, sq, hkv, g, hd), dtype=torch.float32,
                        device=q.device)
    for idx in range(n_chunks):
        lo, hi = idx * kv_chunk, min(skv, (idx + 1) * kv_chunk)
        kv_pos = torch.arange(lo, hi, device=q.device)
        mask = None
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
        if window is not None:
            wmask = kv_pos[None, :] > q_pos[:, None] - window
            mask = wmask if mask is None else mask & wmask
        m_new, l_new, o_new = _chunk_attn(qg, k[:, lo:hi], v[:, lo:hi],
                                          mask, scale)
        m = torch.maximum(m_run, m_new)
        a = torch.exp(m_run - m)
        bfac = torch.exp(m_new - m)
        l_run = l_run * a + l_new * bfac
        o_run = o_run * a[..., None] + o_new * bfac[..., None]
        m_run = m
    out = o_run / torch.clamp(l_run, min=1e-30)[..., None]
    return out.reshape(b, sq, hq, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, length):
    """Single-position attention against a (possibly overlong) cache.

    q: (B, 1, Hq, hd); caches: (B, Smax, Hkv, hd); length: valid prefix.
    Reads the whole cache, as the JAX package's does.
    """
    b, _, hq, hd = q.shape
    _, smax, hkv, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    scale = 1.0 / (hd ** 0.5)
    s = _dot_f32("bkgh,bckh->bkgc", qg, k_cache) * scale
    pos = torch.arange(smax, device=q.device)
    s = torch.where(pos[None, None, None, :] < length, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = _dot_f32("bkgc,bckh->bkgh", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, 1, hq, hd).to(q.dtype)


def _const(value: float, x):
    """A Python constant rounded to x's type, as a host scalar (jnp
    rounds a weakly-typed constant to the array's type)."""
    return float(torch.tensor(value, dtype=x.dtype))


def silu(x):
    """jax.nn.silu as it lowers: x * (1 / (1 + exp(-x))), each op rounded
    to x's type (torch's sigmoid and fused F.silu round once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu(x):
    """jax.nn.gelu's default tanh approximation as it lowers: x * x * x
    and the constants in x's type, each op rounded to x's type."""
    inner = x + _const(0.044715, x) * (x * x * x)
    cdf = 0.5 * (1.0 + torch.tanh(_const(np.sqrt(2 / np.pi), x) * inner))
    return x * cdf


def swiglu(x, w_gate, w_up, w_down):
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(silu(g) * u, w_down)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    h = gelu(torch.matmul(x, w_in) + b_in)
    return torch.matmul(h, w_out) + b_out
