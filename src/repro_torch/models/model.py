"""Model zoo: parameter tables and forward passes for all families.

Params are a flat dict name -> tensor, with the JAX package's names;
per-layer params are stacked on a leading n_layers axis ("layers/...")
and a forward pass loops over that axis (the JAX package scans it).
`Par.spec` keeps the JAX package's PartitionSpec axes (`param_specs`),
which sharding/partition.py reads.

Training runs the same forward under autograd, with
`collect_cache=False`: the per-layer K/V are not kept (a loss needs none
of them), and with `cfg.remat` each layer is recomputed in backward
(torch.utils.checkpoint, non-reentrant) where the JAX package puts
jax.checkpoint: the encoder's layers, the hybrid's inner layers and the
layer loop.  Recomputation applies only while grad is enabled.

Decode updates the caches in place: each layer's new K/V entries (and a
state-space layer's new conv and ssm states) are written into the cache
tensors it was given, which the step then returns.  Prefill returns new
per-layer caches stacked on the leading axis, as the JAX package's scan
does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.protocol import resolve_device
from . import common, moe as moe_lib, ssm as ssm_lib
from .config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Par:
    shape: tuple
    spec: tuple
    init: str = "normal"      # normal | zeros | ones | alog | dtbias
    dtype: Optional[str] = None


# --------------------------------------------------------------------- table

def _attn_pars(cfg: ModelConfig, t: dict, prefix: str = ""):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    t[prefix + "attn_norm"] = Par((d,), (None,), "ones")
    t[prefix + "wq"] = Par((d, hq * hd), (None, "model"))
    t[prefix + "wk"] = Par((d, hkv * hd), (None, "model"))
    t[prefix + "wv"] = Par((d, hkv * hd), (None, "model"))
    t[prefix + "wo"] = Par((hq * hd, d), ("model", None))
    if cfg.qkv_bias:
        t[prefix + "bq"] = Par((hq * hd,), ("model",), "zeros")
        t[prefix + "bk"] = Par((hkv * hd,), ("model",), "zeros")
        t[prefix + "bv"] = Par((hkv * hd,), ("model",), "zeros")
    if cfg.qk_norm:
        t[prefix + "q_norm"] = Par((hd,), (None,), "ones")
        t[prefix + "k_norm"] = Par((hd,), (None,), "ones")


def _mlp_pars(cfg: ModelConfig, t: dict, prefix: str = "", gelu: bool = False):
    d, ff = cfg.d_model, cfg.d_ff
    t[prefix + "mlp_norm"] = Par((d,), (None,), "ones")
    if gelu:
        t[prefix + "w_in"] = Par((d, ff), (None, "model"))
        t[prefix + "b_in"] = Par((ff,), ("model",), "zeros")
        t[prefix + "w_out"] = Par((ff, d), ("model", None))
        t[prefix + "b_out"] = Par((d,), (None,), "zeros")
    else:
        t[prefix + "w_gate"] = Par((d, ff), (None, "model"))
        t[prefix + "w_up"] = Par((d, ff), (None, "model"))
        t[prefix + "w_down"] = Par((ff, d), ("model", None))


def _mamba_pars(cfg: ModelConfig, t: dict, prefix: str = ""):
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    t[prefix + "ssm_norm"] = Par((d,), (None,), "ones")
    t[prefix + "in_proj"] = Par((d, 2 * di), (None, "model"))
    t[prefix + "conv_w"] = Par((cfg.ssm_conv, di), (None, "model"))
    t[prefix + "out_proj"] = Par((di, d), ("model", None))
    if cfg.ssm_version == 1:
        t[prefix + "x_proj"] = Par((di, cfg.dt_rank + 2 * ns), ("model", None))
        t[prefix + "dt_proj"] = Par((cfg.dt_rank, di), (None, "model"))
        t[prefix + "dt_bias"] = Par((di,), ("model",), "dtbias", "float32")
        t[prefix + "a_log"] = Par((di, ns), ("model", None), "alog", "float32")
        t[prefix + "dvec"] = Par((di,), ("model",), "ones")
    else:
        nh = cfg.mamba2_heads
        t[prefix + "b_proj"] = Par((d, ns), (None, None))
        t[prefix + "c_proj"] = Par((d, ns), (None, None))
        t[prefix + "dt_proj"] = Par((d, nh), (None, "model"))
        t[prefix + "dt_bias"] = Par((nh,), ("model",), "dtbias", "float32")
        t[prefix + "a_log"] = Par((nh,), ("model",), "alog", "float32")
        t[prefix + "dvec"] = Par((nh,), ("model",), "ones")


def _moe_pars(cfg: ModelConfig, t: dict, prefix: str = ""):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    t[prefix + "moe_norm"] = Par((d,), (None,), "ones")
    t[prefix + "router"] = Par((d, e), (None, None), dtype="float32")
    t[prefix + "w_gate"] = Par((e, d, ff), ("model", None, None))
    t[prefix + "w_up"] = Par((e, d, ff), ("model", None, None))
    t[prefix + "w_down"] = Par((e, ff, d), ("model", None, None))
    if cfg.dense_residual:
        t[prefix + "dense_w_gate"] = Par((d, ff), (None, "model"))
        t[prefix + "dense_w_up"] = Par((d, ff), (None, "model"))
        t[prefix + "dense_w_down"] = Par((ff, d), ("model", None))


def param_table(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    t: dict = {
        "embed": Par((cfg.vocab, d), ("model", None)),
        "final_norm": Par((d,), (None,), "ones"),
    }
    lt: dict = {}
    if cfg.family in ("dense", "vlm"):
        _attn_pars(cfg, lt)
        _mlp_pars(cfg, lt)
    elif cfg.family == "moe":
        _attn_pars(cfg, lt)
        _moe_pars(cfg, lt)
    elif cfg.family == "ssm":
        _mamba_pars(cfg, lt)
    elif cfg.family == "hybrid":
        _mamba_pars(cfg, lt)
        _attn_pars(cfg, t, "shared_attn/")      # ONE shared block (zamba2)
        _mlp_pars(cfg, t, "shared_attn/")
    elif cfg.family == "encdec":
        _attn_pars(cfg, lt)                      # decoder self-attn
        lt["xattn_norm"] = Par((d,), (None,), "ones")
        lt["xwq"] = Par((d, cfg.n_heads * cfg.hd), (None, "model"))
        lt["xwk"] = Par((d, cfg.n_kv * cfg.hd), (None, "model"))
        lt["xwv"] = Par((d, cfg.n_kv * cfg.hd), (None, "model"))
        lt["xwo"] = Par((cfg.n_heads * cfg.hd, d), ("model", None))
        _mlp_pars(cfg, lt, gelu=True)
        et: dict = {}
        _attn_pars(cfg, et)
        _mlp_pars(cfg, et, gelu=True)
        for k, v in et.items():
            t["enc_layers/" + k] = Par(
                (cfg.encoder_layers,) + v.shape, (None,) + v.spec, v.init,
                v.dtype)
        t["enc_norm"] = Par((d,), (None,), "ones")
    else:
        raise ValueError(cfg.family)
    if cfg.family == "vlm":
        t["patch_proj"] = Par((d, d), (None, None))
    for k, v in lt.items():
        t["layers/" + k] = Par((cfg.n_layers,) + v.shape, (None,) + v.spec,
                               v.init, v.dtype)
    return t


def _par_dtype(cfg: ModelConfig, par: Par) -> torch.dtype:
    return getattr(torch, par.dtype) if par.dtype else cfg.torch_dtype


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """The JAX package's table and inits (normal x fan_in^-1/2, zeros,
    ones, alog, dtbias), drawn in sorted name order from `generator`,
    which must live on `device`: the CUDA card unless device="cpu" is
    asked for.  Not the JAX package's values: its normals come from
    jax.random (carry those with params_from_jax)."""
    device = resolve_device(device)
    table = param_table(cfg)
    out = {}
    for name in sorted(table):
        par = table[name]
        dt = _par_dtype(cfg, par)
        if par.init == "zeros":
            arr = torch.zeros(par.shape, dtype=dt, device=device)
        elif par.init == "ones":
            arr = torch.ones(par.shape, dtype=dt, device=device)
        elif par.init == "alog":
            ns = par.shape[-1]
            if ns > 1:
                base = torch.log(torch.arange(1, ns + 1, dtype=torch.float32,
                                              device=device))
                arr = base.expand(par.shape).to(dt).contiguous()
            else:
                arr = torch.zeros(par.shape, dtype=dt, device=device)
        elif par.init == "dtbias":
            arr = torch.full(par.shape, -2.0, dtype=dt, device=device)
        else:
            fan_in = par.shape[-2] if len(par.shape) >= 2 else par.shape[-1]
            arr = torch.randn(par.shape, generator=generator,
                              dtype=torch.float32, device=device)
            arr = arr.mul_(fan_in ** -0.5).to(dt)
        out[name] = arr
    return out


def param_specs(cfg: ModelConfig) -> dict:
    """name -> the parameter's spec: a tuple of mesh axis names (or None)
    a dimension, the JAX package's PartitionSpec entries."""
    return {k: tuple(v.spec) for k, v in param_table(cfg).items()}


# ------------------------------------------------ weights from the JAX package

def _tensor_from_numpy(arr, dtype: torch.dtype, device, what: str):
    """A numpy array (float32, or bfloat16 through ml_dtypes) as a tensor
    of `dtype`; a bf16 tensor may also come as float32 values."""
    kind = arr.dtype.name
    if kind == "bfloat16":
        if dtype != torch.bfloat16:
            raise ValueError(f"{what}: bfloat16 array for a {dtype} tensor")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    if kind != "float32":
        raise ValueError(f"{what}: dtype {kind}, want float32 or bfloat16")
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(
        device=device, dtype=dtype)


def params_from_jax(cfg: ModelConfig, params_np: dict, device=None) -> dict:
    """The JAX package's parameter dict (numpy arrays) as the port's, on
    the card unless device="cpu": names, shapes and dtypes checked
    against param_table."""
    device = resolve_device(device)
    table = param_table(cfg)
    if set(params_np) != set(table):
        raise ValueError(
            f"parameter names differ: missing {sorted(set(table) - set(params_np))}"
            f", extra {sorted(set(params_np) - set(table))}")
    out = {}
    for name, par in table.items():
        arr = np.asarray(params_np[name])
        if tuple(arr.shape) != par.shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, want "
                             f"{par.shape}")
        out[name] = _tensor_from_numpy(arr, _par_dtype(cfg, par), device,
                                       name)
    return out


def caches_from_jax(caches_np, device=None):
    """The JAX package's decode caches (nested tuples of numpy arrays) as
    tensors of the arrays' own types (bfloat16 or float32), on the card
    unless device="cpu"."""
    device = resolve_device(device)
    if isinstance(caches_np, (tuple, list)):
        return tuple(caches_from_jax(c, device) for c in caches_np)
    dt = torch.bfloat16 if caches_np.dtype.name == "bfloat16" else \
        torch.float32
    return _tensor_from_numpy(caches_np, dt, device, "cache")


def caches_to_numpy(caches):
    """Nested tuples of cache tensors as float32 numpy arrays."""
    if isinstance(caches, (tuple, list)):
        return tuple(caches_to_numpy(c) for c in caches)
    return caches.detach().float().cpu().numpy()


# ------------------------------------------------------------------- forward

def _write_at(cache, new, pos: int, dim: int = 1):
    """cache[..., pos:pos+n, ...] = new along `dim`, in place, with the
    start clamped so the slice fits (jax's dynamic_update_slice)."""
    n = new.shape[dim]
    start = min(max(pos, 0), cache.shape[dim] - n)
    cache.narrow(dim, start, n).copy_(new)
    return cache


def _attention(cfg, p, h, *, causal, cache=None, pos=None, prefix="",
               window=None, kv_input=None, q_offset: int = 0):
    """Returns (out, (k_new, v_new)) -- the updated caches when a cache is
    given (decode), else the full-sequence K/V (prefill)."""
    def g(nm):
        return p[prefix + nm]
    b, s, d = h.shape
    x = common.rms_norm(h, g("attn_norm"), cfg.norm_eps)
    src = x if kv_input is None else kv_input
    q = torch.matmul(x, g("wq"))
    k = torch.matmul(src, g("wk"))
    v = torch.matmul(src, g("wv"))
    if cfg.qkv_bias:
        q, k, v = q + g("bq"), k + g("bk"), v + g("bv")
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, src.shape[1], cfg.n_kv, cfg.hd)
    v = v.reshape(b, src.shape[1], cfg.n_kv, cfg.hd)
    if cfg.qk_norm:
        q = common.rms_norm(q, g("q_norm"), cfg.norm_eps)
        k = common.rms_norm(k, g("k_norm"), cfg.norm_eps)
    if kv_input is None and cfg.family != "encdec":   # self-attn: rope
        # (whisper uses absolute sinusoidal positions added to h instead)
        qpos = (q_offset + torch.arange(s, device=h.device))[None]
        q = common.rope(q, qpos, cfg.rope_theta)
        kpos = torch.arange(src.shape[1], device=h.device)[None] \
            if cache is None else qpos
        k = common.rope(k, kpos, cfg.rope_theta)

    if cache is not None:                      # decode: update + attend
        k_cache, v_cache = cache
        _write_at(k_cache, k, pos)
        _write_at(v_cache, v, pos)
        # decode ignores `window` (the JAX package's decode does too)
        out = common.decode_attention(q, k_cache, v_cache, pos + s)
        new_kv = (k_cache, v_cache)
    else:
        out = common.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
        new_kv = (k, v)
    out = torch.matmul(out.reshape(b, s, -1), g("wo"))
    return out, new_kv


def _mlp(cfg, p, h, prefix="", gelu=False):
    x = common.rms_norm(h, p[prefix + "mlp_norm"], cfg.norm_eps)
    if gelu:
        return common.gelu_mlp(x, p[prefix + "w_in"], p[prefix + "b_in"],
                               p[prefix + "w_out"], p[prefix + "b_out"])
    return common.swiglu(x, p[prefix + "w_gate"], p[prefix + "w_up"],
                         p[prefix + "w_down"])


def _layer(cfg: ModelConfig, p, h, cache, pos, window=None):
    """One decoder layer of any family.  Returns (h, new_cache, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    qo = 0 if pos is None else pos          # decode: rope at the true position
    if cfg.family in ("dense", "vlm"):
        a, kv = _attention(cfg, p, h, causal=True, cache=cache, pos=pos,
                           window=window, q_offset=qo)
        h = h + a
        h = h + _mlp(cfg, p, h)
        return h, kv, aux
    if cfg.family == "moe":
        a, kv = _attention(cfg, p, h, causal=True, cache=cache, pos=pos,
                           window=window, q_offset=qo)
        h = h + a
        x = common.rms_norm(h, p["moe_norm"], cfg.norm_eps)
        mo, aux = moe_lib.moe_forward(
            {"router": p["router"], "w_gate": p["w_gate"],
             "w_up": p["w_up"], "w_down": p["w_down"]}, x, cfg)
        if cfg.dense_residual:
            mo = mo + common.swiglu(x, p["dense_w_gate"], p["dense_w_up"],
                                    p["dense_w_down"])
        return h + mo, kv, aux
    if cfg.family in ("ssm", "hybrid"):
        x = common.rms_norm(h, p["ssm_norm"], cfg.norm_eps)
        fwd = ssm_lib.mamba1_forward if cfg.ssm_version == 1 \
            else ssm_lib.mamba2_forward
        out, new_cache = fwd(p, x, cfg, cache)
        if cache is not None:                  # decode: states in place
            for old, new in zip(cache, new_cache):
                old.copy_(new)
            new_cache = cache
        return h + out, new_cache, aux
    raise ValueError(cfg.family)


def _layer_params(params: dict, prefix: str = "layers/") -> dict:
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _per_layer(lp: dict, n: int) -> list:
    """The stacked per-layer params as one dict a layer.  The stacks are
    unbound once: in backward that is one stack of the layers' gradients
    a leaf, where indexing each layer would add a full-size zero-padded
    gradient a layer (L full-size adds a leaf)."""
    rows = {k: v.unbind(0) for k, v in lp.items()}
    return [{k: r[i] for k, r in rows.items()} for i in range(n)]


def _index(tree, i):
    """tree[i] on every tensor of a nested tuple (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_index(t, i) for t in tree)
    return tree[i]


def _stack(items: list):
    """Stack a list of equal nested tuples of tensors leaf by leaf."""
    if isinstance(items[0], tuple):
        return tuple(_stack([it[j] for it in items])
                     for j in range(len(items[0])))
    return torch.stack(items)


def _embed_tokens(params, tokens):
    return params["embed"][tokens]


def logits_from_h(params, h):
    return torch.matmul(h, params["embed"].t())


def _remat(cfg, fn, *args):
    """fn(*args), recomputed in backward when cfg.remat and grad is on."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode_frames(cfg, params, frames):
    """Whisper encoder over STUB frame embeddings (B, Se, d)."""
    pos = _sinusoid(cfg, frames.shape[1], frames.device).to(frames.dtype)
    h = frames + pos[None]
    lp = _layer_params(params, "enc_layers/")

    def body(p, h):
        a, _ = _attention(cfg, p, h, causal=False)
        h = h + a
        return h + _mlp(cfg, p, h, gelu=True)

    for p in _per_layer(lp, cfg.encoder_layers):
        h = _remat(cfg, body, p, h)
    return common.rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _sinusoid(cfg, s, device=None):
    d = cfg.d_model
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def forward(cfg: ModelConfig, params: dict, tokens, *,
            frontier=None, caches=None, pos=None, collect_cache=True):
    """Full forward.  tokens: (B, S) ints.

    frontier: modality input -- whisper frames (B,Se,d) / vlm patches
    (B,Np,d) / None.  caches: decode caches (nested tuples) or None.
    pos: decode position (int) or None.  collect_cache=False (no caches
    given): the per-layer prefill cache is not kept and None is returned
    in its place.
    Returns (hidden (B,S,d), new_caches or per-layer prefill cache, aux).
    """
    keep = caches is not None or collect_cache
    dev = tokens.device
    h = _embed_tokens(params, tokens).to(cfg.torch_dtype)
    q_offset = 0 if pos is None else pos
    n_prefix = 0
    if cfg.family == "vlm" and frontier is not None:
        patches = torch.matmul(frontier.to(cfg.torch_dtype),
                               params["patch_proj"])
        h = torch.cat([patches, h], dim=1)
        n_prefix = frontier.shape[1]
    enc_out = None
    if cfg.family == "encdec":
        if pos is None:
            h = h + _sinusoid(cfg, h.shape[1], dev)[None].to(h.dtype)
        else:                         # decode: absolute position of the token
            # the table is as long as the cache (the JAX package's quirk)
            table_len = caches[0].shape[2] if caches is not None \
                else h.shape[1]
            table = _sinusoid(cfg, table_len, dev).to(h.dtype)
            start = min(max(pos, 0), table_len - h.shape[1])
            h = h + table[start:start + h.shape[1]][None]
        if frontier is not None:
            enc_out = encode_frames(cfg, params, frontier)

    lp = _layer_params(params)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)

    if cfg.family == "hybrid" and cfg.attn_every:
        # zamba2: groups of `attn_every` mamba2 layers + ONE shared attention
        # block applied between groups (shared weights across applications)
        groups = cfg.n_layers // cfg.attn_every
        shared = {k[len("shared_attn/"):]: v for k, v in params.items()
                  if k.startswith("shared_attn/")}
        m_caches, a_caches = (None, None) if caches is None else caches
        layers = _per_layer(lp, cfg.n_layers)
        new_m, new_a = [], []

        def inner(p, h):
            return _layer(cfg, p, h, None, pos)[0]

        for gi in range(groups):
            nc_g = []
            for j in range(cfg.attn_every):
                li = gi * cfg.attn_every + j
                p = layers[li]
                c = None if m_caches is None else _index(_index(m_caches, gi),
                                                         j)
                if keep:
                    h, nc, _ = _layer(cfg, p, h, c, pos)
                    nc_g.append(nc)
                else:
                    h = _remat(cfg, inner, p, h)
            new_m.append(nc_g)
            ac = _index(a_caches, gi)
            a, akv = _attention(cfg, shared, h, causal=True, cache=ac,
                                pos=pos, window=cfg.window,
                                q_offset=q_offset)
            h = h + a
            h = h + _mlp(cfg, shared, h)
            if keep:
                new_a.append(akv)
        new_caches = caches if caches is not None else \
            (_stack([_stack(g) for g in new_m]), _stack(new_a)) if keep \
            else None
        h = common.rms_norm(h, params["final_norm"], cfg.norm_eps)
        return h, new_caches, aux_total

    def body(p, h):
        """One layer without caches: (h, aux)."""
        if cfg.family == "encdec":
            return _encdec_layer(cfg, p, h, None, pos, q_offset, enc_out)[0], \
                torch.zeros((), dtype=torch.float32, device=dev)
        h, _, a = _layer(cfg, p, h, None, pos, window=cfg.window)
        return h, a

    new = []
    for li, p in enumerate(_per_layer(lp, cfg.n_layers)):
        if not keep:
            h, a = _remat(cfg, body, p, h)
            aux_total = aux_total + a
            continue
        c = _index(caches, li)
        if cfg.family == "encdec":
            h, nc = _encdec_layer(cfg, p, h, c, pos, q_offset, enc_out)
        else:
            h, nc, a = _layer(cfg, p, h, c, pos, window=cfg.window)
            aux_total = aux_total + a
        new.append(nc)
    new_caches = caches if caches is not None else \
        _stack(new) if keep else None
    h = common.rms_norm(h, params["final_norm"], cfg.norm_eps)
    if n_prefix:
        h = h[:, n_prefix:]
    return h, new_caches, aux_total


def _encdec_layer(cfg, p, h, c, pos, q_offset, enc_out):
    """A whisper decoder layer: self-attention (cached), cross-attention
    on the encoder's output (its K/V computed at prefill and cached), MLP.
    Returns (h, (k, v, xk, xv))."""
    a, kv = _attention(cfg, p, h, causal=True,
                       cache=None if c is None else (c[0], c[1]),
                       pos=pos, q_offset=q_offset)
    h = h + a
    if c is None:
        xa, xkv = _attention(cfg, p, h, causal=False, prefix="x",
                             kv_input=enc_out)
    else:
        b, s = h.shape[0], h.shape[1]
        xq = torch.matmul(common.rms_norm(h, p["xattn_norm"], cfg.norm_eps),
                          p["xwq"]).reshape(b, s, cfg.n_heads, cfg.hd)
        xa = common.decode_attention(xq, c[2], c[3], c[2].shape[1])
        xa = torch.matmul(xa.reshape(b, s, -1), p["xwo"])
    h = h + xa
    h = h + _mlp(cfg, p, h, gelu=True)
    nc = (kv[0], kv[1], xkv[0], xkv[1]) if c is None else c
    return h, nc
