"""Partition rules: map model / optimizer / input trees onto a mesh, and
the sharded COPML engine's per-rank state layout.

LM axes: ("pod",) "data", "model" (a core/meshutil.Mesh value); the
sharded COPML engine splits a 1-D "clients" axis (copml_state_structs).
Rules (the JAX package's sharding/partition.py):
  * params: from the model's own param table (models/model.param_specs);
  * optimizer state: each leaf's spec derived from its parameter's, ZeRO-
    sharded (zero_spec); Adafactor's factored statistics drop the reduced
    dim;
  * batch: ("pod", "data") on the batch dim;
  * decode K/V caches: batch on "data", cache sequence on "model" (GQA
    kv-head counts need not divide the model axis; the sequence does).
    long_500k (batch 1): sequence on "data" AND heads on "model".
Axes absent from the mesh (or not dividing the dim) are dropped.

A spec is a tuple with one entry a dimension: None, an axis name, or a
tuple of axis names.  The `*_structs` functions give each rank's shard as
a meta tensor (its shape and dtype, no memory).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.protocol import CopmlState
from ..models import model as M
from ..models import model_zoo as MZ
from ..models.config import ModelConfig, ShapeConfig

BATCH_AXES = MZ.BATCH_AXES


def _axis_size(mesh, entry) -> int:
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= mesh.shape[a]
    return n


def _fit(spec_entry, dim: int, mesh):
    """Keep a spec entry's axes only if present in the mesh and their
    product divides the dim."""
    if spec_entry is None:
        return None
    entries = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    kept = tuple(a for a in entries if a in mesh.shape)
    if not kept or dim % _axis_size(mesh, kept) != 0:
        return None
    return kept if len(kept) > 1 else kept[0]


def normalize(spec: tuple, shape, mesh) -> tuple:
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(_fit(e, d, mesh) for e, d in zip(entries, shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A normalized spec on a mesh (the JAX package's NamedSharding)."""
    mesh: object
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's shard of a `shape` array."""
        entries = self.spec + (None,) * (len(shape) - len(self.spec))
        return tuple(d if e is None else d // _axis_size(self.mesh, e)
                     for d, e in zip(shape, entries))


def shard(mesh, spec: tuple, shape) -> Sharding:
    return Sharding(mesh, normalize(spec, shape, mesh))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def _struct(shape, dtype, sharding: Sharding) -> torch.Tensor:
    return torch.empty(sharding.shard_shape(tuple(shape)), dtype=dtype,
                       device="meta")


def param_shardings(cfg: ModelConfig, mesh) -> dict:
    table = M.param_table(cfg)
    return {k: shard(mesh, v.spec, v.shape) for k, v in table.items()}


def default_fsdp(cfg: ModelConfig, mesh) -> bool:
    """FSDP by default when the model-parallel shard of the bf16 weights
    alone exceeds 4 GiB a device (arctic-480b)."""
    return cfg.param_count() * 2 / mesh.shape.get("model", 1) > 4 * 2 ** 30


def param_plan(cfg: ModelConfig, mesh, fsdp: bool | None = None) -> dict:
    """name -> (global shape, dtype, Sharding) of every parameter.

    fsdp=True additionally shards every >= 2-D parameter's largest free
    dim over 'data' (zero_spec: ZeRO-3 / FSDP, the weights all-gathered a
    layer at a time inside the step).  Default: default_fsdp."""
    table = M.param_table(cfg)
    if fsdp is None:
        fsdp = default_fsdp(cfg, mesh)
    out = {}
    for k, v in table.items():
        dt = M._par_dtype(cfg, v)
        sp = tuple(v.spec)
        if fsdp and len(v.shape) >= 2:
            sp = zero_spec(sp, v.shape, mesh)
        out[k] = (tuple(v.shape), dt, shard(mesh, sp, v.shape))
    return out


def param_structs(cfg: ModelConfig, mesh, fsdp: bool | None = None) -> dict:
    """Each rank's parameter shards as meta tensors (param_plan)."""
    return {k: _struct(shape, dt, sh)
            for k, (shape, dt, sh) in param_plan(cfg, mesh, fsdp).items()}


def zero_spec(spec: tuple, shape: tuple, mesh) -> tuple:
    """ZeRO-style sharding: additionally shard the largest dim not already
    sharded over the 'data' axis (unfactored float32 moments of a 30B+ MoE
    do not fit a device when sharded on 'model' only)."""
    if "data" not in mesh.shape:
        return tuple(spec)
    sp = list(tuple(spec) + (None,) * (len(shape) - len(tuple(spec))))
    data = mesh.shape["data"]
    best, best_dim = None, 0
    for i, (e, d) in enumerate(zip(sp, shape)):
        if e is None and d % data == 0 and d > best_dim:
            best, best_dim = i, d
    if best is not None:
        sp[best] = "data"
    return tuple(sp)


def opt_state_plan(cfg: ModelConfig, mesh) -> dict:
    """The optimizer state's tree with (global shape, Sharding) leaves,
    all float32: adamw {"m", "v"}, sgdm {"m"}, adafactor {"f": {name:
    {"vr", "vc"} or {"v"}}}."""
    table = M.param_table(cfg)

    def f32(shape, sp):
        return (tuple(shape), shard(mesh, zero_spec(sp, shape, mesh), shape))

    if cfg.optimizer in ("adamw", "sgdm"):
        moments = {k: f32(v.shape, tuple(v.spec)) for k, v in table.items()}
        if cfg.optimizer == "adamw":
            return {"m": moments,
                    "v": {k: f32(v.shape, tuple(v.spec))
                          for k, v in table.items()}}
        return {"m": moments}
    fstate = {}
    for k, v in table.items():
        sp = tuple(v.spec) + (None,) * (len(v.shape) - len(v.spec))
        if len(v.shape) >= 2:
            fstate[k] = {"vr": f32(v.shape[:-1], sp[:-1]),
                         "vc": f32(v.shape[:-2] + v.shape[-1:],
                                   sp[:-2] + sp[-1:])}
        else:
            fstate[k] = {"v": f32(v.shape, sp)}
    return {"f": fstate}


def _map_plan(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_plan(v, fn) for k, v in tree.items()}
    return fn(*tree)


def opt_state_structs(cfg: ModelConfig, mesh, params=None) -> dict:
    """Each rank's optimizer-state shards as float32 meta tensors.
    (`params` is accepted for the JAX package's signature.)"""
    return _map_plan(opt_state_plan(cfg, mesh),
                     lambda shape, sh: _struct(shape, torch.float32, sh))


def batch_structs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Each rank's shard of the step's inputs (input_specs), the batch dim
    on ("pod", "data")."""
    out = {}
    for k, t in MZ.input_specs(cfg, shape).items():
        sp = (BATCH_AXES,) + (None,) * (t.dim() - 1)
        out[k] = _struct(t.shape, t.dtype, shard(mesh, sp, tuple(t.shape)))
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """The decode caches' tree (init_cache's layout) with (global meta
    tensor, Sharding) leaves; see the module docstring for the rules."""
    b, s = shape.global_batch, shape.seq_len
    long = b < mesh.shape.get("data", 1)      # can't shard batch: long_500k
    caches = MZ.init_cache(cfg, b, s, device="meta")

    def kv_spec(ndim, seq_axis, batch_axis, head_axis):
        sp = [None] * ndim
        if long:
            sp[seq_axis] = "data"
            sp[head_axis] = "model"
        else:
            sp[batch_axis] = "data"
            sp[seq_axis] = "model"
        return sp

    def annotate(t):
        shp = tuple(t.shape)
        nd = len(shp)
        sp = [None] * nd
        if cfg.family in ("dense", "vlm", "moe", "encdec"):
            # (L, B, S, Hkv, hd); encdec cross caches have S = encoder_seq
            sp = kv_spec(nd, 2, 1, 3)
        elif cfg.family == "ssm":
            # conv (L,B,K-1,di) / h (L,B,di,ns): shard di on model
            sp[1] = None if long else "data"
            di_axis = 3 if nd == 4 and shp[3] == cfg.d_inner else 2
            if shp[di_axis] == cfg.d_inner:
                sp[di_axis] = "model"
        elif cfg.family == "hybrid":
            if nd == 5 and shp[2] == s:           # attn kv (g,B,S,H,hd)
                sp = kv_spec(nd, 2, 1, 3)
            else:
                # mamba conv (g,a,B,K-1,di) / h (g,a,B,nh,hd,ns)
                sp[2] = None if long else "data"
                for ax, dim in enumerate(shp):
                    if ax >= 3 and dim in (cfg.d_inner, cfg.mamba2_heads):
                        sp[ax] = "model"
                        break
        return t, shard(mesh, tuple(sp), shp)

    def walk(node):
        if isinstance(node, tuple):
            return tuple(walk(c) for c in node)
        return annotate(node)
    return walk(caches)


def cache_structs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Each rank's shard of the decode caches, as meta tensors."""
    def walk(node):
        if isinstance(node, tuple) and not isinstance(node[1], Sharding):
            return tuple(walk(c) for c in node)
        t, sh = node
        return _struct(t.shape, t.dtype, sh)
    return walk(cache_specs(cfg, shape, mesh))


# ------------------------------------------------- the sharded COPML engine

def copml_state_structs(proto, mesh) -> list:
    """The CopmlState each rank of a `mesh` (a ClientMesh, or its size P)
    holds, as meta tensors: no memory is touched.

    The client axis is zero-padded to n_pad = ceil(N/P)*P and split into P
    blocks of n_pad/P rows, the layout Copml._train_sharded deals:
    w_shares and xty_shares (n_pad,) + w_shape, coded_x (n_pad,
    ceil(m/K), d), all int32.  Returns one CopmlState a rank."""
    size = int(getattr(mesh, "size", mesh))
    n, d = proto.cfg.n_clients, proto.d
    n_pad = -(-n // size) * size
    mk = -(-proto.m // proto.cfg.k)

    def blocks(*shape):
        return torch.empty(shape, dtype=torch.int32,
                           device="meta").split(n_pad // size)

    w, cx, xty = (blocks(n_pad, *proto.w_shape), blocks(n_pad, mk, d),
                  blocks(n_pad, *proto.w_shape))
    return [CopmlState(w_shares=w[r], coded_x=cx[r], xty_shares=xty[r])
            for r in range(size)]
