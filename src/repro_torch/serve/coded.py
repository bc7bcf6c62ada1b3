"""Encode-once coded inference on a secret-shared model.

The serving-side counterpart of the protocol's encode-once/compute-many
training structure: the trained model is re-shared ONCE into per-client
Shamir shares packed for the field GEMM, and every incoming query batch is
scored against those shares without ever opening the model.

Why this is secure *and* exact: Shamir sharing is mod-p linear, so each
client's LOCAL field matmul  xq @ w_share_i  is itself a share of the
score polynomial evaluated at that client's point, and reconstructing
the per-query logits from any T+1 of them yields exactly  xq @ wq mod p
-- bit-identical to the quantized reference scorer `reference_scores`.
The model never exists in the clear on the serving path; only per-query
logits pass through `open_logits`.

Encode path:

* a COPML TrainResult carries the protocol's final state
  (CopmlState.w_shares, shares at the protocol's serving lambdas):
  `encode_model` degree-refreshes them with `shamir.reshare` at those
  SAME points -- the model secret is never reconstructed in between;
* results without share state (float baselines, secure_agg) fall back to
  quantize + fresh `shamir.share` of the opened weights -- still served
  from shares, but the encode step sees the clear model (flagged in the
  CodedModel as `from_shares=False`).
* an mpc_baseline result's MpcState also has w_shares, but they are N/G
  subgroup shares: re-sharing them to N clients does not give an (N, d,
  C') stack, and encode_model raises, as the JAX package's does.

The packed `w_cols` layout (d, N*C') turns per-batch scoring for ALL N
clients and C' model columns into ONE field GEMM (kernels.ops.modmatmul,
the hand-written CUDA kernel on the card).  `sharded_scorer` splits the
clients over a core/meshutil ClientMesh instead: each rank scores its own
clients' shares, and only the opened logits cross ranks.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from .. import obs
from ..core import field, meshutil, quantize, shamir
from ..core.baselines import sync_clock, to_device
from ..core.labels import Opened, Public, Share
from ..core.protocol import _pad_clients, resolve_device
from ..kernels import ops


def serving_points(cfg) -> tuple:
    """The share evaluation points of a CopmlState's w_shares: the
    protocol's serving lambdas (core/protocol.Copml.__init__), disjoint
    from the K+T encoding betas and the N coding alphas."""
    n, k, t = cfg.n_clients, cfg.k, cfg.t
    return tuple(range(k + t + 1 + n, k + t + 1 + 2 * n))


@dataclasses.dataclass
class CodedModel:
    """The encode-once serving artifact: per-client model shares, packed.

    w_stack is the canonical (N, d, C') share stack (C' = 1 for vector
    models); w_cols is the SAME shares laid out (d, N*C') so one field
    GEMM scores a whole query batch for every client and class at once.
    Both are secret -- only `open_logits` may leave the share domain."""
    w_stack: Share            # (N, d, C') per-client shares of wq
    w_cols: Share             # (d, N*C') the packed scoring layout
    n: int                    # clients (shareholders)
    t: int                    # privacy threshold: any T+1 shares open
    points: tuple             # share evaluation points (len N)
    d: int                    # feature dimension
    out_shape: tuple          # () vector model | (C,) matrix model
    lx: int                   # query quantization scale
    lw: int                   # model quantization scale
    from_shares: bool         # True: re-shared protocol state, model
    #                           never opened on the encode path
    encode_s: float           # wall seconds of the one-time encode

    @property
    def n_cols(self) -> int:
        """C': model columns served per query (1 for vector models)."""
        return self.out_shape[0] if self.out_shape else 1

    @property
    def lz(self) -> int:
        """Scale of the opened field logits: lx + lw."""
        return self.lx + self.lw

    @property
    def device(self) -> torch.device:
        return self.w_cols.device


def encode_model(key, result, cfg, objective, device=None) -> CodedModel:
    """One-time model encode: TrainResult -> CodedModel on `device` (the
    card unless the caller asks for the CPU).

    Prefers the protocol's share state (reshare at the protocol's serving
    lambdas -- fresh randomness, same secret, model never opened); falls
    back to quantize+share of the opened weights."""
    dev = resolve_device(device)
    n, t = cfg.n_clients, cfg.t
    d = int(np.shape(result.weights)[0])
    out_shape = tuple(objective.out_shape)
    cols = out_shape[0] if out_shape else 1

    w_shares = getattr(getattr(result, "state", None), "w_shares", None)
    t0 = sync_clock(dev)
    if w_shares is not None:
        points = serving_points(cfg)
        shares = shamir.reshare(key, w_shares.to(dev), t, n, points)
        from_shares = True
    else:
        points = shamir.default_eval_points(n)
        wq = quantize.quantize(np.array(result.weights, np.float32), cfg.lw,
                               dev)
        shares = shamir.share(key, wq, t, n, points)
        from_shares = False
    w_stack = shares.reshape(n, d, cols)
    # row-major (a view with column stride d at C' = 1 otherwise), so the
    # scoring GEMM reads B's columns coalesced on the split-K path
    w_cols = w_stack.movedim(0, 1).reshape(d, n * cols).contiguous()
    encode_s = sync_clock(dev) - t0
    return CodedModel(w_stack=w_stack, w_cols=w_cols, n=n, t=t,
                      points=points, d=d, out_shape=out_shape,
                      lx=cfg.lx, lw=cfg.lw, from_shares=from_shares,
                      encode_s=encode_s)


def quantize_queries(model: CodedModel, queries) -> Public:
    """Float query batch (B, d) -> field domain at the data scale lx, on
    the model's device (span `serve.quantize`)."""
    with obs.span("serve.quantize"):
        x = to_device(queries, torch.float32, model.device)
        assert x.dim() == 2 and x.shape[1] == model.d, (tuple(x.shape),
                                                         model.d)
        return quantize.quantize(x, model.lx)


def score_shares(model: CodedModel, xq: Public) -> Share:
    """Per-client share of the query logits: ONE packed field GEMM.

    xq: (B, d) quantized queries.  Returns (N, B, C') -- client i's rows
    are Shamir shares (at points[i]) of the logit matrix xq @ wq, because
    sharing commutes with the mod-p linear map xq @ (.)."""
    bsz = xq.shape[0]
    z = ops.modmatmul(xq, model.w_cols)                 # (B, N*C')
    # client-major in memory, so open_logits' (1, T+1) @ (T+1, B C')
    # reads unit-stride columns (the thin GEMM path)
    return z.view(bsz, model.n, model.n_cols).movedim(1, 0).contiguous()


def open_logits(z_shares: Share, model: CodedModel) -> Opened:
    """THE serving declassify sink: reconstruct per-query logits only.

    Any T+1 client scores interpolate to the exact field logits
    xq @ wq mod p, shape (B, C').  Nothing model-shaped is ever opened
    here -- (B, C') is public output, the model stays (N, d, C') shares."""
    return shamir.reconstruct(z_shares, model.t, model.points)


def score_open(model: CodedModel, queries) -> tuple:
    """Quantize -> share-score -> open: (field logits, float logits).

    Field logits are (B, C') int32 at scale lx + lw (bit-exact vs
    `reference_scores`); float logits are their dequantization."""
    xq = quantize_queries(model, queries)
    zf = open_logits(score_shares(model, xq), model)
    return zf, quantize.dequantize(zf, model.lz)


def sharded_scorer(model: CodedModel, mesh: meshutil.ClientMesh):
    """A scoring fn with the client axis SPLIT over a ClientMesh: the
    model's share rows go to the ranks once (zero rows past the last
    client); per window every rank scores its clients locally, one field
    GEMM (B, d) @ (d, n_loc*C'), and the window is OPENed by all-gather
    and reconstruct.  Returns fn(queries float (B, d)) -> Opened field
    logits (B, C') on the model's device, the bits of score_open's."""
    n_loc = -(-model.n // mesh.size)
    # zero rows past the last client: excluded from every reconstruct
    w_stack = _pad_clients(model.w_stack.cpu(), n_loc * mesh.size)
    handle = mesh.new_handle()
    spec = dict(n=model.n, t=model.t, points=model.points, lx=model.lx)
    mesh.run(_rank_keep_shares, handle, spec,
             per_rank=[[rows] for rows in w_stack.split(n_loc)])

    def fn(queries):
        x = np.asarray(queries.cpu() if isinstance(queries, torch.Tensor)
                       else queries, np.float32)
        assert x.ndim == 2 and x.shape[1] == model.d, (x.shape, model.d)
        return mesh.run(_rank_score, handle, x)[0].to(model.device)

    finalizer = weakref.finalize(fn, _drop_shares, mesh, handle)
    finalizer.atexit = False
    return fn


def _drop_shares(mesh, handle) -> None:
    if not mesh.closed:
        mesh.run(_rank_drop, handle)


def _rank_keep_shares(rank, handle, spec: dict, w_rows) -> None:
    """Keep this rank's (n_loc, d, C') share rows in the packed scoring
    layout (d, n_loc*C') on its device."""
    n_loc, d, cols = w_rows.shape
    w_cols = w_rows.to(rank.device).movedim(0, 1).reshape(d, n_loc * cols)
    rank.state[handle] = dict(spec, w_cols=w_cols.contiguous(), cols=cols,
                              n_loc=n_loc)


def _rank_score(rank, handle, queries):
    """One window on one rank: quantize, score the local clients, OPEN by
    all-gather; rank 0 returns the (B, C') field logits."""
    st = rank.state[handle]
    xq = quantize.quantize(queries, st["lx"], rank.device)
    z = ops.modmatmul(xq, st["w_cols"])                  # (B, n_loc*C')
    z = z.view(xq.shape[0], st["n_loc"], st["cols"]).movedim(1, 0)
    z_all = meshutil.all_gather_clients(z.contiguous(), rank)[:st["n"]]
    if rank.rank != 0:
        return None
    return shamir.reconstruct(z_all, st["t"], st["points"]).cpu()


def _rank_drop(rank, handle) -> None:
    rank.state.pop(handle, None)


def reference_scores(weights, queries, cfg, device="cpu") -> Public:
    """The quantized reference scorer the secure path must match BIT FOR
    BIT: quantize the OPENED model and the queries exactly as the secure
    path does, one clear field matmul (on `device`; the plain version on
    the CPU).  (d,) models score as one column; returns (B, C') int32
    field logits at scale lx + lw."""
    w = to_device(weights, torch.float32, device)
    wq = quantize.quantize(w.reshape(w.shape[0], -1), cfg.lw)
    xq = quantize.quantize(to_device(queries, torch.float32, device), cfg.lx)
    return field.matmul(xq, wq)
