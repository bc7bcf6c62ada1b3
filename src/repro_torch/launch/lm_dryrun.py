"""The LM archs' dry-run cells: a model of one rank of a production mesh,
and one step executed at SMOKE.

Per cell (arch x shape x pod/multipod), the JAX package's defaults
(launch/dryrun.py): a train cell takes microbatch = global batch / 8 and
a loss chunk of 512; a decode cell shards the weights over 'data' too
(inference FSDP) when params x 2 / model > 2^32; otherwise FSDP follows
partition.default_fsdp.

MODELLED (a mesh this machine does not have; nothing is measured):
  * state bytes a rank: the shards of sharding/partition's structs --
    parameters, optimizer state (train), the batch, decode caches;
  * work: roofline.lm_train_work / lm_prefill_work / lm_decode_work for
    the global step, spread evenly: compute term = ops / (chips x
    BF16_FLOPS_PER_S); memory term = (the weights' bytes over the
    model axis, plus every other byte over all chips) / HBM_BYTES_PER_S;
  * collective bytes a rank, from the specs, ring algorithms on an axis
    of n ranks ((n-1)/n of the operand a rank for an all-gather or a
    reduce-scatter, twice that for an all-reduce):
      - data axes (pod x data = D): train all-reduces its model shard's
        gradients (W/M bytes), or with FSDP all-gathers the weights in
        forward and again in backward and reduce-scatters the gradients;
        prefill and decode all-gather the weights with FSDP;
      - model axis (M): two all-reduces a layer of the rank's
        activations (tokens x d_model x the type's bytes; tokens =
        B x S / D, at least 1 a sequence), in forward, and in a train
        step also in backward and once more under remat;
    collective term = data bytes / LINK_BYTES_PER_S["ndr400"] + model
    bytes / LINK_BYTES_PER_S["nvlink4"] (the data axes span hosts, the
    model axis a host's NVLink).
  * model_flops: the JAX package's useful-work count.
MEASURED (execute_ranks > 0): one step of the arch's SMOKE config on the
device: train_step (B = 4, S = 32, microbatch 2, loss chunk 16),
prefill_step (B = 2, S = 32) or decode_step (B = 2, a cache 32 long) --
wall ms after a device sync, the device's peak bytes, finite outputs.
"""

from __future__ import annotations

import time

import torch

from ..configs import registry
from ..core.protocol import resolve_device
from ..models import model_zoo as MZ
from ..models.config import ALL_SHAPES, applicable_shapes
from ..optim import optimizers
from ..sharding import partition
from . import mesh as mesh_lib
from . import roofline as RL

DEFAULT_MICROBATCH_DIV = 8   # global batch / 8 per accumulation step
DEFAULT_LOSS_CHUNK = 512     # seq-chunked CE: never materialize (B, S, V)
SHAPES = {s.name: s for s in ALL_SHAPES}
SKIPPED = "skipped (full attention at 500k context)"
#: the executed SMOKE step's shapes
EXEC_TRAIN = dict(batch=4, seq=32, microbatch=2, loss_chunk=16)
EXEC_PREFILL = dict(batch=2, seq=32)
EXEC_DECODE = dict(batch=2, cache=32)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _ring(n: int, nbytes: float, all_reduce: bool = False) -> float:
    """Bytes a rank sends in a ring collective over n ranks."""
    if n <= 1:
        return 0.0
    return (2.0 if all_reduce else 1.0) * (n - 1) / n * nbytes


def model_record(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The modelled numbers of one cell (see the module docstring)."""
    cfg = registry.get_config(arch)
    shape = SHAPES[shape_name]
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    m_ax = mesh.shape.get("model", 1)
    d_ax = chips // m_ax
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        fsdp = cfg.param_count() * 2 / m_ax > 2 ** 32
    else:
        fsdp = partition.default_fsdp(cfg, mesh)
    params = partition.param_structs(cfg, mesh, fsdp=fsdp)
    state = {"params": _nbytes(params),
             "batch": _nbytes(partition.batch_structs(cfg, shape, mesh))}
    microbatch = loss_chunk = 0
    if shape.kind == "train":
        microbatch = max(1, b // DEFAULT_MICROBATCH_DIV)
        loss_chunk = DEFAULT_LOSS_CHUNK
        state["opt_state"] = _nbytes(partition.opt_state_structs(cfg, mesh))
        ops, nbytes = RL.lm_train_work(cfg, b, s, cfg.remat)
        wbytes = 2 * RL._lm_terms(cfg)["weight_bytes"]
    elif shape.kind == "prefill":
        ops, nbytes = RL.lm_prefill_work(cfg, b, s)
        wbytes = RL._weight_bytes(cfg, RL._lm_terms(cfg), b * s)
    else:
        state["caches"] = _nbytes(partition.cache_structs(cfg, shape, mesh))
        ops, nbytes = RL.lm_decode_work(cfg, b, s)
        wbytes = RL._weight_bytes(cfg, RL._lm_terms(cfg), b)
    state["total"] = sum(state.values())

    w_rank = RL._lm_terms(cfg)["weight_bytes"] / m_ax
    seq = 1 if shape.kind == "decode" else s
    tokens = max(b * seq / d_ax, seq)
    elem = 4 if cfg.dtype == "float32" else 2
    act = 2 * cfg.n_layers * _ring(m_ax, tokens * cfg.d_model * elem, True)
    if shape.kind == "train":
        data = _ring(d_ax, w_rank, all_reduce=not fsdp)
        if fsdp:
            data += 2 * _ring(d_ax, w_rank)
        act *= 3 if cfg.remat else 2
    else:
        data = _ring(d_ax, w_rank) if fsdp else 0.0
    compute_s = ops / (chips * RL.BF16_FLOPS_PER_S)
    memory_s = (wbytes / m_ax + (nbytes - wbytes) / chips) / \
        RL.HBM_BYTES_PER_S
    collective_s = data / RL.LINK_BYTES_PER_S["ndr400"] + \
        act / RL.LINK_BYTES_PER_S["nvlink4"]
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    mflops = RL.model_flops(cfg, shape)
    bound_s = max(terms.values())
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "multipod" if multi_pod else "pod", "chips": chips,
        "status": "ok", "kind": shape.kind, "modelled": True,
        "microbatch": microbatch, "loss_chunk": loss_chunk, "fsdp": fsdp,
        "bytes_per_rank": state, "ops": ops, "bytes": nbytes,
        "model_flops": mflops,
        "coll_bytes_per_rank": {"data": data, "model": act},
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": max(terms, key=terms.get),
        "useful_flops_ratio": mflops / ops if ops else 0.0,
        "roofline_fraction": (mflops / (chips * RL.BF16_FLOPS_PER_S)
                              / bound_s) if bound_s else 0.0,
    }


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute_smoke(arch: str, kind: str, device=None, seed: int = 0) -> dict:
    """One step of the arch's SMOKE config of `kind` on `device` (the card
    unless device="cpu"): wall ms after a sync, peak device bytes (None
    on the CPU), and whether its outputs are finite."""
    device = resolve_device(device)
    cfg = registry.smoke_config(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    cpu_gen = torch.Generator().manual_seed(seed)
    params = MZ.build(cfg).init_params(gen, device=device)

    def ints(*shape):
        return torch.randint(0, cfg.vocab, shape, generator=cpu_gen,
                             dtype=torch.int32).to(device)

    def frontier(bsz):
        fs = MZ._frontier_shape(cfg, bsz)
        if fs is None:
            return {}
        return {"frontier": (0.5 * torch.randn(fs, generator=cpu_gen)).to(
            device=device, dtype=cfg.torch_dtype)}

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    t0 = time.perf_counter()
    if kind == "train":
        e = EXEC_TRAIN
        bm = MZ.build(cfg, microbatch=e["microbatch"],
                      loss_chunk=e["loss_chunk"])
        batch = {"tokens": ints(e["batch"], e["seq"]),
                 "labels": ints(e["batch"], e["seq"]),
                 "mask": torch.ones((e["batch"], e["seq"]),
                                    device=device), **frontier(e["batch"])}
        opt_state = optimizers.make(cfg.optimizer).init(params)
        _, _, met = bm.train_step(params, opt_state, batch, 0)
        outs = [met["loss"], met["grad_norm"]]
        shape = (e["batch"], e["seq"])
    elif kind == "prefill":
        e = EXEC_PREFILL
        logits, _ = MZ.build(cfg).prefill_step(
            params, {"tokens": ints(e["batch"], e["seq"]),
                     **frontier(e["batch"])})
        outs = [logits]
        shape = (e["batch"], e["seq"])
    else:
        e = EXEC_DECODE
        caches = MZ.init_cache(cfg, e["batch"], e["cache"], device)
        logits, _ = MZ.build(cfg).decode_step(
            params, caches, ints(e["batch"], 1), e["cache"] // 2)
        outs = [logits]
        shape = (e["batch"], e["cache"])
    finite = all(bool(torch.isfinite(o.float()).all()) for o in outs)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    return {"device": str(device), "kind": kind, "shape": list(shape),
            "ms": ms, "peak_bytes": peak, "finite": finite}


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                execute_ranks: int = 4, device=None) -> dict:
    """One LM cell: the model, and (execute_ranks > 0) one SMOKE step of
    the cell's kind executed on `device`."""
    mesh_name = "multipod" if multi_pod else "pod"
    cfg = registry.get_config(arch)
    if shape_name not in SHAPES or \
            SHAPES[shape_name] not in applicable_shapes(cfg):
        status = SKIPPED if shape_name in SHAPES else \
            f"skipped (no {shape_name} shape for an LM arch)"
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": status}
    rec = model_record(arch, shape_name, multi_pod)
    bpr = rec["bytes_per_rank"]
    print(f"--- {arch} x {shape_name} x {mesh_name}({rec['chips']}) ---")
    print("model: state a rank " + " ".join(
        f"{k}={v / 2 ** 30:.3f}GiB" for k, v in bpr.items())
        + f" fsdp={rec['fsdp']} microbatch={rec['microbatch']} "
        f"loss_chunk={rec['loss_chunk']}")
    print(f"model: ops={rec['ops']:.3e} bytes={rec['bytes']:.3e} "
          f"model_flops={rec['model_flops']:.3e} coll_bytes/rank "
          f"data={rec['coll_bytes_per_rank']['data']:.3e} "
          f"model={rec['coll_bytes_per_rank']['model']:.3e}")
    print(f"model roofline: compute={rec['compute_s'] * 1e3:.3f}ms "
          f"memory={rec['memory_s'] * 1e3:.3f}ms "
          f"collective={rec['collective_s'] * 1e3:.3f}ms "
          f"dominant={rec['dominant']} "
          f"useful_ratio={rec['useful_flops_ratio']:.3f} "
          f"roofline_frac={rec['roofline_fraction']:.3f}")
    if execute_ranks:
        ex = execute_smoke(arch, rec["kind"], device)
        rec["executed"] = ex
        peak = "not measured (CPU)" if ex["peak_bytes"] is None else \
            f"{ex['peak_bytes'] / 2 ** 20:.1f}MiB"
        print(f"executed: SMOKE {ex['kind']} step {tuple(ex['shape'])} on "
              f"{ex['device']}: {ex['ms']:.1f}ms, peak {peak}, "
              f"finite={ex['finite']}")
        if not ex["finite"]:
            raise FloatingPointError(f"{arch} x {shape_name}: the executed "
                                     "step's outputs are not finite")
    return rec

