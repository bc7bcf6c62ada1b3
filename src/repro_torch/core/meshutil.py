"""The client mesh: D rank processes on one torch.distributed group.

The JAX package's mesh is one process driving D devices, and its sharded
engine is a shard_map program over a 1-D ("clients",) axis.  Here the axis
is D OS processes, one per shard, joined in one 1-D process group:

* `ClientMesh` starts the ranks once (torch.multiprocessing, spawn: a
  process holding a CUDA context is never forked) and dispatches SPMD
  calls to them: `mesh.run(fn, ...)` sends a module-level function and its
  arguments to every rank and returns every rank's result.  CPU tensors
  travel through torch.multiprocessing's shared memory.  Each rank keeps
  state between calls in `Rank.state`, under a handle from the caller.
* The collectives (`psum_scatter_mod`, `all_gather_clients`,
  `all_to_all_clients`, and the ring forms `ring_reduce_scatter_mod` /
  `ring_all_to_all`) run inside a rank's call on its `Rank`.

Backend and devices, by a fixed rule (`mesh.backend`, `mesh.devices`):
NCCL when the device is CUDA and there are at least D cards (rank r on
cuda:r); gloo otherwise.  gloo with a CUDA device puts every rank on that
card: its tensors and kernels stay there, and each collective copies its
operand to the host and back.  Asking for NCCL with fewer cards than
ranks raises.

The mod-p reductions rely on field elements being canonical in [0, p): a
raw int32 sum of D partial sums stays below D * p < 2^31 for D <= 31, so
one fold26 after the collective gives the canonical representative, the
bits of the same contraction on one device.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import datetime
import itertools
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing

from ..kernels import build
from . import field

# ------------------------------------------------ the LM stack's named mesh
#
# The JAX package's LM stack names a (data, model) -- or (pod, data, model)
# -- device mesh, and its sharding rules (sharding/partition.py) and
# GSPMD hints (maybe_constrain) read the mesh's axis sizes.  The port keeps
# the mesh as a value: axis names and sizes, no process group and no
# devices (the port's LM trainer runs on one card, where the mesh is 1x1;
# the dry run prices the production meshes from their sizes alone).


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named device mesh: .shape (axis -> size, in axis order),
    .axis_names and .size."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def make_mesh(shape, axes) -> Mesh:
    """The mesh of `shape` over axis names `axes`."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    return Mesh(axes, shape)


_ACTIVE: list = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Context manager making `mesh` the active one (active_mesh())."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The innermost set_mesh's mesh, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def maybe_constrain(x, *spec):
    """The JAX package's GSPMD sharding hint (spec: one entry a dimension).
    The port partitions no step, so under no mesh or a one-device mesh
    (set_mesh) it is the identity; under a larger mesh it raises rather
    than leave the step unsharded without a word."""
    mesh = active_mesh()
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(
            f"sharding {spec} over a mesh of {mesh.size} devices: the port "
            f"runs a step on one device")
    return x

# name of the 1-D mesh axis the sharded engine splits clients over
CLIENT_AXIS = "clients"

# raw int32 sum of canonical field elements must not wrap: D * (p-1) <
# 2^31.  Wider meshes take the two-limb reduction (see _reduce_mod).
NARROW_SHARDS = 31

#: seconds a rank waits in a collective (the process group's timeout) and
#: the caller waits for the ranks of one call
DEFAULT_TIMEOUT_S = 600.0


class RankFailure(RuntimeError):
    """A rank raised, died or missed the deadline; the mesh is closed."""

    def __init__(self, rank: int, message: str):
        super().__init__(f"mesh rank {rank}: {message}")
        self.rank = rank


def choose_backend(size: int, device: torch.device,
                   backend: str | None = None) -> str:
    """NCCL when the device is CUDA and there is a card for every rank,
    gloo otherwise; an explicit `backend` is checked, not overridden."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    fits = device.type == "cuda" and cards >= size
    if backend is None:
        return "nccl" if fits else "gloo"
    if backend == "nccl" and not fits:
        raise ValueError(
            f"backend='nccl' needs a CUDA card for each of the {size} "
            f"ranks; {device} has {cards} card(s) (NCCL refuses two ranks "
            f"on one card: use backend='gloo')")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    return backend


def rank_devices(size: int, device: torch.device, backend: str) -> list:
    """Rank r's device: cuda:r on NCCL, the mesh's device otherwise."""
    if backend == "nccl":
        return [torch.device("cuda", r) for r in range(size)]
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
    return [device] * size


@dataclasses.dataclass
class Rank:
    """What a rank's call gets: its place in the mesh, its device, and the
    state it keeps between calls.  `sent_bytes` counts the bytes each kind
    of collective sent to other ranks."""
    rank: int
    size: int
    device: torch.device
    backend: str
    state: dict = dataclasses.field(default_factory=dict)
    sent_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def staged(self) -> bool:
        """gloo on a CUDA device: collectives go through host copies."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _rank_main(index: int, conns, store_path: str, size: int, backend: str,
               devices: list, timeout_s: float) -> None:
    """A rank's process: join the group, then run calls until told to
    stop.  Every failure is sent to the caller with its traceback."""
    conn = conns[index]
    # a mesh is one host: its ranks rendezvous and talk over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    try:
        dev = devices[index]
        if dev.type == "cuda":
            cards = torch.cuda.device_count() if \
                torch.cuda.is_available() else 0
            if (dev.index or 0) >= cards:
                raise RuntimeError(
                    f"rank {index} was given {dev} but sees {cards} CUDA "
                    f"device(s)")
            torch.cuda.set_device(dev)
        else:
            # one thread a rank: D ranks share the host's cores, and every
            # value is an exact int, so the thread count cannot change a bit
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, size), rank=index,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
        ctx = Rank(index, size, dev, backend)
        conn.send(("ok", str(dev)))
    except Exception:  # noqa: BLE001 -- report ANY failure to the caller
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            fn, args = msg
            try:
                conn.send(("ok", fn(ctx, *args)))
            except Exception:  # noqa: BLE001 -- report, the caller closes
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class ClientMesh:
    """D rank processes on one 1-D process group (see the module doc).

    Build through `client_mesh`, which caches one mesh per (D, device,
    backend) and closes every mesh at exit."""

    def __init__(self, size: int, device, backend: str | None = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        if size < 1:
            raise ValueError(f"a mesh needs >= 1 rank, got {size}")
        self.size = int(size)
        self.device = torch.device(device)
        self.backend = choose_backend(self.size, self.device, backend)
        self.devices = rank_devices(self.size, self.device, self.backend)
        self.timeout_s = float(timeout_s)
        self._handles = itertools.count()
        if self.device.type == "cuda" and torch.cuda.is_available():
            build.build_all()        # never D nvcc runs in one build dir
        self._dir = tempfile.mkdtemp(prefix="repro-mesh-")
        ctx = torch.multiprocessing.get_context("spawn")
        pipes = [ctx.Pipe() for _ in range(self.size)]
        self._conns = [p[0] for p in pipes]
        try:
            self._procs = torch.multiprocessing.start_processes(
                _rank_main,
                args=([p[1] for p in pipes], os.path.join(self._dir, "store"),
                      self.size, self.backend, self.devices, self.timeout_s),
                nprocs=self.size, join=False, start_method="spawn").processes
        except BaseException:
            shutil.rmtree(self._dir, ignore_errors=True)
            raise
        finally:
            for p in pipes:
                p[1].close()
        self.closed = False
        self._collect()                  # every rank joined the group

    def new_handle(self) -> int:
        """A fresh key for state the ranks keep between calls."""
        return next(self._handles)

    def run(self, fn, *args, per_rank=None) -> list:
        """Call fn(rank, *args, *per_rank[r]) on every rank r; returns
        the results in rank order.  `fn` is a module-level function; a
        rank that raises makes this raise RankFailure (with its number and
        traceback) and closes the mesh."""
        if self.closed:
            raise RuntimeError("this mesh is closed")
        for r, conn in enumerate(self._conns):
            extra = () if per_rank is None else tuple(per_rank[r])
            conn.send((fn, args + extra))
        return self._collect()

    def _collect(self) -> list:
        results = [None] * self.size
        pending = set(range(self.size))
        deadline = time.monotonic() + self.timeout_s
        try:
            while pending:
                left = deadline - time.monotonic()
                waits = {self._conns[r]: r for r in pending}
                waits.update({self._procs[r].sentinel: r for r in pending})
                ready = multiprocessing.connection.wait(list(waits),
                                                        max(left, 0))
                if not ready:
                    raise RankFailure(min(pending), (
                        f"no answer within {self.timeout_s:.0f} s (ranks "
                        f"{sorted(pending)} pending)"))
                for obj in ready:
                    r = waits[obj]
                    if r not in pending:
                        continue
                    conn = self._conns[r]
                    if obj is not conn and not conn.poll():
                        raise RankFailure(r, (
                            f"process exited with code "
                            f"{self._procs[r].exitcode}"))
                    status, payload = conn.recv()
                    if status == "err":
                        raise RankFailure(r, "raised\n" + payload)
                    results[r] = payload
                    pending.discard(r)
        except BaseException:
            self.close()
            raise
        return results

    def close(self) -> None:
        """Stop every rank (killing any still blocked in a collective) and
        remove the rendezvous files."""
        if self.closed:
            return
        self.closed = True
        if _MESHES.get(self._key) is self:
            del _MESHES[self._key]
        for conn in self._conns:
            try:
                conn.send(None)
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    @property
    def _key(self) -> tuple:
        return (self.size, str(self.device), self.backend)


_MESHES: dict = {}


def client_mesh(n_devices: int | None = None, device=None,
                backend: str | None = None) -> ClientMesh:
    """The 1-D ("clients",) mesh of `n_devices` ranks on `device` (the card
    unless the caller asks for the CPU; None: one rank per card, or one on
    the CPU).  Cached per (D, device, backend): repeated fits reuse the
    ranks; every mesh is closed at exit."""
    from .protocol import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if n_devices is None:
        n_devices = max(1, torch.cuda.device_count()) \
            if dev.type == "cuda" else 1
    key = (int(n_devices), str(dev), choose_backend(n_devices, dev, backend))
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = ClientMesh(n_devices, dev, key[2])
        _MESHES[key] = mesh
    return mesh


@atexit.register
def close_meshes() -> None:
    """Close every cached mesh (also run at exit)."""
    for mesh in list(_MESHES.values()):
        mesh.close()


# ------------------------------------------------------------ collectives
#
# Each runs inside a rank's call, on its Rank, and takes and returns
# tensors on the rank's device.  Which torch names exist depends on the
# version: newer ones name the single-tensor forms *_single.

_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _host(rank: Rank, x: torch.Tensor) -> torch.Tensor:
    return (x.cpu() if rank.staged else x).contiguous()


def _back(rank: Rank, x: torch.Tensor) -> torch.Tensor:
    return x.to(rank.device) if rank.staged else x


def _reduce_mod(x, rank: Rank, nshards: int, reducer):
    """Exact mod-p cross-rank reduction of canonical field elements.

    nshards <= NARROW_SHARDS: one raw int32 reduction (sum < D*p < 2^31),
    one fold26.  Wider: reduce the 13-bit halves apart (sums < D*2^13)
    and recombine with field ops; everything is mod-p linear, so the value
    is the same canonical one."""
    if nshards <= NARROW_SHARDS:
        return field.fold26(reducer(x))
    lo = x & ((1 << 13) - 1)
    hi = x >> 13
    return field.add(field.mul_scalar(field.fold26(reducer(hi)), 1 << 13),
                     field.fold26(reducer(lo)))


def psum_scatter_mod(x, rank: Rank, nshards: int | None = None):
    """Mod-p reduce-scatter over the leading axis (which D divides): rank
    r gets chunk r of the sum over ranks.  `nshards` forces the branch
    (None: the mesh's size)."""
    d = rank.size

    def reducer(v):
        src = _host(rank, v)
        out = src.new_empty((src.shape[0] // d,) + tuple(src.shape[1:]))
        rank.sent_bytes["reduce_scatter"] += \
            src.numel() * src.element_size() * (d - 1) // d
        _reduce_scatter(out, src, op=dist.ReduceOp.SUM)
        return _back(rank, out)

    return _reduce_mod(x, rank, nshards or d, reducer)


def all_gather_clients(x, rank: Rank):
    """Concatenate every rank's leading axis in rank order (OPEN step)."""
    src = _host(rank, x)
    out = src.new_empty((src.shape[0] * rank.size,) + tuple(src.shape[1:]))
    rank.sent_bytes["all_gather"] += \
        src.numel() * src.element_size() * (rank.size - 1)
    _all_gather(out, src)
    return _back(rank, out)


def all_to_all_clients(x, rank: Rank):
    """Owner<->holder transpose (EXCHANGE step): (n_pad, n_loc, ...) on
    every rank -> (n_loc, n_pad, ...), the JAX package's all_to_all with
    split_axis=0, concat_axis=1: chunk j of the leading (holder) axis goes
    to rank j, and the chunks received stand side by side on axis 1 in
    source-rank order."""
    d = rank.size
    src = _host(rank, x)
    out = torch.empty_like(src)
    rank.sent_bytes["all_to_all"] += \
        src.numel() * src.element_size() * (d - 1) // d
    dist.all_to_all_single(out, src)
    n_loc = src.shape[0] // d
    # torch concatenates along dim 0: (src rank, n_loc holders, ...)
    got = out.view((d, n_loc) + tuple(src.shape[1:])).transpose(0, 1)
    return _back(rank, got.reshape((n_loc, d * src.shape[1])
                                   + tuple(src.shape[2:])))


def _exchange(rank: Rank, send: torch.Tensor, dst: int, src: int, kind: str):
    """Send `send` to rank dst while receiving a tensor of its shape from
    rank src (one hop of a ring)."""
    buf = _host(rank, send)
    recv = torch.empty_like(buf)
    rank.sent_bytes[kind] += buf.numel() * buf.element_size()
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, dst),
                                   dist.P2POp(dist.irecv, recv, src)])
    for req in reqs:
        req.wait()
    return _back(rank, recv)


# --------------------------------------------------------------------------
# Ring forms of the two EXCHANGE collectives.
#
# The monolithic reduce-scatter and all-to-all need the whole local
# contraction before any byte moves.  The ring forms take `segment_fn(j)` /
# `block_fn(j)`, which compute only rank j's slice of the local result, so
# each hop's operand is made just before its send and the GEMM for the next
# hop can run while a transfer is in flight.  Both give the bits of their
# monolithic twins: a row slice of a GEMM is the same contraction, and the
# ring's raw int32 sum is the same no-overflow integer sum in another order,
# with one fold26 at the end as on the narrow path.


def ring_reduce_scatter_mod(segment_fn, rank: Rank):
    """Mod-p reduce-scatter as a D-1 hop ring; rank r ends with
    fold26(sum over ranks s of s's segment_fn(r)).

    segment_fn(j) -> this rank's canonical partial destined for rank j.
    Needs D <= NARROW_SHARDS (the raw int32 sum must not wrap); callers
    take psum_scatter_mod beyond that."""
    d = rank.size
    assert d <= NARROW_SHARDS, d
    r = rank.rank
    if d == 1:
        return field.fold26(segment_fn(r))
    # rank r's chunk travels the whole ring: start with the partial for
    # rank r-1 (which r sends first), end holding the sum for rank r
    acc = segment_fn((r + d - 1) % d)
    for k in range(d - 1):
        acc = _exchange(rank, acc, (r + 1) % d, (r - 1) % d,
                        "ring_reduce_scatter")
        acc = acc + segment_fn((r + d - k - 2) % d)
    return field.fold26(acc)


def ring_all_to_all(block_fn, rank: Rank):
    """Owner<->holder transpose as D-1 hops; the bits of
    all_to_all_clients on the stacked blocks.

    block_fn(j) -> this rank's (n_loc, ...) block destined for rank j (rows
    j*n_loc..(j+1)*n_loc of the monolithic operand), computed just before
    its hop.  Returns the received blocks stacked on a NEW leading axis in
    source-rank order: (D, n_loc, ...)."""
    d = rank.size
    r = rank.rank
    received = [None] * d
    received[r] = block_fn(r)
    for k in range(1, d):
        received[(r - k) % d] = _exchange(
            rank, block_fn((r + k) % d), (r + k) % d, (r - k) % d,
            "ring_all_to_all")
    return torch.stack(received)
