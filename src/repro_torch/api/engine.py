"""Execution engines: the *how* axis of a run, with the JAX package's
names and parse rules.

An engine decides how a protocol's training loop executes, never WHAT is
computed:

  eager    Python loop, one step per iteration.
  jit      the same loop in the port (no CUDA graph yet); in the JAX
           package, the whole loop as one compiled XLA program.
  sharded  the client axis split over a core/meshutil ClientMesh: D rank
           processes on one torch.distributed group, each holding its
           clients' shares; every exchange is a real collective
           (all-to-all, reduce-scatter, all-gather).  COPML and serving.
  proc     N OS processes over real localhost TCP sockets
           (launch/runtime), each running its client group's kernels on
           the run's device; communication is MEASURED, not modeled, and
           stragglers emerge from network timing.  COPML only.

Engine kinds live in a registry (`register_kind` / `names`).  `EngineSpec`
is the value the front doors pass around; `parse` accepts the spec itself,
a plain string ("eager" | "jit" | "sharded[:N]" | "proc[:N]") or a
ClientMesh (sharded over it), and raises wherever the JAX package's
`parse` raises, so `fit` and `serve` refuse the same specs and record the
same `label`.  `net` is a launch.runtime NetConfig (the proc engine's link
model and timeout policy); `mesh` is a ClientMesh.
"""

from __future__ import annotations

import dataclasses

from ..core import meshutil
from ..launch.runtime.config import NetConfig  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class EngineKind:
    """One registered engine kind and what its specs may carry."""
    name: str
    doc: str
    takes_devices: bool = False     # accepts ":N" / devices=
    takes_mesh: bool = False        # accepts mesh=
    takes_net: bool = False         # accepts net=


KINDS: dict = {}


def register_kind(kind: EngineKind) -> EngineKind:
    """Add an engine kind to the registry (protocols opt in per kind via
    their `engines` tuple; registration only teaches spec parsing and the
    enumeration surfaces about the name)."""
    KINDS[kind.name] = kind
    return kind


def names() -> tuple:
    """The live engine-kind names, in registration order."""
    return tuple(KINDS)


register_kind(EngineKind(
    "eager", "Python loop, one step per iteration"))
register_kind(EngineKind(
    "jit", "the training loop as one program (a Python loop in the port)"))
register_kind(EngineKind(
    "sharded", "client axis sharded over a ('clients',) mesh",
    takes_devices=True, takes_mesh=True))
register_kind(EngineKind(
    "proc", "N OS processes over real TCP sockets (launch/runtime)",
    takes_devices=True, takes_net=True))

#: snapshot of the builtin kinds; enumeration surfaces should prefer the
#: live `names()` so later-registered kinds appear automatically
ENGINES = names()


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """One execution strategy.  `devices` is the shard/process count
    (sharded and proc); `mesh` (sharded only, a ClientMesh) wins over
    `devices`; `net` (proc only) is a launch.runtime NetConfig."""
    kind: str
    devices: int | None = None
    mesh: object | None = None
    net: object | None = None

    def __post_init__(self):
        info = KINDS.get(self.kind)
        if info is None:
            raise ValueError(
                f"unknown engine kind {self.kind!r}; expected one of "
                f"{names()}")
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if not (info.takes_devices or info.takes_mesh) and (
                self.devices is not None or self.mesh is not None):
            raise ValueError(f"engine {self.kind!r} takes no mesh/devices")
        if self.mesh is not None and not info.takes_mesh:
            raise ValueError(f"engine {self.kind!r} takes no mesh")
        if self.net is not None and not info.takes_net:
            raise ValueError(f"engine {self.kind!r} takes no net config")

    @property
    def label(self) -> str:
        """Stable row label: "jit" | "sharded:8" | "proc:4" | ..."""
        if self.mesh is not None:
            return f"{self.kind}:{self.mesh.size}"
        if self.devices is not None:
            return f"{self.kind}:{self.devices}"
        return self.kind

    def resolve_mesh(self, device=None) -> meshutil.ClientMesh:
        """The client mesh this spec runs on (sharded only): its own, or
        the cached mesh of `devices` ranks on `device`."""
        assert self.kind == "sharded", self.kind
        if self.mesh is not None:
            return self.mesh
        return meshutil.client_mesh(self.devices, device)


EAGER = EngineSpec("eager")
JIT = EngineSpec("jit")
SHARDED = EngineSpec("sharded")
PROC = EngineSpec("proc")


def parse(spec) -> EngineSpec:
    """Normalize a user-supplied engine spec to an EngineSpec."""
    if isinstance(spec, EngineSpec):
        return spec
    if isinstance(spec, meshutil.ClientMesh):
        return EngineSpec("sharded", mesh=spec)
    if isinstance(spec, str):
        kind, _, arg = spec.partition(":")
        if arg:
            info = KINDS.get(kind)
            if info is not None and not info.takes_devices:
                raise ValueError(f"engine {kind!r} takes no :N suffix")
            return EngineSpec(kind, devices=int(arg))
        return EngineSpec(kind)
    raise TypeError(f"cannot parse engine spec {spec!r}")
