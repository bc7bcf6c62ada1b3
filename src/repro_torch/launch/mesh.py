"""The production meshes the dry run models, and the host's mesh.

The JAX package's pod is 16x16 = 256 chips and its multipod two pods,
512; the port's dry-run cells take the same sizes (copml-logreg: one
client a rank, so their N equals the JAX records').  Nothing here starts
a process or makes a device: a mesh is a value (core/meshutil.Mesh), and
the ranks a copml dry run executes come from core/meshutil.ClientMesh.
"""

from __future__ import annotations

import torch

from ..core import meshutil

POD_RANKS = 256
MULTIPOD_RANKS = 512


def production_ranks(*, multi_pod: bool = False) -> int:
    """Ranks of the production mesh: a pod, or two pods."""
    return MULTIPOD_RANKS if multi_pod else POD_RANKS


def make_production_mesh(*, multi_pod: bool = False) -> meshutil.Mesh:
    """The pod mesh, 16x16 = 256 chips (data, model); the multipod mesh,
    2x16x16 = 512 (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return meshutil.make_mesh(shape, axes)


def make_host_mesh(model_parallel: int = 1,
                   n_devices: int | None = None) -> meshutil.Mesh:
    """(n // mp, mp) over this host's devices: its CUDA cards (one device
    when it has none), or n_devices."""
    n = n_devices if n_devices is not None else \
        max(1, torch.cuda.device_count())
    mp = min(model_parallel, n)
    return meshutil.make_mesh((n // mp, mp), ("data", "model"))
