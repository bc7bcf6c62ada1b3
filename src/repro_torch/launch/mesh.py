"""Sizes of the production meshes the dry run models.

The JAX package's pod is 16x16 = 256 chips and its multipod two pods,
512; the port's dry-run cells take the same sizes, one client a rank, so
their N equals the JAX records'.  Nothing here starts a process or makes
a device: the ranks a dry run executes come from core/meshutil.
"""

from __future__ import annotations

POD_RANKS = 256
MULTIPOD_RANKS = 512


def production_ranks(*, multi_pod: bool = False) -> int:
    """Ranks of the production mesh: a pod, or two pods."""
    return MULTIPOD_RANKS if multi_pod else POD_RANKS
