"""The sharded COPML engine's per-rank state layout.

Only the protocol's entry of the JAX package's sharding/partition.py:
the LM parameter, optimizer and cache specs come with the LM stack.
"""

from __future__ import annotations

import torch

from ..core.protocol import CopmlState


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
