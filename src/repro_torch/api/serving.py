"""api.serve: the serving front door, mirroring api.fit's axes.

    from repro_torch import api
    res = api.fit("mnist10_like", "copml", "jit")
    srv = api.serve("mnist10_like", res, "jit")
    preds, stats = srv.serve(queries)          # micro-batched, in order

The (workload, result, engine) triple specifies a server: the workload
supplies the protocol parameterization (cfg: N/T/scales) and the
objective (decision semantics), the TrainResult supplies the model --
preferably its share state, so the model is re-shared without ever being
opened.  The server runs on the card unless the caller passes
device="cpu".
"""

from __future__ import annotations

import numpy as np

from ..core import random as jrandom
from ..serve import coded
from ..serve.server import SERVE_KINDS, SecureServer, check_kind
from . import engine as engine_mod
from . import workloads as workloads_mod

#: engine kinds api.serve accepts (see SERVE_KINDS in serve/server)
SERVE_ENGINES = SERVE_KINDS


def serve(workload, result, engine="jit", *, key: int = 0,
          batch_size: int = 32, window_ms: float = 5.0,
          device=None) -> SecureServer:
    """Build a SecureServer from a workload and its TrainResult.

    workload    registry name or Workload instance (must be the one the
                result was trained on -- shape-checked)
    result      an api.fit TrainResult; a COPML result's share state is
                re-shared directly (encode path never opens the model)
    engine      "eager" | "jit" | "sharded[:N]" (a spec string, an
                api.EngineSpec or a ClientMesh, parsed as api.fit parses
                it)
    key         seed of the one-time re-share randomness (an int, or a
                JAX key's data as a (2,) uint32 array)
    batch_size  micro-batch window size (queries per scoring dispatch)
    window_ms   max milliseconds a query waits for its window to fill
    device      "cuda" (default when a card is present) or "cpu"
    """
    spec = engine_mod.parse(engine)
    check_kind(spec.kind)
    wl = workloads_mod.resolve(workload)
    w = np.asarray(result.weights)
    if w.shape != wl.w_shape:
        raise ValueError(
            f"result.weights shape {w.shape} does not match workload "
            f"{wl.name!r} model shape {wl.w_shape} -- was this result "
            f"trained on a different workload?")
    rwl = getattr(result, "workload", wl.name)
    if rwl != wl.name:
        raise ValueError(
            f"result was trained on workload {rwl!r}, not {wl.name!r}")
    model = coded.encode_model(jrandom.as_key(key), result, wl.cfg,
                               wl.objective, device)
    mesh = spec.resolve_mesh(model.device) if spec.kind == "sharded" \
        else None
    return SecureServer(workload=wl.name, protocol=result.protocol,
                        engine=spec.label, kind=spec.kind,
                        batch_size=batch_size, window_ms=window_ms,
                        model=model, objective=wl.objective, mesh=mesh)
