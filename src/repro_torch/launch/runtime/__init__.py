"""Multi-process COPML runtime: clients as OS processes over TCP.

The `proc:N` engine (api.fit(..., engine="proc:4")): each worker process
owns a contiguous client group, runs its kernels on the run's device (the
card unless the caller asked for the CPU), and exchanges framed share and
coded payloads over real localhost sockets; a coordinator process handles
session setup and the opening barrier rounds.  The wire, the frames and
their counts are the JAX package's, byte for byte.

    wire      length-prefixed frame format + array payloads
    net       async framed-TCP Node (latency injection, timeout/retry)
    config    NetConfig: every network knob, env-overridable
    worker    per-process client-group compute + socket collectives
    session   coordinator: run_copml_proc, the engine entry point
"""

from .config import NetConfig
from .session import DEFAULT_PROCS, run_copml_proc

__all__ = ["NetConfig", "DEFAULT_PROCS", "run_copml_proc"]
