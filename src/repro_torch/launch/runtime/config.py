"""NetConfig: every network knob of the multi-process runtime.

The JAX package's NetConfig, field for field.  Kept dependency-free (no
torch, no asyncio) so api/engine.py can import it without touching the
runtime's heavy modules.  An instance is frozen and
picklable: the coordinator embeds it in the SESSION blob, so every worker
applies the same link model.

Latency/bandwidth are injected at the RECEIVER when a frame is taken off
the wire: each connection is drained by one sequential task, so delayed
frames stay ordered per link (a slow link serializes, it never reorders).
Straggling then *emerges* from timing -- a worker whose frames arrive
late simply misses the decode deadline and the survivors decode without
it (LCC decode invariance keeps the result bit-exact).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Link model + timeout policy for one proc-engine session.

    host             interface to bind/dial (default loopback).
    latency_s        default one-way per-frame delay on every link.
    bandwidth_bps    optional link bandwidth; adds len(frame)/bandwidth
                     of serialization delay per frame (None = infinite).
    links            per-link latency overrides, most specific match wins:
                     ((src, dst, seconds), ...) where src/dst are ranks or
                     None for "any" -- (3, None, 0.35) makes every frame
                     FROM rank 3 arrive 0.35s late anywhere.
    recv_timeout_s   how long one recv() wait lasts before a retry.
    recv_retries     retries per recv() before NodeTimeout.
    connect_timeout_s  dial/handshake budget per connection.
    spawn_timeout_s  coordinator's budget for worker HELLOs (process
                     spawn, torch import and CUDA context
                     happen inside it).
    decode_timeout_s gradient-decode straggler deadline: once >= R real
                     owners' blocks arrived, wait at most this long for
                     the rest before decoding from the survivors.  None =
                     wait for everyone (the recv timeout still degrades
                     to the survivors if >= R are in hand).
    """
    host: str = "127.0.0.1"
    latency_s: float = 0.0
    bandwidth_bps: float | None = None
    links: tuple = ()
    recv_timeout_s: float = 30.0
    recv_retries: int = 3
    connect_timeout_s: float = 30.0
    spawn_timeout_s: float = 180.0
    decode_timeout_s: float | None = None

    def link_latency(self, src: int, dst: int) -> float:
        """One-way latency for src->dst frames (most specific link wins)."""
        best, best_score = self.latency_s, -1
        for entry in self.links:
            s, d, lat = entry
            if (s is None or s == src) and (d is None or d == dst):
                score = (s is not None) * 2 + (d is not None)
                if score > best_score:
                    best, best_score = float(lat), score
        return best

    def delay(self, src: int, dst: int, nbytes: int) -> float:
        """Total injected delivery delay for one frame on src->dst."""
        d = self.link_latency(src, dst)
        if self.bandwidth_bps:
            d += nbytes / float(self.bandwidth_bps)
        return d

    @classmethod
    def from_env(cls) -> "NetConfig":
        """Defaults, overridable per process via REPRO_PROC_* variables:
        REPRO_PROC_HOST,
        REPRO_PROC_LATENCY_S, REPRO_PROC_TIMEOUT_S, REPRO_PROC_RETRIES."""
        return cls(
            host=os.environ.get("REPRO_PROC_HOST", "127.0.0.1"),
            latency_s=float(os.environ.get("REPRO_PROC_LATENCY_S", "0")),
            recv_timeout_s=float(
                os.environ.get("REPRO_PROC_TIMEOUT_S", "30")),
            recv_retries=int(os.environ.get("REPRO_PROC_RETRIES", "3")),
        )
