"""The program under test for a COPML logistic-regression configuration:
the PyTorch port `repro_torch`, built from the configuration file alone.

Every field the port's `Copml` takes (N, K, T, r, eta, the fixed-point
scales) comes from the configuration, so the benchmark does not depend on
the port's workload registry.  A training job is one call of
`api.protocols.run_copml_engine` on the "jit" engine -- the dispatch that
`api.fit` runs -- with the fused schedule (REPRO_FUSED_STEP=1) and no
faults: protocol setup (quantize, Shamir share, LCC encode, X^T y), the
iterations, and the opened model after each of them (`history=True`, as
`api.fit` keeps it by default), brought to the host.
"""

from __future__ import annotations

import os

import numpy as np

SCHEDULE = "1"            # REPRO_FUSED_STEP: the fused step


def _port():
    os.environ["REPRO_FUSED_STEP"] = SCHEDULE
    from repro_torch import api
    from repro_torch.api import protocols, workloads
    from repro_torch.core import protocol
    return api, protocols, workloads, protocol


def copml_config(cfg: dict):
    """The port's CopmlConfig, every field from the configuration file."""
    _, _, _, protocol = _port()
    return protocol.CopmlConfig(
        n_clients=cfg["n_clients"], k=cfg["k"], t=cfg["t"], r=cfg["r"],
        eta=cfg["eta"], lx=cfg["lx"], lw=cfg["lw"], cb=cfg["cb"],
        k2=cfg["k2"], mag_bits=cfg["mag_bits"],
        sigmoid_bound=cfg["sigmoid_bound"], mpc_mul=cfg["mpc_mul"])


class System:
    """One configuration's program: the Copml driver on one device, reused
    by every job of a run as `api.fit` reuses its cached driver."""

    def __init__(self, cfg: dict, device):
        api, protocols, workloads, protocol = _port()
        self.cfg, self.device = cfg, device
        self._api, self._protocols = api, protocols
        self.copml_cfg = copml_config(cfg)
        self.workload = workloads.Workload(
            cfg["name"], m=cfg["m"], d=cfg["d"], cfg=self.copml_cfg,
            iters=cfg["iters"])
        self.proto = protocol.Copml(self.copml_cfg, cfg["m"], cfg["d"],
                                    device=device)
        self.Copml = protocol.Copml

    def build_kernels(self) -> None:
        """Build or load the port's CUDA libraries (a fresh checkout builds
        them here with nvcc; later runs find them in the program's build
        directory inside the checkout)."""
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()

    def split(self, x: np.ndarray, y: np.ndarray) -> tuple:
        """Rows dealt evenly to the N data owners (paper Sec. V-A)."""
        idx = np.array_split(np.arange(x.shape[0]), self.cfg["n_clients"])
        return [x[i] for i in idx], [y[i] for i in idx]

    def job(self, key, client_xs, client_ys) -> dict:
        """One training job; returns the opened model, its trajectory and
        the program's own timings, on the host."""
        timings: dict = {}
        state, w, hist = self._protocols.run_copml_engine(
            self.proto, "jit", key, client_xs, client_ys, self.cfg["iters"],
            history=True, timings=timings)
        return dict(w=w.cpu().numpy(), hist=hist.cpu().numpy(),
                    timings=timings, state=state)

    def server(self, job: dict, key, batch_size: int, window_ms: float):
        """`api.serve` over the model one job trained: its share state is
        re-shared, never opened."""
        result = self._api.TrainResult(
            workload=self.workload.name, protocol="copml", engine="jit",
            iters=self.cfg["iters"], weights=job["w"], wall_time_s=0.0,
            history=job["hist"], device=str(self.device),
            timings=job["timings"], state=job["state"])
        return self._api.serve(self.workload, result, "jit", key=key,
                               batch_size=batch_size, window_ms=window_ms,
                               device=self.device)

    def span_targets(self) -> list:
        """(owner, attribute, span name) of the calls into each layer that
        a traced stretch wraps in a range."""
        from repro_torch.kernels import ops
        from repro_torch.serve import coded
        return [(self.Copml, "setup", "copml.setup"),
                (self.Copml, "iteration", "copml.iteration"),
                (ops, "fused_step", "kernels.fused_step"),
                (coded, "score_shares", "serve.score_shares")]

    def queue(self, batch_size: int, window_ms: float, clock):
        from repro_torch.serve.queue import MicroBatchQueue
        return MicroBatchQueue(batch_size, window_ms, clock=clock)
