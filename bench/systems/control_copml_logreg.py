"""The control: the plain reference put in the program's place, computed in
the nearest precision below the one the configuration states -- the rows
and queries rounded to lx - 1 fractional bits.  It offers the program
system's interface, so the benchmark's drivers and checks run unchanged;
the check has to judge it not correct.  `bench/control.py` runs it; the
benchmark's own runs never do.
"""

from __future__ import annotations

import numpy as np
import torch

from yardstick import registry


class System:
    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, device
        self.lx = int(cfg["lx"]) - 1
        self.ref = registry.reference(cfg["reference"])

    def build_kernels(self) -> None:
        pass

    def split(self, x, y) -> tuple:
        return [x], [y]

    def job(self, key, client_xs, client_ys) -> dict:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.asarray(key, np.uint64).sum()))
        out = self.ref.control_job(self.cfg, client_xs[0], client_ys[0], gen,
                                   self.device, self.lx)
        out["timings"] = dict(setup_s=0.0, iters_s=0.0)
        out["state"] = None
        return out

    def server(self, job: dict, key, batch_size: int, window_ms: float):
        return _Server(self, job["w"])

    def span_targets(self) -> list:
        return []

    def queue(self, batch_size: int, window_ms: float, clock):
        """The program's batching window: it decides only which queries
        share a window, not what a window computes."""
        from repro_torch.serve.queue import MicroBatchQueue
        return MicroBatchQueue(batch_size, window_ms, clock=clock)


class _Server:
    def __init__(self, system: System, w):
        self.w = w
        self.scorer = system.ref.Reference(
            system.cfg, np.zeros((1, system.cfg["d"]), np.float32),
            np.zeros(1, np.float32), system.device, lx=system.lx)

    def logits(self, batch):
        lg, _ = self.scorer.logits(self.w, np.asarray(batch))
        return lg.reshape(-1, 1)

    def _decide(self, logits):
        return (logits[:, 0] > 0).astype(np.int32)
