"""The program under test for a one-vs-rest COPML configuration: the
PyTorch port `repro_torch` with its C-class objective (`ovr<C>`, C the
configuration's `n_classes`), one (d, C) model whose C logistic columns
train together on one encoding of the rows.  Everything else is
copml_logreg's System, by import: every field of the port's `Copml` from
the configuration file, one job a call of `api.protocols.run_copml_engine`
on the "jit" engine with the opened model after each step
(`history=True`), the same spans.
"""

from __future__ import annotations

import dataclasses

from systems import copml_logreg


class System(copml_logreg.System):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        from repro_torch.core import objectives
        obj = objectives.get(f"ovr{int(cfg['n_classes'])}")
        self.workload = dataclasses.replace(self.workload, objective=obj)
        self.proto = self.Copml(self.copml_cfg, cfg["m"], cfg["d"],
                                objective=obj, device=device)
