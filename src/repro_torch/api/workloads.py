"""Workload registry: the *what* axis of a run.

A Workload fully specifies a training task: dataset shape + generation
parameters (data/pipeline synthetic builders -- real corpora are not
available offline), the COPML protocol parameterization (N, K, T, scales,
eta), the default iteration budget, and an optional default straggler
subset.  Together with a protocol name and an EngineSpec it pins down a
run completely: `api.fit(workload, protocol, engine)`.

The paper-scale shapes come straight from configs/copml_logreg.py (the
single source of truth for Section V-A dataset dimensions); the reduced
entries are the JAX package's registry, name for name and shape for shape,
so a fit of the same name is comparable bit for bit.
"""

from __future__ import annotations

import dataclasses

from ..configs import copml_logreg
from ..core import objectives
from ..core.protocol import (CopmlConfig, case1_params, case2_params,
                             derive_update_constants)
from ..data import pipeline


@dataclasses.dataclass(frozen=True)
class Workload:
    """A named, fully-specified training task (hashable: protocol drivers
    and dataset arrays are cached per workload across fit() calls)."""
    name: str
    m: int                      # total training rows (across all clients)
    d: int                      # feature dimension
    cfg: CopmlConfig            # N / K / T / scales / eta
    seed: int = 0               # synthetic dataset seed
    margin: float = 2.0         # class separation of the planted separator
    test_m: int = 0             # held-out eval rows (0 = eval on train)
    iters: int = 30             # default GD iterations
    subset: tuple | None = None  # default straggler subset (decode clients)
    objective: objectives.SecureObjective = objectives.BINARY_LOGISTIC
    # the model family (core/objectives): binary logreg (default, the
    # paper's task), linreg, or C-class one-vs-rest on a (d, C) matrix

    @property
    def n_clients(self) -> int:
        return self.cfg.n_clients

    @property
    def w_shape(self) -> tuple:
        """The opened model's shape: (d,) or (d, C)."""
        return self.objective.w_shape(self.d)

    def data(self):
        """(x, y, x_test, y_test); the eval pair is (None, None) when
        test_m == 0.  Cached: repeated fits reuse the same arrays."""
        return _dataset(self.m, self.d, self.seed, self.margin, self.test_m,
                        self.objective.dataset_kind,
                        self.objective.n_outputs)

    def eval_set(self):
        """The eval pair accuracy curves are scored against: the held-out
        split when one exists, else the training set."""
        x, y, xt, yt = self.data()
        return (xt, yt) if xt is not None else (x, y)

    def client_data(self):
        """Per-client row splits (paper Section V-A even distribution)."""
        x, y, _, _ = self.data()
        return pipeline.split_clients(x, y, self.n_clients)


_DATA_CACHE: dict = {}


def _dataset(m, d, seed, margin, test_m, kind="binary", n_outputs=1):
    key = (m, d, seed, margin, test_m, kind, n_outputs)
    if key not in _DATA_CACHE:
        if kind == "multiclass":
            out = pipeline.multiclass_dataset(m=m, d=d, n_classes=n_outputs,
                                              seed=seed, margin=margin,
                                              test_m=test_m)
        elif kind == "regression":
            out = pipeline.regression_dataset(m=m, d=d, seed=seed,
                                              test_m=test_m)
        else:
            out = pipeline.classification_dataset(
                m=m, d=d, seed=seed, margin=margin, test_m=test_m)
        if not test_m:
            out = (out[0], out[1], None, None)
        for arr in out:                 # the cache is shared across fits:
            if arr is not None:         # freeze so no caller can corrupt it
                arr.flags.writeable = False
        _DATA_CACHE[key] = out
    return _DATA_CACHE[key]


# ------------------------------------------------------------------ registry

WORKLOADS: dict = {}


def register(workload: Workload, replace: bool = False) -> Workload:
    if not replace and workload.name in WORKLOADS:
        raise ValueError(f"workload {workload.name!r} already registered")
    WORKLOADS[workload.name] = workload
    return workload


def get(name: str) -> Workload:
    if name not in WORKLOADS:
        known = ", ".join(sorted(WORKLOADS))
        raise KeyError(f"unknown workload {name!r}; registered: {known}")
    return WORKLOADS[name]


def resolve(workload) -> Workload:
    """Accept a registry name or an ad-hoc Workload instance."""
    if isinstance(workload, Workload):
        return workload
    return get(workload)


def names() -> tuple:
    return tuple(sorted(WORKLOADS))


def _cfg(n, k, t, eta=1.0):
    return CopmlConfig(n_clients=n, k=k, t=t, eta=eta)


# reduced-scale: train for real on a CPU budget ---------------------------
register(Workload("smoke", m=96, d=12, cfg=_cfg(13, *case1_params(13)),
                  iters=10))
register(Workload("quickstart", m=260, d=16, cfg=_cfg(13, *case1_params(13)),
                  iters=30))
register(Workload("engine_micro", m=208, d=12,
                  cfg=_cfg(13, *case1_params(13)), seed=1, iters=20))
# paper Fig. 4 at reduced m with a held-out eval split
register(Workload("cifar10_like", m=480, d=96, cfg=_cfg(15, *case2_params(15)),
                  seed=5, margin=1.2, test_m=160, iters=40))
register(Workload("gisette_like", m=480, d=128,
                  cfg=_cfg(15, *case2_params(15)), seed=5, margin=3.0,
                  test_m=160, iters=40))
# straggler demo: K=3, T=1 at N=13 leaves R=10 < N; decode from the LAST R
register(Workload("smoke_straggler", m=96, d=12, cfg=_cfg(13, 3, 1), iters=4,
                  subset=tuple(range(3, 13))))
# non-binary objectives: 10-class one-vs-rest on a (d, 10) field matrix
# (dataset encoded ONCE for all 10 classes -- the encode-once/class-batch
# path), and linear regression (ghat(z) = z exactly, r = 1)
register(Workload("mnist10_like", m=390, d=24, cfg=_cfg(13, *case1_params(13)),
                  seed=7, margin=3.0, test_m=130, iters=25,
                  objective=objectives.get("ovr10")))
register(Workload("linreg_smoke", m=96, d=12, cfg=_cfg(13, *case1_params(13)),
                  seed=3, iters=12, objective=objectives.LINREG))

def _field_safe_cfg(cfg: CopmlConfig, m: int, name: str) -> CopmlConfig:
    """Keep the paper's eta when the derived truncation depth fits the
    26-bit field; otherwise apply the documented eta-with-m scaling (the
    field-size scalability limit) so every registered workload is actually
    fittable."""
    try:
        derive_update_constants(cfg, m)
        return cfg
    except AssertionError:
        bumped = dataclasses.replace(cfg, eta=max(cfg.eta, m / 4096.0))
    try:
        derive_update_constants(bumped, m)
    except AssertionError as exc:
        raise ValueError(
            f"workload {name!r} (m={m}, cfg={cfg}) does not fit the 26-bit "
            f"field even after eta scaling to {bumped.eta}") from exc
    return bumped


# paper-scale: Section V-A shapes from configs/copml_logreg (data this size
# is only materialized if a fit actually asks for it)
for _w in copml_logreg.WORKLOADS.values():
    register(Workload(_w.name, m=_w.m, d=_w.d,
                      cfg=_field_safe_cfg(_w.cfg, _w.m, _w.name), iters=50,
                      objective=_w.objective))
