"""Which csrc/modmatmul.cu kernel each protocol's field GEMMs take, on the
CPU: every GEMM of a fit (copml on both schedules and under a fault plan,
mpc_baseline, secure_agg) and of serving is recorded with its shapes and
strides, as on the card, and routed by plan.gemm_path.  copml's GEMMs keep
the thin and column-sum paths; the MPC baseline's Z = X W takes the
row-dot path, and serving's scores the split-K path at full width (the
row-dot path at 16 columns or fewer); no GEMM of these paths takes the
tiled kernel.  chip_smoke.py's COMPARE_SHAPES route the same way.
"""

import collections
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import random as jrandom
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels import ops
from repro_torch.serve import coded

REPO = Path(__file__).resolve().parents[1]


class _Routes:
    """Counts the path of every ops.modmatmul[_batched] call inside."""

    def __init__(self, monkeypatch):
        self.paths: collections.Counter = collections.Counter()
        self.shapes: dict = {}
        for name in ("modmatmul", "modmatmul_batched"):
            real = getattr(ops, name)
            monkeypatch.setattr(ops, name, self._spy(name, real))

    def _spy(self, name, real):
        def call(a, b):
            a3, b3 = (a[None], b[None]) if name == "modmatmul" else (a, b)
            path = mm.path_of(a3, b3)
            self.paths[path] += 1
            self.shapes.setdefault(path, set()).add(
                (tuple(a3.shape), tuple(b3.shape)))
            return real(a, b)
        return call


def test_copml_gemms_keep_the_thin_and_colsum_paths(monkeypatch):
    routes = _Routes(monkeypatch)
    api.fit("cifar10_like", "copml", "jit", iters=2, history=False,
            device="cpu")
    assert set(routes.paths) == {"thin", "colsum"}, routes.shapes


def test_copml_gemms_under_a_fault_plan(monkeypatch):
    routes = _Routes(monkeypatch)
    plan = api.FaultPlan.from_schedule(13, 4, stragglers={1: (0,)})
    api.fit("smoke_straggler", "copml", "jit", iters=4, faults=plan,
            history=False, device="cpu")
    assert set(routes.paths) == {"thin", "colsum"}, routes.shapes


@pytest.mark.parametrize("workload,c", [("cifar10_like", 1),
                                        ("mnist10_like", 10)])
def test_mpc_baseline_z_takes_the_rowdot_path(monkeypatch, workload, c):
    routes = _Routes(monkeypatch)
    api.fit(workload, "mpc_baseline", "jit", iters=1, history=False,
            device="cpu")
    assert "tiled" not in routes.paths, routes.shapes["tiled"]
    assert routes.paths["rowdot"] > 0 and routes.paths["colsum"] > 0
    wl = api.get_workload(workload)
    for ashape, bshape in routes.shapes["rowdot"]:
        assert ashape[2] == wl.d and bshape[2] == c      # Z = X W


def test_secure_agg_gemms_take_the_thin_path(monkeypatch):
    routes = _Routes(monkeypatch)
    api.fit("cifar10_like", "secure_agg", "jit", iters=2, history=False,
            device="cpu")
    assert set(routes.paths) == {"thin"}, routes.shapes


@pytest.mark.parametrize("batch", [1, 16])
def test_serving_scores_keep_off_the_tiled_path(monkeypatch, batch):
    """cifar10_like serves N C' = 15 columns: its scores take the row-dot
    path (N <= 16), the opens the thin one."""
    res = api.fit("cifar10_like", "copml", "jit", iters=2, history=False,
                  device="cpu")
    srv = api.serve("cifar10_like", res, "jit", batch_size=batch,
                    device="cpu")
    routes = _Routes(monkeypatch)
    x = api.get_workload("cifar10_like").eval_set()[0][:2 * batch]
    srv.serve(x)
    assert set(routes.paths) == {"rowdot", "thin"}, routes.shapes
    assert routes.shapes["rowdot"] == {((1, batch, 96), (1, 96, 15))}
    assert routes.shapes["thin"] == {((1, 1, 3), (1, 3, batch))}


@pytest.mark.parametrize("b", [1, 32, 128])
def test_serving_scores_take_the_splitk_path_at_full_width(monkeypatch, b):
    """The encoded model of a cifar10_case2 result is (d, N C') = (3073,
    50), row-major: a window's (B, 3073) @ (3073, 50) takes the split-K
    path, its open (1, T+1) @ (T+1, B) the thin one."""
    wl = api.get_workload("cifar10_case2")
    result = types.SimpleNamespace(weights=np.zeros(wl.d, np.float32),
                                   state=None)
    model = coded.encode_model(jrandom.PRNGKey(0), result, wl.cfg,
                               wl.objective, "cpu")
    assert tuple(model.w_cols.shape) == (wl.d, wl.n_clients)
    assert model.w_cols.is_contiguous()
    routes = _Routes(monkeypatch)
    coded.score_open(model, np.zeros((b, wl.d), np.float32))
    assert routes.shapes == {
        "splitk": {((1, b, wl.d), (1, wl.d, wl.n_clients))},
        "thin": {((1, 1, wl.cfg.t + 1), (1, wl.cfg.t + 1, b))}}


@pytest.mark.parametrize("workload,procs", [("cifar10_case2", 4),
                                            ("cifar10_case2", 3),
                                            ("mnist10_like", 4)])
def test_proc_worker_gemms_take_the_thin_path(workload, procs):
    """Every field GEMM a proc worker makes at full width (share rows,
    LCC encode, the encode's reduce-scatter segments, the gradient-share
    blocks, the decode), with the strides the worker passes, routes to
    the thin kernel; its coded-gradient shape has a gradient plan.  The
    plan is pure: shapes only (tests/test_torch_runtime_engine.py holds
    step_gemms to what the workers of CPU fits launched)."""
    from repro_torch.kernels.plan import gradient_plan, strip_run
    from repro_torch.launch.runtime import worker
    wl = api.get_workload(workload)
    c = wl.objective.n_outputs
    step = worker.step_gemms(wl.n_clients, wl.cfg.k, wl.cfg.t, wl.d * c,
                             procs, wl.cfg.recovery_threshold)
    assert sum(step.values()) == 3 + 1 + 2 * procs + 1
    for op, ash, ast, bsh, bst in step:
        a = torch.empty_strided(ash, ast, dtype=torch.int32, device="meta")
        b = torch.empty_strided(bsh, bst, dtype=torch.int32, device="meta")
        if op == "modmatmul":
            a, b = a[None], b[None]
        assert mm.path_of(a, b) == "thin", (op, ash, ast, bsh, bst)
    n_loc = -(-wl.n_clients // procs)
    mk = -(-wl.m // wl.cfg.k)
    plan = gradient_plan(mk, wl.d, c)
    run, ctas = strip_run(n_loc * -(-mk // plan["bm"]), 132 * 2)
    assert run * ctas >= n_loc * -(-mk // plan["bm"]) > run * (ctas - 1)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_compare_shapes_route_as_stated():
    """chip_smoke.COMPARE_SHAPES, the shapes `--compare` times: the copml
    GEMMs keep their paths, Z = X W and a sharded rank's scores are
    rowdot and serving is splitk."""
    smoke, seen = _chip_smoke(), {}

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    for label, name, ashape, bshape, _ in smoke.COMPARE_SHAPES:
        if name.startswith("modmatmul"):
            a, b = smoke.gemm_operands(empty, label, name, ashape, bshape)
            if name == "modmatmul":
                a, b = a[None], b[None]
            seen[label] = mm.path_of(a, b)
    for label, path in seen.items():
        if label.startswith("X^T y"):
            assert path == "colsum", label
        elif label.startswith(("MPC baseline Z", "sharded rank scores")):
            assert path == "rowdot", label
        elif label.startswith("serving"):
            assert path == "splitk", label
        else:
            assert path == "thin", label
    assert {p for p in seen.values()} == {"thin", "colsum", "rowdot",
                                          "splitk"}

