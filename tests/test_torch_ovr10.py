"""CIFAR-10's ten classes at its published shape (m = 50,000, d = 3,073,
C = 10, N = 50, Case 2), on the CPU at small shapes.

The gradient kernel's plan for the configuration's coded slices; the
update constants its eta gives (and eta = 1 refused at this m); TruncPr's
window, which the first updates of ten columns need at k2 = 25; a small
ten-class Copml job through the benchmark's dispatch held to the
benchmark's one-vs-rest reference (`bench/reference/copml_ovr.py`), with
set-up's X^T y span and the job's gradient counts; the reference at one
column against the binary one (`copml_logreg.py`) on a binary job; and
the benchmark's ten-class rows, which repeat by seed.
"""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api import protocols
from repro_torch.core import field, objectives, protocol, shamir, truncation
from repro_torch.core import random as jrandom
from repro_torch.kernels import ops, plan

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
M, D, C = 50_000, 3073, 10


@pytest.fixture
def bench(monkeypatch):
    """The benchmark's folder on sys.path, as bench/run.py puts it."""
    monkeypatch.syspath_prepend(str(BENCH))


@pytest.fixture
def counted(monkeypatch):
    """ops.fused_step counting each call as the card's launcher does (the
    CPU's plain version counts nothing), over process counters that
    already hold other launches."""
    monkeypatch.setattr(ops, "LAUNCHES", collections.Counter(fused_step=3))
    real = ops.fused_step

    def fused_step(x, w, *args, **kw):
        assert plan.gradient_route(x.shape[-1], w.shape[-1]) == "body"
        ops.LAUNCHES["fused_step"] += 1
        return real(x, w, *args, **kw)

    monkeypatch.setattr(ops, "fused_step", fused_step)


def _config() -> dict:
    return json.loads((BENCH / "configs" / "cifar10_ovr10_case2.json")
                      .read_text())


def _split(x, y, n):
    idx = np.array_split(np.arange(x.shape[0]), n)
    return [x[i] for i in idx], [y[i] for i in idx]


def _ref_cfg(cfg: protocol.CopmlConfig, m: int, n_classes=None) -> dict:
    out = dict(field_p=field.P, m=m, eta=cfg.eta, lx=cfg.lx, lw=cfg.lw,
               cb=cfg.cb, r=cfg.r, k2=cfg.k2,
               sigmoid_bound=cfg.sigmoid_bound, sigmoid_grid=2001)
    if n_classes is not None:
        out["n_classes"] = n_classes
    return out


def test_the_cells_gradient_takes_the_smem_body_instance():
    """5,000 coded rows a client (50,000 / K = 10) at d = 3,073 and ten
    columns: the body route with (d, 10) partials in shared memory,
    4-row slices in 2 stages."""
    cfg = _config()
    assert (cfg["m"], cfg["d"], cfg["n_classes"]) == (M, D, C)
    assert -(-cfg["m"] // cfg["k"]) == 5000
    assert plan.gradient_route(D, C) == "body"
    pl = plan.gradient_plan(5000, D, C)
    assert (pl["mode"], pl["bm"], pl["stages"], pl["smem"]) == \
        ("smem", 4, 2, 224_104)
    assert pl["smem"] + plan.GRAD_STATIC <= plan.SMEM_MAX


def test_the_configurations_update_constants():
    """eta = m / 4096 gives e = 13, q_eta = 2, k1 = 23, and TruncPr's
    window k2 = 25; eta = 1 at m = 50,000 needs k1 = 27, past the 26-bit
    field, and is refused.  The port's registry entry scales eta to the
    same value and takes the same window."""
    cfg = _config()
    ccfg = protocol.CopmlConfig(n_clients=cfg["n_clients"], k=cfg["k"],
                                t=cfg["t"], eta=cfg["eta"], k2=cfg["k2"])
    q_eta, e, k1, k2 = protocol.derive_update_constants(ccfg, M)
    assert (e, q_eta, k1, k2) == (13, 2, 23, 25)
    with pytest.raises(AssertionError):
        protocol.derive_update_constants(
            protocol.CopmlConfig(n_clients=50, k=10, t=7, eta=1.0, k2=25), M)
    wl = api.get_workload("cifar10_ovr10_case2")
    assert (wl.m, wl.d, wl.n_clients, wl.iters) == (M, D, 50, 50)
    assert (wl.cfg.k, wl.cfg.t, wl.cfg.eta, wl.cfg.k2) == \
        (10, 7, cfg["eta"], cfg["k2"])
    assert wl.objective is objectives.get("ovr10")
    assert wl.w_shape == (D, C)


def _truncpr_misses(a: int, k2: int, n: int = 2000) -> int:
    """Elements of n copies of the field value `a` whose TruncPr by 2^23
    (N = 13, T = 1) lands outside floor(a / 2^23) + {0, 1}."""
    pts = shamir.default_eval_points(13)
    sh = shamir.share(jrandom.as_key(3), torch.full(
        (n,), a % field.P, dtype=torch.int32), 1, 13, pts)
    z = shamir.reconstruct(truncation.trunc_pr(jrandom.as_key(4), sh, 23,
                                               k2, 1, pts), 1, pts)
    z = z.to(torch.int64)
    s = torch.where(z > field.P // 2, z - field.P, z) - (a >> 23)
    return int(((s != 0) & (s != 1)).sum())


def test_truncpr_holds_the_first_ten_class_updates_at_k2_25(bench):
    """The ten columns' first gradients, X^T(ghat(0) - Y), are led by the
    class means: 2,500 (sum over the other classes of mu_k - mu_c) a
    coordinate, past 512 in real units on some seeds.  At k1 = 23 and
    q_eta = 2 that is past 2^23, where TruncPr's open at the default
    k2 = 24 wraps p (an update 8 LSBs off); k2 = 25 takes up to 2^24."""
    from yardstick import data
    cfg = _config()
    worst = []
    for seed in (2**31 + 5, 7, 3_000_000_033):
        gen = data.generator(seed, "rows", "cpu")
        mu = torch.randn((C, D), generator=gen, dtype=torch.float64)
        mu /= mu.norm(dim=1, keepdim=True)
        g = 2500.0 * (mu.sum(0)[:, None] - 2 * mu.T)
        worst.append(float(g.abs().max()))
    a = [2 * w * 2 ** 13 for w in worst]          # q_eta g at s_grad = 13
    assert max(a) > 2 ** 23
    assert max(a) < 0.75 * 2 ** (cfg["k2"] - 1)
    big = -int(max(a))
    assert _truncpr_misses(big, 24) > 0
    assert _truncpr_misses(big, cfg["k2"]) == 0


def test_a_ten_class_job_is_judged_by_the_reference(bench, counted):
    """mnist10_like's shape (m = 390, d = 24, N = 13, Case 1), four steps
    through run_copml_engine on "jit": every element of every step within
    TruncPr's rounding of the reference's update; set-up's X^T y opens
    its span once; the job counts one fused step a step."""
    from reference import copml_ovr
    wl = api.get_workload("mnist10_like")
    iters = 4
    obj = objectives.get("ovr10")
    proto = protocol.Copml(wl.cfg, wl.m, wl.d, objective=obj, device="cpu")
    x, y, _, _ = wl.data()
    cx, cy = _split(np.asarray(x, np.float32), y, wl.n_clients)
    timings = {}
    _, w, hist = protocols.run_copml_engine(proto, "jit", 33, cx, cy, iters,
                                            history=True, timings=timings)
    assert hist.shape == (iters, wl.d, C)
    assert timings["spans"]["setup.xty"][0] == 1
    assert timings["counts"]["fused_step"] == iters
    ref = copml_ovr.Reference(_ref_cfg(wl.cfg, wl.m, C),
                              np.asarray(x, np.float32), y,
                              torch.device("cpu"))
    assert (ref.f.k1, ref.f.q_eta) == (proto.k1, proto.q_eta)
    got = copml_ovr.judge_jobs(ref, [dict(hist=hist.numpy(), w=w.numpy())])
    assert got["step_gap"] == 0
    assert abs(got["drift_z"]) < copml_ovr.LIMITS["drift_z"]
    # a model that skipped its last step is caught
    bad = hist.numpy().copy()
    bad[-1] = bad[-2]
    assert copml_ovr.judge_jobs(ref, [dict(hist=bad, w=bad[-1])])[
        "step_gap"] > 0


def test_the_reference_at_one_column_is_the_binary_one(bench):
    """A binary job (the smoke shape, five steps): the one-vs-rest
    reference without `n_classes` reads what copml_logreg reads."""
    from reference import copml_logreg, copml_ovr
    wl = api.get_workload("smoke")
    proto = protocol.Copml(wl.cfg, wl.m, wl.d, device="cpu")
    x, y, _, _ = wl.data()
    x, y = np.asarray(x, np.float32), np.array(y)
    cx, cy = _split(x, y, wl.n_clients)
    _, w, hist = protocols.run_copml_engine(proto, "jit", 5, cx, cy, 5,
                                            history=True)
    job = [dict(hist=hist.numpy(), w=w.numpy())]
    rcfg = _ref_cfg(wl.cfg, wl.m)
    dev = torch.device("cpu")
    want = copml_logreg.judge_jobs(copml_logreg.Reference(rcfg, x, y, dev),
                                   job)
    got = copml_ovr.judge_jobs(copml_ovr.Reference(rcfg, x, y, dev), job)
    assert got["step_gap"] == want["step_gap"] == 0
    assert got["drift_z"] == pytest.approx(want["drift_z"], abs=1e-9)


def test_the_ten_class_rows_repeat_by_seed(bench):
    from yardstick import classes
    seed = 2**31 + 33
    x, y = classes.class_rows(600, 40, C, 2.0, seed, "cpu")
    x2, y2 = classes.class_rows(600, 40, C, 2.0, seed, "cpu")
    assert np.array_equal(x, x2) and np.array_equal(y, y2)
    assert x.shape == (600, 40) and x.dtype == np.float32
    assert y.shape == (600,) and y.min() >= 0 and y.max() < C
    assert len(np.unique(y)) == C
    assert np.abs(x).max() <= 1.0
    x3, _ = classes.class_rows(600, 40, C, 2.0, seed + 1, "cpu")
    assert not np.array_equal(x, x3)
