"""The port's launch layer on the CPU, against the JAX package's.

* sharding/partition.copml_state_structs: each rank's shapes equal the
  JAX package's per-device shard shapes (its NamedSharding on 4 host
  devices, in a subprocess);
* launch/roofline: useful work equals twice the JAX dry run's field-MAC
  count (its model flops / 16) in every cell; the terms on hand-computed
  numbers; the rank step's closed forms by hand;
* launch/copml_dist: run_parity on gloo ranks on the CPU, weights equal to
  the JAX package's jit fit (legacy threefry), plain and under a seeded
  fault plan; the smoke dry-run cell executed on 2 ranks (bytes by
  collective and launches equal to the closed forms, bit-equal to the
  single-device step) on both REPRO_SHARDED_OVERLAP settings;
* launch/dryrun's exit codes and closing line, launch/train's summary,
  launch/launch_counter over CPU steps, and the registry.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.configs import copml_logreg, registry
from repro_torch.core import meshutil
from repro_torch.launch import copml_dist, dryrun, launch_counter
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as RL
from repro_torch.sharding import partition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
CELLS = [(shape, ranks) for shape in ("smoke", "train_4k", "prefill_32k",
                                      "decode_32k") for ranks in (256, 512)]


@pytest.fixture(scope="module", autouse=True)
def close_meshes():
    yield
    meshutil.close_meshes()


def _env():
    return dict(os.environ, PYTHONPATH=SRC)


# ------------------------------------------------------ partition, roofline

_JAX_STRUCTS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro.core import meshutil
from repro.launch import copml_dist
mesh = meshutil.client_mesh(4)
out = {}
for shape in ("smoke", "train_4k"):
    for n in (13, 256):
        _, m, d = copml_dist._SHAPE_MAP[shape]
        st = copml_dist.state_structs(copml_dist.make_protocol(n, m, d), mesh)
        out[f"{shape} {n}"] = {
            f: list(getattr(st, f).sharding.shard_shape(getattr(st, f).shape))
            for f in ("w_shares", "coded_x", "xty_shares")}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_structs():
    env = _env()
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _JAX_STRUCTS], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", ["smoke", "train_4k"])
@pytest.mark.parametrize("n", [13, 256])
def test_copml_state_structs_match_jax(jax_structs, shape, n):
    _, m, d = copml_dist._SHAPE_MAP[shape]
    proto = copml_dist.make_protocol(n, m, d)
    ranks = partition.copml_state_structs(proto, 4)
    assert len(ranks) == 4
    want = jax_structs[f"{shape} {n}"]
    for st in ranks:
        for f in ("w_shares", "coded_x", "xty_shares"):
            x = getattr(st, f)
            assert x.device.type == "meta" and x.dtype == torch.int32
            assert list(x.shape) == want[f], (f, x.shape, want[f])
    n_pad = sum(st.w_shares.shape[0] for st in ranks)
    assert n_pad == -(-n // 4) * 4


def _jax_mac_count(monkeypatch, shape, ranks):
    """The JAX package's dryrun_cell field-MAC count (its model flops /
    FIELD_MAC_FLOPS), taken where it hands them to the roofline: the
    compile and the mesh are stubbed, nothing in the package changes."""
    from repro.launch import copml_dist as jcd
    from repro.launch import roofline as jrl

    class Taken(Exception):
        pass

    got = {}

    def analyze(name, compiled, chips, mflops):
        got["mflops"] = mflops
        raise Taken

    lowered = types.SimpleNamespace(compile=lambda: types.SimpleNamespace(
        memory_analysis=lambda: None))
    monkeypatch.setattr(jrl, "analyze", analyze)
    monkeypatch.setattr(jcd, "flatten_mesh", lambda mesh: mesh)
    monkeypatch.setattr(jcd, "state_structs", lambda proto, mesh:
                        types.SimpleNamespace(w_shares=None, coded_x=None,
                                              xty_shares=None))
    monkeypatch.setattr(jcd, "NamedSharding", lambda *a, **k: None)
    monkeypatch.setattr(jcd, "jax", types.SimpleNamespace(
        ShapeDtypeStruct=lambda *a, **k: None,
        jit=lambda fn: types.SimpleNamespace(lower=lambda *a: lowered)))
    monkeypatch.setattr(jcd.Copml, "sharded_step",
                        lambda self, mesh: (None, None))
    with pytest.raises(Taken):
        jcd.dryrun_cell(shape, types.SimpleNamespace(size=ranks),
                        ranks == 512)
    return got["mflops"] / jcd.FIELD_MAC_FLOPS


@pytest.mark.parametrize("shape,ranks", CELLS)
def test_model_ops_equals_twice_the_jax_mac_count(monkeypatch, shape,
                                                  ranks):
    _, m, d = copml_dist._SHAPE_MAP[shape]
    cfg = copml_dist.make_config(ranks, m, d)
    ours = copml_dist.model_ops(cfg, m, d)
    assert ours == 2 * _jax_mac_count(monkeypatch, shape, ranks)


def test_roofline_terms_by_hand():
    assert RL.INT32_INST_PER_S == 132 * 64 * 1.98e9
    assert RL.FIELD_OPS_PER_S == 2 * 132 * 64 * 1.98e9 / 2
    assert RL.HBM_BYTES_PER_S == 3.35e12
    assert RL.LINK_BYTES_PER_S == {"nvlink4": 450e9, "ndr400": 50e9}
    rf = RL.Roofline(name="x", chips=4, ops=8 * RL.FIELD_OPS_PER_S,
                     bytes=4 * RL.HBM_BYTES_PER_S * 3,
                     coll_bytes_per_device=450e9 * 0.5, model_ops=
                     2 * RL.FIELD_OPS_PER_S)
    assert rf.compute_s == pytest.approx(2.0)
    assert rf.memory_s == pytest.approx(3.0)
    assert rf.collective_s == pytest.approx(0.5)
    assert (rf.dominant, rf.bound_s) == ("memory", pytest.approx(3.0))
    assert rf.useful_ops_ratio == pytest.approx(0.25)
    assert rf.roofline_fraction == pytest.approx(0.5 / 3.0)
    slow = RL.Roofline("x", 4, 0, 0, 50e9 * 0.5, link="ndr400")
    assert slow.collective_s == pytest.approx(0.5)
    assert set(rf.to_dict()) >= {"ops", "bytes", "model_ops", "compute_s",
                                 "memory_s", "collective_s", "dominant",
                                 "roofline_fraction"}
    with pytest.raises(ValueError):
        RL.Roofline("x", 1, 0, 0, 0, link="pcie")
    # bound: 3.35e9 bytes take 1 ms; 16.727e9 field ops take 1 ms
    assert RL.bound(3.35e9, 1.0) == (pytest.approx(1.0), "bytes")
    assert RL.bound(1.0, 2 * RL.FIELD_OPS_PER_S / 1e3) == \
        (pytest.approx(2.0), "operations")
    # a (2, 3) @ (3, 5) GEMM, and the same with A broadcast (stride 0)
    # and B read from rows 7 apart
    assert RL.gemm_work((2, 3), (3, 1), (3, 5), (5, 1)) == \
        (2 * 2 * 3 * 5, 4 * (6 + 15 + 10))
    assert RL.gemm_work((4, 2, 3), (0, 3, 1), (4, 3, 5), (105, 7, 1)) == \
        (2 * 4 * 2 * 3 * 5, 4 * (6 + 60 + 40))
    assert RL.gradient_work(2, 3, 5, 1, 1) == (2 * 2 * 2 * 3 * 5,
                                               4 * (30 + 20 + 2))
    assert RL.poly_work(10, 3) == (2 * 3 * 10, 4 * (20 + 4))
    # (d N (K+T) + 2 ceil(m/K) d + d R K) N multiply-adds, 2 ops each
    assert RL.copml_model_ops(5, 7, 3, 2, 1, 5) == \
        2 * (3 * 5 * 3 + 2 * 4 * 3 + 3 * 5 * 2) * 5


def test_rank_step_closed_forms_by_hand():
    """The collectives of one rank's step: N = 40 clients of d = 6 on 4
    ranks (the rings) and on 40 (past NARROW_SHARDS: the monolithic
    encode's two 13-bit halves, the ring exchange)."""
    proto = copml_dist.make_protocol(40, 80, 6)
    w = 4 * 6                                # bytes of one client's model
    assert copml_dist.rank_step_collectives(proto, 4, True) == {
        "ring_reduce_scatter": {"calls": 3, "bytes": 3 * 10 * w},
        "ring_all_to_all": {"calls": 3, "bytes": 3 * 10 * 10 * w},
        "all_gather": {"calls": 1, "bytes": 10 * w * 3}}
    assert copml_dist.rank_step_collectives(proto, 4, False,
                                            history=True) == {
        "reduce_scatter": {"calls": 1, "bytes": 40 * w * 3 // 4},
        "all_to_all": {"calls": 1, "bytes": 40 * 10 * w * 3 // 4},
        "all_gather": {"calls": 2, "bytes": 2 * 10 * w * 3}}
    assert copml_dist.rank_step_collectives(proto, 40, True) == {
        "reduce_scatter": {"calls": 2, "bytes": 2 * (40 * w * 39 // 40)},
        "ring_all_to_all": {"calls": 39, "bytes": 39 * w},
        "all_gather": {"calls": 1, "bytes": w * 39}}
    gemms = copml_dist.rank_step_launches(proto, 40, True)
    # 3 shares, the encode, its one monolithic segment GEMM, the gradient,
    # 40 exchange blocks, the decode and TruncPr's open
    assert sum(gemms.values()) == 3 + 1 + 1 + 1 + 40 + 1 + 1


# ------------------------------------------------------------- copml_dist


def _jax_fit(args):
    """The JAX package's jit fit of copml_dist's workload (legacy
    threefry), replaying the same seeded plan when --straggle-p is set."""
    import jax
    from repro import api as japi
    from repro.launch import copml_dist as jcd
    wl = jcd._workload(args)
    plan = None
    if args.straggle_p is not None:
        thr = japi.PROTOCOLS["copml"].fault_threshold(wl)
        plan = japi.FaultPlan.random(
            wl.cfg.n_clients, args.iters, seed=args.fault_seed,
            straggle_p=args.straggle_p, min_available=thr)
    with jax.threefry_partitionable(False):
        res = japi.fit(wl, "copml", "jit", key=args.seed, iters=args.iters,
                       history=False, faults=plan)
    return np.asarray(res.weights), np.asarray(res.state.w_shares)


@pytest.mark.parametrize("argv", [
    ["--clients", "13", "--m", "78"],
    ["--clients", "20", "--m", "80", "--straggle-p", "0.15"]],
    ids=["plain", "fault_plan"])
def test_run_parity_equals_jax_jit(capsys, argv):
    args = copml_dist.parser().parse_args(
        ["--devices", "2", "--iters", "3", "--d", "6", "--device", "cpu"]
        + argv)
    res_s, res_j = copml_dist.run_parity(args)
    out = capsys.readouterr().out
    assert "bit-exact: sharded == jit" in out
    assert res_s.engine == "sharded:2"
    w, shares = _jax_fit(args)
    np.testing.assert_array_equal(res_s.weights, w)
    np.testing.assert_array_equal(res_s.state.w_shares.numpy(), shares)
    np.testing.assert_array_equal(res_j.weights, w)
    if args.straggle_p is not None:
        assert "FaultPlan(N=20" in out
        assert res_s.availability.sum(1).min() < 20


def test_run_bench_rows():
    args = copml_dist.parser().parse_args(
        ["--devices", "2", "--iters", "2", "--clients", "13", "--m", "78",
         "--d", "6", "--reps", "1", "--device", "cpu", "--bench"])
    rows = []
    copml_dist.run_bench(args, report=rows.append)
    assert [r.split(",")[0] for r in rows] == [
        "copml_dist/train_jit_1dev_2it", "copml_dist/train_sharded_2dev_2it"]
    assert rows[0].endswith(",1.00x_vs_1dev")


def test_copml_dist_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        copml_dist.main(["--devices", "2"])


@pytest.mark.parametrize("overlap", ["0", "1"])
def test_smoke_cell_executes_on_two_ranks(monkeypatch, overlap):
    monkeypatch.setenv("REPRO_SHARDED_OVERLAP", overlap)
    rec = copml_dist.dryrun_cell("smoke", 256, False, execute_ranks=2,
                                 device="cpu")
    assert (rec["status"], rec["n_clients"], rec["K"], rec["T"]) == \
        ("model", 256, 44, 42)
    ex = rec["executed"]
    assert ex["ranks"] == 2 and ex["device"] == "cpu"
    assert ex["overlap"] == (overlap == "1")
    assert ex["bit_equal_single_device"]
    want = copml_dist.rank_step_collectives(
        copml_dist.make_protocol(256, 416, 64), 2, overlap == "1")
    for sent in ex["sent_bytes"]:
        assert {k: v for k, v in sent.items() if v} == \
            {k: v["bytes"] for k, v in want.items()}
    # the model: one client a rank, the monolithic encode past 31 ranks
    assert rec["collectives"]["reduce_scatter"] == 2
    assert rec["bytes_per_device"]["argument"] == 4 * (10 * 64 + 2 * 64)
    assert rec["model_ops"] == copml_dist.model_ops(
        copml_dist.make_config(256, 416, 64), 416, 64)


def test_dryrun_exit_codes_and_closing_line(tmp_path, monkeypatch, capsys):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "copml-logreg", "--shape", "smoke", "--execute-ranks", "0",
         "--out", str(tmp_path)], env=_env(), cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == \
        "dry-run: all requested cells compiled"
    rec = json.loads((tmp_path / "copml-logreg_smoke_pod.json").read_text())
    assert rec["status"] == "model" and "executed" not in rec
    dryrun.main(["--shape", "long_500k", "--mesh", "both",
                 "--execute-ranks", "0"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "dry-run: all requested cells compiled"
    assert sum(line.startswith("SKIP copml-logreg x long_500k")
               for line in lines) == 2

    def broken(*a, **k):
        raise RuntimeError("a cell that fails")

    monkeypatch.setattr(copml_dist, "dryrun_cell", broken)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--shape", "smoke", "--mesh", "both"])
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert err.count("FAIL copml-logreg x smoke") == 2
    assert "2 failures" in err


# ----------------------------------------------------------- train, counter


def _without_time(summary: str) -> str:
    return re.sub(r"iters in [0-9.]+s", "iters in <s>", summary)


def test_train_prints_the_fit_summary():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--workload",
         "smoke", "--iters", "3", "--device", "cpu"], env=_env(), cwd=REPO,
        capture_output=True, text=True, timeout=300, check=True)
    res = api.fit("smoke", "copml", "jit", iters=3, device="cpu")
    assert _without_time(out.stdout.splitlines()[-1]) == \
        _without_time(res.summary())


def test_launch_counter_on_cpu_steps():
    wl = api.get_workload("smoke")
    with launch_counter.LaunchLog() as log:
        res = api.fit(wl, "copml", "jit", iters=1, device="cpu")
    assert log.counts("setup")["modmatmul"] > 0
    assert log.counts("step")["fused_step"] == 1
    proto = api.protocols.driver(wl, torch.device("cpu"))
    cnt = launch_counter.count_steps(proto.iteration, res.state, 2)
    assert cnt["launches"]["fused_step"] == 1
    assert cnt["launches"]["modmatmul_batched"] >= 1
    o, b = launch_counter.work(cnt["rows"])
    assert (cnt["ops"], cnt["bytes"]) == (o / 2, b / 2) and o > 0
    # no device here: the profile's device numbers are not measured
    assert cnt["device_ms_per_step"] is None and cnt["idle_share"] is None
    rf = cnt.roofline("smoke step", model_ops=1.0)
    assert rf.ops == cnt["ops"] and rf.chips == 1


def test_registry_and_production_meshes(capsys):
    """The registry holds the JAX package's archs in its order, each
    config equal to the JAX package's field by field; launch.train runs an
    LM arch (its LM route); the dry run reports an LM cell for every arch
    x applicable shape and no `SKIP <arch>` line."""
    import dataclasses

    from repro.configs import registry as jregistry
    from repro_torch.launch import train
    assert registry.ARCH_IDS == jregistry.ARCH_IDS
    assert registry.LM_ARCH_IDS == registry.ARCH_IDS[:-1]
    for arch in registry.ARCH_IDS:
        for get in ("get_config", "smoke_config"):
            got = getattr(registry, get)(arch)
            want = getattr(jregistry, get)(arch)
            assert type(got).__name__ == type(want).__name__, (arch, get)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (arch, get)
    assert registry.get_config("copml-logreg") is copml_logreg.CONFIG
    assert registry.smoke_config("copml-logreg") is copml_logreg.SMOKE
    with pytest.raises(ValueError):
        registry.get_config("gpt-5")
    train.main(["--arch", "qwen3-1.7b", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "8"])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "final loss: ")
    dryrun.main(["--all", "--execute-ranks", "0"])
    lines = capsys.readouterr().out.splitlines()
    skips = [line for line in lines if line.startswith("SKIP")
             and "copml-logreg" not in line]
    assert skips == [
        f"SKIP {a} x long_500k: skipped (full attention at 500k context)"
        for a in registry.LM_ARCH_IDS
        if not registry.get_config(a).subquadratic]
    from repro_torch.models.config import applicable_shapes
    for a in registry.LM_ARCH_IDS:
        cells = [line for line in lines if line.startswith(f"--- {a} x ")]
        assert cells == [f"--- {a} x {s.name} x pod(256) ---" for s in
                         applicable_shapes(registry.get_config(a))], a
    assert lines[-1] == "dry-run: all requested cells compiled"
    assert (mesh_lib.production_ranks(),
            mesh_lib.production_ranks(multi_pod=True)) == (256, 512)
    assert isinstance(copml_dist.parser().parse_args([]), argparse.Namespace)
