"""repro_torch's other protocols and secure serving on a CUDA card.

The card-side counterparts of test_torch_baselines.py, test_torch_protocols
.py and test_torch_serve.py: they import no JAX, hold the card to the JAX
package's pinned shas (chip_smoke.py's MPC_SHAS and AGG_SHAS, which the CPU
tests pin to the JAX package) and to the port's own CPU runs, are marked
`gpu`, and skip where no card is present.  On a card:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_protocols.py
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import field, protocol, quantize
from repro_torch.core import random as jrandom
from repro_torch.kernels import modmatmul as mm
from repro_torch.kernels import ops, ref
from repro_torch.serve import coded

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scheme", ["bh08", "bgw"])
def test_mpc_baseline_shas_on_the_card(cuda, chip_smoke, scheme):
    ops.reset_launches()
    assert chip_smoke.mpc_smoke(scheme, cuda) == chip_smoke.MPC_SHAS[scheme]
    counts = ops.launch_counts()
    assert counts["modmatmul"] > 0 and counts["modmatmul_batched"] > 0


def test_aggregation_rounds_on_the_card(cuda, chip_smoke):
    assert chip_smoke.agg_rounds(cuda) == chip_smoke.AGG_SHAS


@pytest.mark.parametrize("protocol", ["float", "poly_float"])
@pytest.mark.parametrize("name", ["smoke", "mnist10_like", "linreg_smoke"])
def test_float_protocols_on_the_card(cuda, protocol, name):
    for engine, tol_w, tol_h in (("eager", 1e-9, 1e-9),
                                 ("jit", 1e-5, 1e-4)):
        got = api.fit(name, protocol, engine)
        want = api.fit(name, protocol, engine, device="cpu")
        assert got.device.startswith("cuda")
        np.testing.assert_allclose(got.weights, want.weights, rtol=0,
                                   atol=tol_w)
        np.testing.assert_allclose(got.history, want.history, rtol=0,
                                   atol=tol_h)


@pytest.mark.parametrize("name", ["smoke", "mnist10_like", "linreg_smoke"])
def test_secure_agg_fit_on_the_card(cuda, name):
    got = api.fit(name, "secure_agg", "jit", iters=6)
    want = api.fit(name, "secure_agg", "jit", iters=6, device="cpu")
    np.testing.assert_allclose(got.history, want.history, rtol=0, atol=1e-4)


def test_mpc_baseline_fit_on_the_card_equals_cpu(cuda):
    got = api.fit("mnist10_like", "mpc_baseline", "jit", iters=2)
    want = api.fit("mnist10_like", "mpc_baseline", "jit", iters=2,
                   device="cpu")
    np.testing.assert_array_equal(got.state.w_shares.cpu().numpy(),
                                  want.state.w_shares.numpy())
    np.testing.assert_array_equal(got.history, want.history)
    assert got.cost == want.cost


@pytest.mark.parametrize("name,protocol", [
    ("smoke", "copml"), ("mnist10_like", "copml"), ("smoke", "float")])
def test_serving_on_the_card_is_bit_exact(cuda, name, protocol):
    res = api.fit(name, protocol, "jit", iters=3)
    wl = api.get_workload(name)
    x, _ = wl.eval_set()
    x = np.asarray(x[:40], np.float32)
    srv = api.serve(name, res, "jit", batch_size=16)
    assert srv.model.w_cols.is_cuda
    assert srv.model.from_shares == (protocol == "copml")
    ops.reset_launches()
    secure = srv.score_field(x)
    assert ops.launch_counts()["modmatmul"] > 0
    np.testing.assert_array_equal(
        secure, coded.reference_scores(res.weights, x, wl.cfg).numpy())
    preds, stats = srv.serve(x)
    np.testing.assert_array_equal(preds, srv.predict(x))
    assert stats["batches"] == 3


@pytest.mark.parametrize("b", [1, 32, 128])
def test_serving_gemm_shapes_match_plain(cuda, b):
    """(B, 3073) @ (3073, 50), serving's packed GEMM at cifar10_case2's
    width, on the split-K kernel."""
    rng = np.random.default_rng(b)
    a = torch.from_numpy(rng.integers(0, field.P, (b, 3073), dtype=np.int64)
                         .astype(np.int32))
    w = torch.from_numpy(rng.integers(0, field.P, (3073, 50),
                                      dtype=np.int64).astype(np.int32))
    assert mm.path_of(a[None], w[None]) == "splitk"
    got = mm.modmatmul(a.to(cuda), w.to(cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(), ref.modmatmul(a, w).numpy())


@pytest.mark.parametrize("c", [1, 10])
def test_baseline_z_gemm_matches_plain(cuda, c):
    """Z = X W of the MPC baseline: a K-contiguous (N_g, m/3, d) share
    tensor times (N_g, d, C), on the row-dot kernel (a cut of cifar10_case2's
    (16, 3006, 3073))."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy(rng.integers(0, field.P, (4, 301, 3073),
                                      dtype=np.int64).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, field.P, (4, 3073, c),
                                      dtype=np.int64).astype(np.int32))
    assert mm.path_of(x, w) == "rowdot"
    got = mm.modmatmul_batched(x.to(cuda), w.to(cuda)).cpu()
    np.testing.assert_array_equal(got.numpy(),
                                  ref.modmatmul_batched(x, w).numpy())


def test_proc_engine_smoke_golden_on_the_card(cuda, chip_smoke):
    """proc:4 on the card: four worker processes, each with its own CUDA
    context, land on the smoke goldens with the budgeted frames; every
    worker ran on cuda, launched its coded-gradient kernel once a step,
    and took no GEMM down the tiled path."""
    from repro_torch.core import cost_model
    res = api.fit("smoke", "copml", "proc:4", key=0, iters=10)
    np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                  np.asarray(chip_smoke.GOLDEN_W))
    assert chip_smoke.sha(res.state.w_shares.cpu().numpy(), np.int32) == \
        chip_smoke.GOLDEN_SHARES_SHA
    assert chip_smoke.sha(res.history, np.float32) == \
        chip_smoke.GOLDEN_HIST_SHA
    mc = res.measured_comm
    assert mc["frames_by_phase"] == cost_model.proc_net_frames(
        4, 10, history=True)
    for rec in mc["workers"]:
        assert rec["device"].startswith("cuda")
        assert rec["launches"]["coded_gradient_batched"] == 10
        assert rec["launches"]["fused_step"] == 0
        assert rec["gemm_paths"]["thin"] > 0
        assert rec["gemm_paths"]["tiled"] == 0


def test_proc_engine_pinned_subset_on_the_card(cuda):
    """smoke_straggler's default decode subset pinned through proc:3 (13
    clients in groups of 5, the last with 2 zero rows): the workers wait
    for exactly the ranks that cover it, and land on the jit fit's bits."""
    ref = api.fit("smoke_straggler", "copml", "jit", history=False)
    res = api.fit("smoke_straggler", "copml", "proc:3", history=False)
    np.testing.assert_array_equal(res.weights, ref.weights)
    np.testing.assert_array_equal(res.state.w_shares.cpu().numpy(),
                                  ref.state.w_shares.cpu().numpy())
    assert res.measured_comm["degraded_steps"] == 0


def _card_ranks(res, iters: int, kernel: str) -> None:
    """Every rank of a sharded fit ran on a card, launched its gradient
    kernel once a step, and took no GEMM down the tiled path."""
    for rec in res.timings["ranks"]:
        assert rec["device"].startswith("cuda")
        assert rec["launches"][kernel] == iters
        assert rec["launches"]["fused_step"] == 0
        assert rec["gemm_paths"]["thin"] > 0
        assert rec["gemm_paths"]["tiled"] == 0
        assert rec["peak_bytes"] > 0


def test_sharded2_gloo_on_the_card_equals_jit(cuda, chip_smoke):
    """Two gloo ranks on one card (collectives staged through the host):
    jit's bits on smoke, and a sharded server equal to reference_scores."""
    from repro_torch.core import meshutil
    mesh = meshutil.ClientMesh(2, cuda, backend="gloo")
    try:
        assert mesh.devices == [torch.device("cuda", 0)] * 2
        res = api.fit("smoke", "copml", mesh, key=0, iters=10)
        assert res.engine == "sharded:2"
        np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                      np.asarray(chip_smoke.GOLDEN_W))
        assert chip_smoke.sha(res.state.w_shares.cpu().numpy(),
                              np.int32) == chip_smoke.GOLDEN_SHARES_SHA
        assert chip_smoke.sha(res.history, np.float32) == \
            chip_smoke.GOLDEN_HIST_SHA
        assert {r["backend"] for r in res.timings["ranks"]} == {"gloo"}
        _card_ranks(res, 10, "coded_gradient_batched")
        x = np.asarray(api.get_workload("smoke").eval_set()[0][:33],
                       np.float32)
        srv = api.serve("smoke", res, mesh, batch_size=16)
        want = coded.reference_scores(res.weights, x,
                                      api.get_workload("smoke").cfg)
        np.testing.assert_array_equal(srv.score_field(x), want.numpy())
    finally:
        mesh.close()


def test_sharded1_nccl_on_the_card(cuda, chip_smoke):
    from repro_torch.core import meshutil
    mesh = meshutil.ClientMesh(1, cuda, backend="nccl")
    try:
        res = api.fit("smoke", "copml", mesh, key=0, iters=10)
        np.testing.assert_array_equal(np.asarray(res.weights, np.float64),
                                      np.asarray(chip_smoke.GOLDEN_W))
        assert chip_smoke.sha(res.state.w_shares.cpu().numpy(),
                              np.int32) == chip_smoke.GOLDEN_SHARES_SHA
        assert [r["backend"] for r in res.timings["ranks"]] == ["nccl"]
        _card_ranks(res, 10, "coded_gradient_batched")
    finally:
        mesh.close()


def test_nccl_with_more_ranks_than_cards_raises(cuda):
    from repro_torch.core import meshutil
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        meshutil.ClientMesh(torch.cuda.device_count() + 1, cuda,
                            backend="nccl")


@pytest.mark.parametrize("argv", [
    ["--clients", "13", "--m", "78"],
    ["--clients", "20", "--m", "80", "--straggle-p", "0.15"]],
    ids=["plain", "fault_plan"])
def test_copml_dist_parity_on_the_card(cuda, capsys, argv):
    """launch/copml_dist's parity on the card (gloo ranks on cuda:0),
    bit-equal to the same run on the CPU."""
    from repro_torch.core import meshutil
    from repro_torch.launch import copml_dist
    base = ["--devices", "2", "--iters", "3", "--d", "6"] + argv
    try:
        res_s, res_j = copml_dist.run_parity(
            copml_dist.parser().parse_args(base))
        assert "bit-exact: sharded == jit" in capsys.readouterr().out
        assert res_s.device.startswith("cuda")
        cpu_s, _ = copml_dist.run_parity(
            copml_dist.parser().parse_args(base + ["--device", "cpu"]))
        np.testing.assert_array_equal(res_s.weights, cpu_s.weights)
        np.testing.assert_array_equal(res_s.state.w_shares.cpu().numpy(),
                                      cpu_s.state.w_shares.numpy())
    finally:
        meshutil.close_meshes()


@pytest.mark.parametrize("overlap", ["0", "1"])
def test_dryrun_smoke_cell_on_the_card(cuda, monkeypatch, overlap):
    """The smoke dry-run cell's step on 2 ranks of the card: bytes by
    collective and launches equal to the closed forms (checked inside),
    bit-equal to the single-device step, every rank's peak measured."""
    from repro_torch.core import meshutil
    from repro_torch.launch import copml_dist
    monkeypatch.setenv("REPRO_SHARDED_OVERLAP", overlap)
    try:
        rec = copml_dist.dryrun_cell("smoke", 256, False, execute_ranks=2,
                                     device="cuda")
    finally:
        meshutil.close_meshes()
    ex = rec["executed"]
    assert ex["device"].startswith("cuda") and ex["bit_equal_single_device"]
    assert all(p and p > 0 for p in ex["peak_bytes"])
    for launches in ex["launches"]:
        assert launches["coded_gradient_batched"] == 1


def test_launch_counter_on_the_card(cuda):
    """launch_counter over two smoke steps on the card: its field-kernel
    launches equal ops.launch_counts, and the profile saw the device."""
    from repro_torch.launch import launch_counter
    wl = api.get_workload("smoke")
    res = api.fit(wl, "copml", "jit", iters=1)
    proto = api.protocols.driver(wl, cuda)
    ops.reset_launches()
    cnt = launch_counter.count_steps(proto.iteration, res.state, 2)
    counts = ops.launch_counts()
    for name, per_step in cnt["launches"].items():
        assert counts[name] == 2 * per_step, (name, counts, cnt["launches"])
    assert counts["fused_step"] == 2
    assert cnt["device_kernels_per_step"] > sum(cnt["launches"].values())
    assert 0.0 < cnt["idle_share"] < 1.0 and cnt["device_ms_per_step"] > 0


def _concatenated_rows(proto, client_xs, client_ys):
    """Phase 1 as one host array: the clients' rows joined by
    np.concatenate, copied to the card and quantized there."""
    xq = quantize.quantize(np.concatenate(client_xs), proto.cfg.lx,
                           proto.device)
    yq = quantize.quantize(np.asarray(proto.obj.prepare_targets(
        np.concatenate(client_ys)), np.float32), proto.cfg.lg, proto.device)
    return xq, yq


def _spy_row_copies(mp) -> dict:
    """The source device of every Tensor.copy_ (set-up's one copy a client
    into its buffer on the card) under "copies", and under "joined" the
    np.concatenate calls given 2-D arrays (a host array of all the
    rows), while `mp` holds."""
    seen = {"copies": [], "joined": 0}
    copy_, concatenate = torch.Tensor.copy_, np.concatenate

    def spy_copy(dst, src, *a, **kw):
        seen["copies"].append(src.device.type)
        return copy_(dst, src, *a, **kw)

    def spy_concatenate(arrays, *a, **kw):
        arrays = list(arrays)
        seen["joined"] += any(np.ndim(x) == 2 for x in arrays)
        return concatenate(arrays, *a, **kw)

    mp.setattr(torch.Tensor, "copy_", spy_copy)
    mp.setattr(np, "concatenate", spy_concatenate)
    return seen


@pytest.mark.parametrize("mixed", [False, True])
def test_setup_rows_on_the_card_equal_the_concatenated_rows(cuda,
                                                            monkeypatch,
                                                            mixed):
    """cifar10_case2's shape (m = 9,019, d = 3,073, N = 50, K = 10, T = 7),
    each client's rows copied straight into one buffer on the card: the
    field elements and the CopmlState equal those of the rows concatenated
    on the host, and a job copies each client's rows once, from the host
    for a float32 client and on the card after its host-to-device copy
    otherwise, with no host array of all the rows.  `mixed`: every third
    client float64, every third int8."""
    m, d, n = 9019, 3073, 50
    rng = np.random.default_rng(29)
    x = np.clip(rng.normal(0.0, 0.5, (m, d)), -1.0, 1.0)
    y = (rng.random(m) < 0.5).astype(np.float32)
    parts = np.array_split(np.arange(m), n)
    srcs = (x.astype(np.float32),)
    if mixed:
        srcs += (x, np.round(x * 100).astype(np.int8))
    cx = [srcs[j % len(srcs)][i] for j, i in enumerate(parts)]
    cy = [y[i] for i in parts]
    cfg = protocol.CopmlConfig(n_clients=n, k=10, t=7)
    proto = protocol.Copml(cfg, m, d, device=cuda)
    xq, yq = proto.quantize_rows(cx, cy)
    want_x, want_y = _concatenated_rows(proto, cx, cy)
    assert torch.equal(xq, want_x) and torch.equal(yq, want_y)
    del xq, want_x

    key = jrandom.as_key(5)
    got = proto.setup(key, cx, cy)
    with monkeypatch.context() as mp:
        mp.setattr(proto, "quantize_rows",
                   lambda xs, ys: _concatenated_rows(proto, xs, ys))
        want = proto.setup(key, cx, cy)
    for f in ("w_shares", "coded_x", "xty_shares"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    del got, want
    timings = {}
    with monkeypatch.context() as mp:
        seen = _spy_row_copies(mp)
        proto.train(3, cx, cy, 1, timings=timings)
    f32 = sum(x.dtype == np.float32 for x in cx)
    assert sorted(seen["copies"]) == ["cpu"] * f32 + ["cuda"] * (n - f32)
    assert seen["joined"] == 0
    assert timings["spans"]["setup.rows"][0] == 1
