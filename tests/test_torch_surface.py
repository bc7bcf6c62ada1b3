"""The last of the JAX package's public surface in the port, each held to
its JAX counterpart on the CPU: quantize.quantization_noise_variance,
field.matvec_batched, ref.coded_gradient_vmap, the deprecated
Copml.train_jit / train_eager / train_sharded shims, and the five examples
(`python -m repro_torch.examples.<name>`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import field as jfield
from repro.core import quantize as jquantize
from repro.kernels import ref as jref
from repro_torch import api
from repro_torch.core import field, meshutil, quantize
from repro_torch.core.protocol import Copml
from repro_torch.examples import (multiclass_quickstart, protocol_matrix,
                                  quickstart, secure_agg_lm, train_lm)
from repro_torch.kernels import ref

P = field.P


def _fld(rng, *shape):
    return rng.integers(0, P, size=shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("d,m,k1", [(3073, 9019, 21), (12, 96, 11),
                                    (65536, 1560, 25)])
def test_quantization_noise_variance_matches_jax(d, m, k1):
    got = quantize.quantization_noise_variance(d, m, k1)
    assert got == jquantize.quantization_noise_variance(d, m, k1)
    assert got > 0


def test_matvec_batched_at_p_minus_1():
    """All-(p-1) operands, K past the JAX package's 1024-term chunk."""
    k = jfield.MATMUL_CHUNK + 5
    a = np.full((3, 8, k), P - 1, np.int32)
    v = np.full((3, k), P - 1, np.int32)
    got = field.matvec_batched(torch.from_numpy(a), torch.from_numpy(v))
    want = np.asarray(jfield.matvec_batched(jnp.asarray(a), jnp.asarray(v)))
    np.testing.assert_array_equal(got.numpy(), want)
    exp = field.np_matmul(a[0], v[0][:, None])[:, 0]
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), exp)


def test_matvec_batched_matches_jax():
    rng = np.random.default_rng(3)
    a, v = _fld(rng, 5, 7, 2000), _fld(rng, 5, 2000)
    got = field.matvec_batched(torch.from_numpy(a), torch.from_numpy(v))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfield.matvec_batched(jnp.asarray(a),
                                                      jnp.asarray(v))))
    with pytest.raises(ValueError, match="matvec_batched"):
        field.matvec_batched(torch.from_numpy(a), torch.from_numpy(v[:, 1:]))


def test_coded_gradient_vmap_matches_batched_and_jax():
    rng = np.random.default_rng(11)
    x, w, c = _fld(rng, 4, 70, 40), _fld(rng, 4, 40), _fld(rng, 4)
    x[0] = P - 1
    w[0] = P - 1
    tx, tw, tc = (torch.from_numpy(a) for a in (x, w, c))
    got = ref.coded_gradient_vmap(tx, tw, tc)
    np.testing.assert_array_equal(got.numpy(),
                                  ref.coded_gradient_batched(tx, tw, tc))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.coded_gradient_vmap(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(c))))


@pytest.fixture(scope="module")
def smoke_jax_fit():
    with jax.threefry_partitionable(False):
        return japi.fit("smoke", "copml", "jit", key=0, iters=3,
                        history=False)


def test_train_method_shims_warn_and_match_facade(smoke_jax_fit):
    """The shims warn, name repro_torch.api.fit, and give api.fit's bits
    (and the JAX package's)."""
    wl = api.get_workload("smoke")
    proto = Copml(wl.cfg, wl.m, wl.d, device="cpu")
    cx, cy = wl.client_data()
    key = np.asarray(jax.random.PRNGKey(0))
    res = api.fit("smoke", "copml", "jit", key=0, iters=3, history=False,
                  device="cpu")
    np.testing.assert_array_equal(res.weights, smoke_jax_fit.weights)
    with pytest.warns(DeprecationWarning, match="train_jit is deprecated"):
        st_j, w_j = proto.train_jit(key, cx, cy, 3)
    with pytest.warns(DeprecationWarning,
                      match=r"train_eager is deprecated; use repro_torch\."
                            r"api\.fit"):
        st_e, w_e = proto.train_eager(key, cx, cy, 3)
    try:
        with pytest.warns(DeprecationWarning,
                          match="train_sharded is deprecated"):
            st_s, w_s = proto.train_sharded(key, cx, cy, 3, mesh=None)
    finally:
        meshutil.close_meshes()
    for w, st in ((w_j, st_j), (w_e, st_e), (w_s, st_s)):
        np.testing.assert_array_equal(np.asarray(w), res.weights)
        np.testing.assert_array_equal(st.w_shares.numpy(),
                                      res.state.w_shares.numpy())
        np.testing.assert_array_equal(
            st.w_shares.numpy(), np.asarray(smoke_jax_fit.state.w_shares))


def test_train_eager_callback_matches_train_jit_history():
    """tests/test_protocol.py's eager-vs-jit case: the eager shim's
    callback sees each step's opened model, the jit shim's history."""
    wl = api.get_workload("smoke")
    proto = Copml(wl.cfg, wl.m, wl.d, device="cpu")
    cx, cy = wl.client_data()
    seen = []
    with pytest.warns(DeprecationWarning):
        st_e, w_e = proto.train_eager(
            11, cx, cy, iters=4,
            callback=lambda t, w: seen.append((t, w.numpy().copy())))
    with pytest.warns(DeprecationWarning):
        st_j, w_j, hist = proto.train_jit(11, cx, cy, iters=4, history=True)
    np.testing.assert_array_equal(w_e.numpy(), w_j.numpy())
    np.testing.assert_array_equal(st_e.w_shares.numpy(),
                                  st_j.w_shares.numpy())
    assert [t for t, _ in seen] == [0, 1, 2, 3] and hist.shape[0] == 4
    for t, w in seen:
        np.testing.assert_array_equal(w, hist[t].numpy())
    with pytest.raises(ValueError, match="only supported on the eager"):
        api.run_copml_engine(proto, "jit", 11, cx, cy, 2,
                             callback=lambda t, w: None)


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_example_quickstart_matches_jax(capsys):
    """quickstart (30 iterations) prints the JAX package's example lines
    with its numbers."""
    secure, plain = quickstart.main(["--device", "cpu"])
    out = _lines(capsys)
    with jax.threefry_partitionable(False):
        jsec = japi.fit("quickstart", "copml", "jit", key=0)
    jplain = japi.fit("quickstart", "float", "eager", key=0)
    np.testing.assert_array_equal(secure.weights, jsec.weights)
    wl = japi.get_workload("quickstart")
    assert secure.iters == plain.iters == wl.iters == 30
    assert out[0] == (f"COPML: N={wl.n_clients} clients, K={wl.cfg.k} "
                      f"(parallelization), T={wl.cfg.t} (privacy), recovery "
                      f"threshold R={wl.cfg.recovery_threshold}")
    assert out[2:5] == [f"  iter {t:3d}  accuracy {jsec.accuracy[t]:.3f}"
                        for t in (0, 10, 20)]
    assert (f"final accuracy: COPML {jsec.final_accuracy:.3f} vs float "
            f"logreg {jplain.final_accuracy:.3f}") in out[6]
    assert out[7].startswith("modeled per-client cost")
    assert f"COPML {jsec.cost['total_s']:.0f}s total" in out[7]


def test_example_multiclass_quickstart(capsys):
    secure, plain = multiclass_quickstart.main(["--device", "cpu"])
    out = _lines(capsys)
    wl = japi.get_workload("mnist10_like")
    assert out[0] == (f"COPML multi-class: N={wl.n_clients} clients, C=10 "
                      f"one-vs-rest classes on ONE dataset encoding "
                      f"(K={wl.cfg.k}, T={wl.cfg.t}, "
                      f"R={wl.cfg.recovery_threshold})")
    assert secure.weights.shape == (wl.d, 10) and secure.iters == wl.iters
    assert sum(ln.startswith("  class ") for ln in out) == 10
    assert out[-1].endswith("amortized over all 10 classes")


def test_example_protocol_matrix(capsys):
    rows = protocol_matrix.main(["--device", "cpu"])
    out = _lines(capsys)
    assert out[0] == "workload 'smoke', 10 GD iterations, engine jit"
    assert set(rows) == set(japi.protocol_names()) == \
        set(api.protocol_names())
    for name, res in rows.items():
        assert any(ln.startswith(f"{name:14s} {res.final_accuracy:8.3f}")
                   for ln in out), name


def test_example_train_lm(capsys, tmp_path):
    params, hist = train_lm.main(["--device", "cpu", "--steps", "2",
                                  "--ckpt", str(tmp_path)])
    out = _lines(capsys)
    assert out[0].startswith("training smollm-360m variant: ~")
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert out[-1].startswith(f"loss: {hist[0]['loss']:.3f} -> ")
    assert any(tmp_path.iterdir())                  # a checkpoint was written


def test_example_secure_agg_lm(capsys, monkeypatch):
    monkeypatch.setattr(secure_agg_lm, "STEPS", 2)
    params, hist = secure_agg_lm.main(["--device", "cpu"])
    out = _lines(capsys)
    assert out[0] == ("secure aggregation: N=8 hosts, privacy T=2, "
                      "straggler budget 5")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert out[-1].endswith("information-theoretically private)")
