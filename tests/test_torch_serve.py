"""repro_torch's secure serving vs the JAX package's, on the CPU.

score_field (quantize, one packed field GEMM over every client's model
shares, reconstruct the logits) must equal reference_scores of the opened
model bit for bit -- the port's and the JAX package's -- and the JAX
package's score_field on the same share state and re-share key.  The
micro-batch queue behaves as the JAX package's tests/test_serve.py holds
it to.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import baselines as jbaselines
from repro.core.protocol import CopmlState as JCopmlState
from repro.serve import coded as jcoded
from repro.serve.server import SecureServer as JSecureServer
from repro_torch import api
from repro_torch.core import meshutil, quantize, shamir
from repro_torch.core import random as jrandom
from repro_torch.serve import coded
from repro_torch.serve.queue import MicroBatchQueue


@pytest.fixture(scope="module")
def smoke_result():
    return api.fit("smoke", "copml", "jit", iters=4, history=False,
                   device="cpu")


@pytest.fixture(scope="module")
def mnist_result():
    return api.fit("mnist10_like", "copml", "jit", iters=3, history=False,
                   device="cpu")


def _queries(workload, n):
    x, y = api.get_workload(workload).eval_set()
    return np.asarray(x[:n], np.float32), np.asarray(y[:n])


def _jax_score_field(result, wl, queries, key):
    """The JAX package's SecureServer.score_field on the port result's
    share state (carried across as a JAX CopmlState) or, without one, on
    its opened weights; re-share key `key`."""
    st_ = result.state
    jstate = None if st_ is None else JCopmlState(
        w_shares=jnp.asarray(st_.w_shares.numpy()),
        coded_x=jnp.asarray(st_.coded_x.numpy()),
        xty_shares=jnp.asarray(st_.xty_shares.numpy()))
    jres = types.SimpleNamespace(weights=result.weights, state=jstate)
    with jax.threefry_partitionable(False):
        model = jcoded.encode_model(jax.random.PRNGKey(key), jres, wl.cfg,
                                    wl.objective)
        srv = JSecureServer(workload=wl.name, protocol=result.protocol,
                            engine="eager", kind="eager", batch_size=8,
                            window_ms=5.0, model=model,
                            objective=wl.objective)
        return srv.score_field(queries), model


@pytest.fixture(scope="module", autouse=True)
def _close_meshes():
    yield
    meshutil.close_meshes()


@pytest.mark.parametrize("engine", ["eager", "jit", "sharded:1"])
@pytest.mark.parametrize("workload,fixture", [
    ("smoke", "smoke_result"),            # (d,) vector model
    ("mnist10_like", "mnist_result"),     # (d, C) matrix model
])
def test_score_field_bit_exact(engine, workload, fixture, request):
    """The secure logits equal reference_scores (the port's and the JAX
    package's) of the opened weights, and the JAX package's score_field
    on the same share state and key; the re-shared model stacks match."""
    res = request.getfixturevalue(fixture)
    wl = api.get_workload(workload)
    x, _ = _queries(workload, 16)
    srv = api.serve(workload, res, engine, key=3, batch_size=8,
                    device="cpu")
    assert srv.model.from_shares        # copml state: model never opened
    secure = srv.score_field(x)
    ref = coded.reference_scores(res.weights, x, wl.cfg).numpy()
    np.testing.assert_array_equal(secure, ref)
    np.testing.assert_array_equal(
        ref, np.asarray(jcoded.reference_scores(res.weights, x, wl.cfg)))
    jscore, jmodel = _jax_score_field(res, wl, x, 3)
    np.testing.assert_array_equal(secure, jscore)
    np.testing.assert_array_equal(srv.model.w_stack.numpy(),
                                  np.asarray(jmodel.w_stack))
    np.testing.assert_array_equal(srv.model.w_cols.numpy(),
                                  np.asarray(jmodel.w_cols))
    assert srv.model.points == jmodel.points


@pytest.mark.parametrize("protocol", ["float", "secure_agg"])
def test_fallback_encode_without_share_state(protocol):
    """A float or secure_agg result (no share state) serves from fresh
    shares of its quantized weights at the default points: bit-exact vs
    reference_scores and vs the JAX package's fallback encode."""
    res = api.fit("smoke", protocol, "eager", iters=4, device="cpu")
    wl = api.get_workload("smoke")
    x, _ = _queries("smoke", 8)
    srv = api.serve("smoke", res, "eager", key=5, batch_size=8,
                    device="cpu")
    assert not srv.model.from_shares
    assert srv.model.points == shamir.default_eval_points(wl.n_clients)
    secure = srv.score_field(x)
    np.testing.assert_array_equal(
        secure, coded.reference_scores(res.weights, x, wl.cfg).numpy())
    jscore, jmodel = _jax_score_field(
        dataclasses.replace(res, state=None), wl, x, 5)
    np.testing.assert_array_equal(secure, jscore)
    np.testing.assert_array_equal(srv.model.w_stack.numpy(),
                                  np.asarray(jmodel.w_stack))


def test_mpc_baseline_result_is_refused_as_by_jax():
    """An mpc_baseline result's MpcState has w_shares, but they are
    subgroup shares (N/3 of them): the JAX package's encode_model re-shares
    them and fails to form the (N, d, C') stack, and so does the port's."""
    res = api.fit("smoke", "mpc_baseline", "jit", iters=2, device="cpu")
    wl = api.get_workload("smoke")
    jstate = jbaselines.MpcState(
        w_shares=jnp.asarray(res.state.w_shares.numpy()),
        x_shares=jnp.asarray(res.state.x_shares.numpy()),
        xty_shares=jnp.asarray(res.state.xty_shares.numpy()))
    jres = types.SimpleNamespace(weights=res.weights, state=jstate)
    with jax.threefry_partitionable(False):
        with pytest.raises(TypeError, match="reshape"):
            jcoded.encode_model(jax.random.PRNGKey(0), jres, wl.cfg,
                                wl.objective)
    with pytest.raises(RuntimeError, match="shape"):
        api.serve("smoke", res, "jit", device="cpu")


def test_model_stays_secret_shared(smoke_result):
    """Any T+1 shares of the CodedModel open to the quantized model, at
    the protocol's serving lambdas; the last T+1 open the same secret."""
    wl = api.get_workload("smoke")
    model = api.serve("smoke", smoke_result, "jit", device="cpu").model
    assert model.points == coded.serving_points(wl.cfg)
    assert model.lz == wl.cfg.lx + wl.cfg.lw and model.n_cols == 1
    wq = quantize.quantize(np.asarray(smoke_result.weights, np.float32),
                           wl.cfg.lw).numpy()
    for sub in (None, tuple(range(model.n - model.t - 1, model.n))):
        opened = shamir.reconstruct(model.w_stack, model.t, model.points,
                                    subset=sub)[:, 0]
        np.testing.assert_array_equal(opened.numpy(), wq)


def test_serve_queue_path_matches_direct_predict(smoke_result, mnist_result):
    """Micro-batched serving (ragged tail included) returns the same
    decisions, in submission order, as one direct predict(); argmax on the
    matrix model."""
    x, _ = _queries("smoke", 21)          # 21 = 2 full windows + tail 5
    srv = api.serve("smoke", smoke_result, "jit", batch_size=8, device="cpu")
    preds, stats = srv.serve(x)
    np.testing.assert_array_equal(preds, srv.predict(x))
    assert set(np.unique(preds)) <= {0, 1}
    assert (stats["queries"], stats["batches"], stats["padded"]) == (21, 3, 3)
    assert stats["queries_per_s"] > 0 and stats["encode_s"] > 0
    assert "21 queries in 3 batches" in srv.summary()
    xm, ym = _queries("mnist10_like", 30)
    msrv = api.serve("mnist10_like", mnist_result, "eager", batch_size=16,
                     device="cpu")
    mpreds, _ = msrv.serve(xm)
    want = np.argmax(xm.astype(np.float64) @ mnist_result.weights.astype(
        np.float64), axis=1)
    assert (mpreds == want).mean() >= 0.9      # only lx/lw rounding differs
    lin = api.fit("linreg_smoke", "float", "jit", iters=3, device="cpu")
    xl, _ = _queries("linreg_smoke", 5)
    lsrv = api.serve("linreg_smoke", lin, "jit", device="cpu")
    np.testing.assert_allclose(lsrv.predict(xl), xl @ lin.weights, atol=0.2)


def test_serve_argument_checks(smoke_result, mnist_result):
    with pytest.raises(ValueError, match="future work"):
        api.serve("smoke", smoke_result, "proc:4", device="cpu")
    srv = api.serve("smoke", smoke_result, "sharded:1", device="cpu")
    assert (srv.engine, srv.kind, srv.mesh.size) == ("sharded:1", "sharded",
                                                     1)
    with pytest.raises(ValueError, match="shape"):
        api.serve("mnist10_like", smoke_result, device="cpu")
    relabeled = dataclasses.replace(mnist_result, workload="smoke")
    with pytest.raises(ValueError, match="trained on"):
        api.serve("mnist10_like", relabeled, device="cpu")
    assert api.SERVE_ENGINES == ("eager", "jit", "sharded")
    with pytest.raises(ValueError, match="needs a mesh"):
        dataclasses.replace(srv, kind="sharded", mesh=None)
    with jax.threefry_partitionable(False):
        key = np.asarray(jax.random.PRNGKey(3))
    a = api.serve("smoke", smoke_result, key=key, device="cpu").model
    b = api.serve("smoke", smoke_result, key=3, device="cpu").model
    np.testing.assert_array_equal(a.w_stack.numpy(), b.w_stack.numpy())
    assert jrandom.as_key(key).tolist() == jrandom.PRNGKey(3).tolist()


# ------------------------------------------------- the micro-batch queue


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_queue_window_expiry_flushes_partial():
    clk = FakeClock()
    q = MicroBatchQueue(batch_size=4, window_ms=10.0, clock=clk)
    assert not q.ready()                       # empty: never ready
    q.submit(np.zeros(3))
    q.submit(np.ones(3))
    assert not q.ready()                       # 2 < 4 and window open
    clk.t += 0.0099
    assert not q.ready()
    clk.t += 0.0002                            # window expired
    assert q.ready()
    tickets, batch, n_valid = q.drain()
    assert tickets == (0, 1) and n_valid == 2
    assert batch.shape == (4, 3)
    np.testing.assert_array_equal(batch[1], np.ones(3))
    np.testing.assert_array_equal(batch[2:], np.zeros((2, 3)))
    assert len(q) == 0 and not q.ready()


def test_queue_full_batch_flushes_regardless_of_clock():
    q = MicroBatchQueue(batch_size=2, window_ms=1e9, clock=FakeClock())
    q.submit(np.zeros(2))
    assert not q.ready()
    q.submit(np.zeros(2))
    assert q.ready()


def test_queue_validates_inputs():
    with pytest.raises(ValueError, match="batch_size"):
        MicroBatchQueue(0, 5.0)
    with pytest.raises(ValueError, match="window_ms"):
        MicroBatchQueue(4, -1.0)
    q = MicroBatchQueue(4, 5.0, clock=FakeClock())
    with pytest.raises(ValueError, match="query row"):
        q.submit(np.zeros((2, 3)))
    q.submit(np.zeros(3))
    with pytest.raises(ValueError, match="dim"):
        q.submit(np.zeros(5))
    with pytest.raises(ValueError, match="empty"):
        MicroBatchQueue(4, 5.0, clock=FakeClock()).drain()


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 40), st.integers(1, 9))
def test_queue_preserves_order_and_pads(n_queries, batch_size):
    """Draining everything yields every ticket exactly once, in
    submission order, with every window exactly (batch_size, d)."""
    q = MicroBatchQueue(batch_size, window_ms=1e9, clock=FakeClock())
    rows = [np.full(2, i, np.float32) for i in range(n_queries)]
    tickets = [q.submit(r) for r in rows]
    assert tickets == list(range(n_queries))
    seen = []
    while len(q):
        tk, batch, n_valid = q.drain()
        assert batch.shape == (batch_size, 2)
        assert 1 <= n_valid <= batch_size
        for i, t in enumerate(tk):
            np.testing.assert_array_equal(batch[i], rows[t])
        np.testing.assert_array_equal(batch[n_valid:],
                                      np.zeros((batch_size - n_valid, 2)))
        seen.extend(tk)
    assert seen == list(range(n_queries))
