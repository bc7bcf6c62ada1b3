"""repro_torch.api.engine against the JAX package's api/engine.py, on the
CPU: engine specs parse to the same label or raise the same exception
type, and api.fit and api.serve refuse every spec the JAX package's parse
refuses and record the spec's label.
"""

import numpy as np
import pytest

from repro.api import engine as jengine
from repro.core import objectives as jobjectives
from repro_torch import api
from repro_torch.api import engine
from repro_torch.core import meshutil
from repro_torch.serve import coded

SPECS = ["jit", "eager", "jit:4", "eager:x", "sharded:0", "sharded:x",
         "proc:3", "nope", "sharded", "sharded:8", "proc", "jit:", ":3",
         "proc:-1", 3, None]
REFUSED = ["jit:4", "eager:x", "sharded:0", "sharded:x", "nope", "proc:-1",
           ":3", 3]


def _parse(mod, spec):
    try:
        return mod.parse(spec).label
    except Exception as exc:               # the type is what is compared
        return type(exc)


@pytest.mark.parametrize("spec", SPECS, ids=repr)
def test_parse_matches_the_jax_package(spec):
    assert _parse(engine, spec) == _parse(jengine, spec)


def test_registry_and_specs_match_the_jax_package():
    assert engine.names() == jengine.names()
    for name in engine.names():
        mine, ref = engine.KINDS[name], jengine.KINDS[name]
        assert (mine.takes_devices, mine.takes_mesh, mine.takes_net) == \
            (ref.takes_devices, ref.takes_mesh, ref.takes_net)
    for const in ("EAGER", "JIT", "SHARDED", "PROC"):
        assert getattr(engine, const).label == getattr(jengine, const).label
    spec = engine.EngineSpec("proc", devices=4)
    assert engine.parse(spec) is spec and spec.label == "proc:4"
    for bad in (dict(kind="jit", devices=2), dict(kind="eager", net=1),
                dict(kind="proc", mesh=object()), dict(kind="proc",
                                                       devices=0)):
        with pytest.raises(ValueError):
            engine.EngineSpec(**bad)
        with pytest.raises(ValueError):
            jengine.EngineSpec(**bad)


def test_api_exports_the_jax_package_names():
    from repro import api as japi
    for name in ("EngineSpec", "EngineKind", "parse_engine",
                 "register_engine_kind", "engine_names", "register_objective",
                 "objective_names", "EAGER", "JIT", "SHARDED", "PROC",
                 "ENGINES", "NetConfig", "run_copml_engine"):
        assert name in api.__all__ and hasattr(api, name), name
    assert set(japi.__all__) <= set(api.__all__)
    assert api.parse_engine is engine.parse
    assert api.engine_names() == engine.names()
    assert api.ENGINES == engine.ENGINES == japi.ENGINES == jengine.names()
    assert api.NetConfig is engine.NetConfig
    assert api.objective_names() == jobjectives.names()


@pytest.mark.parametrize("spec", ["jit:4", "eager:x", "nope", "sharded:0"])
def test_fit_refuses_what_the_jax_parse_refuses(spec):
    with pytest.raises(_parse(jengine, spec)):
        api.fit("smoke", "copml", spec, iters=1, device="cpu")


@pytest.mark.parametrize("protocol,spec", [
    pytest.param("copml", "sharded:2", id="sharded:2"),
    pytest.param("mpc_baseline", "proc:4", id="mpc_baseline-proc:4")])
def test_fit_names_the_roadmap_item_of_an_engine_not_ported(protocol, spec):
    """Every engine of the JAX package is ported: copml runs "sharded:2"
    with jit's bits; proc runs copml only, and another protocol refuses it
    with the JAX package's exception type, before any compute."""
    if protocol == "copml":
        res = api.fit("smoke", protocol, spec, iters=2, device="cpu")
        want = api.fit("smoke", protocol, "jit", iters=2, device="cpu")
        assert res.engine == spec
        np.testing.assert_array_equal(res.weights, want.weights)
        np.testing.assert_array_equal(res.history, want.history)
        meshutil.close_meshes()
        return
    from repro import api as japi
    with pytest.raises(Exception) as want:
        japi.fit("smoke", protocol, spec, iters=1)
    with pytest.raises(type(want.value), match="supports engines"):
        api.fit("smoke", protocol, spec, iters=1, device="cpu")


@pytest.fixture(scope="module")
def smoke_fit():
    return api.fit("smoke", "copml", "eager", iters=2, history=False,
                   device="cpu")


def test_fit_records_the_spec_label(smoke_fit):
    assert smoke_fit.engine == jengine.parse("eager").label == "eager"
    res = api.fit("smoke", "float", api.JIT, iters=2, device="cpu")
    assert res.engine == "jit"


@pytest.mark.parametrize("spec", REFUSED + ["sharded:2", "proc:3"],
                         ids=repr)
def test_serve_refuses_the_same_specs(smoke_fit, spec):
    """Serving refuses what the JAX package's parse refuses, and proc;
    "sharded:2" serves, every window equal to reference_scores."""
    if spec == "sharded:2":
        srv = api.serve("smoke", smoke_fit, spec, device="cpu")
        x = np.asarray(api.get_workload("smoke").eval_set()[0][:9],
                       np.float32)
        want = coded.reference_scores(smoke_fit.weights, x,
                                      api.get_workload("smoke").cfg)
        assert (srv.engine, srv.kind) == ("sharded:2", "sharded")
        np.testing.assert_array_equal(srv.score_field(x), want.numpy())
        meshutil.close_meshes()
        return
    with pytest.raises((ValueError, TypeError)) as err:
        api.serve("smoke", smoke_fit, spec, device="cpu")
    want = _parse(jengine, spec)
    if isinstance(want, type):
        assert isinstance(err.value, want)


def test_serve_records_the_spec_label(smoke_fit):
    srv = api.serve("smoke", smoke_fit, api.EngineSpec("jit"), device="cpu")
    assert (srv.engine, srv.kind) == ("jit", "jit")
    x = np.zeros((2, 12), np.float32)
    assert srv.score_field(x).shape == (2, 1)
