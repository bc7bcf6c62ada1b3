"""seclint on the port: fixture corpus, self-run gate, corruption drills.

The cases of tests/test_analysis.py, against repro_torch.analysis and the
port's sources:

* fixture corpus: the JAX package's tests/fixtures/seclint snippets,
  translated into tmp_path (`repro.` -> `repro_torch.`, jnp idioms ->
  torch: `.astype(t)` -> `.to(torch.t)`, `axis=` -> `dim=`, a `.tobytes()`
  of a tensor -> `.numpy().tobytes()`, and SEC003's unregistered module
  `pickle` -> `json`, since pickle is a host escape here), with the same
  expected rule sets; plus torch's host escapes, one snippet each;
* the live gate: `repro_torch.analysis` over src/repro_torch is clean;
* corruption drills on tmp_path copies of the port's core/protocol.py.
"""

import os
import re
import subprocess
import sys
import time

import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.analysis import analyze_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PORT = os.path.join(REPO, "src", "repro_torch")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "seclint")

#: every fixture's translation into the port's idioms
_TRANSLATE = [
    ("import jax.numpy as jnp", "import torch"),
    ("jnp.", "torch."),
    ('.astype("int32")', ".to(torch.int32)"),
    (".astype(np.float32)", ".to(torch.float32)"),
    ("(axis=0)", "(dim=0)"),
    (".tobytes()", ".numpy().tobytes()"),
    ("import pickle", "import json"),
    ("pickle.dumps(", "json.dumps("),
]


def translate(src: str) -> str:
    out = re.sub(r"\brepro\.", "repro_torch.", src)
    for a, b in _TRANSLATE:
        out = out.replace(a, b)
    if "torch." in out and "import torch" not in out:
        out = out.replace("from repro_torch", "import torch\n\nfrom "
                          "repro_torch", 1)
    return out


def _fixture(tmp_path, name):
    with open(os.path.join(FIXTURES, name)) as fh:
        src = translate(fh.read())
    path = tmp_path / name
    path.write_text(src)
    return str(path)


def _active_rules(result):
    return sorted({f.rule for f in result.active})


def _run_cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


# ------------------------------------------------------------- fixture corpus

CORPUS = [
    ("sec001_bad.py", ["SEC001"]),
    ("sec001_good.py", []),
    ("sec002_bad.py", ["SEC002"]),
    ("sec002_good.py", []),
    ("sec003_bad.py", ["SEC003"]),
    ("sec003_good.py", []),
    ("procsend_bad.py", ["SEC001"]),
    ("procsend_good.py", []),
    ("servesend_bad.py", ["SEC001"]),
    ("servesend_good.py", []),
    ("fld001_bad.py", ["FLD001"]),
    ("fld001_good.py", []),
    ("fld002_bad.py", ["FLD002"]),
    ("fld002_good.py", []),
    ("fld003_bad.py", ["FLD003"]),
    ("fld003_good.py", []),
    ("fld004_bad.py", ["FLD004"]),
    ("fld004_good.py", []),
    ("barrett_bad.py", ["FLD001", "FLD002"]),
    ("barrett_good.py", []),
    ("wvr001_bad.py", ["SEC001", "WVR001"]),
    ("wvr001_good.py", []),
    ("wvr002_strict.py", []),
]


@pytest.mark.parametrize("name,expected", CORPUS,
                         ids=[c[0].removesuffix(".py") for c in CORPUS])
def test_fixture_corpus(tmp_path, name, expected):
    res = analyze_paths([_fixture(tmp_path, name)])
    assert _active_rules(res) == expected


_ESCAPE_TEMPLATE = """import pickle

import numpy as np
import torch

from repro_torch.core import shamir


def f(key, secret, pts):
    s = shamir.share(key, secret, 1, 4, pts)
    return {expr}
"""

#: torch's host escapes (SEC001) and its moves within a party (clean)
ESCAPES = [
    ("s.numpy()", ["SEC001"]),
    ("s.cpu().numpy()", ["SEC001"]),
    ("s.item()", ["SEC001"]),
    ("s.tolist()", ["SEC001"]),
    ("bytes(s)", ["SEC001"]),
    ("pickle.dumps(s)", ["SEC001"]),
    ("np.asarray(s)", ["SEC001"]),
    ("print(s)", ["SEC001"]),
    ("s.cpu()", []),
    ("s.to('cuda')", []),
    ("torch.swapaxes(s, 0, 1).contiguous()", []),
    ("shamir.reconstruct(s, 1, pts).cpu().numpy()", []),
]


@pytest.mark.parametrize("expr,expected", ESCAPES,
                         ids=[e[0] for e in ESCAPES])
def test_torch_host_escapes(tmp_path, expr, expected):
    path = tmp_path / "snippet.py"
    path.write_text(_ESCAPE_TEMPLATE.format(expr=expr))
    assert _active_rules(analyze_paths([str(path)])) == expected


def test_waived_findings_recorded_with_reasons(tmp_path):
    res = analyze_paths([_fixture(tmp_path, "wvr001_good.py")])
    assert res.active == []
    waived = res.waived
    assert len(waived) == 2
    assert all(f.rule == "SEC001" and f.waiver_reason for f in waived)


def test_strict_surfaces_unused_waiver(tmp_path):
    path = _fixture(tmp_path, "wvr002_strict.py")
    assert _active_rules(analyze_paths([path])) == []
    strict = analyze_paths([path], strict=True)
    assert "WVR002" in _active_rules(strict)


# --------------------------------------------------------------- the live gate

def test_self_run_clean_and_fast():
    """The port carries zero active findings; each waiver has a reason and
    waives a finding."""
    t0 = time.monotonic()
    res = analyze_paths([SRC_PORT])
    elapsed = time.monotonic() - t0
    assert elapsed < 30.0, f"seclint took {elapsed:.1f}s (budget 30s)"
    assert res.active == [], "\n".join(
        f"{f.location} {f.rule} {f.message}" for f in res.active)
    assert all(f.waiver_reason for f in res.waived)
    assert res.unused_waivers == []


def test_cli_exit_codes(tmp_path):
    ok = _run_cli(_fixture(tmp_path, "sec001_good.py"))
    assert ok.returncode == 0, ok.stdout + ok.stderr
    bad = _run_cli(_fixture(tmp_path, "sec001_bad.py"))
    assert bad.returncode == 1
    assert "SEC001" in bad.stdout
    good = _fixture(tmp_path, "wvr001_good.py")
    waived = _run_cli(good)
    assert waived.returncode == 0
    strict = _run_cli("--strict", good)
    assert strict.returncode == 1  # strict treats waivers as errors
    default = _run_cli()           # the port's tree
    assert default.returncode == 0, default.stdout + default.stderr
    assert " 0 finding(s)," in default.stdout


def test_budget_report_lists_waivers(tmp_path):
    out = _run_cli("--budget-report", "-",
                   _fixture(tmp_path, "wvr001_good.py"))
    assert out.returncode == 0
    assert "allow[SEC001]" in out.stdout
    assert "trailing-style waiver" in out.stdout


# ---------------------------------------------------------- corruption drills

def _protocol_source():
    with open(os.path.join(SRC_PORT, "core", "protocol.py")) as fh:
        return fh.read()


def _analyze_corrupted(tmp_path, source):
    path = tmp_path / "protocol.py"
    path.write_text(source)
    return _run_cli("--package", "repro_torch.core", str(path))


_DECODE_ANCHOR = "        mat = (n, self.d, self.obj.n_outputs)\n"


@pytest.mark.parametrize("leak", [
    "print(state.w_shares)", "leak = mix.cpu().numpy()",
    "leak = state.w_shares.tolist()"])
def test_corrupted_protocol_share_leak_is_flagged(tmp_path, leak):
    """Opening shares on the host inside the fused iteration, before its
    decode -> SEC001."""
    src = _protocol_source()
    assert _DECODE_ANCHOR in src, "protocol.py changed; update the drill"
    bad = src.replace(_DECODE_ANCHOR,
                      _DECODE_ANCHOR + f"        {leak}\n", 1)
    proc = _analyze_corrupted(tmp_path, bad)
    assert proc.returncode == 1
    assert "SEC001" in proc.stdout


def test_corrupted_protocol_dropped_reduction_is_flagged(tmp_path):
    """Removing the `% field.P` before the int32 narrow in _decode_vec
    -> FLD002."""
    src = _protocol_source()
    anchor = "(num.sum(axis=0) % field.P * w % field.P).astype(np.int32)"
    assert anchor in src, "protocol.py changed; update the corruption drill"
    bad = src.replace(anchor, "(num.sum(axis=0) % field.P * w).astype(np.int32)",
                      1)
    proc = _analyze_corrupted(tmp_path, bad)
    assert proc.returncode == 1
    assert "FLD002" in proc.stdout


def test_uncorrupted_protocol_copy_is_clean(tmp_path):
    """The drill harness itself must not produce findings on the pristine
    file (otherwise the corruption assertions prove nothing)."""
    proc = _analyze_corrupted(tmp_path, _protocol_source())
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------------ property: FLD

_PROP_TEMPLATE = """import torch

from repro_torch.core import field


def f(x, y):
    z = field.mul(x, y)
    return ({expr}).to(torch.int32)
"""


@given(st.sampled_from(["+", "-", "*"]), st.integers(1, 4096),
       st.integers(1, 3))
@settings(max_examples=12, deadline=None)
def test_random_unreduced_field_expression_is_flagged(op, k, depth):
    """Any raw-arithmetic chain over a field value, narrowed without a
    dominating `% field.P`, must trip both the raw-op and the
    unreduced-narrow rules."""
    import tempfile
    expr = "z"
    for _ in range(depth):
        expr = f"({expr} {op} {k})"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snippet.py")
        with open(path, "w") as fh:
            fh.write(_PROP_TEMPLATE.format(expr=expr))
        rules = _active_rules(analyze_paths([path]))
    assert "FLD001" in rules and "FLD002" in rules, (expr, rules)
