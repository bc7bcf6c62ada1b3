"""commlint on the port: fixture corpus, self-run gate, corruption drills.

The cases of tests/test_commlint.py, against repro_torch.analysis and the
port's runtime (src/repro_torch/launch/runtime):

* fixture corpus: the JAX package's tests/fixtures/commlint choreographies,
  copied into tmp_path with `repro.` -> `repro_torch.`, each firing the
  same COM rule set;
* the live gate: `--pass comm` over src/repro_torch is clean with zero
  waivers;
* corruption drills on tmp_path copies of the port's worker.py and
  session.py;
* the comm budget: the choreography's closed-form frame counts equal the
  port's core/cost_model.proc_net_frames, and a diverging cost model is
  COM009.
"""

import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from repro_torch.analysis import analyze_paths
from repro_torch.analysis import choreography
from repro_torch.analysis.cache import FindingsCache
from repro_torch.core import cost_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PORT = os.path.join(REPO, "src", "repro_torch")
RUNTIME = os.path.join(SRC_PORT, "launch", "runtime")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "commlint")


def _active_rules(result):
    return sorted({f.rule for f in result.active})


def _run_cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def _case(tmp_path, case) -> str:
    """The fixture choreography `case`, translated into tmp_path."""
    dst = tmp_path / case
    dst.mkdir()
    src = os.path.join(FIXTURES, case)
    for name in sorted(os.listdir(src)):
        with open(os.path.join(src, name)) as fh:
            text = re.sub(r"\brepro\.", "repro_torch.", fh.read())
        (dst / name).write_text(text)
    return str(dst)


# ------------------------------------------------------------- fixture corpus

CORPUS = [
    ("clean", []),
    ("drop_opened_recv", ["COM001", "COM005"]),  # orphan send -> deadlock
    ("drop_open_send", ["COM002", "COM005"]),    # unfulfillable recv
    ("inverted_enc", ["COM005"]),                # recv-before-send cycle
    ("step_const", ["COM004"]),                  # send pins step=0
    ("phase_wrong", ["COM004"]),                 # OPEN billed to "encode"
    ("adaptive_block", ["COM006"]),              # blocking collect loop
    ("recv_any_no_timeout", ["COM006"]),
    ("unknown_kind", ["COM007"]),                # net.PING not in the spec
    ("pickle_enc", ["COM008"]),                  # pickle on a data round
    ("tobytes_enc", ["COM008"]),                 # raw bytes on an array round
    ("card_single_enc", ["COM003"]),             # one send where P-1 expected
]


@pytest.mark.parametrize("case,expected", CORPUS, ids=[c[0] for c in CORPUS])
def test_fixture_corpus(tmp_path, case, expected):
    res = analyze_paths([_case(tmp_path, case)], passes=("comm",))
    assert _active_rules(res) == expected


def test_sec_pass_ignores_comm_fixtures(tmp_path):
    """Pass selection is real: the sec family alone does not fire on a
    choreography bug."""
    res = analyze_paths([_case(tmp_path, "step_const")], passes=("sec",))
    assert _active_rules(res) == []


def test_waiver_covers_comm_findings(tmp_path):
    """A seclint-grammar pragma waives COM findings too: both COM004s
    anchored at step_const's SHARE send line go quiet, with reasons."""
    case = _case(tmp_path, "step_const")
    worker = os.path.join(case, "worker.py")
    with open(worker) as fh:
        src = fh.read()
    target = "                node.send(s, net.SHARE, step=0,"
    assert target in src
    src = src.replace(
        target,
        "                # seclint: allow[COM004] reason=fixture pins step\n"
        + target)
    with open(worker, "w") as fh:
        fh.write(src)
    res = analyze_paths([case], passes=("comm",))
    assert res.active == []
    assert len(res.waived) == 2
    assert all(f.rule == "COM004" and f.waiver_reason for f in res.waived)
    assert res.unused_waivers == []


# ------------------------------------------------------------- the live gate

def test_self_run_comm_clean_zero_waivers():
    t0 = time.monotonic()
    res = analyze_paths([SRC_PORT], package="repro_torch", passes=("comm",))
    elapsed = time.monotonic() - t0
    assert res.active == [], [str(f) for f in res.active]
    assert res.waived == []          # clean with ZERO waivers
    assert elapsed < 30.0


def test_cli_pass_selection_and_rule_listing(tmp_path):
    p = _run_cli("--pass", "comm", _case(tmp_path, "clean"))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "analysis[comm]" in p.stdout

    pickle_enc = _case(tmp_path, "pickle_enc")
    p = _run_cli("--pass", "comm", pickle_enc)
    assert p.returncode == 1
    assert "COM008" in p.stdout

    p = _run_cli("--pass", "sec", pickle_enc)
    assert p.returncode == 0       # comm bug invisible to the sec family

    p = _run_cli("--list-rules")
    assert p.returncode == 0
    for rid in [f"COM00{i}" for i in range(1, 10)]:
        assert rid in p.stdout


def test_cli_changed_only_smoke():
    """--changed-only runs (restricted to git-dirty files) and stays clean
    whatever is dirty."""
    p = _run_cli("--changed-only", SRC_PORT)
    assert p.returncode == 0, p.stdout + p.stderr


# --------------------------------------------------------- corruption drills

def _runtime_copy(tmp, mutate=None):
    """Copy the port's worker.py + session.py (+ net.py) into tmp,
    optionally mutated, and return the directory to lint."""
    d = os.path.join(tmp, "runtime")
    os.mkdir(d)
    for name in ("worker.py", "session.py", "net.py"):
        shutil.copy(os.path.join(RUNTIME, name), os.path.join(d, name))
    if mutate:
        path = os.path.join(d, mutate[0])
        with open(path) as fh:
            src = fh.read()
        assert mutate[1] in src, f"drill anchor not found in {mutate[0]}"
        with open(path, "w") as fh:
            fh.write(src.replace(mutate[1], mutate[2]))
    return d


_WORKER_OPENED_RECV = (
    "            frm = node.recv(net.OPENED, src=net.COORD, step=step,\n"
    "                            tag=net.TAG_TRUNC)")


def test_drill_deleted_recv_is_a_deadlock(tmp_path):
    """Deleting the worker's OPENED recv orphans the coordinator's
    broadcast AND removes a barrier leg -> COM001 + COM005."""
    d = _runtime_copy(str(tmp_path), mutate=(
        "worker.py", _WORKER_OPENED_RECV, "            frm = None"))
    p = _run_cli("--pass", "comm", d)
    assert p.returncode == 1
    assert "COM001" in p.stdout and "COM005" in p.stdout


def test_drill_mutated_step_expr_is_a_pair_mismatch(tmp_path):
    d = _runtime_copy(str(tmp_path), mutate=(
        "session.py",
        "node.send(r, net.OPENED, step=t, tag=net.TAG_TRUNC,",
        "node.send(r, net.OPENED, step=0, tag=net.TAG_TRUNC,"))
    p = _run_cli("--pass", "comm", d)
    assert p.returncode == 1
    assert "COM004" in p.stdout


def test_uncorrupted_runtime_copy_is_clean(tmp_path):
    d = _runtime_copy(str(tmp_path))
    p = _run_cli("--pass", "comm", d)
    assert p.returncode == 0, p.stdout + p.stderr


# ------------------------------------------------------------ the comm budget

@pytest.mark.parametrize("procs", [1, 2, 3, 4, 8])
def test_choreography_matches_cost_model_closed_forms(procs):
    for iters in (0, 1, 2, 10):
        for history in (False, True):
            spec = choreography.frames_by_phase(procs, iters, history)
            model = cost_model.proc_net_frames(procs, iters,
                                               history=history)
            assert spec == model, (procs, iters, history)


def test_frame_closed_forms_spot_values():
    got = choreography.frames_by_phase(4, 10, history=True)
    assert got == {
        "setup": 4 * 3 // 2 + 6 * 4,       # P(P-1)/2 HELLOs + 6P control
        "encode": 4 * 3 * 10,              # P(P-1) per step
        "exchange": 4 * 3 * 10,
        "trunc_open": 2 * 4 * 10,          # OPEN up + OPENED down
        "open_model": 4 * 10 + 4,          # hist OPENs + P RESULTs
    }
    # zero-valued phases are omitted, not reported as 0
    assert "open_model" in choreography.frames_by_phase(2, 0, history=False)
    assert choreography.frames_by_phase(2, 0)["open_model"] == 2


def test_diverging_cost_model_is_com009(monkeypatch):
    def wrong(procs, iters, history=False):
        good = dict(choreography.frames_by_phase(procs, iters, history))
        good["encode"] = good.get("encode", 0) + 1
        return good
    monkeypatch.setattr(cost_model, "proc_net_frames", wrong)
    res = analyze_paths([RUNTIME], passes=("comm",))
    assert "COM009" in _active_rules(res)


def test_missing_cost_model_hook_is_com009(monkeypatch):
    monkeypatch.delattr(cost_model, "proc_net_frames")
    res = analyze_paths([RUNTIME], passes=("comm",))
    assert "COM009" in _active_rules(res)


# -------------------------------------------------- cache + scoped runs

def test_findings_cache_hit_miss_invalidate(tmp_path):
    src = os.path.join(REPO, "tests", "fixtures", "seclint", "sec001_bad.py")
    target = tmp_path / "sec001_bad.py"
    with open(src) as fh:
        target.write_text(re.sub(r"\brepro\.", "repro_torch.", fh.read()))
    cpath = str(tmp_path / "cache.json")

    cache = FindingsCache(cpath)
    res = analyze_paths([str(target)], cache=cache)
    assert _active_rules(res) == ["SEC001"]
    assert cache.misses >= 1 and cache.hits == 0
    cache.save()

    cache2 = FindingsCache(cpath)          # fresh load from disk
    res = analyze_paths([str(target)], cache=cache2)
    assert _active_rules(res) == ["SEC001"]  # findings survive the cache
    assert cache2.hits >= 1 and cache2.misses == 0

    st = os.stat(target)
    os.utime(target, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    cache3 = FindingsCache(cpath)
    analyze_paths([str(target)], cache=cache3)
    assert cache3.misses >= 1               # mtime change invalidates


def test_only_files_restricts_but_keeps_the_group():
    """Scoping the run to worker.py alone still lints it against its
    session.py counterpart (groups come from the full index)."""
    worker = os.path.abspath(os.path.join(RUNTIME, "worker.py"))
    res = analyze_paths([SRC_PORT], package="repro_torch", passes=("comm",),
                        only_files={worker})
    assert res.active == []
    assert res.files == [worker]
