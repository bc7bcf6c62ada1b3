"""repro_torch packaging contracts: no JAX anywhere in the port, entry
points that refuse to run without a card unless asked for the CPU, and a
chip_smoke.py that fails without a card or without the repository."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import api
from repro_torch.core import protocol
from repro_torch.kernels import build, ops
from repro_torch.launch.runtime import session

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_package_imports(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.fit("smoke", "copml", "jit", iters=1)

    def spawn(*args, **kw):
        raise AssertionError("a proc fit with no card spawned a worker")

    monkeypatch.setattr(session.subprocess, "Popen", spawn)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.fit("smoke", "copml", "proc:4", iters=1)
    wl = api.get_workload("smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        protocol.Copml(wl.cfg, wl.m, wl.d)
    assert protocol.resolve_device("cpu") == torch.device("cpu")


def test_kernel_sources_and_launch_counts():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    assert set(build.SOURCES) == {"modmatmul", "fused_step",
                                  "coded_gradient", "field_poly"}
    assert build.BUILD_DIR.name == "build"
    # every TPU kernel of the JAX package has a launch counter
    assert set(ops.KERNELS) == {
        "modmatmul", "modmatmul_batched", "fused_step",
        "coded_gradient_batched", "coded_gradient_matrix", "coded_gradient",
        "poly_eval"}
    assert set(ops.launch_counts()) == set(ops.KERNELS)
    text = (REPO / "pyproject.toml").read_text()
    assert "kernels/csrc/*.cu" in text and '"gpu:' in text


def test_library_name_hashes_the_shared_headers(tmp_path, monkeypatch):
    """Editing a shared csrc/*.cuh header renames every library, so a
    library built from the old header is never loaded."""
    for src in build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._lib_path(n) for n in build.SOURCES}
    header = tmp_path / "coded_gradient.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    assert all(before[n] != after[n] for n in build.SOURCES)


def _run_chip_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    proc = _run_chip_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
