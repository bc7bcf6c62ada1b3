"""Config registry: --arch <id> resolves here.

The port's archs only: the paper's own workload.  The LM archs of the JAX
package's registry come with the LM stack."""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "copml-logreg",        # the paper's own workload, as an arch
)


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}: one of {ARCH_IDS}")
    return importlib.import_module(
        f".{arch.replace('-', '_').replace('.', '_')}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def smoke_config(arch: str):
    return _module(arch).SMOKE
