"""Config registry: --arch <id> resolves here.

The ten LM archs (`models.config.ModelConfig`) and the paper's own
workload (`copml_logreg.CopmlWorkload`), in the JAX package's order."""

from __future__ import annotations

import importlib

ARCH_IDS = (
    "qwen3-1.7b",
    "qwen2.5-3b",
    "smollm-360m",
    "llama3.2-3b",
    "falcon-mamba-7b",
    "qwen3-moe-30b-a3b",
    "arctic-480b",
    "whisper-tiny",
    "zamba2-2.7b",
    "internvl2-2b",
    "copml-logreg",        # the paper's own workload, as an arch
)
#: the archs of the LM stack (every one but the paper's workload)
LM_ARCH_IDS = tuple(a for a in ARCH_IDS if a != "copml-logreg")


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}: one of {ARCH_IDS}")
    return importlib.import_module(
        f".{arch.replace('-', '_').replace('.', '_')}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def smoke_config(arch: str):
    return _module(arch).SMOKE
