"""Checkpointing with async save, in the JAX package's on-disk format.

Contract (the JAX package's train/checkpoint.py):
  * save(step): every leaf is written as `leaf_<i>.npy` inside
    `step_<step:010d>/`, with a JSON manifest (step, tree description,
    each leaf's shape and dtype); bfloat16 leaves are saved as their
    uint16 view (np.save cannot write bfloat16).  Leaves are numbered in
    the tree's order: dicts by sorted key, depth first -- jax's
    tree_flatten order over the same dicts, so a checkpoint the JAX
    package wrote restores here.
  * async: the copy to host memory happens in save() (a copy for CPU
    tensors too, which later steps update in place); the disk write runs
    on a background thread, at most one in flight.
  * integrity: the step directory is written under a temporary name and
    renamed into place once its manifest is written; list_steps() sees
    only complete steps, and restore() takes the newest.
  * keep: the newest `keep` complete steps are kept.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

_MANIFEST = "manifest.json"


def flatten(tree) -> list:
    """The leaves of nested dicts (sorted keys, depth first), lists and
    tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(tree_like, leaves: list):
    """`leaves` (flatten's order) in the structure of `tree_like`."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return next(it)
    return walk(tree_like)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "*"


def _to_host(leaf) -> np.ndarray:
    """A copy of a leaf as a numpy array: a bf16 tensor as its uint16 bits
    (the manifest says bfloat16), a Python scalar as np.asarray gives it.
    A CPU tensor is copied too: the trainer updates its parameters and
    optimizer state in place while the write is still running."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree, *, blocking: bool = False):
        leaves = flatten(tree)
        host = [_to_host(leaf) for leaf in leaves]      # device -> host now
        dtypes = ["bfloat16" if isinstance(leaf, torch.Tensor)
                  and leaf.dtype == torch.bfloat16 else str(h.dtype)
                  for leaf, h in zip(leaves, host)]
        self.wait()                                      # one in flight max
        self._thread = threading.Thread(
            target=self._write, args=(step, host, dtypes, _describe(tree)),
            daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def _write(self, step: int, leaves, dtypes, treedef_str: str):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step:010d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "treedef": treedef_str, "leaves": []}
        for i, (leaf, dt) in enumerate(zip(leaves, dtypes)):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), leaf)
            manifest["leaves"].append({"shape": list(leaf.shape),
                                       "dtype": dt})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)                            # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.list_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore

    def list_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, _MANIFEST)):
                out.append(int(name[5:]))
        return sorted(out)

    def restore(self, tree_like, step: int | None = None):
        """Restore into the structure of `tree_like` (the newest complete
        step unless `step` is given): a tensor leaf takes its template's
        dtype and device, a Python scalar leaf its type.  Returns (tree,
        step)."""
        steps = self.list_steps()
        if not steps:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        step = steps[-1] if step is None else step
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        templates = flatten(tree_like)
        if len(templates) != len(manifest["leaves"]):
            raise ValueError(f"checkpoint {path} holds "
                             f"{len(manifest['leaves'])} leaves, the tree "
                             f"{len(templates)}")
        out = []
        for i, tmpl in enumerate(templates):
            arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
            if manifest["leaves"][i]["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            if not isinstance(tmpl, torch.Tensor):   # a Python scalar leaf
                out.append(type(tmpl)(t.item()))
                continue
            if tuple(t.shape) != tuple(tmpl.shape):
                raise ValueError(f"leaf {i}: shape {tuple(t.shape)}, the "
                                 f"tree's {tuple(tmpl.shape)}")
            out.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
        return unflatten(tree_like, out), step
