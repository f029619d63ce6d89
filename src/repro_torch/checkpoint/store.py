"""Fault-tolerant checkpointing: atomic commits, retention, restore.

The reference's ``repro.checkpoint.store`` for trees of torch tensors, in
its layout, so that a checkpoint of either package restores into the
other's tree:

  <dir>/step_<k>.tmp-<nonce>/  ->  fsync'd  ->  rename to <dir>/step_<k>/

holding ``arrays.npz`` (one array a leaf, keyed by the leaf's path joined
with ``__``) and ``meta.json`` (``step``, the sorted ``keys``, ``extra``).
The rename is the commit point; a crash mid-write leaves only a .tmp dir
that restore ignores and the next save garbage-collects.

The port keeps a model's layers as lists of per-layer dicts (``blocks``,
``tail``, ``encoder``, ``decoder``) where the reference stacks each leaf on
a leading layer axis: a list of dicts is saved stacked under the
reference's key (``params__blocks__attn__wq`` [L, ...]) and split back into
the list on restore.  bf16 leaves are saved as f32 (numpy has no bf16);
restore casts every array to its template leaf's dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

_SEP = "__"


def _is_layers(node) -> bool:
    return isinstance(node, (list, tuple)) and bool(node) and all(
        isinstance(x, dict) for x in node)


def _array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, parts: tuple = ()) -> dict[str, np.ndarray]:
    if isinstance(tree, dict):
        flat = {}
        for key, val in tree.items():
            flat.update(_flatten(val, parts + (str(key),)))
        return flat
    if _is_layers(tree):
        layers = [_flatten(layer) for layer in tree]
        return {_SEP.join(parts + (key,)): np.stack([lay[key]
                                                     for lay in layers])
                for key in layers[0]}
    if isinstance(tree, (list, tuple)):
        flat = {}
        for i, val in enumerate(tree):
            flat.update(_flatten(val, parts + (str(i),)))
        return flat
    return {_SEP.join(parts): _array(tree)}


def save_pytree(tree, directory: str, step: int, extra: dict | None = None
                ) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = f"{final}.tmp-{os.getpid()}-{time.time_ns()}"
    os.makedirs(tmp)
    flat = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    meta = {"step": step, "keys": sorted(flat), "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic commit
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and ".tmp" not in d]
    return max(steps) if steps else None


def _restore(template, data, parts: tuple = (), index: int | None = None,
             layers: int | None = None):
    if isinstance(template, dict):
        return {key: _restore(val, data, parts + (str(key),), index, layers)
                for key, val in template.items()}
    if _is_layers(template):
        return [_restore(layer, data, parts, i, len(template))
                for i, layer in enumerate(template)]
    if isinstance(template, (list, tuple)):
        return [_restore(val, data, parts + (str(i),), index, layers)
                for i, val in enumerate(template)]
    key = _SEP.join(parts)
    arr = data[key]
    if index is not None:
        if arr.ndim == 0 or arr.shape[0] != layers:
            raise ValueError(f"{key}: checkpoint {arr.shape} does not stack "
                             f"the template's {layers} layers")
        arr = arr[index]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"{key}: checkpoint {arr.shape} != template "
                         f"{tuple(template.shape)}")
    dev = template.device if template.device.type != "meta" else "cpu"
    return torch.from_numpy(np.array(arr)).to(device=dev,
                                              dtype=template.dtype)


def restore_pytree(template, directory: str, step: int | None = None
                   ) -> tuple:
    """Restore into the structure of ``template`` (a tree of tensors, on
    the ``meta`` device or any other): each leaf on its template's device
    (the CPU for ``meta``) in its template's dtype.  Returns (tree, meta)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        data = {key: npz[key] for key in npz.files}
    return _restore(template, data), meta


class CheckpointManager:
    """Retention + crash-garbage collection + convenience wrappers."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, tree, step: int, extra: dict | None = None) -> str:
        self._gc_tmp()
        path = save_pytree(tree, self.directory, step, extra)
        self._retain()
        return path

    def restore_latest(self, template):
        return restore_pytree(template, self.directory, None)

    def _retain(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and ".tmp" not in d)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def _gc_tmp(self) -> None:
        for d in os.listdir(self.directory):
            if ".tmp" in d:
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
