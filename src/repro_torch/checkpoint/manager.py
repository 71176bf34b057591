"""Checkpoints: atomic, asynchronous, elastic, with retention (port of
``repro/checkpoint/manager.py``).

On disk, the reference's layout: ``<dir>/step-%08d/`` holding
``arrays.npz`` (one array per leaf, keyed by its path in the tree,
``params/blocks/0/attn/wq``) and ``manifest.json`` (the step, the count of
arrays, the caller's ``extra`` and each leaf's torch dtype), written to
``<dir>/tmp-<step>`` and renamed into place, so a crash mid-save never
leaves a partial checkpoint. numpy has no bfloat16: a bf16 leaf is stored
as its raw 16 bits (int16) and comes back as bf16.

The port updates parameters in place, so an asynchronous save copies
every leaf to host memory in the calling thread and only writes the files
in the background: the next step cannot race the writer.

**Elastic.** A checkpoint holds every leaf whole, whatever mesh wrote it.
``save(..., ruleset=, shapes=)`` of a tree of shards gathers each leaf
(``sharding.gather_leaf``, exact) on every rank; rank 0 writes and every
rank waits at a barrier, so N ranks never race on one ``tmp-<step>``.
``load_checkpoint(..., ruleset=)`` (``restore``) cuts each leaf to this
rank's shard by its ``param_spec`` under the ruleset's mesh, which may
differ from the one that saved it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import sharding
from repro_torch.tree import tree_items, tree_unflatten


def _sharded(ruleset) -> bool:
    return ruleset is not None and ruleset.mesh is not None


def _snapshot(tree, ruleset=None, shapes=None
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host copies of every leaf (never views of a tensor that a later
    step may update in place), and each leaf's dtype name. Under a
    ruleset with a mesh, ``tree`` holds shards and ``shapes`` (a tree of
    the same structure, meta tensors will do) the global shapes: each
    leaf is gathered whole on every rank, one at a time, and only rank 0
    keeps the copies (the others return empty dicts)."""
    specs = None
    if _sharded(ruleset):
        if shapes is None:
            raise ValueError("saving shards needs the tree's global "
                             "shapes (shapes=)")
        specs = sharding.leaf_specs(shapes, ruleset)
    keep = not _sharded(ruleset) or dist.get_rank() == 0
    arrays, dtypes = {}, {}
    for key, leaf in tree_items(tree):
        if specs is not None:
            leaf = sharding.gather_leaf(leaf.detach(), specs[key],
                                        ruleset.mesh)
        if not keep:
            continue
        t = leaf.detach().to("cpu", copy=True)
        dtypes[key] = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:       # numpy has no bf16: its bits
            t = t.view(torch.int16)
        arrays[key] = t.numpy()
    return arrays, dtypes


def _write(directory: str, step: int, arrays, dtypes,
           extra: Optional[dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp-{step}")
    final = os.path.join(directory, f"step-{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "n_arrays": len(arrays), "dtypes": dtypes,
                "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[dict] = None) -> str:
    """Write ``tree`` (nested dicts and lists of tensors) as step
    ``step``; returns the checkpoint's directory."""
    return _write(directory, step, *_snapshot(tree), extra)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("-")[1]) for d in os.listdir(directory)
             if d.startswith("step-")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, like, step: Optional[int] = None,
                    ruleset=None) -> Tuple[Any, dict]:
    """(a tree of ``like``'s structure, the manifest): each leaf read from
    the checkpoint (the latest, or ``step``) onto the device of ``like``'s
    leaf at the same path. With a ``ruleset`` whose mesh is set, each
    leaf is cut to this rank's shard by its ``param_spec`` (the elastic
    restore; ``like`` then holds shards). Raises if a leaf's stored dtype
    or (cut) shape is not ``like``'s."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step-{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, leaf in tree_items(like):
            dtype = getattr(torch, manifest["dtypes"][key])
            t = torch.from_numpy(data[key]).view(dtype)
            if _sharded(ruleset):
                spec = sharding.param_spec(
                    (sharding.leaf_name(key),), tuple(t.shape), ruleset)
                t = sharding.local_shard(t, spec, ruleset.mesh)
            if t.dtype != leaf.dtype or t.shape != leaf.shape:
                raise ValueError(f"{key}: stored {t.dtype} {tuple(t.shape)}"
                                 f", expected {leaf.dtype} "
                                 f"{tuple(leaf.shape)}")
            leaves.append(t.to(leaf.device))
    return tree_unflatten(like, leaves), manifest


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, extra: Optional[dict] = None,
             ruleset=None, shapes=None) -> None:
        """Write ``tree`` as ``step``. Under a ``ruleset`` with a mesh
        (``tree`` this rank's shards, ``shapes`` its global shapes) every
        rank gathers, rank 0 writes, synchronously, and every rank waits
        at a barrier."""
        # The host copy is taken here, before the caller's next step.
        arrays, dtypes = _snapshot(tree, ruleset, shapes)
        if _sharded(ruleset):
            self.wait()
            if dist.get_rank() == 0:
                _write(self.directory, step, arrays, dtypes, extra)
                self._gc()
            dist.barrier()
        elif self.async_save:
            self.wait()

            def work():
                try:
                    _write(self.directory, step, arrays, dtypes, extra)
                    self._gc()
                except BaseException as e:     # raised by the next wait()
                    self._error = e

            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            _write(self.directory, step, arrays, dtypes, extra)
            self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, like, step: Optional[int] = None, ruleset=None):
        return load_checkpoint(self.directory, like, step=step,
                               ruleset=ruleset)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self) -> None:
        steps = sorted(int(d.split("-")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step-"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:08d}"),
                          ignore_errors=True)
