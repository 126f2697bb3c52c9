"""Checkpointing in the reference's on-disk format (counterpart of
``repro.checkpoint.checkpoint``): a checkpoint that either package writes
restores in the other.

Layout:
    <dir>/step_00000100/
        manifest.json        keys, leaf metadata (shape, dtype), user metadata
        arrays.npz           every leaf under its path-derived key
    <dir>/step_00000100.COMPLETE   (commit marker — written last)

* **Keys** are the tree's ``/``-joined dict keys in sorted order (JAX's
  flattening order), such as ``params/blocks/wq`` and ``opt/count``.
* **bf16** leaves are stored as a ``uint16`` bit view, the logical dtype in
  the manifest. The reference reads them back with ``ml_dtypes`` (which
  ships with JAX); the port uses a bit view through ``torch.int16``, so it
  needs neither.
* **Atomic:** the payload is written into a temporary directory, fsynced and
  renamed into place; the COMPLETE marker comes last, and restore considers
  marked steps only.

Trees are nested dicts of torch tensors (any device; copied to the host to
save). Restore places each leaf on the device of the matching ``target``
leaf, in its dtype; with ``placements`` (the elastic-restore path), each
leaf becomes a DTensor on its mesh, every rank keeping its own shard.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import distribute

Tree = Any
_SEP = "/"

def _key(prefix: str, k) -> str:
    return f"{prefix}{_SEP}{k}" if prefix else str(k)


def _flatten_with_paths(tree: Tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(key, leaf) pairs in JAX's order: dict keys sorted."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [kv for k in sorted(tree) for kv in _flatten_with_paths(tree[k], _key(prefix, k))]


def _unflatten_like(target: Tree, leaves: Dict[str, torch.Tensor], prefix: str = "") -> Tree:
    if not isinstance(target, dict):
        return leaves[prefix]
    return {k: _unflatten_like(v, leaves, _key(prefix, k)) for k, v in target.items()}


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """The stored array and the logical dtype name. A leaf that is not a
    tensor (an engine state's ints, lists and numpy arrays) is stored as
    ``np.asarray`` gives it, as the reference stores every leaf."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, str(a.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(
    directory: str | Path,
    step: int,
    tree: Tree,
    metadata: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> Path:
    """Atomically write ``tree`` at ``step``; keep the newest ``keep``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    step_name = f"step_{step:08d}"
    final = directory / step_name
    marker = directory / f"{step_name}.COMPLETE"
    tmp = Path(tempfile.mkdtemp(prefix=f".{step_name}.", dir=directory))
    try:
        leaves = _flatten_with_paths(tree)
        stored = {k: _to_numpy(v) for k, v in leaves}
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in stored.items()})
        manifest = {
            "step": step,
            "keys": [k for k, _ in leaves],
            "leaf_meta": {k: {"shape": list(a.shape), "dtype": dt} for k, (a, dt) in stored.items()},
            "metadata": metadata or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        for f in tmp.iterdir():
            fd = os.open(f, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        marker.touch()
        fd = os.open(directory, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    _prune(directory, keep)
    return final


def _prune(directory: Path, keep: int) -> None:
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        name = f"step_{s:08d}"
        (directory / f"{name}.COMPLETE").unlink(missing_ok=True)
        shutil.rmtree(directory / name, ignore_errors=True)


def latest_steps(directory: str | Path) -> List[int]:
    directory = Path(directory)
    out = []
    for marker in directory.glob("step_*.COMPLETE"):
        name = marker.name[: -len(".COMPLETE")]
        if (directory / name).is_dir():
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str | Path) -> Optional[int]:
    steps = latest_steps(directory)
    return steps[-1] if steps else None


def _leaf_tensor(arr: np.ndarray, stored_dtype: str) -> torch.Tensor:
    arr = np.array(arr, order="C")          # a writable copy; keeps 0-dim leaves 0-dim
    if stored_dtype == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(
    directory: str | Path,
    step: Optional[int] = None,
    target: Optional[Tree] = None,
    placements: Optional[Tree] = None,
) -> Tuple[Tree, Dict[str, Any]]:
    """Restore a checkpoint (the latest complete one by default).

    ``target``: a dict tree of the same structure (tensors, ``meta`` tensors
    included); each restored tensor leaf takes its target's dtype (through
    float32 where the stored one differs, as the reference converts) and
    device, and a leaf whose target is not a tensor comes back as its stored
    numpy array. ``placements``: an optional matching tree of ``(DeviceMesh,
    spec)`` pairs (``distributed.sharding`` specs) — each leaf then becomes a
    DTensor on its mesh (the elastic-restore path: the mesh may differ from
    the writer's). Without a target, returns the stored arrays by key (bf16
    as their uint16 bits). Returns (tree, metadata).
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoints under {directory}")
    final = directory / f"step_{step:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    with np.load(final / "arrays.npz") as arrays:
        by_key = {k: arrays[k] for k in manifest["keys"]}
    if target is None:
        return by_key, manifest["metadata"]
    where = dict(_flatten_with_paths(placements)) if placements is not None else {}
    leaves = {}
    for key, tgt in _flatten_with_paths(target):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        if not isinstance(tgt, torch.Tensor):
            leaves[key] = by_key[key]
            continue
        t = _leaf_tensor(by_key[key], manifest["leaf_meta"][key]["dtype"])
        if t.dtype != tgt.dtype:
            t = t.float().to(tgt.dtype)
        leaves[key] = distribute(t, *where[key]) if key in where else t.to(tgt.device)
    return _unflatten_like(target, leaves), manifest["metadata"]


class CheckpointManager:
    """Save-every-N policy + resume helper used by the train loop."""

    def __init__(self, directory: str | Path, save_every: int = 100, keep: int = 3):
        self.directory = Path(directory)
        self.save_every = save_every
        self.keep = keep

    def maybe_save(self, step: int, tree: Tree, metadata: Optional[dict] = None):
        if step % self.save_every == 0:
            return save_checkpoint(self.directory, step, tree, metadata, self.keep)
        return None

    def resume(self, target: Tree):
        step = latest_step(self.directory)
        if step is None:
            return None, 0, {}
        tree, meta = restore_checkpoint(self.directory, step, target)
        return tree, step, meta
