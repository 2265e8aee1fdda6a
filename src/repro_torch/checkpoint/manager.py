"""Checkpointing: atomic, async-capable, keep-k, verified restore
(PyTorch port of the JAX package's ``repro.checkpoint.manager``).

Layout per step::

    <dir>/step_000123/
        arrays.npz          # flattened tree leaves (host copies)
        manifest.json       # keys, shapes/dtypes, hash, extra metadata
    <dir>/LATEST            # atomic pointer (rename-into-place)

Fault-tolerance posture:
  * writes go to ``step_N.tmp`` then ``os.rename`` — a crash mid-save never
    corrupts the latest valid checkpoint;
  * ``restore_latest`` verifies the manifest hash before trusting arrays,
    and falls back past corrupt steps to the newest valid one;
  * ``restore_latest(like=tree)`` puts fresh tensors on the devices of
    ``like``'s leaves;
  * ``AsyncWriter`` moves serialisation off the caller's thread.

Trees are nested dicts, lists, tuples and named tuples of tensors, numpy
arrays or scalars.  Their flattened keys are those of the JAX package's
``jax.tree_util.tree_flatten_with_path``, letter for letter: dict keys
sorted and joined by ``/``, list and tuple entries by index, a named
tuple's fields as ``.name`` in field order, ``None`` leaves dropped — so
for equal trees ``manifest.json``'s keys, shapes, dtypes and hash equal
the JAX manager's.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

Tree = Any


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """``[(key part, child)]`` of an inner node, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _leaves_with_paths(tree: Tree, path: str = ""):
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for part, child in kids:
        yield from _leaves_with_paths(child, f"{path}/{part}" if path
                                      else part)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten_with_paths(tree: Tree) -> List[Tuple[str, np.ndarray]]:
    return [(k, _to_host(leaf)) for k, leaf in _leaves_with_paths(tree)]


def _unflatten(like: Tree, leaves) -> Tree:
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in flattening order."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return next(leaves)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    vals = [_unflatten(child, leaves) for _, child in kids]
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def _tree_hash(items: List[Tuple[str, np.ndarray]]) -> str:
    h = hashlib.sha256()
    for k, v in items:
        h.update(k.encode())
        h.update(str(v.shape).encode())
        h.update(str(v.dtype).encode())
        h.update(np.ascontiguousarray(v).tobytes()[:65536])  # prefix hash
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save -------------------------------------------------------------------
    def save(self, step: int, state: Tree,
             extra: Optional[Dict[str, Any]] = None) -> pathlib.Path:
        items = _flatten_with_paths(state)
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{k: v for k, v in items})
        manifest = {
            "step": step,
            "keys": [k for k, _ in items],
            "shapes": {k: list(v.shape) for k, v in items},
            "dtypes": {k: str(v.dtype) for k, v in items},
            "hash": _tree_hash(items),
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        # atomic LATEST pointer
        ptr_tmp = self.dir / "LATEST.tmp"
        ptr_tmp.write_text(final.name)
        os.replace(ptr_tmp, self.dir / "LATEST")
        self._gc()
        return final

    def _gc(self):
        steps = sorted(p for p in self.dir.glob("step_*") if p.is_dir()
                       and not p.name.endswith(".tmp"))
        for p in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(p)

    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.name.endswith(".tmp"))

    # -- restore ------------------------------------------------------------------
    def load_step(self, path: pathlib.Path
                  ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """Load and verify one step directory, raising on any corruption.

        Raises ``IOError`` when the manifest hash does not match the arrays
        (the classic integrity failure); a torn/corrupted npz or manifest
        surfaces as whatever ``np.load``/``json.loads`` raises.  Callers that
        want the newest *valid* step should go through :meth:`restore_latest`,
        which catches all of these and falls back.
        """
        manifest = json.loads((path / "manifest.json").read_text())
        with np.load(path / "arrays.npz") as z:
            arrays = {k: z[k] for k in manifest["keys"]}
        items = [(k, arrays[k]) for k in manifest["keys"]]
        if _tree_hash(items) != manifest["hash"]:
            raise IOError(f"checkpoint {path} failed integrity check")
        return manifest, arrays

    def _candidates(self) -> List[pathlib.Path]:
        """Step dirs to try, LATEST-pointed first, then the rest newest-first."""
        steps = sorted((p for p in self.dir.glob("step_*")
                        if p.is_dir() and not p.name.endswith(".tmp")),
                       reverse=True)
        ptr = self.dir / "LATEST"
        if ptr.exists():
            head = self.dir / ptr.read_text().strip()
            if head in steps:
                steps.remove(head)
                steps.insert(0, head)
        return steps

    def restore_latest(self, like: Optional[Tree] = None
                       ) -> Optional[Tuple[int, Tree, Dict[str, Any]]]:
        """Restore the newest valid checkpoint.

        Tries the ``LATEST``-pointed step first; if it fails its manifest-hash
        check (or is torn/unreadable), logs the skip and falls back to the
        newest remaining valid step rather than giving up on the directory.
        Raises ``IOError`` only when steps exist but none are valid; returns
        ``None`` when the directory holds no steps at all.

        With ``like=None`` the raw host array dict is returned — the
        durable-serving path, whose snapshot layout is a flat dict.  With
        a ``like`` tree the result has its structure, each leaf a fresh
        tensor of the ``like`` leaf's dtype on its device (a CPU tensor
        where the ``like`` leaf is not a tensor).
        """
        candidates = self._candidates()
        if not candidates:
            return None
        errors: List[str] = []
        for path in candidates:
            try:
                manifest, arrays = self.load_step(path)
            except Exception as e:  # noqa: BLE001 — any corruption means "try older"
                log.warning("skipping corrupt checkpoint %s: %s", path.name, e)
                errors.append(f"{path.name}: {e}")
                continue
            if errors:
                log.warning("restored fallback checkpoint %s (skipped: %s)",
                            path.name, "; ".join(errors))
            if like is None:
                return manifest["step"], arrays, manifest.get("extra", {})
            flat_like = list(_leaves_with_paths(like))
            assert [k for k, _ in flat_like] == manifest["keys"], \
                "checkpoint/model structure mismatch"
            leaves = []
            for k, ref in flat_like:
                t = torch.from_numpy(np.array(arrays[k], copy=True))
                if isinstance(ref, torch.Tensor):
                    t = t.to(device=ref.device, dtype=ref.dtype)
                leaves.append(t)
            state = _unflatten(like, iter(leaves))
            return manifest["step"], state, manifest.get("extra", {})
        raise IOError(
            f"checkpoint dir {self.dir} failed integrity check: no valid step "
            f"({'; '.join(errors)})")


class AsyncWriter:
    """Serialise checkpoints on a background thread (off the step path).
    The tree is copied to the host before the thread starts, so the
    caller may go on changing its tensors in place."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self._pending: Optional[threading.Thread] = None

    def save(self, step: int, state: Tree, extra=None) -> None:
        self.wait()
        host_state = _unflatten(state, iter(
            v for _, v in _flatten_with_paths(state)))       # snapshot
        self._pending = threading.Thread(
            target=self.manager.save, args=(step, host_state, extra))
        self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
