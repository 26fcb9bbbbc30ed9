"""Fault-tolerant checkpoints: the port's counterpart of the reference's
``repro.checkpoint.checkpointer``, in its on-disk format.

* **atomic**: a step is written to ``step_XXXXXXXX.tmp/`` and published
  with one ``os.rename``, so a crash mid-write never corrupts the newest
  complete step, and a torn ``.tmp`` is never offered for restore;
* **async**: :meth:`Checkpointer.save_async` copies the tree to host
  memory (:func:`tree.to_numpy` copies every leaf) before it returns and writes in a background thread; a write that
  failed re-raises once, at the next :meth:`Checkpointer.wait`;
* **format**: the arrays go into ``arrays.npz`` under the reference's keys
  (``"/"``-joined dict keys) and in its stacked layout
  (:func:`tree.to_numpy`: the port's lists of groups are stacked
  along a leading axis), so a checkpoint written by the reference restores
  into the port and the other way round; the step, the leaf count and the
  caller's JSON ``extra`` live in ``manifest.json``;
* **keep**: after each write all but the newest ``keep`` steps are removed.

:meth:`Checkpointer.restore` rebuilds the tree in the structure, dtypes
and devices of ``like`` (:func:`tree.from_numpy`, as
``convert.state_from_numpy`` does).

* **elastic**: arrays are saved whole.  Given ``shardings`` (a tree of
  ``runtime.sharding.NamedSharding`` beside the tree, None for a whole
  leaf), :meth:`Checkpointer.restore` keeps each rank's shard of every
  leaf, whatever mesh wrote the step (the reference's ``device_put`` onto
  a ``NamedSharding``), and :meth:`Checkpointer.save` gathers the ranks'
  shards and writes from the mesh's rank 0 alone; every rank calls it.
  So a step written mesh-free restores onto a mesh, and the other way
  round.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..tree import from_numpy, to_numpy, tree_leaves, tree_map

__all__ = ["Checkpointer"]


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """A reference-layout numpy tree -> ``{"a/b/c": array}``."""
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: np.asarray(tree)}


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._async_error: BaseException | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    # ---- save -----------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None,
             shardings: Any | None = None) -> str:
        """Publish step ``step`` holding ``tree`` (torch or numpy leaves, in
        dicts and lists) and ``extra`` (JSON); returns its path.  With
        ``shardings`` the leaves are a mesh rank's shards (module
        docstring): every rank calls this, rank 0 writes."""
        host_tree = _whole(tree, shardings)
        if host_tree is None:
            return self._path(step)
        return self._write(step, host_tree, extra or {})

    def save_async(self, step: int, tree: Any, extra: dict | None = None,
                   shardings: Any | None = None) -> None:
        """Copy ``tree`` to host memory (gathered whole, with
        ``shardings``), then write it in the background."""
        self.wait()  # one outstanding write at a time
        host_tree = _whole(tree, shardings)  # the snapshot, before returning
        if host_tree is None:
            return
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host_tree, extra or {}),
            daemon=True,
        )
        self._thread.start()

    def _write_guarded(self, step: int, host_tree: Any, extra: dict) -> None:
        try:
            self._write(step, host_tree, extra)
        except BaseException as e:  # surfaced at the next wait()
            self._async_error = e

    def wait(self) -> None:
        """Join the in-flight async write; a write that failed re-raises
        here, once (a caller who believed the save landed would otherwise
        restore an older step later and silently lose work)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _write(self, step: int, host_tree: Any, extra: dict) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(host_tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "treedef": "repro_torch", "n_leaves": len(flat),
                    "extra": extra}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._path(s))

    # ---- restore ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        """Steps with a complete checkpoint: ``.tmp`` directories (a writer
        died before the rename) and stray names are ignored."""
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            suffix = name.split("_", 1)[1]
            if suffix.isdigit():
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any | None = None
                ) -> tuple[Any, dict]:
        """Step ``step`` in the structure of ``like`` (a port tree: a list
        takes its elements from the stored array's leading axis; each leaf
        takes ``like``'s dtype and device).  With ``shardings`` each leaf is
        this rank's shard of the stored array (module docstring).  Returns
        ``(tree, extra)``."""
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if not tree_leaves(like):
            # no arrays wanted (the plan database's steps): arrays.npz is
            # not read, so a manifest-only step restores too
            return like, manifest["extra"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            stored = _unflatten({k: data[k] for k in data.files})
        if shardings is None:
            return from_numpy(stored, like, _leaf), manifest["extra"]
        paired = tree_map(lambda leaf, sh: (leaf, sh), like, shardings)
        return from_numpy(stored, paired, _shard_leaf), manifest["extra"]


def _whole(tree, shardings):
    """``tree`` in host memory, in the reference's layout; with
    ``shardings`` its shards gathered whole, and None on every rank but
    the mesh's rank 0 (a collective: every rank calls it)."""
    if shardings is None:
        return to_numpy(tree)
    whole = tree_map(lambda t, sh: t if sh is None else sh.gather(t), tree, shardings)
    mesh = next(sh.mesh for sh in tree_leaves(shardings) if sh is not None)
    return to_numpy(whole) if mesh.rank == 0 else None


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    """``{"a/b/c": array}`` -> the nested tree :func:`_flatten` took."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = arr
    return tree


def _shard_leaf(arr: np.ndarray, pair) -> torch.Tensor:
    like_leaf, sh = pair
    return _leaf(arr if sh is None else arr[sh.slices(arr.shape)], like_leaf)


def _leaf(arr: np.ndarray, like_leaf) -> torch.Tensor:
    # ascontiguousarray would make a 0-d leaf (the step) 1-d
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(np.shape(arr)))
    if isinstance(like_leaf, torch.Tensor):
        return t.to(device=like_leaf.device, dtype=like_leaf.dtype)
    return t
