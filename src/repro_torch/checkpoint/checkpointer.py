"""Atomic, versioned step directories: the part of the reference's
``repro.checkpoint.checkpointer`` that the plan database rides on.

* **atomic**: a step is written to ``step_XXXXXXXX.tmp/`` and published
  with one ``os.rename``, so a crash mid-write never corrupts the newest
  complete step;
* **manifest**: the step and the caller's JSON ``extra`` live in
  ``manifest.json``; :meth:`Checkpointer.latest_step` scans for the newest
  complete step (a torn ``.tmp`` is never offered);
* **keep**: after each write all but the newest ``keep`` steps are removed.

The reference also saves arrays (``arrays.npz``), asynchronously and
re-sharded on restore; those are training's and wait for ROADMAP queue 11.
"""

from __future__ import annotations

import json
import os
import shutil

__all__ = ["Checkpointer"]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, extra: dict | None = None) -> str:
        """Publish step ``step`` holding ``extra`` (JSON); returns its path."""
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "extra": extra or {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._path(s))

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

    def restore(self, step: int) -> dict:
        """The ``extra`` that step ``step`` was saved with."""
        with open(os.path.join(self._path(step), "manifest.json")) as f:
            return json.load(f)["extra"]
