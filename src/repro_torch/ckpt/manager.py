"""Checkpoint manager: rotation + async writer thread + quarantine."""
from __future__ import annotations

import logging
import os
import queue
import threading
import zipfile
from typing import Optional

import numpy as np

from .checkpoint import (
    _flatten,
    _unflatten,
    host_array,
    latest_step,
    load_checkpoint,
    quarantine_step,
    save_checkpoint,
)

log = logging.getLogger(__name__)

__all__ = ["CheckpointManager"]

# restore failures that mean "this checkpoint is damaged" (sha mismatch,
# truncated/unreadable payload, mangled manifest) — NOT structural
# mismatches like KeyError, which callers use to detect cross-mode
# resumes and must keep seeing
_CORRUPTION_ERRORS = (
    OSError,  # includes the IOError sha-mismatch raise
    ValueError,  # np.load on a mangled zip / json decode errors
    EOFError,
    zipfile.BadZipFile,
)


def _snapshot(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that shares no memory with it: on the CPU
    ``tensor.numpy()`` is a view, so a later in-place update of the
    tensor would reach the queued save; from a CUDA tensor the copy is a
    synchronous device-to-host transfer.  A bfloat16 tensor becomes the
    ``|V2`` array of its bits, as the payload holds it, and a mesh array
    its global array, each block copied."""
    return host_array(leaf, copy=True)


class CheckpointManager:
    """keep-last-k rotation with an optional background writer.

    The async path snapshots every leaf to a host copy (blocking only on
    the transfer), then serializes + fsyncs on a worker thread so the
    loop overlaps the write with the next steps.  Writer errors surface
    on the *next* ``save()`` (and on ``wait()``/``close()``) — a dying
    writer must not silently drop every subsequent checkpoint.
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker: Optional[threading.Thread] = None
        self._errors = []
        if async_save:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _save_now(self, step: int, tree, extra):
        from ..runtime import faultinject

        # raising faults fire before the write; a CkptCorrupt site fires
        # on the post-write call (passing the payload path) and flips a
        # byte so restore exercises verify + quarantine
        faultinject.fire("ckpt_save", step=step)
        save_checkpoint(self.directory, step, tree, extra=extra)
        self._rotate()
        faultinject.fire(
            "ckpt_save",
            step=step,
            path=os.path.join(self.directory, f"step_{step:010d}.npz"),
        )

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, tree, extra = item
            try:
                self._save_now(step, tree, extra)
            except Exception as e:  # noqa: BLE001 — re-raised by the caller
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._errors:
            err = self._errors[0]
            self._errors = []
            raise RuntimeError(
                "checkpoint writer failed on an earlier save; later "
                "checkpoints would be silently dropped"
            ) from err

    def save(self, step: int, tree, *, extra=None):
        self._raise_pending()
        if self.async_save:
            host = {k: _snapshot(v) for k, v in _flatten(tree)}
            self._q.put((step, _unflatten(tree, host), extra))
        else:
            self._save_now(step, tree, extra)

    def wait(self):
        if self.async_save:
            self._q.join()
        self._raise_pending()

    def _rotate(self):
        steps = sorted(
            int(f[len("step_"):-len(".json")])
            for f in os.listdir(self.directory)
            if f.startswith("step_") and f.endswith(".json")
        )
        for s in steps[: -self.keep]:
            for suffix in (".json", ".npz"):
                p = os.path.join(self.directory, f"step_{s:010d}{suffix}")
                if os.path.exists(p):
                    os.remove(p)

    def restore_latest(self, like, *, mesh=None, specs=None,
                       quarantine: bool = True):
        """Restore the newest *intact* checkpoint: ``(step, tree, extra)``,
        or ``(None, None, None)`` when there is none.  ``mesh`` and
        ``specs`` place the leaves on a mesh (:func:`load_checkpoint`).

        A step whose payload fails digest verification (or is
        unreadable) is quarantined — renamed to ``*.corrupt`` so it
        stops being the latest — and the previous step is tried, until
        one restores or none remain.  ``quarantine=False`` raises on the
        first damaged step instead.
        """
        while True:
            step = latest_step(self.directory)
            if step is None:
                return None, None, None
            try:
                tree, extra = load_checkpoint(self.directory, step, like,
                                              mesh=mesh, specs=specs)
                return step, tree, extra
            except _CORRUPTION_ERRORS as e:
                if not quarantine:
                    raise
                quarantine_step(self.directory, step)
                log.warning(
                    "checkpoint step %d is corrupt (%s); quarantined, "
                    "falling back to the previous step",
                    step, e,
                )

    def close(self):
        if self.async_save and self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=10)
        self._raise_pending()
