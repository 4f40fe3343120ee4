"""Fault-tolerant checkpointing of tensor trees.

* atomic writes: tmp file + fsync + rename, manifest with content hashes
  (the JAX package's on-disk format: either package loads the other's);
* keep-last-k rotation + an async writer thread that saves host copies;
* quarantine of a damaged step and fallback to the one before;
* TC shift-level resume: (shift index, the stepper's carry, per-device
  partial counts) lets a restarted job skip completed Cannon shifts
  (``tc_run --ckpt-dir``).
"""
from .checkpoint import (  # noqa: F401
    latest_step,
    load_checkpoint,
    quarantine_step,
    save_checkpoint,
)
from .manager import CheckpointManager  # noqa: F401
