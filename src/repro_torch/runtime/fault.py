"""Fault-tolerant execution wrapper: checkpoint/restart with retries.

``run_with_restarts`` is the JAX package's front door of the same name:
it delegates to :func:`repro_torch.runtime.supervisor.supervise_loop` —
the supervised driver of checkpointed step loops — so restarts get
exponential backoff + jitter, a structured attempt record, and corrupt
checkpoints are quarantined instead of crashing the restore.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

log = logging.getLogger(__name__)

__all__ = ["run_with_restarts"]


def run_with_restarts(
    init_state: Callable[[], dict],
    step_fn: Callable[[dict, int], dict],
    *,
    n_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    max_restarts: int = 3,
    state_like=None,
    fault_injector: Optional[Callable[[int], None]] = None,
):
    """Run ``step_fn`` n_steps times with checkpoint/restart semantics.

    ``fault_injector(step)`` may raise to simulate failures (used by tests
    and the fault-tolerance example).  Any exception is restartable, as
    before.  Returns the final state dict.
    """
    from .supervisor import BackoffPolicy, Supervisor, supervise_loop

    sup = Supervisor(
        max_restarts=max_restarts,
        backoff=BackoffPolicy(base=0.01, max_delay=0.05),
        retry_on=(Exception,),
    )
    state, _report = supervise_loop(
        init_state,
        step_fn,
        n_steps=n_steps,
        ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every,
        supervisor=sup,
        state_like=state_like,
        fault_injector=fault_injector,
    )
    return state
