"""Plan rebalancer — straggler mitigation at the planning level.

In lockstep SPMD the slowest device per shift sets the pace, so the lever
against stragglers is *balance*: the paper relies on degree-ordered cyclic
distribution.  A randomized-relabeling search perturbs the vertex order
*within equal-degree runs* and keeps the seed minimizing the **masked
critical path** — the max per-device probe work on *kept* (non-skipped)
steps per shift, i.e. what the engine actually executes with
sparsity-aware step skipping on.

This module is the thin front end of the JAX package's module of the same
name; the search itself is the pipeline's rebalance stage
(:mod:`repro_torch.pipeline.rebalance`), so it runs behind the
content-addressed plan cache and supports all three schedules.
"""
from __future__ import annotations

from typing import Tuple

from ..core.graph import Graph

__all__ = ["rebalance_plan"]


def rebalance_plan(
    graph: Graph,
    q: int,
    *,
    trials: int = 8,
    chunk: int = 512,
    schedule: str = "cannon",
    cache=None,
) -> Tuple[object, dict]:
    """Search relabeling seeds; return the best-balanced plan + report.

    Pipeline-backed: plans the *raw* graph through the cached planning
    pipeline with its skip-aware rebalance stage.  ``schedule`` picks the
    plan family — ``cannon`` (``q x q``), ``summa`` (``q x q``), or
    ``oned`` (``p = q``).  The report carries the trial history, the
    winning seed, ``baseline/best`` masked critical paths, the
    ``improvement`` ratio (baseline / best, guarded only against a
    literal-zero best), and the winner's ``skipped_steps``.
    """
    from ..pipeline import plan_cannon, plan_oned, plan_summa

    trials = max(1, int(trials))
    if schedule == "cannon":
        art = plan_cannon(
            graph, q, chunk=chunk, keep_blocks=False,
            rebalance_trials=trials, cache=cache,
        )
    elif schedule == "summa":
        art = plan_summa(
            graph, q, q, chunk=chunk, rebalance_trials=trials, cache=cache
        )
    elif schedule == "oned":
        art = plan_oned(
            graph, q, chunk=chunk, rebalance_trials=trials, cache=cache
        )
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return art.plan, art.rebalance
