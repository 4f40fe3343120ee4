"""Elastic scaling: re-factorize the grid after device count changes.

Cannon needs a square grid; after losing devices the framework falls back
to the best rectangular factorization under the SUMMA schedule (the
paper's own §8 suggestion) and replans.  ``replan_elastic`` plans through
:mod:`repro_torch.pipeline` — the content-addressed plan cache, skip
masks, schedule compaction, rebalance and hub-split all survive an
elastic re-plan; ``legacy=True`` keeps the JAX package's deprecated raw
planners.  On one device the "devices" are the logical grid's positions
(:mod:`repro_torch.runtime.supervisor`).  Checkpointed mid-schedule
partials do **not** transfer across grids (see
:func:`repro_torch.runtime.supervisor.check_partials_portable`); only
completed-graph / stream-round boundaries are portable.
"""
from __future__ import annotations

import math
import warnings
from typing import Optional, Tuple

__all__ = ["best_grid", "replan_elastic"]


def best_grid(n_devices: int, *, require_square: bool = False) -> Tuple[int, int]:
    """Largest usable (r, c) with r*c <= n_devices.

    Prefers square; falls back to the most-square factorization where the
    larger dim is a multiple of the smaller (SUMMA panel-slot requirement).
    """
    q = int(math.isqrt(n_devices))
    if require_square:
        return q, q
    best = (1, 1)
    for r in range(1, n_devices + 1):
        c = n_devices // r
        if c < r:
            break
        if c % r == 0 and r * c <= n_devices:
            # prefer larger area, then most-square (largest r)
            if (r * c, r) > (best[0] * best[1], best[0]):
                best = (r, c)
    if best == (1, 1):
        best = (q, q)
    return best


def replan_elastic(
    graph,
    n_devices: int,
    *,
    schedule: Optional[str] = None,
    chunk: int = 512,
    reorder: bool = True,
    cyclic_p: Optional[int] = None,
    compact: bool = True,
    rebalance_trials: int = 0,
    hub_split=False,
    cache=None,
    legacy: bool = False,
):
    """Re-plan for a new device count through the pipeline planner.

    Returns ``(schedule_name, artifact, (r, c))`` where ``artifact`` is a
    :class:`repro_torch.pipeline.PlanArtifact` — plan features (skip masks,
    compaction, rebalance seed, hub cut) and cache behavior are
    identical to a cold pipeline plan at the new grid, so nothing is
    lost to elasticity.  ``schedule="cannon"`` forces the square
    factorization; the default picks Cannon when the best factorization
    is square and SUMMA otherwise.

    ``legacy=True`` (deprecated) returns the raw plan of the bare
    planners — no cache, no masks, no compaction — as the JAX package's
    does; it exists only for old callers and will be removed.
    """
    if legacy:
        warnings.warn(
            "replan_elastic(legacy=True) bypasses the pipeline (no plan "
            "cache, skip masks, compaction, rebalance or hub-split) and "
            "will be removed; drop legacy= to plan through the pipeline",
            DeprecationWarning,
            stacklevel=2,
        )
        from ..core.plan import build_plan
        from ..core.summa import build_summa_plan

        r, c = best_grid(n_devices)
        if r == c:
            return "cannon", build_plan(graph, r, chunk=chunk), (r, c)
        return "summa", build_summa_plan(graph, r, c, chunk=chunk), (r, c)

    from ..pipeline import plan_cannon, plan_summa

    r, c = best_grid(n_devices, require_square=(schedule == "cannon"))
    common = dict(
        chunk=chunk,
        reorder=reorder,
        cyclic_p=cyclic_p,
        compact=compact,
        rebalance_trials=rebalance_trials,
        hub_split=hub_split,
        cache=cache,
    )
    if r == c and schedule != "summa":
        art = plan_cannon(graph, r, **common)
        return "cannon", art, (r, c)
    art = plan_summa(graph, r, c, **common)
    return "summa", art, (r, c)
