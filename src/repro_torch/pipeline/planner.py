"""Cached pipeline entry point: one call = ingest → relabel (→ hub split
→ rebalance) → decompose → pack (→ stage, lazily), all behind the
content-addressed cache.

``plan_cannon`` / ``plan_summa`` / ``plan_oned`` are what the schedule
runners in :mod:`repro_torch.core.api` call; each returns a
:class:`~repro_torch.pipeline.artifact.PlanArtifact`.  Repeated counts of
the same (or merely re-labeled / re-ordered-edge) graph hit the cache at
the digest and skip every stage; the relabel result is cached separately
so different schedules planning the same graph share the degree ordering.
Cache keys have the same tails as the JAX package's planners.
"""
from __future__ import annotations

import time
from typing import Optional

from ..core.graph import Graph
from ..core.plan import bucketize_plan
from ..runtime import faultinject
from .artifact import PlanArtifact
from .cache import PlanCache, default_cache, graph_digest
from .hubsplit import hubsplit_stage, normalize_hub_split
from .rebalance import rebalance_stage
from .stages import (
    autotune_oned_plan,
    autotune_summa_plan,
    autotune_tc_plan,
    compact_stage,
    pack_oned_plan,
    pack_summa_plan,
    pack_tc_plan,
    relabel_stage,
)

__all__ = ["plan_cannon", "plan_summa", "plan_oned", "relabel_cached"]


def relabel_cached(
    graph: Graph,
    digest: str,
    *,
    reorder: bool,
    cyclic_p: Optional[int],
    cache: PlanCache,
):
    """Relabel stage behind the cache: shared across plan configurations."""
    return cache.memo(
        ("relabel", digest, reorder, cyclic_p),
        lambda: relabel_stage(graph, reorder=reorder, cyclic_p=cyclic_p),
    )


def _rebalanced(g2, perm, trials, reorder, pack_trial, seconds):
    """Run the rebalance stage between relabel and pack (no-op when off).

    Trials pack lean (stats + masks only); the returned winner plan is
    reused by callers whose flags match the trial flags, and re-packed
    otherwise — so the stage composes with any pack configuration
    (keep_blocks, bucketize, step_masks=False, ...).
    """
    if not trials:
        return g2, perm, None, None
    if not reorder:
        raise ValueError(
            "rebalance_trials requires reorder=True: trial relabelings "
            "shuffle within equal-degree runs of the degree ordering"
        )
    t0 = time.perf_counter()
    g2, perm, best_plan, report = rebalance_stage(g2, perm, trials, pack_trial)
    seconds["rebalance"] = time.perf_counter() - t0
    return g2, perm, best_plan, report


def _hub_knob(hub_split, reorder, cyclic_p):
    """Validate + canonicalize the hub-split knob (None | threshold c).

    The suffix-cut decomposition needs the degree ordering: hub
    detection is a ``searchsorted`` on the sorted degrees, and the cut
    ``[h0, n)`` is only the hub set because hubs get the highest ids.
    """
    hub_c = normalize_hub_split(hub_split)
    if hub_c is None:
        return None
    if not reorder:
        raise ValueError(
            "hub_split requires reorder=True: the hub cut is a suffix "
            "of the degree ordering"
        )
    if cyclic_p is not None:
        raise ValueError(
            "hub_split composes with the degree ordering only; the "
            "cyclic redistribution (cyclic_p) breaks the degree-suffix "
            "property the cut relies on"
        )
    return hub_c


def _hub_stage(g2, grid, hub_c, chunk, seconds):
    """Run the hub-split stage (no-op when off / nothing crosses)."""
    if hub_c is None:
        return g2, None
    t0 = time.perf_counter()
    g2, hub = hubsplit_stage(g2, grid, c=hub_c, chunk=chunk)
    seconds["hubsplit"] = time.perf_counter() - t0
    return g2, hub


def _artifact_graph(graph, g2, perm, hub, rb):
    """The graph an artifact carries: the planned one, or — for a hub
    plan, whose arrays cover only the residual — the *full* relabeled
    graph.  Marks whether the hub side's id space survived rebalance
    (trial seed 0 = yes)."""
    if hub is None:
        return g2
    hub.aligned = rb is None or int(rb.get("best_seed", 0)) == 0
    return graph.relabel(perm)


def _drive(kind, graph, key_tail, cache, pack):
    """Shared front half: ingest (digest + cache probe) then relabel + pack.
    The ``plan_stage`` injection point fires first, before the cache
    probe, so a retried plan hits the cache."""
    faultinject.fire("plan_stage", kind=kind)
    cache = cache if cache is not None else default_cache()
    seconds = {}
    t0 = time.perf_counter()
    digest = graph_digest(graph)
    seconds["ingest"] = time.perf_counter() - t0

    key = (kind, digest) + key_tail
    art = cache.get(key)
    if art is not None:
        art.cache_hit = True
        return art

    art = pack(digest, key, seconds, cache)
    art.stage_seconds.update(seconds)
    cache.put(key, art)
    return art


def plan_cannon(
    graph: Graph,
    q: int,
    *,
    skew: bool = True,
    chunk: int = 512,
    reorder: bool = True,
    cyclic_p: Optional[int] = None,
    with_stats: bool = True,
    keep_blocks: bool = True,
    bucketize: bool = False,
    d_small: int = 32,
    step_masks: bool = True,
    rebalance_trials: int = 0,
    compact: bool = True,
    autotune: bool = False,
    aug_keys: bool = False,
    hub_split=False,
    cache: Optional[PlanCache] = None,
) -> PlanArtifact:
    """Plan the 2D-cyclic (Cannon) execution of ``graph`` on a ``q x q``
    grid, through the cache.

    ``step_masks`` stages the per-(device, shift) skip mask the engine
    consumes for sparsity-aware step skipping (part of the cache key —
    masked and unmasked artifacts are distinct entries).
    ``compact`` (default on) runs the schedule-compaction stage: it
    searches the σ visit order concentrating live work onto the fewest
    steps, re-packs under the winner, and stages the globally-live step
    list the engine's compacted loop executes.
    ``bucketize=True`` stores the long|short-reordered plan of
    :func:`~repro_torch.core.plan.bucketize_plan` (for
    ``method="search2"``, split at ``d_small``) under its own cache entry;
    it keeps the canonical blocks the bucketizer reads.
    ``autotune`` runs the deterministic kernel-shape stage (chunk +
    long/short split from the probe-length distribution) — pass the
    string ``"fused"`` for the two-sided maxfrag split the fused kernel
    requires; ``aug_keys`` stages the row-encoded B intersection keys for
    the ``global`` and ``search2`` kernels.  All are cache-key components.
    ``rebalance_trials > 0`` runs the skip-aware rebalance stage over that
    many relabeling seeds (the winner's report lands on the artifact's
    ``rebalance``); ``hub_split`` (False | True | threshold multiplier c)
    runs the hub-split stage between relabel and rebalance: the
    heavy-tailed id suffix is cut off into column-strided fragments
    (``plan.hub``) and every later stage sees only the residual graph.
    """
    hub_c = _hub_knob(hub_split, reorder, cyclic_p)

    def pack(digest, key, seconds, cache_):
        t0 = time.perf_counter()
        g2, perm = relabel_cached(
            graph, digest, reorder=reorder, cyclic_p=cyclic_p, cache=cache_
        )
        seconds["relabel"] = time.perf_counter() - t0
        g2, hub = _hub_stage(g2, (q, q), hub_c, chunk, seconds)
        g2, perm, best_plan, rb = _rebalanced(
            g2, perm, rebalance_trials, reorder,
            lambda gt: pack_tc_plan(
                gt, q, skew=skew, chunk=chunk, with_stats=True,
                keep_blocks=False, step_masks=True,
            ),
            seconds,
        )
        t1 = time.perf_counter()
        pack_kwargs = dict(
            skew=skew,
            chunk=chunk,
            with_stats=with_stats,
            keep_blocks=keep_blocks or bucketize,
            step_masks=step_masks,
            aug_keys=aug_keys,
        )
        if best_plan is not None and (
            with_stats and not (keep_blocks or bucketize) and step_masks
            and not aug_keys
        ):  # caller flags == trial flags: the winner pack is the plan
            plan = best_plan
        else:
            plan = pack_tc_plan(g2, q, **pack_kwargs)
        if compact and skew:
            plan = compact_stage(
                plan,
                repack=lambda sigma: pack_tc_plan(
                    g2, q, skew_perm=sigma, **pack_kwargs
                ),
            )
        if bucketize:
            plan = bucketize_plan(plan, d_small=d_small)
        if autotune:
            plan = autotune_tc_plan(plan, two_sided=(autotune == "fused"))
        plan.hub = hub
        seconds["decompose+pack"] = time.perf_counter() - t1
        return PlanArtifact(
            kind="cannon", digest=digest, key=key,
            graph=_artifact_graph(graph, g2, perm, hub, rb),
            perm=perm, plan=plan, rebalance=rb, config=config,
        )

    config = dict(
        q=q, skew=skew, chunk=chunk, reorder=reorder, cyclic_p=cyclic_p,
        with_stats=with_stats, keep_blocks=keep_blocks, bucketize=bucketize,
        d_small=d_small, step_masks=step_masks,
        rebalance_trials=rebalance_trials, compact=compact,
        autotune=autotune, aug_keys=aug_keys, hub_split=hub_c,
    )
    tail = (
        q, skew, chunk, reorder, cyclic_p, with_stats, keep_blocks,
        bucketize, d_small if bucketize else None, step_masks,
        rebalance_trials, compact, autotune, aug_keys, hub_c,
    )
    return _drive("cannon", graph, tail, cache, pack)


def plan_summa(
    graph: Graph,
    r: int,
    c: int,
    *,
    chunk: int = 512,
    reorder: bool = True,
    cyclic_p: Optional[int] = None,
    step_masks: bool = True,
    rebalance_trials: int = 0,
    compact: bool = True,
    autotune: bool = False,
    broadcast: str = "auto",
    hub_split=False,
    cache: Optional[PlanCache] = None,
) -> PlanArtifact:
    """Plan the SUMMA execution on an ``r x c`` grid, through the cache.

    ``compact`` stages the globally-live broadcast rounds (the engine
    leaves the dead ones out); ``autotune`` runs the deterministic
    kernel-shape stage (``"fused"``: the maxfrag split); ``broadcast``
    records the panel-broadcast strategy the plan is staged for
    (``"auto"``/``"onehot"``/``"chain"``, resolved by ``build_summa_fn``) — like
    every planner knob it is a cache-key component.
    ``rebalance_trials`` and ``hub_split`` run the rebalance and hub-split
    stages as in :func:`plan_cannon`."""
    hub_c = _hub_knob(hub_split, reorder, cyclic_p)

    def pack(digest, key, seconds, cache_):
        t0 = time.perf_counter()
        g2, perm = relabel_cached(
            graph, digest, reorder=reorder, cyclic_p=cyclic_p, cache=cache_
        )
        seconds["relabel"] = time.perf_counter() - t0
        g2, hub = _hub_stage(g2, (r, c), hub_c, chunk, seconds)
        g2, perm, best_plan, rb = _rebalanced(
            g2, perm, rebalance_trials, reorder,
            lambda gt: pack_summa_plan(
                gt, r, c, chunk=chunk, step_masks=True, with_stats=True
            ),
            seconds,
        )
        t1 = time.perf_counter()
        if best_plan is not None and step_masks:
            plan = best_plan  # caller flags == trial flags
        else:
            plan = pack_summa_plan(
                g2, r, c, chunk=chunk, step_masks=step_masks,
                with_stats=bool(rebalance_trials),
            )
        if compact:
            plan = compact_stage(plan)  # rounds have no free visit order
        if autotune:
            plan = autotune_summa_plan(plan, two_sided=(autotune == "fused"))
        plan.broadcast = broadcast
        plan.hub = hub
        seconds["decompose+pack"] = time.perf_counter() - t1
        return PlanArtifact(
            kind="summa", digest=digest, key=key,
            graph=_artifact_graph(graph, g2, perm, hub, rb),
            perm=perm, plan=plan, rebalance=rb, config=config,
        )

    config = dict(
        r=r, c=c, chunk=chunk, reorder=reorder, cyclic_p=cyclic_p,
        step_masks=step_masks, rebalance_trials=rebalance_trials,
        compact=compact, autotune=autotune, broadcast=broadcast,
        hub_split=hub_c,
    )
    tail = (
        r, c, chunk, reorder, cyclic_p, step_masks, rebalance_trials,
        compact, autotune, broadcast, hub_c,
    )
    return _drive("summa", graph, tail, cache, pack)


def plan_oned(
    graph: Graph,
    p: int,
    *,
    chunk: int = 512,
    reorder: bool = True,
    cyclic_p: Optional[int] = None,
    step_masks: bool = True,
    rebalance_trials: int = 0,
    compact: bool = True,
    autotune: bool = False,
    hub_split=False,
    cache: Optional[PlanCache] = None,
) -> PlanArtifact:
    """Plan the 1D-ring baseline over ``p`` devices, through the cache.

    ``compact`` stages the globally-live ring steps (dead steps become
    fused multi-hop rotations); ``autotune`` tunes the chunk (the ring's
    global-id columns rule out the two-level split), and with
    ``"fused"`` lands the maxfrag split and long-first reorder the fused
    kernel needs.  ``rebalance_trials`` and ``hub_split`` run the
    rebalance and hub-split stages as in :func:`plan_cannon` (on the ring
    the hub tasks go round-robin over ``p`` devices, with full
    fragments)."""
    hub_c = _hub_knob(hub_split, reorder, cyclic_p)

    def pack(digest, key, seconds, cache_):
        t0 = time.perf_counter()
        g2, perm = relabel_cached(
            graph, digest, reorder=reorder, cyclic_p=cyclic_p, cache=cache_
        )
        seconds["relabel"] = time.perf_counter() - t0
        g2, hub = _hub_stage(g2, (p,), hub_c, chunk, seconds)
        g2, perm, best_plan, rb = _rebalanced(
            g2, perm, rebalance_trials, reorder,
            lambda gt: pack_oned_plan(
                gt, p, chunk=chunk, step_masks=True, with_stats=True
            ),
            seconds,
        )
        t1 = time.perf_counter()
        if best_plan is not None and step_masks:
            plan = best_plan  # caller flags == trial flags
        else:
            plan = pack_oned_plan(
                g2, p, chunk=chunk, step_masks=step_masks,
                with_stats=bool(rebalance_trials),
            )
        if compact:
            plan = compact_stage(plan)  # ring steps have no free order
        if autotune:
            plan = autotune_oned_plan(plan, two_sided=(autotune == "fused"))
        plan.hub = hub
        seconds["decompose+pack"] = time.perf_counter() - t1
        return PlanArtifact(
            kind="oned", digest=digest, key=key,
            graph=_artifact_graph(graph, g2, perm, hub, rb),
            perm=perm, plan=plan, rebalance=rb, config=config,
        )

    config = dict(
        p=p, chunk=chunk, reorder=reorder, cyclic_p=cyclic_p,
        step_masks=step_masks, rebalance_trials=rebalance_trials,
        compact=compact, autotune=autotune, hub_split=hub_c,
    )
    tail = (
        p, chunk, reorder, cyclic_p, step_masks, rebalance_trials,
        compact, autotune, hub_c,
    )
    return _drive("oned", graph, tail, cache, pack)
