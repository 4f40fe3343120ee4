"""Cached pipeline entry point: one call = ingest → relabel → decompose →
pack (→ stage, lazily), all behind the content-addressed cache.

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
from .artifact import PlanArtifact
from .cache import PlanCache, default_cache, graph_digest
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


def _drive(kind, graph, key_tail, cache, pack):
    """Shared front half: ingest (digest + cache probe) then relabel + pack."""
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


def _not_ported(what: str, roadmap_item: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet ({roadmap_item} in "
        "ROADMAP.md); the JAX package repro.pipeline has it"
    )


def _refuse_later_stages(rebalance_trials, hub_split):
    if rebalance_trials:
        _not_ported("rebalance_trials > 0 (skip-aware rebalance)", "Queue A-9")
    if hub_split is not None and hub_split is not False:
        _not_ported("hub_split (hub-split decomposition)", "Queue A-9")


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

    ``rebalance_trials > 0`` and ``hub_split`` are accepted in the
    signature (they are cache-key components) and raise
    ``NotImplementedError`` until their stages are ported.
    """
    _refuse_later_stages(rebalance_trials, hub_split)
    hub_c = None

    def pack(digest, key, seconds, cache_):
        t0 = time.perf_counter()
        g2, perm = relabel_cached(
            graph, digest, reorder=reorder, cyclic_p=cyclic_p, cache=cache_
        )
        seconds["relabel"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        pack_kwargs = dict(
            skew=skew,
            chunk=chunk,
            with_stats=with_stats,
            keep_blocks=keep_blocks or bucketize,
            step_masks=step_masks,
            aug_keys=aug_keys,
        )
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
        seconds["decompose+pack"] = time.perf_counter() - t1
        return PlanArtifact(
            kind="cannon", digest=digest, key=key, graph=g2,
            perm=perm, plan=plan, config=config,
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
    ``rebalance_trials > 0`` and ``hub_split`` raise
    ``NotImplementedError`` until their stages are ported."""
    _refuse_later_stages(rebalance_trials, hub_split)
    hub_c = None

    def pack(digest, key, seconds, cache_):
        t0 = time.perf_counter()
        g2, perm = relabel_cached(
            graph, digest, reorder=reorder, cyclic_p=cyclic_p, cache=cache_
        )
        seconds["relabel"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        plan = pack_summa_plan(
            g2, r, c, chunk=chunk, step_masks=step_masks,
            with_stats=bool(rebalance_trials),
        )
        if compact:
            plan = compact_stage(plan)  # rounds have no free visit order
        if autotune:
            plan = autotune_summa_plan(plan, two_sided=(autotune == "fused"))
        plan.broadcast = broadcast
        seconds["decompose+pack"] = time.perf_counter() - t1
        return PlanArtifact(
            kind="summa", digest=digest, key=key, graph=g2,
            perm=perm, plan=plan, config=config,
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
    kernel needs.  ``rebalance_trials > 0`` and ``hub_split`` raise
    ``NotImplementedError`` until their stages are ported."""
    _refuse_later_stages(rebalance_trials, hub_split)
    hub_c = None

    def pack(digest, key, seconds, cache_):
        t0 = time.perf_counter()
        g2, perm = relabel_cached(
            graph, digest, reorder=reorder, cyclic_p=cyclic_p, cache=cache_
        )
        seconds["relabel"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        plan = pack_oned_plan(
            g2, p, chunk=chunk, step_masks=step_masks,
            with_stats=bool(rebalance_trials),
        )
        if compact:
            plan = compact_stage(plan)  # ring steps have no free order
        if autotune:
            plan = autotune_oned_plan(plan, two_sided=(autotune == "fused"))
        seconds["decompose+pack"] = time.perf_counter() - t1
        return PlanArtifact(
            kind="oned", digest=digest, key=key, graph=g2,
            perm=perm, plan=plan, config=config,
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
