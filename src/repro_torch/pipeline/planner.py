"""Cached pipeline entry point: one call = ingest → relabel → decompose →
pack (→ stage, lazily), all behind the content-addressed cache.

``plan_cannon`` is what the Cannon runner in :mod:`repro_torch.core.api`
calls; it returns a :class:`~repro_torch.pipeline.artifact.PlanArtifact`.
Repeated counts of the same (or merely re-labeled / re-ordered-edge)
graph hit the cache at the digest and skip every stage; the relabel
result is cached separately so different configurations planning the
same graph share the degree ordering.  Cache keys have the same tail as
the JAX package's ``plan_cannon``.
"""
from __future__ import annotations

import time
from typing import Optional

from ..core.graph import Graph
from .artifact import PlanArtifact
from .cache import PlanCache, default_cache, graph_digest
from .stages import (
    autotune_tc_plan,
    compact_stage,
    pack_tc_plan,
    relabel_stage,
)

__all__ = ["plan_cannon", "relabel_cached"]


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
    ``autotune`` runs the deterministic kernel-shape stage (chunk +
    long/short split from the probe-length distribution) — pass the
    string ``"fused"`` for the two-sided maxfrag split the fused kernel
    requires; ``aug_keys`` stages the row-encoded B intersection keys for
    the ``global`` kernel.  All three are cache-key components.

    ``rebalance_trials > 0``, ``hub_split`` and ``bucketize=True`` are
    accepted in the signature (they are cache-key components) and raise
    ``NotImplementedError`` until their stages are ported.
    """
    if rebalance_trials:
        _not_ported("rebalance_trials > 0 (skip-aware rebalance)", "Queue A-9")
    if hub_split is not None and hub_split is not False:
        _not_ported("hub_split (hub-split decomposition)", "Queue A-9")
    if bucketize:
        _not_ported("bucketize=True (search2's bucketize_plan)", "Queue A-3")
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
            keep_blocks=keep_blocks,
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
