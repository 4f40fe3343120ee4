"""Staged host-planning pipeline.

Public surface:

* :func:`plan_cannon` / :func:`plan_summa` / :func:`plan_oned` — cached
  pipeline entry points (ingest → relabel → decompose → pack → stage)
  returning a :class:`PlanArtifact`.
* :class:`PlanCache` / :func:`graph_digest` / :func:`default_cache` —
  the content-addressed plan cache.
* :func:`count_triangles_many` — batched front end: many graphs, one
  engine call.
* :class:`EdgeDelta` / :func:`apply_delta` — incremental re-plans of an
  artifact after a batch of edge edits (splice / repack / rebase).
* :func:`rebalance_stage` / :func:`hubsplit_stage` — the skip-aware
  rebalance and hub-split stages the planners run on request.
* :mod:`.stages` — the individual stage functions (vectorized packer,
  relabel composition) for callers assembling their own pipelines.
"""
from .artifact import PlanArtifact  # noqa: F401
from .batch import ManyResult, count_triangles_many  # noqa: F401
from .cache import (  # noqa: F401
    PlanCache,
    default_cache,
    graph_digest,
    set_default_cache,
)
from .delta import EdgeDelta, apply_delta  # noqa: F401
from .hubsplit import HubSide, hubsplit_stage  # noqa: F401
from .planner import plan_cannon, plan_oned, plan_summa, relabel_cached  # noqa: F401
from .rebalance import (  # noqa: F401
    masked_critical_path,
    rebalance_stage,
    rebalance_trial_perm,
)
from .stages import relabel_stage  # noqa: F401

__all__ = [
    "EdgeDelta",
    "apply_delta",
    "relabel_stage",
    "relabel_cached",
    "rebalance_stage",
    "rebalance_trial_perm",
    "masked_critical_path",
    "hubsplit_stage",
    "HubSide",
    "PlanArtifact",
    "PlanCache",
    "ManyResult",
    "count_triangles_many",
    "default_cache",
    "set_default_cache",
    "graph_digest",
    "plan_cannon",
    "plan_summa",
    "plan_oned",
]
