"""Staged host-planning pipeline.

Public surface:

* :func:`plan_cannon` — cached pipeline entry point (ingest → relabel →
  decompose → pack → stage) returning a :class:`PlanArtifact`.
* :class:`PlanCache` / :func:`graph_digest` / :func:`default_cache` —
  the content-addressed plan cache.
* :mod:`.stages` — the individual stage functions (vectorized packer,
  relabel composition) for callers assembling their own pipelines.
"""
from .artifact import PlanArtifact  # noqa: F401
from .cache import (  # noqa: F401
    PlanCache,
    default_cache,
    graph_digest,
    set_default_cache,
)
from .planner import plan_cannon, relabel_cached  # noqa: F401
from .stages import relabel_stage  # noqa: F401

__all__ = [
    "relabel_stage",
    "relabel_cached",
    "PlanArtifact",
    "PlanCache",
    "default_cache",
    "set_default_cache",
    "graph_digest",
    "plan_cannon",
]
