"""Preprocessing phase (paper §5.3).

Steps, mirroring the paper:

1. *initial cyclic redistribution* — in our SPMD formulation the host
   planner feeds pre-placed blocks, so the "redistribution" is a relabeling
   choice; :func:`cyclic_relabel` implements it and the planning pipeline
   wires it in as the optional first relabel stage
   (``repro_torch.pipeline.stages.relabel_stage(..., cyclic_p=p)``).
2. *reorder vertices in non-decreasing degree* via counting sort.  The host
   path (:func:`degree_order`) is a stable counting sort; the distributed
   formulation the paper describes (local histograms, global max-degree
   reduction, prefix sums over degree buckets) is not part of this package
   yet.
3. *split the adjacency matrix into U and L*.  Because L = Uᵀ, the planner
   only materializes U blocks; the ⟨j,i,k⟩ task set over L's nonzeros is the
   transposed view of the same blocks.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .graph import Graph

__all__ = [
    "degree_order",
    "cyclic_relabel",
    "preprocess",
]


def degree_order(graph: Graph) -> np.ndarray:
    """Return ``perm`` with ``perm[v]`` = new id of vertex ``v``.

    Vertices are ranked by non-decreasing degree; ties broken by original
    id (stable sort — the same ranks the paper's counting sort yields).
    """
    deg = graph.degrees()
    order = np.argsort(deg, kind="stable")  # vertex ids sorted by degree
    perm = np.empty(graph.n, dtype=np.int64)
    perm[order] = np.arange(graph.n, dtype=np.int64)
    return perm


def cyclic_relabel(n: int, p: int) -> np.ndarray:
    """The paper's initial cyclic redistribution as a relabeling.

    Vertex ``v`` (owned contiguously in a 1D input distribution) moves to
    position ``(v % p) * ceil(n/p) + v // p`` — round-robin over ranks.
    When ``p`` does not divide ``n`` the trailing slots of the last rank's
    chunk are empty; they are compacted away so the result is a true
    permutation of ``[0, n)`` (safe for :meth:`Graph.relabel`), identical
    to the raw positions whenever ``p | n``.
    """
    chunk = -(-n // p)
    v = np.arange(n, dtype=np.int64)
    pos = (v % p) * chunk + v // p
    perm = np.empty(n, dtype=np.int64)
    perm[np.argsort(pos)] = v
    return perm


def preprocess(graph: Graph) -> Tuple[Graph, np.ndarray]:
    """Degree-order the graph; return (relabeled graph, perm)."""
    perm = degree_order(graph)
    return graph.relabel(perm, name=graph.name + "+degord"), perm
