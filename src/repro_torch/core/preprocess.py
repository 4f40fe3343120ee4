"""Preprocessing phase (paper §5.3).

Steps, mirroring the paper:

1. *initial cyclic redistribution* — in our SPMD formulation the host
   planner feeds pre-placed blocks, so the "redistribution" is a relabeling
   choice; :func:`cyclic_relabel` implements it and the planning pipeline
   wires it in as the optional first relabel stage
   (``repro_torch.pipeline.stages.relabel_stage(..., cyclic_p=p)``).
2. *reorder vertices in non-decreasing degree* via counting sort.  The host
   path (:func:`degree_order`) is a stable counting sort;
   :func:`distributed_degree_rank` is the distributed formulation the
   paper describes (local histograms, a global histogram, prefix sums over
   degree buckets and over shards), with the shards as a leading tensor
   dimension or spread over the positions of a device mesh.
3. *split the adjacency matrix into U and L*.  Because L = Uᵀ, the planner
   only materializes U blocks; the ⟨j,i,k⟩ task set over L's nonzeros is the
   transposed view of the same blocks.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .graph import Graph

__all__ = [
    "degree_order",
    "cyclic_relabel",
    "distributed_degree_rank",
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


# ----------------------------------------------------------------------
# Distributed counting sort — the paper's §5.3/§5.4, shards as dim 0
# ----------------------------------------------------------------------
def distributed_degree_rank(degrees):
    """Per-shard degree ranks via the paper's distributed counting sort.

    ``degrees`` is a ``(p, chunk)`` integer tensor: shard ``s`` holds the
    degrees of vertices ``s * chunk ... (s + 1) * chunk - 1``.  The JAX
    package runs the same steps inside ``shard_map`` over a 1D axis; here
    the shards are the leading dimension, so its collectives become sums
    and scans over dim 0.  ``degrees`` may instead be a
    :class:`~repro_torch.core.engine.MeshArray` over a one-axis mesh
    (:func:`_mesh_degree_rank`), each position holding its shard on its
    device: the steps are then the JAX package's, position by position.

    (a) a local histogram per shard;
    (b) the global histogram (the paper's all-reduce: ``psum`` there, a
        sum over dim 0 here) and its exclusive scan over degree buckets;
    (c) for each degree, the vertices of it held by *earlier* shards (the
        paper's prefix sum over shards, cost ``d_max log p``: there an
        ``all_gather`` and a masked sum, here an exclusive cumsum over
        dim 0);
    (d) stable within-shard offsets: a stable sort of the shard's degrees
        against the shard's own exclusive bucket starts.

    (The global max-degree reduction of the paper's cost model is
    subsumed by the static bucket bound: a degree is below ``p * chunk``.)
    Returns the global rank (= new vertex id) of each vertex as a
    ``(p, chunk)`` int64 tensor (or a mesh array of each shard's int64
    ranks), stable by (shard, local position) — the permutation
    :func:`degree_order` gives.
    """
    from .engine import MeshArray

    if isinstance(degrees, MeshArray):
        return _mesh_degree_rank(degrees)
    deg = torch.as_tensor(degrees)
    if deg.dim() != 2:
        raise ValueError(
            f"degrees must be (p, chunk), got shape {tuple(deg.shape)}"
        )
    deg = deg.long()
    p, chunk = deg.shape
    nbuckets = chunk * p + 1
    hist = torch.zeros((p, nbuckets), dtype=torch.int64, device=deg.device)
    hist.scatter_add_(1, deg, torch.ones_like(deg))
    ghist = hist.sum(dim=0)
    bucket_starts = torch.cumsum(ghist, 0) - ghist
    before = torch.cumsum(hist, 0) - hist
    order = torch.argsort(deg, dim=1, stable=True)
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(chunk, device=deg.device).expand(
        p, chunk).contiguous())
    local_starts = torch.cumsum(hist, 1) - hist
    within = pos - torch.gather(local_starts, 1, deg)
    return bucket_starts[deg] + torch.gather(before, 1, deg) + within


def _mesh_degree_rank(degrees):
    """:func:`distributed_degree_rank` over a one-axis device mesh.

    Position ``s`` holds shard ``s``'s degrees (a 1-D block; the shards may
    differ in length, the last one short where ``p`` does not divide
    ``n``) on its device.  Each position builds its int64 histogram over
    ``n + 1`` buckets; the all-reduce of the histograms is a copy of each
    to the first position's device, a sum there and a copy of the sum back
    to every position; the prefix over earlier shards is carried along the
    ring, position ``s`` sending ``s + 1`` the histograms of shards
    ``0 .. s`` summed.  The within-shard offsets are local.  Returns the
    ranks as a mesh array of int64 blocks on the positions' devices.
    """
    from .engine import MeshArray, _send

    mesh = degrees.mesh
    if len(mesh.shape) != 1:
        raise ValueError(f"the degrees' mesh must have one axis, got "
                         f"{tuple(mesh.shape)}")
    positions = list(np.ndindex(*mesh.shape))
    deg = {pos: degrees.blocks[pos].long() for pos in positions}
    if any(d.dim() != 1 for d in deg.values()):
        raise ValueError("each position holds a 1-D block of degrees")
    nbuckets = sum(d.numel() for d in deg.values()) + 1
    hist = {pos: torch.zeros(nbuckets, dtype=torch.int64,
                             device=d.device).scatter_add_(
                                 0, d, torch.ones_like(d))
            for pos, d in deg.items()}
    # the all-reduce: every histogram to the first device, summed, back
    ghist = sum(_send(h, mesh, positions[0], "reduce") for h in hist.values())
    before, carried = {}, None
    for pos in positions:  # the prefix over earlier shards, along the ring
        before[pos] = (torch.zeros_like(hist[pos]) if carried is None
                       else _send(carried, mesh, pos, "shift"))
        carried = before[pos] + hist[pos]
    ranks = {}
    for pos in positions:
        d, h = deg[pos], hist[pos]
        g = _send(ghist, mesh, pos, "broadcast")
        bucket_starts = torch.cumsum(g, 0) - g
        order = torch.argsort(d, stable=True)
        local = torch.empty_like(order)
        local[order] = torch.arange(d.numel(), device=d.device)
        within = local - (torch.cumsum(h, 0) - h)[d]
        ranks[pos] = bucket_starts[d] + before[pos][d] + within
    return MeshArray(mesh, ranks)
