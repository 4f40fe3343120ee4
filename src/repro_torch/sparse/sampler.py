"""Neighbor sampler (GraphSAGE-style fanout) for minibatch GNN training.

Host-side (numpy) sampling over a CSR graph — part of the data pipeline:
given seed nodes and fanouts (e.g. 15-10), draws a layered subgraph and
returns relabeled edge lists with static (padded) shapes so the device
step compiles once.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["sample_neighbors", "SampledSubgraph"]


class SampledSubgraph:
    def __init__(self, node_ids, edge_src, edge_dst, seed_count, seeds=None):
        self.node_ids = node_ids  # (N_sub,) global ids (padded w/ -1)
        self.edge_src = edge_src  # (E_sub,) local ids into node_ids
        self.edge_dst = edge_dst
        self.seed_count = seed_count
        self.seeds = seeds  # (seed_count,) the seeds' global ids, as drawn

    @property
    def n_nodes(self):
        return self.node_ids.shape[0]

    @property
    def n_edges(self):
        return self.edge_src.shape[0]


def sample_neighbors(
    indptr: np.ndarray,
    indices: np.ndarray,
    seeds: np.ndarray,
    fanouts: Sequence[int],
    rng: np.random.Generator,
) -> SampledSubgraph:
    """Layered uniform neighbor sampling with replacement-free truncation.

    Shapes are padded to the static maxima ``batch * prod(fanouts)`` so the
    training step has a fixed signature.
    """
    seeds = np.asarray(seeds, dtype=np.int64)
    layers: List[np.ndarray] = [seeds]
    e_src: List[np.ndarray] = []
    e_dst: List[np.ndarray] = []
    frontier = seeds
    for f in fanouts:
        srcs = []
        dsts = []
        for v in frontier:
            nbrs = indices[indptr[v] : indptr[v + 1]]
            if nbrs.shape[0] == 0:
                continue
            take = min(f, nbrs.shape[0])
            sel = rng.choice(nbrs, size=take, replace=False)
            srcs.append(sel)
            dsts.append(np.full(take, v, dtype=np.int64))
        if srcs:
            srcs = np.concatenate(srcs)
            dsts = np.concatenate(dsts)
        else:
            srcs = np.zeros(0, np.int64)
            dsts = np.zeros(0, np.int64)
        e_src.append(srcs)
        e_dst.append(dsts)
        frontier = np.unique(srcs)
        layers.append(frontier)

    node_ids, inverse = np.unique(
        np.concatenate([np.concatenate(layers), np.array([0], np.int64)]),
        return_inverse=True,
    )
    remap = {int(g): i for i, g in enumerate(node_ids)}
    src_all = np.concatenate(e_src) if e_src else np.zeros(0, np.int64)
    dst_all = np.concatenate(e_dst) if e_dst else np.zeros(0, np.int64)
    src_l = np.array([remap[int(v)] for v in src_all], dtype=np.int32)
    dst_l = np.array([remap[int(v)] for v in dst_all], dtype=np.int32)

    # pad to static shapes
    max_nodes = int(seeds.shape[0] * np.prod([f + 1 for f in fanouts])) + 1
    max_edges = int(seeds.shape[0] * np.prod(fanouts) * 2) + 1
    nid = np.full(max_nodes, -1, np.int64)
    nid[: node_ids.shape[0]] = node_ids
    es = np.zeros(max_edges, np.int32)
    ed = np.zeros(max_edges, np.int32)
    es[: src_l.shape[0]] = src_l
    ed[: dst_l.shape[0]] = dst_l
    return SampledSubgraph(nid, es, ed, seeds.shape[0], seeds)
