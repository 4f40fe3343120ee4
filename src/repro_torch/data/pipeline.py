"""Deterministic synthetic data pipelines with background prefetch.

Every family gets a seeded generator (same seed -> same stream, so a
restarted job replays its data cursor from the checkpoint) and a
double-buffered prefetch thread so host batch synthesis overlaps device
steps — the data-side analogue of the collective/compute overlap.

The batches are numpy, made exactly as the JAX package makes them (the
same seed gives the same bytes), over the port's own graph and sampler;
:func:`as_tensors` moves one to a device where the caller asks.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np

__all__ = ["TokenPipeline", "RecsysPipeline", "GraphPipeline", "Prefetcher",
           "as_tensors"]


class Prefetcher:
    """Background-thread double buffering around any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        for item in self._it:
            self._q.put(item)
        self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


class TokenPipeline:
    """Synthetic LM tokens with a restartable cursor.

    Samples Zipf-ish token ids (matching real vocab skew) with labels =
    tokens shifted by one; ``state_dict``/``load_state`` give exact replay
    after restart.
    """

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.cursor = 0

    def state_dict(self):
        return {"cursor": self.cursor, "seed": self.seed}

    def load_state(self, st):
        self.cursor = int(st["cursor"])
        self.seed = int(st["seed"])

    def next_batch(self):
        rng = np.random.default_rng((self.seed, self.cursor))
        self.cursor += 1
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        toks = np.minimum(z, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        while True:
            yield self.next_batch()


class RecsysPipeline:
    """Criteo-like synthetic batches (dense log-normals + Zipf ids)."""

    def __init__(self, cfg, batch: int, seed: int = 0):
        self.cfg, self.batch, self.seed = cfg, batch, seed
        self.cursor = 0

    def next_batch(self):
        rng = np.random.default_rng((self.seed, self.cursor))
        self.cursor += 1
        cfg = self.cfg
        dense = rng.lognormal(0, 1, size=(self.batch, cfg.n_dense)).astype(
            np.float32
        )
        ids = np.stack(
            [
                np.minimum(
                    rng.zipf(1.2, size=(self.batch, cfg.multi_hot)), size - 1
                )
                for size in cfg.table_sizes
            ],
            axis=1,
        ).astype(np.int32)
        ctr = (dense[:, 0] > np.median(dense[:, 0])).astype(np.float32)
        return {"dense": dense, "sparse_ids": ids, "labels": ctr}


class GraphPipeline:
    """Minibatch GNN sampling pipeline over a host CSR graph."""

    def __init__(self, graph, batch_nodes: int, fanouts, seed: int = 0):
        self.graph = graph
        adj = graph.adjacency_csr()
        self.indptr, self.indices = adj.indptr, adj.indices
        self.batch_nodes = batch_nodes
        self.fanouts = tuple(fanouts)
        self.seed = seed
        self.cursor = 0

    def next_batch(self):
        from ..sparse.sampler import sample_neighbors

        rng = np.random.default_rng((self.seed, self.cursor))
        self.cursor += 1
        seeds = rng.choice(self.graph.n, size=self.batch_nodes, replace=False)
        return sample_neighbors(
            self.indptr, self.indices, seeds, self.fanouts, rng
        )


def as_tensors(batch, device=None):
    """A batch as tensors on ``device`` (the GPU unless the caller asks for
    another, :func:`repro_torch.device.resolve_device`): a dict batch
    entry by entry, a sampled subgraph as ``{"node_ids", "edge_src",
    "edge_dst"}``; dtypes are kept."""
    import torch

    from ..device import resolve_device
    from ..sparse.sampler import SampledSubgraph

    dev = resolve_device(device)
    if isinstance(batch, SampledSubgraph):
        batch = {"node_ids": batch.node_ids, "edge_src": batch.edge_src,
                 "edge_dst": batch.edge_dst}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
