"""Host-side graph containers used by the planner and the preprocessing phase.

The Cannon engine (:mod:`repro_torch.core.cannon`) operates on
fixed-shape stacked tensors produced by :mod:`repro_torch.core.plan`;
this module holds the *host* representation: a simple undirected graph as a
deduplicated COO edge list plus CSR conversion helpers and exact oracles
used by the tests and benchmarks.

Conventions
-----------
* graphs are simple (no self loops, no duplicate edges) and undirected;
* ``edges`` stores each undirected edge once as ``(min, max)``;
* vertex ids are ``0 .. n-1`` int64 on the host, int32 on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Graph",
    "CSR",
    "csr_from_edges",
    "triangle_count_dense_oracle",
    "triangle_count_oracle",
]


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row structure over ``n_rows`` rows.

    ``indices[indptr[i]:indptr[i+1]]`` are the (sorted) column ids of row
    ``i``.  ``indices`` is int64 on the host; the planner narrows to int32
    when building device arrays.
    """

    n_rows: int
    n_cols: int
    indptr: np.ndarray  # (n_rows + 1,) int64
    indices: np.ndarray  # (nnz,) int64

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i] : self.indptr[i + 1]]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def validate(self) -> None:
        assert self.indptr.shape == (self.n_rows + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.nnz
        assert np.all(np.diff(self.indptr) >= 0)
        if self.nnz:
            assert self.indices.min() >= 0
            assert self.indices.max() < self.n_cols


def csr_from_edges(
    n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray
) -> CSR:
    """Build a CSR with per-row *sorted* column indices from COO pairs."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(n_rows=n_rows, n_cols=n_cols, indptr=indptr, indices=cols)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A simple undirected graph held on the host.

    ``edges`` is an ``(m, 2)`` int64 array with ``edges[:, 0] < edges[:, 1]``
    (each undirected edge stored exactly once).
    """

    n: int
    edges: np.ndarray
    name: str = "graph"

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @staticmethod
    def from_edges(n: int, src, dst, name: str = "graph") -> "Graph":
        """Deduplicate, drop self loops, canonicalize to (min, max)."""
        src = np.asarray(src, dtype=np.int64).ravel()
        dst = np.asarray(dst, dtype=np.int64).ravel()
        keep = src != dst
        src, dst = src[keep], dst[keep]
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        key = lo * np.int64(n) + hi
        _, first = np.unique(key, return_index=True)
        edges = np.stack([lo[first], hi[first]], axis=1)
        return Graph(n=n, edges=edges, name=name)

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def m(self) -> int:
        """Number of undirected edges."""
        return int(self.edges.shape[0])

    def degrees(self) -> np.ndarray:
        d = np.bincount(self.edges[:, 0], minlength=self.n)
        d += np.bincount(self.edges[:, 1], minlength=self.n)
        return d

    def relabel(self, perm: np.ndarray, name: Optional[str] = None) -> "Graph":
        """Return the graph with vertex ``v`` renamed to ``perm[v]``."""
        perm = np.asarray(perm, dtype=np.int64)
        src = perm[self.edges[:, 0]]
        dst = perm[self.edges[:, 1]]
        return Graph.from_edges(self.n, src, dst, name=name or self.name)

    def adjacency_csr(self) -> CSR:
        """Symmetric adjacency as CSR (both directions)."""
        rows = np.concatenate([self.edges[:, 0], self.edges[:, 1]])
        cols = np.concatenate([self.edges[:, 1], self.edges[:, 0]])
        return csr_from_edges(self.n, self.n, rows, cols)

    def upper_csr(self) -> CSR:
        """U: edges (i, j) with i < j, CSR over rows i."""
        return csr_from_edges(self.n, self.n, self.edges[:, 0], self.edges[:, 1])

    def dense_adjacency(self, dtype=np.float64) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=dtype)
        a[self.edges[:, 0], self.edges[:, 1]] = 1
        a[self.edges[:, 1], self.edges[:, 0]] = 1
        return a


# ----------------------------------------------------------------------
# exact oracles
# ----------------------------------------------------------------------
def triangle_count_dense_oracle(graph: Graph) -> int:
    """tr(A^3) / 6 — only usable for small n (dense)."""
    a = graph.dense_adjacency()
    return int(round(np.trace(a @ a @ a) / 6.0))


def triangle_count_oracle(graph: Graph) -> int:
    """Exact sparse host oracle: sum over U edges of |Adj_U(i) ∩ Adj_U(j)|.

    This is Eq. (1)/(2) of the paper evaluated sequentially and is fast
    enough for the RMAT scales used in tests and CPU benchmarks.
    """
    u = graph.upper_csr()
    indptr, indices = u.indptr, u.indices
    total = 0
    for i, j in graph.edges:
        a = indices[indptr[i] : indptr[i + 1]]
        b = indices[indptr[j] : indptr[j + 1]]
        # both lists sorted -> intersect via np.intersect1d on small arrays
        if len(a) and len(b):
            total += np.intersect1d(a, b, assume_unique=True).size
    return int(total)
