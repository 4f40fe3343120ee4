"""2D cyclic decomposition of the upper-triangular adjacency matrix.

The processor grid is ``r x c`` (square ``q x q`` for Cannon; SUMMA accepts
rectangular).  Following the paper, matrix entry ``(i, j)`` belongs to block
``(i % r, j % c)`` with *transformed* (local) index ``(i // r, j // c)`` —
"the adjacency list of a vertex v_i is accessed using the transformed index
v_i ÷ √p in the per-processor CSR representation".

Because L = Uᵀ, a single cyclic decomposition of U provides everything:

* the task (mask) block of device ``(x, y)`` is ``U_{x,y}``;
* the Cannon "A" operand at shift ``s`` is ``U_{x, (x+y+s) % q}`` (rows i,
  columns k);
* the Cannon "B" operand is ``L_{(x+y+s) % q, y} = (U_{y, (x+y+s) % q})ᵀ`` —
  i.e. the *same* block family, read as rows-j-by-columns-k.  The device
  therefore intersects rows of two U blocks sharing their column range,
  which is exactly Eq. (6) of the paper.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .graph import Graph

__all__ = [
    "BlockCSR",
    "CyclicCOO",
    "cyclic_coo",
    "blocks_from_coo",
    "cyclic_blocks",
    "block_of",
    "local_index",
]


def block_of(i: np.ndarray, j: np.ndarray, r: int, c: int):
    return i % r, j % c


def local_index(i: np.ndarray, j: np.ndarray, r: int, c: int):
    return i // r, j // c


@dataclasses.dataclass(frozen=True)
class BlockCSR:
    """One cyclic block of U in CSR form with a doubly-compressed row list.

    ``active_rows`` lists local rows with non-empty adjacency fragments —
    the paper's doubly-sparse traversal structure; everything else loops
    only over these.
    """

    bx: int
    by: int
    n_rows: int  # local rows = ceil(n / r)
    n_cols: int  # local cols = ceil(n / c)
    indptr: np.ndarray  # (n_rows + 1,) int64
    indices: np.ndarray  # (nnz,) int64 local column ids, sorted per row
    active_rows: np.ndarray  # (n_active,) int64

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def max_row_len(self) -> int:
        if self.n_rows == 0:
            return 0
        return int(np.max(np.diff(self.indptr), initial=0))


@dataclasses.dataclass(frozen=True)
class CyclicCOO:
    """One lexsorted pass over the 2D-cyclic decomposition of U.

    The single sort by ``(block id, local row, local col)`` is everything
    the packers need: per-block slices are contiguous (``starts``), the
    per-block CSR indptr is a row-count cumsum (``rowcnt``), and block-local
    COO scatter offsets are ``arange(m) - starts[bid_s]``.  This replaces
    the per-block bincount/cumsum loops that used to run q×q times.
    """

    r: int
    c: int
    rows_loc: int  # local rows per block = ceil(n / r)
    cols_loc: int  # local cols per block = ceil(n / c)
    bid_s: np.ndarray  # (m,) block id = bx * c + by, sorted
    li_s: np.ndarray  # (m,) local row, sorted within block
    lj_s: np.ndarray  # (m,) local col, sorted within (block, row)
    counts: np.ndarray  # (r*c,) nnz per block
    starts: np.ndarray  # (r*c + 1,) prefix offsets into the sorted arrays
    rowcnt: np.ndarray  # (r*c, rows_loc) nnz per (block, local row)

    @property
    def nnz_max(self) -> int:
        return int(self.counts.max()) if self.counts.size else 0

    @property
    def row_len_max(self) -> int:
        return int(self.rowcnt.max()) if self.rowcnt.size else 0

    def offsets(self) -> np.ndarray:
        """Position of each sorted entry within its block."""
        return np.arange(self.bid_s.shape[0], dtype=np.int64) - self.starts[
            self.bid_s
        ]


def cyclic_coo(graph: Graph, r: int, c: int) -> CyclicCOO:
    """The lexsort pass: sort U's edges by (block, local row, local col)."""
    n = graph.n
    rows_loc = -(-n // r)
    cols_loc = -(-n // c)
    i = graph.edges[:, 0]
    j = graph.edges[:, 1]
    bx, by = block_of(i, j, r, c)
    li, lj = local_index(i, j, r, c)

    bid = bx * c + by
    order = np.lexsort((lj, li, bid))
    bid_s, li_s, lj_s = bid[order], li[order], lj[order]
    counts = np.bincount(bid_s, minlength=r * c)
    starts = np.zeros(r * c + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rowcnt = np.bincount(
        bid_s * rows_loc + li_s, minlength=r * c * rows_loc
    ).reshape(r * c, rows_loc)
    return CyclicCOO(
        r=r,
        c=c,
        rows_loc=rows_loc,
        cols_loc=cols_loc,
        bid_s=bid_s,
        li_s=li_s,
        lj_s=lj_s,
        counts=counts,
        starts=starts,
        rowcnt=rowcnt,
    )


def blocks_from_coo(coo: CyclicCOO) -> List[List[BlockCSR]]:
    """Materialize ``BlockCSR`` views of a sorted pass (cheap slicing)."""
    r, c = coo.r, coo.c
    out: List[List[BlockCSR]] = []
    for x in range(r):
        row_blocks = []
        for y in range(c):
            b = x * c + y
            lo, hi = coo.starts[b], coo.starts[b + 1]
            indptr = np.zeros(coo.rows_loc + 1, dtype=np.int64)
            np.cumsum(coo.rowcnt[b], out=indptr[1:])
            row_blocks.append(
                BlockCSR(
                    bx=x,
                    by=y,
                    n_rows=coo.rows_loc,
                    n_cols=coo.cols_loc,
                    indptr=indptr,
                    indices=coo.lj_s[lo:hi].astype(np.int64),
                    active_rows=np.nonzero(coo.rowcnt[b])[0].astype(np.int64),
                )
            )
        out.append(row_blocks)
    return out


def cyclic_blocks(graph: Graph, r: int, c: int) -> List[List[BlockCSR]]:
    """Decompose U(graph) into an ``r x c`` grid of cyclic blocks.

    Assumes the graph is already degree-ordered (the decomposition is valid
    regardless; balance relies on the ordering).  Returns ``blocks[x][y]``.
    """
    return blocks_from_coo(cyclic_coo(graph, r, c))
