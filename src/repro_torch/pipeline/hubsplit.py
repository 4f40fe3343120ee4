"""Hub-split planning stage for heavy-tailed graphs.

On power-law graphs a handful of hub vertices dominate the masked
critical path no matter how rows are permuted (Arifuzzaman et al.,
arXiv:1706.05151): the rebalance stage only shuffles *which*
device holds the hub row, it cannot shrink it.  This stage removes the
hubs from the 2D cyclic path entirely.

Under the degree ordering (non-decreasing, so hubs get the *highest*
ids) the degree-threshold hub set is a contiguous id suffix ``[h0, n)``,
which admits an exact suffix-cut decomposition of the standard
edge-apex triangle sum ``T(G) = Σ_{(i,j)∈U} |U(i) ∩ U(j)|``:

* **residual** — the true induced subgraph on ``[0, h0)`` (every U edge
  with column < h0; rows ≥ h0 are empty by ``i < j``).  Its triangle
  count covers exactly the apexes ``k < h0``, and it flows through the
  normal relabel → rebalance → decompose → pack path with strictly
  smaller ``nnz`` / ``dmax`` / probe work.
* **hub side** — for every original U edge ``(i, j)``, the partial
  ``|H(i) ∩ H(j)|`` with ``H(v) = U(v) ∩ [h0, n)`` (v's neighbors at or
  above the cut).  This covers exactly the apexes ``k ≥ h0``.  Tasks
  where either fragment is empty are pruned.

The hub side is **self-contained in post-relabel ids**: fragments are
only ever intersected against each other, so the rebalance stage's
trial relabelings of the residual and the compaction stage's σ-search
never touch it, and it can never revive an elided schedule step — it
runs *outside* the schedule loop as one extra partial sum folded into
the existing :class:`~repro_torch.core.engine.Reduction`
(:class:`~repro_torch.core.engine.HubCount`).

Replication layout: on an ``(r, c)`` grid the device column ``y`` holds
the column-strided fragment slice ``H_y(v) = {k ∈ H(v) : k % c == y}``
(stored as local ids ``k // c``) and tasks are round-robin over grid
rows, so every device sees ``~tasks/r × nnz_H/c`` work and summing the
per-device partials over the whole grid reconstructs every
``|H(i) ∩ H(j)|`` exactly once.  On a 1D ring the ``p`` devices split
the tasks round-robin and hold full fragments.  With the grid held on one
device the arrays are stacked ``(*grid, ...)`` like the plan's own, and
the engine counts every logical device's slice in turn.  Host numpy only,
the same stage as the JAX package's module of the same name: the same
graph gives the same cut, the same arrays byte for byte and the same
report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.graph import Graph

__all__ = [
    "HubSide",
    "DEFAULT_HUB_C",
    "normalize_hub_split",
    "detect_hub_cut",
    "hubsplit_stage",
]

INT = np.int32

# Degree threshold multiplier: rows with degree > c · (2m/n) (c × the
# average degree) are hubs.  Grid-independent — the same graph splits
# the same way on every grid — and calibrated on the powerlaw fixtures
# (alpha 2.2 / 1.8: ~14 hub rows, ~9-10× masked-critical-path drop).
DEFAULT_HUB_C = 8.0


def normalize_hub_split(hub_split) -> Optional[float]:
    """Canonicalize the knob: False/None → None, True → DEFAULT_HUB_C,
    a number → that threshold multiplier (cache keys stay canonical)."""
    if hub_split is None or hub_split is False:
        return None
    if hub_split is True:
        return DEFAULT_HUB_C
    c = float(hub_split)
    if c < 0:
        raise ValueError(f"hub_split threshold multiplier must be >= 0, got {c}")
    return c


def detect_hub_cut(graph: Graph, c: float) -> int:
    """The suffix cut ``h0``: vertices ``>= h0`` are hubs.

    ``graph`` must be degree-ordered (non-decreasing degrees — the
    relabel stage's output), so ``degree > threshold`` is a suffix and
    one ``searchsorted`` finds it.  Returns ``n`` when nothing crosses
    the threshold (hub side empty, stage is a no-op).
    """
    n = graph.n
    if n == 0 or graph.m == 0:
        return n
    deg = graph.degrees()
    tau = c * (2.0 * graph.m / n)
    return int(np.searchsorted(deg, tau, side="right"))


@dataclasses.dataclass
class HubSide:
    """Device-ready hub-fragment arrays + the cut metadata.

    Arrays are stacked ``(*grid, ...)`` exactly like the plan statics
    (``grid`` is ``(r, c)`` or ``(p,)``); they join
    ``plan.device_arrays()`` under the ``hub_*`` names and are consumed
    by :class:`repro_torch.core.engine.HubCount`.
    """

    h0: int  # suffix cut: vertices >= h0 are hubs
    n: int  # relabeled graph size
    grid: Tuple[int, ...]  # (r, c) or (p,)
    hub_rows: int  # n - h0
    hub_nnz: int  # U entries with column >= h0
    hub_nnz_frac: float  # hub_nnz / m
    hub_tasks: int  # task pairs with both fragments nonempty
    dpad: int  # max fragment length on any device (padded probe len)
    chunk: int
    sentinel: int  # > any stored local id

    hub_indptr: np.ndarray  # (*grid, nref_pad + 1)
    hub_indices: np.ndarray  # (*grid, hnnz_pad)
    hub_ti: np.ndarray  # (*grid, tmax) local task row i
    hub_tj: np.ndarray  # (*grid, tmax) local task row j
    hub_cnt: np.ndarray  # (*grid,) valid task count

    # True while the hub side's internal id space matches the artifact's
    # final id space (set False by the planner when a non-identity
    # rebalance trial relabeled the residual after the split) — the
    # delta path repacks in place only when aligned, else it rebases.
    aligned: bool = True

    names = ("hub_indptr", "hub_indices", "hub_ti", "hub_tj", "hub_cnt")

    def device_arrays(self) -> Dict[str, np.ndarray]:
        return {k: getattr(self, k) for k in self.names}

    def report(self) -> dict:
        return dict(
            h0=self.h0,
            hub_rows=self.hub_rows,
            hub_nnz=self.hub_nnz,
            hub_nnz_frac=self.hub_nnz_frac,
            hub_tasks=self.hub_tasks,
            hub_dpad=self.dpad,
        )


def _build_hub_side(
    edges: np.ndarray, n: int, m: int, h0: int,
    grid: Tuple[int, ...], chunk: int,
) -> Optional[HubSide]:
    """Pack the hub-side arrays for an (r, c) grid or (p,) ring."""
    if len(grid) == 2:
        r, c = int(grid[0]), int(grid[1])
    else:
        r, c = int(grid[0]), 1  # ring: full fragments, tasks over p
    hi = edges[edges[:, 1] >= h0]
    if hi.shape[0] == 0:
        return None
    # high fragments H(v) as one (v, k)-sorted entry list
    order = np.lexsort((hi[:, 1], hi[:, 0]))
    hv, hk = hi[order, 0], hi[order, 1]
    hdeg = np.bincount(hv, minlength=n)
    has = hdeg > 0
    # tasks: every original U edge whose both endpoints keep a fragment
    te = edges[has[edges[:, 0]] & has[edges[:, 1]]]

    ndev_rows = r
    per_x = []  # (ref, lti, ltj) per grid row
    tmax = 1
    nref = 1
    for x in range(ndev_rows):
        tx = te[x::ndev_rows]
        if tx.shape[0] == 0:
            per_x.append((np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0, np.int64)))
            continue
        ref, inv = np.unique(tx.reshape(-1), return_inverse=True)
        inv = inv.reshape(-1)
        per_x.append((ref, inv[0::2], inv[1::2]))
        tmax = max(tmax, tx.shape[0])
        nref = max(nref, ref.shape[0])

    # per-(x, y) strided CSR of the referenced rows' fragments
    frag = {}
    hnnz_pad = 1
    dpad = 1
    for x in range(ndev_rows):
        ref, _, _ = per_x[x]
        if ref.shape[0] == 0:
            continue
        pos = np.searchsorted(ref, hv)
        pos_c = np.minimum(pos, ref.shape[0] - 1)
        in_ref = (pos < ref.shape[0]) & (ref[pos_c] == hv)
        for y in range(c):
            sel = in_ref & ((hk % c) == y) if c > 1 else in_ref
            rows = pos_c[sel]
            vals = (hk[sel] // c).astype(INT) if c > 1 else hk[sel].astype(INT)
            counts = np.bincount(rows, minlength=ref.shape[0])
            indptr = np.zeros(ref.shape[0] + 1, INT)
            np.cumsum(counts, out=indptr[1:], dtype=np.int64)
            frag[(x, y)] = (indptr, vals)
            hnnz_pad = max(hnnz_pad, vals.shape[0])
            if counts.size:
                dpad = max(dpad, int(counts.max()))

    sentinel = n + 1
    shape = (r, c) if len(grid) == 2 else (r,)
    hub_indptr = np.zeros(shape + (nref + 1,), INT)
    hub_indices = np.full(shape + (hnnz_pad,), sentinel, INT)
    hub_ti = np.zeros(shape + (tmax,), INT)
    hub_tj = np.zeros(shape + (tmax,), INT)
    hub_cnt = np.zeros(shape, INT)
    for x in range(ndev_rows):
        ref, lti, ltj = per_x[x]
        for y in range(c):
            dev = (x, y) if len(grid) == 2 else (x,)
            if ref.shape[0] == 0:
                continue
            indptr, vals = frag[(x, y)]
            hub_indptr[dev][: indptr.shape[0]] = indptr
            hub_indptr[dev][indptr.shape[0]:] = indptr[-1]
            hub_indices[dev][: vals.shape[0]] = vals
            hub_ti[dev][: lti.shape[0]] = lti
            hub_tj[dev][: ltj.shape[0]] = ltj
            hub_cnt[dev] = lti.shape[0]

    return HubSide(
        h0=h0,
        n=n,
        grid=tuple(int(g) for g in grid),
        hub_rows=n - h0,
        hub_nnz=int(hi.shape[0]),
        hub_nnz_frac=float(hi.shape[0]) / max(1, m),
        hub_tasks=int(te.shape[0]),
        dpad=dpad,
        chunk=int(min(chunk, max(64, -(-tmax // 64) * 64))),
        sentinel=sentinel,
        hub_indptr=hub_indptr,
        hub_indices=hub_indices,
        hub_ti=hub_ti,
        hub_tj=hub_tj,
        hub_cnt=hub_cnt,
    )


def hubsplit_stage(
    graph: Graph,
    grid: Tuple[int, ...],
    *,
    c: float = DEFAULT_HUB_C,
    chunk: int = 512,
    h0: Optional[int] = None,
) -> Tuple[Graph, Optional[HubSide]]:
    """Split ``graph`` (degree-ordered) at the hub cut.

    Returns ``(residual, hub_side)``: the residual is the induced
    subgraph on ``[0, h0)`` (handed to rebalance → pack unchanged), the
    hub side carries the replicated fragment arrays (``None`` when no
    row crosses the threshold — the stage is then a no-op).  ``h0``
    overrides detection (the delta repack path reuses the parent cut so
    stage-local repacks stay deterministic).
    """
    if h0 is None:
        h0 = detect_hub_cut(graph, c)
    h0 = int(h0)
    if h0 >= graph.n or graph.m == 0:
        return graph, None
    hub = _build_hub_side(graph.edges, graph.n, graph.m, h0, grid, chunk)
    if hub is None:
        return graph, None
    residual = Graph(
        n=graph.n,
        edges=graph.edges[graph.edges[:, 1] < h0],
        name=graph.name + f"+hub{h0}",
    )
    return residual, hub
