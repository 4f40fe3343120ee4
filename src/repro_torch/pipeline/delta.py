"""Delta-aware planning: incremental re-plans over edge deltas.

The cold pipeline is content-addressed — *any* edge edit changes the
graph digest and forces ingest → relabel → decompose → pack → stage from
scratch.  Streaming workloads (Tangwongsan, Pavan & Tirthapura,
arXiv:1308.2166) mutate one graph continuously, so this module gives
every pipeline stage an incremental contract:

* :class:`EdgeDelta` — a batched, canonicalized add/remove edge list
  with its own content digest;
* :func:`apply_delta` — ``PlanArtifact × EdgeDelta → PlanArtifact``,
  choosing the cheapest correct level per delta:

  - **splice** (Cannon): diff block membership under the existing
    cyclic decomposition to find the *dirty* canonical blocks, re-sort
    only their edges, splice the re-packed rows into copies of the
    plan's CSR/task/key arrays via the inverse σ placement, recompute
    probe stats and ``step_keep`` only for dirty (device, shift) cells,
    and reuse the compacted live-step schedule (plus the parent's
    engine fns, rebound to the spliced plan's host arrays) when the
    live-step set did not grow;
  - **repack** (fallback): stage-local re-pack of the mutated graph
    with the parent's relabeling permutation and σ kept verbatim —
    taken when too many blocks are dirty for splicing to pay, or the
    plan kind has no splice path (SUMMA / 1D, hub-split plans);
  - **rebase** (periodic): a cold re-plan through the planners every
    ``rebase_every`` deltas, restoring the degree ordering and padding
    tightness that drift under repeated splices; the returned artifact
    composes the relabeling permutations so callers keep addressing
    vertices by their original ids.

Cache lineage: delta-derived artifacts are cached under
``(kind, "delta", root digest, (δ₁, …, δₖ)) + config tail`` — the base
digest plus the chain of delta digests — so replaying the same stream
hits; a rebase starts a fresh chain at the new root digest.

Host numpy only, the same ladder as the JAX package's module of the same
name: the same artifact and delta give the same level, the same plan
arrays byte for byte, the same report and the same lineage key.  Two
things differ because the port's engine fns and staged tensors differ:

* an engine fn built by ``build_*_fn`` holds the plan's *host* task
  counts and skip mask (the loop reads them on the host), so a parent's
  fn is never handed to a derived artifact as it is: it is rebound
  (``fn.rebind``) onto the derived plan's ``m_cnt`` / ``step_keep``,
  sharing the parent's store, kernel and schedule;
* staged tensors are memoized per device, so the re-stage handoff
  carries the parent's staged tensors of every device it was staged on.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional, Tuple

import numpy as np

from ..core.decomp import BlockCSR
from ..core.graph import Graph
from ..core.plan import (
    INT,
    PlanStats,
    bucketize_plan,
    compact_live_steps,
    host_aug_keys,
)
from ..runtime import faultinject
from .artifact import PlanArtifact
from .cache import PlanCache, default_cache
from .hubsplit import hubsplit_stage
from .stages import (
    autotune_oned_plan,
    autotune_summa_plan,
    autotune_tc_plan,
    cannon_step_keep,
    compact_stage,
    pack_oned_plan,
    pack_summa_plan,
    pack_tc_plan,
)

__all__ = ["EdgeDelta", "apply_delta"]


def _canon_pairs(pairs) -> np.ndarray:
    """Canonicalize an edge list to deduplicated, sorted ``(min, max)``
    rows: the same normal form :meth:`Graph.from_edges` uses, so delta
    digests and set arithmetic are order-insensitive."""
    arr = np.asarray(
        pairs if pairs is not None else np.zeros((0, 2)), dtype=np.int64
    ).reshape(-1, 2)
    keep = arr[:, 0] != arr[:, 1]
    arr = arr[keep]
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    order = np.lexsort((hi, lo))
    lo, hi = lo[order], hi[order]
    if lo.size:
        first = np.ones(lo.size, dtype=bool)
        first[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        lo, hi = lo[first], hi[first]
    return np.stack([lo, hi], axis=1)


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """A batched edge delta: edges to add and edges to remove.

    Both lists are canonicalized (``(min, max)``, deduplicated, self
    loops dropped) at construction; an edge appearing in both lists is
    an error — the delta would be order-dependent.  Vertex ids are in
    the *original* (pre-relabel) id space of the graph the stream is
    mutating; :func:`apply_delta` maps them through the artifact's
    composed permutation.
    """

    add: np.ndarray  # (ka, 2) int64, canonical
    remove: np.ndarray  # (kr, 2) int64, canonical

    def __init__(self, add=None, remove=None):
        a = _canon_pairs(add)
        r = _canon_pairs(remove)
        if a.shape[0] and r.shape[0]:
            span = np.int64(max(a.max(initial=0), r.max(initial=0))) + 1
            both = np.intersect1d(
                a[:, 0] * span + a[:, 1], r[:, 0] * span + r[:, 1]
            )
            if both.size:
                raise ValueError(
                    f"{both.size} edge(s) appear in both add and remove"
                )
        object.__setattr__(self, "add", a)
        object.__setattr__(self, "remove", r)

    # ------------------------------------------------------------------
    @property
    def k(self) -> int:
        """Total number of edge edits in the batch."""
        return int(self.add.shape[0] + self.remove.shape[0])

    def digest(self) -> str:
        """Content digest of the delta (joins the cache lineage key)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(np.ascontiguousarray(self.add).tobytes())
        h.update(b"|")
        h.update(np.ascontiguousarray(self.remove).tobytes())
        return h.hexdigest()

    def relabeled(self, perm: Optional[np.ndarray]) -> "EdgeDelta":
        """The same delta with vertices renamed by ``perm`` (old → new)."""
        if perm is None:
            return self
        perm = np.asarray(perm, dtype=np.int64)
        return EdgeDelta(add=perm[self.add], remove=perm[self.remove])

    def apply_to(self, graph: Graph) -> Graph:
        """Host-side reference application: ``G ± Δ`` as a new graph."""
        g2, _, _ = _merge(graph, self)
        return g2

    @staticmethod
    def random_flips(graph: Graph, k: int, seed: int) -> "EdgeDelta":
        """Deterministic delta of ``k`` random edge flips: a sampled pair
        already present becomes a removal, an absent one an addition
        (the ``delta:`` graph spec's mutation model)."""
        from ..core.generators import random_edge_flips

        add, remove = random_edge_flips(graph, k, seed)
        return EdgeDelta(add=add, remove=remove)


def _edge_keys(edges: np.ndarray, n: int) -> np.ndarray:
    return edges[:, 0] * np.int64(n) + edges[:, 1]


def _merge(graph: Graph, delta: EdgeDelta):
    """Apply ``delta`` to ``graph``: returns the merged graph plus the
    *effective* additions / removals (adds already present and removes
    already absent are dropped — the merge is idempotent)."""
    n = graph.n
    for arr, what in ((delta.add, "add"), (delta.remove, "remove")):
        if arr.size and (arr.min() < 0 or arr.max() >= n):
            raise ValueError(
                f"delta {what} list references vertices outside 0..{n - 1}"
            )
    base = _edge_keys(graph.edges, n)
    if base.size and not np.all(base[1:] > base[:-1]):
        order = np.argsort(base)
        base = base[order]
    add_k = _edge_keys(delta.add, n)
    rem_k = _edge_keys(delta.remove, n)

    def member(keys):
        if base.size == 0:
            return np.zeros(keys.shape, dtype=bool)
        pos = np.searchsorted(base, keys)
        return (pos < base.size) & (
            base[np.minimum(pos, base.size - 1)] == keys
        )

    eff_add = add_k[~member(add_k)]
    eff_rem = rem_k[member(rem_k)]

    kept = base
    if eff_rem.size:
        kept = base[~np.isin(base, eff_rem, assume_unique=True)]
    merged = kept
    if eff_add.size:
        merged = np.insert(kept, np.searchsorted(kept, eff_add), eff_add)
    edges = np.stack([merged // n, merged % n], axis=1)
    g2 = Graph(n=n, edges=edges, name=graph.name + "+d")

    def unkey(k):
        return np.stack([k // n, k % n], axis=1)

    return g2, unkey(eff_add), unkey(eff_rem)


# ======================================================================
# apply_delta: the incremental re-plan ladder
# ======================================================================
def apply_delta(
    artifact: PlanArtifact,
    delta: EdgeDelta,
    *,
    cache: Optional[PlanCache] = None,
    rebase_every: int = 8,
    dirty_limit: float = 0.5,
) -> PlanArtifact:
    """Re-plan ``artifact`` for ``graph ± delta`` incrementally.

    Returns a new :class:`PlanArtifact` whose ``delta_report`` records
    the chosen level (``"splice"`` / ``"repack"`` / ``"rebase"`` /
    ``"noop"``), the dirty block/cell fractions, which stages were
    re-run, and whether the parent's engine fns were inherited
    (``fn_inherited``: rebound to the new plan's host arrays, not
    rebuilt).  The result is cached under the delta lineage key (base
    digest + delta digest chain), so replaying a stream hits the cache.

    ``rebase_every`` bounds the lineage depth: after that many
    incremental applications the next delta triggers a cold re-plan
    (rebase) restoring degree ordering and padding tightness.
    ``dirty_limit`` is the dirty-block fraction above which splicing
    falls back to the stage-local repack.
    """
    if artifact.config is None:
        raise ValueError(
            "artifact carries no planner config (built by a pre-delta "
            "code path); re-plan through plan_cannon/plan_summa/plan_oned"
        )
    cache = cache if cache is not None else default_cache()
    cfg = artifact.config
    lineage = artifact.lineage or dict(
        root_digest=artifact.digest, chain=(), depth=0
    )
    chain = tuple(lineage["chain"]) + (delta.digest(),)
    # config tail of the cache key: cold keys are (kind, digest) + tail,
    # lineage keys (kind, "delta", root, chain) + tail
    tail = tuple(
        artifact.key[4:] if artifact.lineage is not None
        else artifact.key[2:]
    )
    key = (artifact.kind, "delta", lineage["root_digest"], chain) + tail
    hit = cache.get(key)
    if hit is not None:
        hit.cache_hit = True
        return hit

    t0 = time.perf_counter()
    d2 = delta.relabeled(artifact.perm)
    g2, eff_add, eff_rem = _merge(artifact.graph, d2)
    eff = np.concatenate([eff_add, eff_rem], axis=0)

    if eff.shape[0] == 0:
        art = dataclasses.replace(
            artifact,
            key=key,
            cache_hit=False,
            lineage=dict(lineage, chain=chain),
            delta_report=_report(
                "noop", 0, 0.0, None, None, [], False, lineage["depth"],
                eff_add, eff_rem, True,
            ),
        )
        cache.put(key, art)
        return art

    depth = int(lineage["depth"]) + 1
    hub_side = getattr(artifact.plan, "hub", None)
    if depth > int(rebase_every):
        art = _rebase(artifact, g2, cfg, cache, key, eff, eff_add, eff_rem)
    elif hub_side is not None and not getattr(hub_side, "aligned", True):
        # the rebalance stage relabeled the residual *after* the split,
        # so the hub side's internal ids no longer match the artifact's
        # id space and the parent cut cannot be reused positionally —
        # rebase (cold re-plan, fresh cut) and say so in the report
        art = _rebase(artifact, g2, cfg, cache, key, eff, eff_add, eff_rem)
        art.delta_report["reason"] = "hub_split_misaligned"
    else:
        art = None
        splice_refused = None
        if artifact.kind == "cannon" and cfg.get("skew", True):
            if hub_side is not None:
                # the splice edits packed residual blocks in place; a
                # delta edge landing on a split hub row would silently
                # corrupt the residual/hub partition (the hub arrays
                # have no splice path) — refuse loudly, repack instead
                splice_refused = "hub_split"
            else:
                faultinject.fire("delta_splice")
                art = _splice_cannon(
                    artifact, g2, eff, eff_add, eff_rem, depth, chain,
                    dirty_limit, lineage,
                )
        if art is None:
            art = _repack(
                artifact, g2, cfg, eff, eff_add, eff_rem, depth, chain,
                lineage,
            )
            if splice_refused is not None:
                art.delta_report["reason"] = splice_refused
    art.key = key
    art.stage_seconds["apply_delta"] = time.perf_counter() - t0
    cache.put(key, art)
    return art


def _report(
    level, dirty_blocks, dirty_block_frac, dirty_cells, dirty_cell_frac,
    replanned, rebased, depth, eff_add, eff_rem, fn_inherited,
):
    return dict(
        level=level,
        dirty_blocks=int(dirty_blocks),
        dirty_block_fraction=float(dirty_block_frac),
        dirty_cells=None if dirty_cells is None else int(dirty_cells),
        dirty_cell_fraction=(
            None if dirty_cell_frac is None else float(dirty_cell_frac)
        ),
        replanned_stages=list(replanned),
        rebased=bool(rebased),
        depth=int(depth),
        edges_added=int(eff_add.shape[0]),
        edges_removed=int(eff_rem.shape[0]),
        fn_inherited=bool(fn_inherited),
    )


def _dirty_grid(eff: np.ndarray, r: int, c: int) -> np.ndarray:
    dirty = np.zeros((r, c), dtype=bool)
    dirty[eff[:, 0] % r, eff[:, 1] % c] = True
    return dirty


def _lineage_digest(root: str, chain: Tuple[str, ...]) -> str:
    return f"{root}+{len(chain)}d:{chain[-1][:8]}" if chain else root


def _derived_artifact(artifact, g2, plan2, depth, chain, lineage, report,
                      inherit_fns):
    """Assemble the delta-derived artifact: fresh memo space seeded with
    the parent's engine fns — rebound to ``plan2``'s host arrays — when
    the engine statics survived, plus the re-stage handoff (the parent's
    host arrays and its staged tensors of every device) so clean device
    buffers skip the re-upload."""
    art = PlanArtifact(
        kind=artifact.kind,
        digest=_lineage_digest(lineage["root_digest"], chain),
        key=artifact.key,  # overwritten by apply_delta with the lineage key
        graph=g2,
        perm=artifact.perm,
        plan=plan2,
        rebalance=artifact.rebalance,
        config=artifact.config,
        lineage=dict(
            root_digest=lineage["root_digest"], chain=chain, depth=depth
        ),
        delta_report=report,
    )
    with artifact._memo_lock:
        fns = {
            k: v for k, v in artifact._memo.items()
            if isinstance(k, tuple) and k and k[0] == "fn"
        } if inherit_fns else {}
        staged = {
            k[1]: v for k, v in artifact._memo.items()
            if isinstance(k, tuple) and len(k) == 2
            and k[0] == "staged_arrays"
        }
    # only a Cannon splice inherits, and hub plans refuse the splice: the
    # rebound fn reads plan2's task counts and skip mask, and no hub side
    art._memo.update({
        k: fn.rebind(m_cnt=plan2.m_cnt, step_keep=plan2.step_keep)
        for k, fn in fns.items()
    })
    if staged:
        art.restage_from = (artifact.plan.device_arrays(), staged)
    return art


# ----------------------------------------------------------------------
# level 0: Cannon block splice
# ----------------------------------------------------------------------
def _splice_cannon(
    artifact, g2, eff, eff_add, eff_rem, depth, chain, dirty_limit, lineage
):
    """Splice re-packed dirty blocks into copies of the plan's arrays.

    Placement inversion: under the σ-skewed placement ``a[x, y] =
    c[x, σ[(x+y)%q]]`` / ``b[x, y] = c[y, σ[(x+y)%q]]``, the canonical
    block ``(bx, bz)`` appears exactly once in each operand — at
    ``a[bx, (σ⁻¹[bz]-bx)%q]`` and ``b[(σ⁻¹[bz]-bx)%q, bx]`` — and the
    task/mask arrays sit at ``(bx, bz)`` directly.  Every array written
    is a copy: the parent's staged tensors may alias its host arrays
    (a CPU tensor shares the numpy array's memory).  Returns ``None``
    when too many blocks are dirty (the caller falls back to the
    stage-local repack).  The JAX package also falls back when its keys
    would need int64 with 64-bit types off; the port's keys widen to
    int64 instead, as its packer's do.
    """
    plan = artifact.plan
    q, nb, nnz_pad, tmax = plan.q, plan.nb, plan.nnz_pad, plan.tmax
    sp = (
        np.asarray(plan.skew_perm, dtype=np.int64)
        if plan.skew_perm is not None
        else np.arange(q, dtype=np.int64)
    )
    inv = np.argsort(sp)

    dirty = _dirty_grid(eff, q, q)
    n_dirty = int(dirty.sum())
    if n_dirty > dirty_limit * q * q:
        return None
    dirty_bids = np.flatnonzero(dirty.ravel())
    nd = dirty_bids.size

    # --- re-sort only the dirty blocks' edges (the decompose stage,
    # restricted): one lexsort over the touched fraction of the graph
    i, j = g2.edges[:, 0], g2.edges[:, 1]
    bid = (i % q) * q + (j % q)
    sel = dirty.ravel()[bid]
    pos = np.searchsorted(dirty_bids, bid[sel])  # dense dirty-block index
    li, lj = i[sel] // q, j[sel] // q
    order = np.lexsort((lj, li, pos))
    pos_s, li_s, lj_s = pos[order], li[order], lj[order]

    counts_d = np.bincount(pos_s, minlength=nd)
    rowcnt_d = np.bincount(
        pos_s * nb + li_s, minlength=nd * nb
    ).reshape(nd, nb)

    # exact padded dims of a cold pack of g2: max nnz over *all* blocks
    # (clean blocks keep their counts) — growing deltas widen the
    # arrays, shrinking ones narrow them, so the splice output stays
    # byte-identical to a cold re-pack under the same σ
    counts2_all = plan.m_cnt.astype(np.int64).copy()
    counts2_all[dirty_bids // q, dirty_bids % q] = counts_d
    nnz_pad2 = max(1, int(counts2_all.max()))
    tmax2 = nnz_pad2

    starts_d = np.zeros(nd + 1, dtype=np.int64)
    np.cumsum(counts_d, out=starts_d[1:])
    offs = np.arange(pos_s.size, dtype=np.int64) - starts_d[pos_s]

    new_ptr = np.zeros((nd, nb + 1), dtype=INT)
    np.cumsum(rowcnt_d, axis=1, out=new_ptr[:, 1:])
    new_idx = np.full((nd, nnz_pad2), nb, dtype=INT)  # cols_loc sentinel
    new_idx[pos_s, offs] = lj_s
    new_ti = np.zeros((nd, tmax2), dtype=INT)
    new_tj = np.zeros((nd, tmax2), dtype=INT)
    new_ti[pos_s, offs] = li_s
    new_tj[pos_s, offs] = lj_s

    # --- splice into copies of the plan's arrays (pack stage, dirty rows)
    bx = dirty_bids // q
    bz = dirty_bids % q
    ya = (inv[bz] - bx) % q  # a column / b row holding canonical (bx, bz)

    a_ptr = plan.a_indptr.copy()
    b_ptr = plan.b_indptr.copy()
    if nnz_pad2 == nnz_pad:
        a_idx = plan.a_indices.copy()
        b_idx = plan.b_indices.copy()
        m_ti = plan.m_ti.copy()
        m_tj = plan.m_tj.copy()
    else:
        # resize the padded axis; the copied prefix is exact because
        # every clean block's payload fits in the new max by definition,
        # and the tails are sentinel (indices) / zero (tasks) both ways
        w = min(nnz_pad, nnz_pad2)
        a_idx = np.full((q, q, nnz_pad2), nb, dtype=INT)
        a_idx[:, :, :w] = plan.a_indices[:, :, :w]
        b_idx = np.full((q, q, nnz_pad2), nb, dtype=INT)
        b_idx[:, :, :w] = plan.b_indices[:, :, :w]
        m_ti = np.zeros((q, q, tmax2), dtype=INT)
        m_ti[:, :, :w] = plan.m_ti[:, :, :w]
        m_tj = np.zeros((q, q, tmax2), dtype=INT)
        m_tj[:, :, :w] = plan.m_tj[:, :, :w]
    a_ptr[bx, ya] = new_ptr
    a_idx[bx, ya] = new_idx
    b_ptr[ya, bx] = new_ptr
    b_idx[ya, bx] = new_idx
    m_cnt = plan.m_cnt.copy()
    m_ti[bx, bz] = new_ti
    m_tj[bx, bz] = new_tj
    m_cnt[bx, bz] = counts_d.astype(INT)

    # keys: int32 up to base 46,340, int64 past it — the base nb + 1
    # never changes on a delta, so neither does the key dtype
    b_aug = plan.b_aug
    if b_aug is not None:
        if nnz_pad2 == nnz_pad:
            b_aug = b_aug.copy()
            b_aug[ya, bx] = host_aug_keys(new_ptr, new_idx).astype(
                b_aug.dtype
            )
        else:  # padded width changed: rebuild keys over the new layout
            b_aug = host_aug_keys(
                b_ptr.reshape(q * q, nb + 1), b_idx.reshape(q * q, -1)
            ).reshape(q, q, nnz_pad2).astype(b_aug.dtype)

    blocks2 = plan.blocks
    if blocks2 is not None:
        blocks2 = [list(row) for row in blocks2]
        for t in range(nd):
            x_, z_ = int(bx[t]), int(bz[t])
            indptr64 = np.zeros(nb + 1, dtype=np.int64)
            np.cumsum(rowcnt_d[t], out=indptr64[1:])
            blocks2[x_][z_] = BlockCSR(
                bx=x_,
                by=z_,
                n_rows=nb,
                n_cols=nb,
                indptr=indptr64,
                indices=lj_s[starts_d[t]:starts_d[t + 1]].astype(np.int64),
                active_rows=np.nonzero(rowcnt_d[t])[0].astype(np.int64),
            )

    replanned = ["decompose:dirty", "pack:splice"]

    # --- fragment lengths for every (block row, panel), reconstructed
    # from the spliced placement: a[x, y] holds canonical (x, σ[(x+y)%q])
    lens = np.diff(a_ptr.astype(np.int64), axis=2)  # (q, q, nb)
    xg = np.broadcast_to(np.arange(q)[:, None], (q, q))
    zg = sp[(np.arange(q)[:, None] + np.arange(q)[None, :]) % q]
    rowcnt3 = np.zeros((q, q, nb), dtype=np.int64)
    rowcnt3[xg, zg] = lens
    counts2 = m_cnt.astype(np.int64)  # (q, q) nnz per canonical block
    dmax2 = max(1, int(rowcnt3.max()))  # kernels' dpad, like a cold pack

    # --- stats: recompute probe / itasks only at dirty (device, shift)
    # cells — the dominant cold-planning loop, cut to the dirty fraction
    dirty_cells = None
    dirty_cell_frac = None
    stats2 = plan.stats
    probe2 = None
    if stats2 is not None:
        x3 = np.arange(q)[:, None, None]
        y3 = np.arange(q)[None, :, None]
        s3 = np.arange(q)[None, None, :]
        z3 = sp[(x3 + y3 + s3) % q]
        dirty_cell = dirty[:, :, None] | dirty[x3, z3] | dirty[y3, z3]
        dirty_cells = int(dirty_cell.sum())
        dirty_cell_frac = dirty_cells / float(q * q * q)

        probe2 = stats2.probe_work_per_device_shift.copy()
        it_cell = stats2.itasks_per_cell
        it_cell2 = it_cell.copy() if it_cell is not None else None
        for x, y in zip(*np.nonzero(dirty_cell.any(axis=2))):
            cnt = int(m_cnt[x, y])
            rows = m_ti[x, y, :cnt]
            cols = m_tj[x, y, :cnt]
            for s in np.flatnonzero(dirty_cell[x, y]):
                z = int(sp[(x + y + int(s)) % q])
                la = rowcnt3[x, z][rows]
                lb = rowcnt3[y, z][cols]
                both = (la > 0) & (lb > 0)
                probe2[x, y, s] = int(np.minimum(la, lb)[both].sum())
                if it_cell2 is not None:
                    it_cell2[x, y, s] = int(both.sum())
        tot_idx = q * q * nnz_pad2
        stats2 = PlanStats(
            tasks_per_device=counts2,
            nnz_per_block=counts2.copy(),
            probe_work_per_device_shift=probe2,
            task_imbalance=float(
                counts2.max() / max(1.0, counts2.mean())
            ),
            probe_imbalance=float(
                probe2.sum(axis=2).max()
                / max(1.0, probe2.sum(axis=2).mean())
            ),
            intersection_tasks_total=(
                int(it_cell2.sum())
                if it_cell2 is not None
                else stats2.intersection_tasks_total
            ),
            padding_fraction_indices=float(1.0 - g2.m / max(1, tot_idx)),
            padding_fraction_tasks=float(1.0 - g2.m / max(1, q * q * tmax2)),
            itasks_per_cell=it_cell2,
        )
        replanned.append("stats:dirty-cells")

    # --- step masks: full vectorized recompute (cheap), same inputs a
    # cold pack would use under this σ and stats configuration
    keep2 = plan.step_keep
    if keep2 is not None:
        keep2 = cannon_step_keep(
            counts2, m_cnt, probe2,
            skew_perm=sp if plan.skew_perm is not None else None,
        )
        replanned.append("masks")

    # --- compaction: σ is never re-searched on a delta; the schedule
    # (and the engine fns built around its live list) is reused verbatim
    # when the live-step set did not grow
    compact2 = plan.compact
    live_grew = False
    if compact2 is not None and keep2 is not None:
        new_cs = compact_live_steps(keep2)
        if set(new_cs.live_steps) <= set(compact2.live_steps):
            pass  # superset of the true live set stays correct
        else:
            compact2 = new_cs
            live_grew = True
            replanned.append("compact:live-steps")

    cfg = artifact.config
    plan2 = dataclasses.replace(
        plan,
        m=g2.m,
        nnz_pad=nnz_pad2,
        tmax=tmax2,
        dmax=dmax2,
        chunk=min(int(cfg.get("chunk") or plan.chunk), tmax2),
        a_indptr=a_ptr,
        a_indices=a_idx,
        b_indptr=b_ptr,
        b_indices=b_idx,
        m_ti=m_ti,
        m_tj=m_tj,
        m_cnt=m_cnt,
        stats=stats2,
        blocks=blocks2,
        step_keep=keep2,
        b_aug=b_aug,
        compact=compact2,
    )

    if cfg.get("bucketize"):
        plan2 = bucketize_plan(plan2, d_small=cfg.get("d_small") or 32)
        replanned.append("bucketize")
    if cfg.get("autotune"):
        plan2 = autotune_tc_plan(
            plan2, two_sided=(cfg["autotune"] == "fused")
        )
        replanned.append("autotune")

    # the engine statics a fn is built around: everything else it reads
    # (task counts, skip mask) is rebound onto plan2's host arrays
    statics_changed = (
        live_grew
        or plan2.chunk != plan.chunk
        or plan2.dmax != plan.dmax
        or plan2.n_long != plan.n_long
        or plan2.d_small != plan.d_small
    )
    report = _report(
        "splice", n_dirty, n_dirty / float(q * q), dirty_cells,
        dirty_cell_frac, replanned, False, depth, eff_add, eff_rem,
        not statics_changed,
    )
    return _derived_artifact(
        artifact, g2, plan2, depth, chain, lineage, report,
        inherit_fns=not statics_changed,
    )


# ----------------------------------------------------------------------
# level 1: stage-local repack (relabel + σ + lineage kept, pack re-run)
# ----------------------------------------------------------------------
def _repack(artifact, g2, cfg, eff, eff_add, eff_rem, depth, chain, lineage):
    """Re-run decompose+pack (and the downstream stages) on the mutated
    graph, skipping ingest (no digest) and relabel (parent permutation
    kept) and never re-searching σ — the stage-local fallback when the
    splice does not apply."""
    kind = artifact.kind
    plan = artifact.plan
    replanned = ["decompose+pack"]
    hub_side = getattr(plan, "hub", None)
    g_pack = g2
    hub2 = None
    if hub_side is not None:
        # re-split the merged graph at the *parent* cut (positional — a
        # suffix cut is exact for any h0, so no re-detection drift) and
        # pack the new residual; the ladder routed misaligned hub sides
        # to _rebase, so the parent id space is the artifact's own
        grid = (
            (cfg["q"], cfg["q"]) if kind == "cannon"
            else (cfg["r"], cfg["c"]) if kind == "summa"
            else (cfg["p"],)
        )
        g_pack, hub2 = hubsplit_stage(
            g2, grid, chunk=cfg["chunk"], h0=hub_side.h0
        )
        replanned.insert(0, "hubsplit")
    if kind == "cannon":
        dirty = _dirty_grid(eff, cfg["q"], cfg["q"])
        sp = plan.skew_perm
        plan2 = pack_tc_plan(
            g_pack,
            cfg["q"],
            skew=cfg["skew"],
            chunk=cfg["chunk"],
            with_stats=cfg["with_stats"],
            keep_blocks=cfg["keep_blocks"] or cfg["bucketize"],
            step_masks=cfg["step_masks"],
            skew_perm=sp if cfg["skew"] else None,
            aug_keys=cfg["aug_keys"],
        )
        if cfg["compact"] and cfg["skew"]:
            plan2 = compact_stage(plan2)  # live list under the kept σ
            replanned.append("compact")
        if cfg["bucketize"]:
            plan2 = bucketize_plan(plan2, d_small=cfg["d_small"])
            replanned.append("bucketize")
        if cfg["autotune"]:
            plan2 = autotune_tc_plan(
                plan2, two_sided=(cfg["autotune"] == "fused")
            )
            replanned.append("autotune")
    elif kind == "summa":
        dirty = _dirty_grid(eff, cfg["r"], cfg["c"])
        plan2 = pack_summa_plan(
            g_pack, cfg["r"], cfg["c"], chunk=cfg["chunk"],
            step_masks=cfg["step_masks"],
            with_stats=bool(cfg["rebalance_trials"]),
        )
        if cfg["compact"]:
            plan2 = compact_stage(plan2)
            replanned.append("compact")
        if cfg["autotune"]:
            plan2 = autotune_summa_plan(
                plan2, two_sided=(cfg["autotune"] == "fused")
            )
            replanned.append("autotune")
        plan2.broadcast = cfg["broadcast"]
    elif kind == "oned":
        dirty = _dirty_grid(eff, cfg["p"], cfg["p"])
        plan2 = pack_oned_plan(
            g_pack, cfg["p"], chunk=cfg["chunk"],
            step_masks=cfg["step_masks"],
            with_stats=bool(cfg["rebalance_trials"]),
        )
        if cfg["compact"]:
            plan2 = compact_stage(plan2)
            replanned.append("compact")
        if cfg["autotune"]:
            plan2 = autotune_oned_plan(
                plan2, two_sided=(cfg["autotune"] == "fused")
            )
            replanned.append("autotune")
    else:
        raise ValueError(f"unknown plan kind {kind!r}")
    if hub_side is not None:
        plan2.hub = hub2  # may be None: the delta drained the hub side

    report = _report(
        "repack", int(dirty.sum()), float(dirty.mean()), None, None,
        replanned, False, depth, eff_add, eff_rem, False,
    )
    return _derived_artifact(
        artifact, g2, plan2, depth, chain, lineage, report,
        inherit_fns=False,
    )


# ----------------------------------------------------------------------
# level 2: periodic rebase (cold re-plan, composed permutation)
# ----------------------------------------------------------------------
def _rebase(artifact, g2, cfg, cache, key, eff, eff_add, eff_rem):
    """Cold re-plan of the mutated graph through the planner — restores
    the degree ordering, σ search, padding tightness, and rebalance;
    starts a fresh lineage chain at the new root digest.  The relabeling
    permutations are composed so the returned artifact still maps
    *original* vertex ids."""
    from .planner import plan_cannon, plan_oned, plan_summa

    kind = artifact.kind
    if kind == "cannon":
        dirty = _dirty_grid(eff, cfg["q"], cfg["q"])
        art2 = plan_cannon(
            g2, cfg["q"], skew=cfg["skew"], chunk=cfg["chunk"],
            reorder=cfg["reorder"], cyclic_p=cfg["cyclic_p"],
            with_stats=cfg["with_stats"], keep_blocks=cfg["keep_blocks"],
            bucketize=cfg["bucketize"], d_small=cfg["d_small"],
            step_masks=cfg["step_masks"],
            rebalance_trials=cfg["rebalance_trials"],
            compact=cfg["compact"], autotune=cfg["autotune"],
            aug_keys=cfg["aug_keys"],
            hub_split=cfg.get("hub_split", False), cache=cache,
        )
    elif kind == "summa":
        dirty = _dirty_grid(eff, cfg["r"], cfg["c"])
        art2 = plan_summa(
            g2, cfg["r"], cfg["c"], chunk=cfg["chunk"],
            reorder=cfg["reorder"], cyclic_p=cfg["cyclic_p"],
            step_masks=cfg["step_masks"],
            rebalance_trials=cfg["rebalance_trials"],
            compact=cfg["compact"], autotune=cfg["autotune"],
            broadcast=cfg["broadcast"],
            hub_split=cfg.get("hub_split", False), cache=cache,
        )
    elif kind == "oned":
        dirty = _dirty_grid(eff, cfg["p"], cfg["p"])
        art2 = plan_oned(
            g2, cfg["p"], chunk=cfg["chunk"], reorder=cfg["reorder"],
            cyclic_p=cfg["cyclic_p"], step_masks=cfg["step_masks"],
            rebalance_trials=cfg["rebalance_trials"],
            compact=cfg["compact"], autotune=cfg["autotune"],
            hub_split=cfg.get("hub_split", False), cache=cache,
        )
    else:
        raise ValueError(f"unknown plan kind {kind!r}")

    if artifact.perm is None:
        perm = art2.perm
    elif art2.perm is None:
        perm = artifact.perm
    else:
        perm = art2.perm[artifact.perm]
    report = _report(
        "rebase", int(dirty.sum()), float(dirty.mean()), None, None,
        ["ingest", "relabel", "decompose+pack", "compact", "autotune"],
        True, 0, eff_add, eff_rem, False,
    )
    return dataclasses.replace(
        art2,
        key=key,
        perm=perm,
        cache_hit=False,
        lineage=dict(root_digest=art2.digest, chain=(), depth=0),
        delta_report=report,
    )
