"""Composable host-planning stages.

The pipeline is  **ingest → relabel → decompose → pack → stage**:

* *ingest*    — content-digest the input graph (:mod:`.cache`);
* *relabel*   — optional cyclic redistribution (paper §5.3 step 1) then
  degree ordering (step 2), composed into one permutation;
* *decompose* — the single lexsort pass over the 2D-cyclic decomposition
  (:func:`repro_torch.core.decomp.cyclic_coo`);
* *pack*      — emit the stacked, padded arrays **directly** from the
  sorted pass (this module): one cumsum for every indptr, one scatter
  for every index/task array — no per-block Python loops;
* *stage*     — host→device conversion, memoized on the artifact
  (:meth:`repro_torch.pipeline.artifact.PlanArtifact.staged`).

Everything here is host numpy and emits, byte for byte, what the JAX
package's module of the same name emits for the same graph and flags —
the Cannon, SUMMA and 1D-ring packers and their autotune stages.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from ..core.decomp import CyclicCOO, blocks_from_coo, cyclic_coo
from ..core.graph import Graph
from ..core.onedim import OneDPlan
from ..core.plan import (
    INT,
    PlanStats,
    StepStats,
    TCPlan,
    compact_live_steps,
    host_aug_keys,
)
from ..core.preprocess import cyclic_relabel, degree_order
from ..core.summa import SummaPlan

__all__ = [
    "relabel_stage",
    "emit_block_arrays",
    "cannon_step_keep",
    "summa_probe_work",
    "oned_probe_work",
    "pack_tc_plan",
    "pack_summa_plan",
    "pack_oned_plan",
    "choose_cannon_skew",
    "compact_stage",
    "autotune_tc_plan",
    "autotune_summa_plan",
    "autotune_oned_plan",
    "timed",
]


# ======================================================================
# relabel
# ======================================================================
def relabel_stage(
    graph: Graph,
    *,
    reorder: bool = True,
    cyclic_p: Optional[int] = None,
) -> Tuple[Graph, Optional[np.ndarray]]:
    """Paper §5.3 steps 1-2 as one composed permutation.

    ``cyclic_p`` applies the initial cyclic redistribution over ``p``
    ranks first (optional — a relabeling choice here);
    ``reorder`` then ranks vertices by non-decreasing degree.  Returns
    the relabeled graph and the composed ``perm`` (old id → new id), or
    ``(graph, None)`` when both steps are off.
    """
    perm: Optional[np.ndarray] = None
    g = graph
    if cyclic_p is not None:
        perm = cyclic_relabel(g.n, cyclic_p)
        g = g.relabel(perm, name=g.name + f"+cyc{cyclic_p}")
    if reorder:
        dperm = degree_order(g)
        g = g.relabel(dperm, name=g.name + "+degord")
        perm = dperm if perm is None else dperm[perm]
    return g, perm


# ======================================================================
# pack: canonical stacked block arrays from one sorted pass
# ======================================================================
def emit_block_arrays(
    coo: CyclicCOO, nnz_pad: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Stacked ``(r, c, nb+1)`` indptr and ``(r, c, nnz_pad)`` indices.

    One cumsum (indptr) and one scatter (indices) over the whole sorted
    pass; padding positions hold the ``cols_loc`` sentinel (beyond any
    valid local column id) so padded rows stay sorted for the
    binary-search probe.
    """
    rc = coo.r * coo.c
    nb = coo.rows_loc
    indptr = np.zeros((rc, nb + 1), dtype=INT)
    np.cumsum(coo.rowcnt, axis=1, out=indptr[:, 1:])
    indices = np.full((rc, nnz_pad), coo.cols_loc, dtype=INT)
    indices[coo.bid_s, coo.offsets()] = coo.lj_s
    return (
        indptr.reshape(coo.r, coo.c, nb + 1),
        indices.reshape(coo.r, coo.c, nnz_pad),
    )


def _emit_tasks(
    coo: CyclicCOO, tmax: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-block task lists ``(m_ti, m_tj, m_cnt)`` by direct scatter."""
    rc = coo.r * coo.c
    m_ti = np.zeros((rc, tmax), dtype=INT)
    m_tj = np.zeros((rc, tmax), dtype=INT)
    offs = coo.offsets()
    m_ti[coo.bid_s, offs] = coo.li_s
    m_tj[coo.bid_s, offs] = coo.lj_s
    return (
        m_ti.reshape(coo.r, coo.c, tmax),
        m_tj.reshape(coo.r, coo.c, tmax),
        coo.counts.reshape(coo.r, coo.c).astype(INT),
    )


def _tc_plan_stats(
    coo: CyclicCOO, q: int, nnz_pad: int, tmax: int, m: int,
    skew_perm: Optional[np.ndarray] = None,
):
    """Balance statistics (paper Tables 3/4 analogues) from the sorted
    pass — fragment lengths come straight from ``rowcnt``.  ``skew_perm``
    indexes the per-shift probe by the σ visit order so stats stay
    aligned with the staged masks."""
    rowcnt3 = coo.rowcnt.reshape(q, q, coo.rows_loc)
    tasks = coo.counts.reshape(q, q).astype(np.int64)
    probe = np.zeros((q, q, q), dtype=np.int64)
    sp = (
        np.asarray(skew_perm, dtype=np.int64)
        if skew_perm is not None
        else np.arange(q, dtype=np.int64)
    )
    it_cell = np.zeros((q, q, q), dtype=np.int64)
    for x in range(q):
        for y in range(q):
            b = x * q + y
            lo, hi = coo.starts[b], coo.starts[b + 1]
            rows = coo.li_s[lo:hi]
            cols = coo.lj_s[lo:hi]
            for s in range(q):
                z = int(sp[(x + y + s) % q])
                la = rowcnt3[x, z][rows]
                lb = rowcnt3[y, z][cols]
                both = (la > 0) & (lb > 0)
                it_cell[x, y, s] = int(both.sum())
                probe[x, y, s] = int(np.minimum(la, lb)[both].sum())
    tot_idx = q * q * nnz_pad
    return PlanStats(
        tasks_per_device=tasks,
        nnz_per_block=tasks.copy(),
        probe_work_per_device_shift=probe,
        task_imbalance=float(tasks.max() / max(1.0, tasks.mean())),
        probe_imbalance=float(
            probe.sum(axis=2).max() / max(1.0, probe.sum(axis=2).mean())
        ),
        intersection_tasks_total=int(it_cell.sum()),
        padding_fraction_indices=float(1.0 - m / max(1, tot_idx)),
        padding_fraction_tasks=float(1.0 - m / max(1, q * q * tmax)),
        itasks_per_cell=it_cell,
    )


def cannon_step_keep(
    nnz_blocks: np.ndarray,
    m_cnt: np.ndarray,
    probe: Optional[np.ndarray],
    skew_perm: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-(device, shift) skip mask for the pre-skewed Cannon rotation.

    Device ``(x, y)`` at shift ``s`` holds ``A = U_{x,z}`` and
    ``B = U_{y,z}`` with ``z = σ[(x + y + s) % q]`` (``σ`` the
    visit-order permutation, identity by default), so its count that
    step is provably zero — and safe to skip — unless the device's task
    list and *both* incoming blocks are non-empty.  When the planner
    computed per-shift probe work (``with_stats``), the mask is refined
    to exact zero-work steps (``probe == 0`` ⇒ every task has an empty
    fragment side ⇒ count 0), which also prunes steps whose blocks are
    non-empty but never intersect a task row.
    """
    q = m_cnt.shape[0]
    x = np.arange(q)[:, None, None]
    y = np.arange(q)[None, :, None]
    s = np.arange(q)[None, None, :]
    z = (x + y + s) % q
    if skew_perm is not None:
        z = np.asarray(skew_perm, dtype=np.int64)[z]
    nz = nnz_blocks > 0
    keep = (m_cnt > 0)[:, :, None] & nz[x, z] & nz[y, z]
    if probe is not None:
        keep &= probe > 0
    return keep


def pack_tc_plan(
    graph: Graph,
    q: int,
    *,
    skew: bool = True,
    chunk: int = 512,
    with_stats: bool = True,
    keep_blocks: bool = True,
    step_masks: bool = True,
    skew_perm=None,
    aug_keys: bool = False,
    coo: Optional[CyclicCOO] = None,
) -> TCPlan:
    """Vectorized 2D-cyclic planner: the decompose+pack stages for the
    Cannon family (see :func:`repro_torch.core.plan.build_plan` for the
    placement semantics it implements).

    Emits the stacked ``(q, q, ...)`` arrays directly from one
    lexsorted pass: the canonical block family is packed once and the
    (skewed) A/B placements are fancy-indexed gathers of it.
    ``skew_perm`` gathers through the σ visit order instead of the
    identity (:func:`choose_cannon_skew`); ``aug_keys`` emits the
    host-staged ``b_aug`` intersection keys for the placed B blocks.
    """
    n, m = graph.n, graph.m
    assert skew_perm is None or skew, "skew_perm is a Cannon-placement knob"
    if coo is None:
        coo = cyclic_coo(graph, q, q)
    nb = coo.rows_loc
    nnz_pad = max(1, coo.nnz_max)
    tmax = nnz_pad

    sp = (
        np.asarray(skew_perm, dtype=np.int64)
        if skew_perm is not None
        else None
    )
    c_ptr, c_idx = emit_block_arrays(coo, nnz_pad)
    x = np.arange(q)[:, None]
    y = np.arange(q)[None, :]
    if skew:
        z = (x + y) % q
        if sp is not None:
            z = sp[z]
        a_indptr, a_indices = c_ptr[x, z], c_idx[x, z]
        b_indptr, b_indices = c_ptr[y, z], c_idx[y, z]
    else:
        a_indptr, a_indices = c_ptr.copy(), c_idx.copy()
        b_indptr, b_indices = c_ptr[y, x], c_idx[y, x]

    m_ti, m_tj, m_cnt = _emit_tasks(coo, tmax)
    dmax = max(1, coo.row_len_max)

    stats = (
        _tc_plan_stats(coo, q, nnz_pad, tmax, m, skew_perm=sp)
        if with_stats
        else None
    )
    blocks = blocks_from_coo(coo) if keep_blocks else None

    step_keep = None
    if skew and step_masks:
        step_keep = cannon_step_keep(
            coo.counts.reshape(q, q),
            m_cnt,
            stats.probe_work_per_device_shift if stats is not None else None,
            skew_perm=sp,
        )

    b_aug = host_aug_keys(b_indptr, b_indices) if aug_keys else None

    return TCPlan(
        n=n,
        m=m,
        q=q,
        nb=nb,
        nnz_pad=nnz_pad,
        tmax=tmax,
        dmax=dmax,
        chunk=min(chunk, tmax),
        a_indptr=a_indptr,
        a_indices=a_indices,
        b_indptr=b_indptr,
        b_indices=b_indices,
        m_ti=m_ti,
        m_tj=m_tj,
        m_cnt=m_cnt,
        stats=stats,
        blocks=blocks,
        step_keep=step_keep,
        b_aug=b_aug,
        skew_perm=tuple(int(v) for v in sp) if sp is not None else None,
    )


def summa_probe_work(acoo: CyclicCOO, bcoo: CyclicCOO, r: int, c: int) -> np.ndarray:
    """Per-(device, round) probe work for SUMMA, ``(r, c, c)`` int64.

    Broadcast round ``z`` hands device ``(x, y)`` the A panel ``(x, z)``
    and the B panel ``(y, z)``; each task ``(i, j)`` of its mask block
    then intersects row ``i`` of the A panel with row ``j`` of the B
    panel, so the round's work is ``sum(min(la, lb))`` over tasks with
    both fragments non-empty (the SUMMA analogue of
    :func:`_tc_plan_stats`'s Cannon probe)."""
    rowcnt_a = acoo.rowcnt.reshape(r, c, acoo.rows_loc)
    rowcnt_b = bcoo.rowcnt.reshape(c, c, bcoo.rows_loc)
    probe = np.zeros((r, c, c), dtype=np.int64)
    for x in range(r):
        for y in range(c):
            b = x * c + y
            lo, hi = acoo.starts[b], acoo.starts[b + 1]
            rows = acoo.li_s[lo:hi]
            cols = acoo.lj_s[lo:hi]
            for z in range(c):
                la = rowcnt_a[x, z][rows]
                lb = rowcnt_b[y, z][cols]
                both = (la > 0) & (lb > 0)
                probe[x, y, z] = int(np.minimum(la, lb)[both].sum())
    return probe


def oned_probe_work(
    rowcnt: np.ndarray, t_i: np.ndarray, t_j: np.ndarray,
    gcnt: np.ndarray, p: int,
) -> np.ndarray:
    """Per-(device, ring step) probe work for the 1D baseline, ``(p, p)``.

    At ring step ``t`` device ``d`` holds owner ``o = (d + t) % p``'s row
    block and counts its task group ``(d, o)``: row ``i`` comes from its
    own block, row ``j`` from the arriving one."""
    probe = np.zeros((p, p), dtype=np.int64)
    for d in range(p):
        for o in range(p):
            cnt = int(gcnt[d * p + o])
            if not cnt:
                continue
            la = rowcnt[d][t_i[d * p + o, :cnt]]
            lb = rowcnt[o][t_j[d * p + o, :cnt]]
            both = (la > 0) & (lb > 0)
            probe[d, (o - d) % p] = int(np.minimum(la, lb)[both].sum())
    return probe


def _step_stats(probe: np.ndarray) -> StepStats:
    per_dev = probe.reshape(-1, probe.shape[-1]).sum(axis=1)
    return StepStats(
        probe_work_per_device_shift=probe,
        probe_imbalance=float(per_dev.max() / max(1.0, per_dev.mean()))
        if per_dev.size else 1.0,
    )


def pack_summa_plan(
    graph: Graph, r: int, c: int, *, chunk: int = 512,
    step_masks: bool = True, with_stats: bool = False,
) -> SummaPlan:
    """Vectorized SUMMA planner (semantics of
    :func:`repro_torch.core.summa.build_summa_plan`): A/mask blocks from one
    ``(r, c)`` pass, B panels gathered from one ``(c, c)`` pass.

    ``with_stats`` computes per-round probe work (:class:`StepStats`) —
    the skip-aware rebalancer's cost input — and, like the Cannon
    packer, refines the skip mask to exact zero-work rounds."""
    n, m = graph.n, graph.m
    nb_r = -(-n // r)
    nb_c = -(-n // c)
    npan = -(-c // r)

    acoo = cyclic_coo(graph, r, c)
    bcoo = cyclic_coo(graph, c, c)
    a_nnz_pad = max(1, acoo.nnz_max)
    b_nnz_pad = max(1, bcoo.nnz_max)
    tmax = a_nnz_pad

    a_indptr, a_indices = emit_block_arrays(acoo, a_nnz_pad)
    m_ti, m_tj, m_cnt = _emit_tasks(acoo, tmax)

    cb_ptr, cb_idx = emit_block_arrays(bcoo, b_nnz_pad)
    b_indptr = np.zeros((r, c, npan, nb_c + 1), dtype=INT)
    b_indices = np.full((r, c, npan, b_nnz_pad), nb_c, dtype=INT)
    for kc in range(c):  # panel owner mapping: kc -> (row kc % r, slot kc // r)
        b_indptr[kc % r, :, kc // r] = cb_ptr[:, kc]
        b_indices[kc % r, :, kc // r] = cb_idx[:, kc]

    stats = None
    probe = None
    if with_stats:
        probe = summa_probe_work(acoo, bcoo, r, c)
        stats = _step_stats(probe)

    step_keep = None
    if step_masks:
        # step z broadcasts A panel (x, z) and B panel (y, z): skip the
        # count when the task list or either incoming panel is empty
        a_nz = acoo.counts.reshape(r, c) > 0
        b_nz = bcoo.counts.reshape(c, c) > 0
        step_keep = (
            (m_cnt > 0)[:, :, None] & a_nz[:, None, :] & b_nz[None, :, :]
        )
        if probe is not None:
            # probe == 0 ⇒ every task has an empty fragment side ⇒ the
            # round's count is provably zero even with non-empty panels
            step_keep &= probe > 0

    dmax = max(1, acoo.row_len_max, bcoo.row_len_max)
    return SummaPlan(
        n=n,
        m=m,
        r=r,
        c=c,
        nb_r=nb_r,
        nb_c=nb_c,
        npan=npan,
        a_nnz_pad=a_nnz_pad,
        b_nnz_pad=b_nnz_pad,
        tmax=tmax,
        dmax=dmax,
        chunk=min(chunk, tmax),
        a_indptr=a_indptr,
        a_indices=a_indices,
        b_indptr=b_indptr,
        b_indices=b_indices,
        m_ti=m_ti,
        m_tj=m_tj,
        m_cnt=m_cnt,
        step_keep=step_keep,
        stats=stats,
    )


def pack_oned_plan(
    graph: Graph, p: int, *, chunk: int = 512, step_masks: bool = True,
    with_stats: bool = False,
) -> OneDPlan:
    """Vectorized 1D planner (semantics of
    :func:`repro_torch.core.onedim.build_oned_plan`): the per-device row CSR
    and the owner-grouped task lists are both single-sort scatters.

    ``with_stats`` computes per-step probe work (:class:`StepStats`) for
    the skip-aware rebalancer and refines the skip mask to exact
    zero-work ring steps."""
    n, m = graph.n, graph.m
    nb = -(-n // p)
    i = graph.edges[:, 0]
    j = graph.edges[:, 1]
    own = i % p

    # per-device CSR over local rows, global sorted cols
    order = np.lexsort((j, i, own))
    i_s, j_s, own_s = i[order], j[order], own[order]
    dev_cnt = np.bincount(own_s, minlength=p)
    nnz_pad = max(1, int(dev_cnt.max()) if m else 0)
    dev_starts = np.zeros(p + 1, dtype=np.int64)
    np.cumsum(dev_cnt, out=dev_starts[1:])
    rowcnt = np.bincount(own_s * nb + i_s // p, minlength=p * nb).reshape(p, nb)
    indptr = np.zeros((p, nb + 1), dtype=INT)
    np.cumsum(rowcnt, axis=1, out=indptr[:, 1:])
    indices = np.full((p, nnz_pad), n + 1, dtype=INT)
    indices[own_s, np.arange(m, dtype=np.int64) - dev_starts[own_s]] = j_s

    # task groups: device d = i%p, group o = j%p (stable in edge order)
    gid = own * p + j % p
    gorder = np.argsort(gid, kind="stable")
    gid_s = gid[gorder]
    gcnt = np.bincount(gid_s, minlength=p * p)
    gmax = max(1, int(gcnt.max()) if m else 0)
    gstarts = np.zeros(p * p + 1, dtype=np.int64)
    np.cumsum(gcnt, out=gstarts[1:])
    goffs = np.arange(m, dtype=np.int64) - gstarts[gid_s]
    t_i = np.zeros((p * p, gmax), dtype=INT)
    t_j = np.zeros((p * p, gmax), dtype=INT)
    t_i[gid_s, goffs] = i[gorder] // p
    t_j[gid_s, goffs] = j[gorder] // p

    stats = None
    probe = None
    if with_stats:
        probe = oned_probe_work(rowcnt, t_i, t_j, gcnt, p)
        stats = _step_stats(probe)

    step_keep = None
    if step_masks:
        # device d at ring step t holds owner o = (d + t) % p's rotating
        # row block and counts its task group (d, o): skip when either
        # the group or the incoming block is empty
        d = np.arange(p)[:, None]
        t = np.arange(p)[None, :]
        o = (d + t) % p
        t_cnt_pp = gcnt.reshape(p, p)
        step_keep = (t_cnt_pp[d, o] > 0) & (dev_cnt[o] > 0)
        if probe is not None:
            step_keep &= probe > 0

    dmax = max(1, int(rowcnt.max()) if m else 0)
    return OneDPlan(
        n=n,
        m=m,
        p=p,
        nb=nb,
        nnz_pad=nnz_pad,
        gmax=gmax,
        dmax=dmax,
        chunk=min(chunk, gmax),
        indptr=indptr,
        indices=indices,
        t_i=t_i.reshape(p, p, gmax),
        t_j=t_j.reshape(p, p, gmax),
        t_cnt=gcnt.reshape(p, p).astype(INT),
        step_keep=step_keep,
        stats=stats,
    )


# ======================================================================
# schedule compaction: dead-shift elision + σ visit-order search
# ======================================================================
_SKEW_SEARCH_MAX_Q = 8  # q! permutations; beyond this keep the identity


def choose_cannon_skew(step_keep: np.ndarray):
    """Pick the visit-order permutation σ minimizing globally-live steps.

    Any σ is a valid Cannon alignment (placement ``A0[x,y] =
    U_{x,σ[(x+y)%q]}`` with the same unit shifts), so the planner is
    free to *reorder which k-panel every device sees at which step*.
    Liveness only depends on the per-diagonal-class union of live panels
    ``W[d, z] = ∃(x,y): (x+y)%q == d and panel z live at (x, y)``; step
    ``s`` is dead under σ iff ``σ[(d+s)%q] ∉ W[d]`` for every class
    ``d``.  Exhaustive over ``q!`` permutations (q ≤ 8; lexicographic
    order, identity first, first minimum wins — deterministic), identity
    beyond.

    Returns ``(σ tuple, n_live under σ)``; σ is the identity whenever it
    is already optimal, so dense graphs re-pack to byte-identical plans.
    """
    import itertools

    keep = np.asarray(step_keep, dtype=bool)
    q = keep.shape[-1]
    x = np.arange(q)[:, None, None]
    y = np.arange(q)[None, :, None]
    s = np.arange(q)[None, None, :]
    # live panels per device: keep is indexed by step; panel at step s is
    # z = (x+y+s)%q under the identity placement the mask was packed with
    z = (x + y + s) % q
    d = np.broadcast_to((x + y) % q, z.shape)
    W = np.zeros((q, q), dtype=bool)
    np.logical_or.at(W, (d.ravel(), z.ravel()), keep.ravel())

    dd = np.arange(q)[:, None]
    ss = np.arange(q)[None, :]
    identity = tuple(range(q))
    n_live_id = int(W[dd, (dd + ss) % q].any(axis=0).sum())
    if n_live_id <= 1 or q > _SKEW_SEARCH_MAX_Q:
        return identity, n_live_id
    perms = np.array(list(itertools.permutations(range(q))), dtype=np.int64)
    # visit[p, d, s] = σ_p[(d+s)%q]; live step s under σ_p iff any class
    # d has its visited panel in W[d]
    visit = perms[np.arange(perms.shape[0])[:, None, None], (dd + ss)[None] % q]
    live = W[dd[None], visit]
    n_live = live.any(axis=1).sum(axis=1)
    best = int(np.argmin(n_live))  # first minimum: identity wins ties at σ=id
    return tuple(int(v) for v in perms[best]), int(n_live[best])


def compact_stage(plan, *, repack=None):
    """Attach the compacted executable schedule to a packed plan.

    Computes the globally-live step list from the staged ``step_keep``
    mask (:func:`repro_torch.core.plan.compact_live_steps`).  A ``repack``
    callable re-packs the graph under the live-minimizing σ visit order
    first (:func:`choose_cannon_skew`) when that beats the identity.
    No-op (returns the plan unchanged) when the plan has no skip mask.
    """
    keep = getattr(plan, "step_keep", None)
    if keep is None:
        return plan
    if repack is not None:
        sigma, n_live = choose_cannon_skew(keep)
        if list(sigma) != list(range(len(sigma))):
            plan = repack(sigma)
            keep = plan.step_keep
    plan.compact = compact_live_steps(keep)
    return plan


# ======================================================================
# deterministic kernel-shape autotune (chunk + long/short split)
# ======================================================================
_CHUNK_BUDGET = 1 << 17  # probe-panel elements one chunk may gather
_CHUNK_MIN, _CHUNK_MAX = 64, 4096
_TAIL_PERCENTILE = 90.0


def _pick_chunk(tmax: int, d_eff: int) -> int:
    """Deterministic chunk: the smallest power of two covering the task
    list, capped so one chunk's gathered probe panel (``chunk * d_eff``
    elements) stays within a fixed budget — fewer scan iterations on
    small blocks, bounded working set on large ones."""
    cap = max(_CHUNK_MIN, _CHUNK_BUDGET // max(1, int(d_eff)))
    c = _CHUNK_MIN
    while c < min(max(1, tmax), cap):
        c <<= 1
    return int(max(_CHUNK_MIN, min(c, _CHUNK_MAX)))


def _tail_split(need: np.ndarray, dmax: int):
    """Percentile split of the per-task probe-length distribution:
    ``d_small`` = p90 rounded up to a multiple of 8 (≥ 8), ``tail_heavy``
    when the max exceeds twice that — the regime where flat ``dmax``
    padding wastes ≥ 2x on ≥ 90% of tasks."""
    if need.size == 0:
        return min(8, max(1, dmax)), False
    p = float(np.percentile(need, _TAIL_PERCENTILE))
    d_small = int(min(max(8, int(-(-p // 8)) * 8), dmax))
    return d_small, bool(dmax > 2 * d_small)


def _autotune_tasks(ti3, tj3, cnt, need_rows_of, dmax, tmax,
                    need_rows_b_of=None):
    """Shared autotune body: per-task probe lengths → percentile
    ``d_small``/``n_long`` split, stable long-first task reorder, and the
    deterministic chunk.  Returns ``(new_ti, new_tj, chunk, report)``.

    With ``need_rows_b_of`` the split is *two-sided* ("maxfrag"): a task
    is short only when BOTH fragments fit in ``d_small`` — required by
    the fused kernel, which takes the A and B fragments at most
    ``d_small`` long and would silently truncate a long B row under the
    probe-only criterion."""
    ti = ti3.reshape(-1, ti3.shape[-1])
    tj = tj3.reshape(-1, tj3.shape[-1])
    cnt = np.asarray(cnt).reshape(-1)
    new_ti = ti.copy()
    new_tj = tj.copy()

    def _need(b):
        c = int(cnt[b])
        if not c:
            return np.zeros(0, np.int64)
        need = need_rows_of(b)[ti[b, :c]]
        if need_rows_b_of is not None:
            need = np.maximum(need, need_rows_b_of(b)[tj[b, :c]])
        return need

    per_dev = [_need(b) for b in range(ti.shape[0])]
    needs_all = (
        np.concatenate(per_dev) if per_dev else np.zeros(0, np.int64)
    )
    d_small, tail_heavy = _tail_split(needs_all, dmax)
    n_long_max = 0
    for b in range(ti.shape[0]):
        c = int(cnt[b])
        if not c:
            continue
        long_mask = per_dev[b] > d_small
        order = np.argsort(~long_mask, kind="stable")  # long tasks first
        new_ti[b, :c] = ti[b, :c][order]
        new_tj[b, :c] = tj[b, :c][order]
        n_long_max = max(n_long_max, int(long_mask.sum()))
    chunk = max(
        1, min(_pick_chunk(tmax, d_small if tail_heavy else dmax), tmax)
    )
    report = dict(
        chunk=int(chunk),
        d_small=int(d_small),
        n_long=int(n_long_max),
        dmax=int(dmax),
        tail_heavy=tail_heavy,
        split="maxfrag" if need_rows_b_of is not None else "probe",
        probe_p90=float(np.percentile(needs_all, _TAIL_PERCENTILE))
        if needs_all.size
        else 0.0,
    )
    return new_ti.reshape(ti3.shape), new_tj.reshape(tj3.shape), chunk, report


def autotune_tc_plan(plan: TCPlan, two_sided: bool = False) -> TCPlan:
    """Deterministic kernel-shape autotune for Cannon plans: per-task
    probe lengths (max over every pairing a task can meet)
    come straight from the packed ``a_indptr`` — grid row ``x`` holds
    every panel of block-row ``x`` across its columns, so the row-wise
    max over ``y`` is the max over ``z`` regardless of the σ visit
    order.  No timing, no randomness: same plan in, same shapes out
    (the property the plan cache key relies on).

    ``two_sided=True`` switches to the fused kernel's maxfrag split:
    B-side lengths come from ``b_indptr`` the same way (grid *column*
    ``y`` holds every panel of block-column ``y`` across its rows)."""
    import dataclasses as _dc

    q = plan.q
    lens = np.diff(plan.a_indptr.astype(np.int64), axis=2)  # (q, q, nb)
    need_rows = lens.max(axis=1)  # (q, nb): max over all panels of row x
    need_b_of = None
    if two_sided:
        lens_b = np.diff(plan.b_indptr.astype(np.int64), axis=2)
        need_rows_b = lens_b.max(axis=0)  # (q, nb): max over column y
        need_b_of = lambda b: need_rows_b[b % q]  # noqa: E731

    new_ti, new_tj, chunk, report = _autotune_tasks(
        plan.m_ti, plan.m_tj, plan.m_cnt, lambda b: need_rows[b // q],
        plan.dmax, plan.tmax, need_rows_b_of=need_b_of,
    )
    return _dc.replace(
        plan, m_ti=new_ti, m_tj=new_tj, chunk=chunk,
        n_long=report["n_long"], d_small=report["d_small"],
        autotune=report,
    )


def autotune_summa_plan(plan: SummaPlan, two_sided: bool = False) -> SummaPlan:
    """SUMMA autotune: the probe side is the A panel row, so per-task
    lengths are the max over broadcast rounds of the ``a_indptr`` row
    lengths (panel ``(x, z)`` sits at grid position ``(x, z)``).  With
    ``two_sided=True`` the maxfrag split also folds in the B panel rows:
    device column ``y`` sees exactly the panels stored at
    ``b_indptr[:, y, :]``, so the max over (grid row, panel slot) is the
    max over broadcast rounds."""
    import dataclasses as _dc

    c = plan.c
    lens = np.diff(plan.a_indptr.astype(np.int64), axis=2)  # (r, c, nb_r)
    need_rows = lens.max(axis=1)  # (r, nb_r)
    need_b_of = None
    if two_sided:
        lens_b = np.diff(plan.b_indptr.astype(np.int64), axis=3)
        need_rows_b = lens_b.max(axis=(0, 2))  # (c, nb_c)
        need_b_of = lambda b: need_rows_b[b % c]  # noqa: E731

    new_ti, new_tj, chunk, report = _autotune_tasks(
        plan.m_ti, plan.m_tj, plan.m_cnt, lambda b: need_rows[b // c],
        plan.dmax, plan.tmax, need_rows_b_of=need_b_of,
    )
    return _dc.replace(
        plan, m_ti=new_ti, m_tj=new_tj, chunk=chunk,
        n_long=report["n_long"], d_small=report["d_small"],
        autotune=report,
    )


def autotune_oned_plan(plan: OneDPlan, two_sided: bool = False) -> OneDPlan:
    """1D-ring autotune: chunk only by default.  The ring's B columns are
    *global* ids (they rotate whole adjacency rows), so the block-local
    global-key two-level kernel does not apply — ``tail_heavy`` is
    reported for visibility but ``method='auto'`` resolves to ``search``
    on this schedule, and no two-level split lands on the plan.

    ``two_sided=True`` (fused): the panel path compares raw column ids,
    which IS valid on global ids, so the maxfrag split and long-first
    reorder land on the plan — task (d, o) intersects device ``d``'s row
    ``t_i`` with partner ``o``'s row ``t_j``."""
    import dataclasses as _dc

    lens = np.diff(plan.indptr.astype(np.int64), axis=1)  # (p, nb)
    p = plan.p

    new_ti, new_tj, chunk, report = _autotune_tasks(
        plan.t_i, plan.t_j, plan.t_cnt, lambda b: lens[b // p],
        plan.dmax, plan.gmax,
        need_rows_b_of=(lambda b: lens[b % p]) if two_sided else None,
    )
    if two_sided:
        return _dc.replace(
            plan, t_i=new_ti, t_j=new_tj, chunk=chunk,
            n_long=report["n_long"], d_small=report["d_small"],
            autotune=report,
        )
    # task order stays put (the two-level boundary is unused here)
    return _dc.replace(
        plan, chunk=chunk, autotune=dict(report, n_long=None, d_small=None)
    )


def timed(name: str, seconds: dict, fn, *args, **kwargs):
    """Run one stage, recording its wall time under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    seconds[name] = time.perf_counter() - t0
    return out
