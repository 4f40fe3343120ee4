"""Composable host-planning stages, Cannon family.

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
package's module of the same name emits for the same graph and flags.
The SUMMA and 1D packers and their autotune stages are not carried over
yet.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np

from ..core.decomp import CyclicCOO, blocks_from_coo, cyclic_coo
from ..core.graph import Graph
from ..core.plan import (
    INT,
    PlanStats,
    TCPlan,
    compact_live_steps,
    host_aug_keys,
)
from ..core.preprocess import cyclic_relabel, degree_order

__all__ = [
    "relabel_stage",
    "emit_block_arrays",
    "cannon_step_keep",
    "pack_tc_plan",
    "choose_cannon_skew",
    "compact_stage",
    "autotune_tc_plan",
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


def timed(name: str, seconds: dict, fn, *args, **kwargs):
    """Run one stage, recording its wall time under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    seconds[name] = time.perf_counter() - t0
    return out
