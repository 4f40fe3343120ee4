"""Host-side execution plan for the 2D (Cannon) algorithm.

The planner turns a degree-ordered :class:`~repro_torch.core.graph.Graph`
into fixed-shape numpy arrays stacked over the logical processor grid: the
leading ``(q, q)`` dimensions of every array are the grid, so logical
device ``(x, y)`` owns ``array[x, y]`` and the engine moves blocks between
logical devices by rolling those two dimensions on one GPU:

* ``a_*``  — Cannon "A" operand, pre-skewed: device ``(x, y)`` starts with
  block ``U_{x, (x+y) % q}``  (rows *i*, columns *k*);
* ``b_*``  — Cannon "B" operand, pre-skewed: device ``(x, y)`` starts with
  block ``U_{y, (x+y) % q}``  (rows *j*, columns *k*; this is
  ``L_{(x+y)%q, y}`` stored transposed);
* ``m_*``  — the static task list: nonzeros ``(i, j)`` of ``U_{x, y}``.

All ragged structures are padded to plan-wide maxima so every logical
device has the same shapes; the padding fractions are part of the plan
report.

The pre-skew implements Cannon's initial alignment at data-distribution
time (the paper performs it as its first communication step; here the
aligned blocks are simply *fed*).  ``skew=0`` (SUMMA placement) is also
available from the packer.  The SUMMA and 1D-ring plans live in
:mod:`.summa` and :mod:`.onedim`; :func:`plan_from_numpy` assembles any of
the three.

The dry run (:mod:`repro_torch.launch.dryrun`) sizes graphs too large to
plan on the host: :func:`analytic_plan` is a shape-only plan, and
:meth:`TCPlan.shape_structs` gives tensors on the ``meta`` device — the
counterpart of the JAX package's ``jax.ShapeDtypeStruct`` — that carry
every staged array's shape and dtype and allocate nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .decomp import BlockCSR, cyclic_blocks
from .graph import Graph

__all__ = [
    "TCPlan",
    "analytic_plan",
    "build_plan",
    "plan_from_numpy",
    "PlanStats",
    "CompactSchedule",
    "compact_live_steps",
    "as_plan",
    "bucketize_plan",
    "resolve_broadcast",
    "resolve_step_mask",
    "StepStats",
    "resolve_compact_steps",
    "host_aug_keys",
    "shape_structs_of",
]


def as_plan(obj):
    """Coerce a pipeline :class:`~repro_torch.pipeline.artifact.PlanArtifact`
    (or a raw plan) to its plan object — every ``build_*_fn`` accepts
    either."""
    inner = getattr(obj, "plan", None)
    return obj if inner is None else inner


@dataclasses.dataclass(frozen=True)
class CompactSchedule:
    """Globally-live steps of a skip-masked schedule.

    A schedule step is *globally dead* when ``step_keep`` is False on
    every device — no device can contribute, so the whole loop iteration
    (count *and* shift) is removable.  The compacted engine executes
    only ``live_steps`` (original step indices, strictly increasing),
    replacing the elided unit shifts with fused multi-hop rolls whose
    distances are :attr:`hops`.  Keeping a dead step live is always
    correct (its count is provably zero), so any superset of the true
    live set is a valid ``live_steps``.
    """

    n_total: int  # schedule steps before compaction
    live_steps: Tuple[int, ...]  # original indices of the kept steps

    @property
    def n_live(self) -> int:
        return len(self.live_steps)

    @property
    def n_elided(self) -> int:
        return self.n_total - self.n_live

    @property
    def hops(self) -> Tuple[int, ...]:
        """Fused shift distances: ``hops[0]`` is the prologue hop from
        the initial placement to the first live step; ``hops[i]`` moves
        live step ``i-1``'s payload to live step ``i``."""
        prev, out = 0, []
        for s in self.live_steps:
            out.append(s - prev)
            prev = s
        return tuple(out)


def compact_live_steps(step_keep: np.ndarray) -> CompactSchedule:
    """Derive the compacted schedule from a staged skip mask.

    ``step_keep`` is any ``(..., nsteps)`` per-(device, step) bool array;
    a step survives iff *any* device keeps it.
    """
    keep = np.asarray(step_keep, dtype=bool)
    nsteps = keep.shape[-1]
    live = np.flatnonzero(keep.reshape(-1, nsteps).any(axis=0))
    return CompactSchedule(
        n_total=int(nsteps), live_steps=tuple(int(s) for s in live)
    )


def resolve_compact_steps(
    plan, compact, *, batched: bool = False, npods: int = 1
) -> Optional[Tuple[int, ...]]:
    """Resolve a ``compact`` request against the plan.

    ``None`` auto-enables compaction iff the planner staged a
    :class:`CompactSchedule` that actually elides something and the
    build is a plain (non-batched, single-pod) engine — a batch's
    per-graph masks differ, and pods stride the mask (pod ``t`` runs the
    global steps ``t, t + npods, ...``), so both keep the full loop.  An
    explicit ``True`` that cannot be honored is an error.
    """
    cs = getattr(as_plan(plan), "compact", None)
    if compact is None:
        if cs is None or batched or npods != 1 or cs.n_elided == 0:
            return None
    elif not compact:
        return None
    else:
        if cs is None:
            raise ValueError(
                "plan carries no compacted schedule; re-plan through the "
                "pipeline with step_masks=True (or leave compact=None)"
            )
        if batched or npods != 1:
            raise ValueError(
                "compact=True is not supported for batched or multi-pod "
                "engines; pass compact=False (or None for auto)"
            )
    return cs.live_steps


def resolve_broadcast(plan, broadcast, *, batched: bool = False) -> str:
    """Resolve a ``broadcast`` request of ``build_summa_fn`` against the
    plan.

    ``None`` defers to the strategy the plan was staged for (its
    ``broadcast`` field; ``"auto"`` when it has none); ``"auto"``
    resolves to ``"chain"`` for a plain engine and ``"onehot"`` for a
    batched one, and an explicit ``"chain"`` is refused for a batched
    one, as in the JAX package.  On one device both strategies are the
    same gather (:class:`~repro_torch.core.engine.SummaCSRStore`); the
    name is kept so plans, cache keys and errors stay the reference's.
    """
    b = broadcast
    if b is None:
        b = getattr(as_plan(plan), "broadcast", None) or "auto"
    if b == "auto":
        return "onehot" if batched else "chain"
    if b not in ("onehot", "chain"):
        raise ValueError(
            f"unknown broadcast strategy {b!r}; "
            "expected 'onehot', 'chain', or 'auto'"
        )
    if b == "chain" and batched:
        raise ValueError(
            "broadcast='chain' is not supported for batched engines "
            "(chain rounds need the unrolled body); pass 'onehot' "
            "(or 'auto')"
        )
    return b


def resolve_step_mask(plan, use_step_mask) -> bool:
    """Resolve a ``use_step_mask`` request against the plan.

    ``None`` auto-enables skipping iff the planner staged ``step_keep``
    masks; an explicit ``True`` on a mask-less plan is an error (the
    engine would have nothing to consume).
    """
    has = getattr(plan, "step_keep", None) is not None
    if use_step_mask is None:
        return has
    if use_step_mask and not has:
        raise ValueError(
            "plan carries no step_keep masks; re-plan with step_masks=True"
        )
    return bool(use_step_mask)

INT = np.int32


def shape_structs_of(shapes, device="meta") -> Dict[str, torch.Tensor]:
    """``{name: (shape, numpy dtype)}`` -> ``{name: tensor}``: uninitialised
    tensors of those shapes and dtypes on ``device``.  On ``meta`` (the
    default) they are shape-only stand-ins, the counterpart of the JAX
    package's ``jax.ShapeDtypeStruct``: nothing is allocated and no value
    can be read."""
    return {
        k: torch.empty(tuple(shape),
                       dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       device=device)
        for k, (shape, dtype) in shapes.items()
    }


def host_aug_keys(
    indptr: np.ndarray, indices: np.ndarray
) -> np.ndarray:
    """Host-side row-encoded intersection keys for stacked CSR blocks.

    The numpy twin of :func:`repro_torch.core.count.build_aug_keys`, applied
    once per block at pack time: for every ``(..., nb + 1)`` indptr /
    ``(..., nnz_pad)`` indices pair, emits ``aug[e] = row(e) * (nb + 1)
    + col(e)`` with padding positions landing on the maximal key (their
    row resolves past the last row and their column holds the ``nb``
    sentinel), so each block's key array is sorted exactly like the
    on-device build.  Keys are int32 while ``base**2 - 1`` fits and int64
    past it (:func:`~repro_torch.core.count.aug_key_numpy_dtype`).
    """
    from .count import aug_key_numpy_dtype

    nb = indptr.shape[-1] - 1
    base = nb + 1
    key_dtype = aug_key_numpy_dtype(base)
    flat_ptr = indptr.reshape(-1, nb + 1)
    flat_idx = indices.reshape(-1, indices.shape[-1])
    nnz_pad = flat_idx.shape[1]
    # row of entry e per block: searchsorted(indptr, e, 'right') - 1,
    # vectorized over blocks (indptr rows are independently sorted)
    e = np.arange(nnz_pad, dtype=np.int64)
    row_of = (
        np.apply_along_axis(np.searchsorted, 1, flat_ptr, e, side="right")
        - 1
    )
    aug = row_of.astype(key_dtype) * base + flat_idx.astype(key_dtype)
    return aug.reshape(indices.shape)


@dataclasses.dataclass
class PlanStats:
    """Balance statistics (paper Tables 3/4 analogues), host-computed."""

    tasks_per_device: np.ndarray  # (q, q) int64 — nonzero tasks owned
    nnz_per_block: np.ndarray  # (q, q) int64
    probe_work_per_device_shift: np.ndarray  # (q, q, q) int64
    task_imbalance: float  # max/avg of tasks_per_device
    probe_imbalance: float  # max/avg of per-shift probe work
    intersection_tasks_total: int  # paper Table 4 metric
    padding_fraction_indices: float
    padding_fraction_tasks: float
    # per-(device, shift) intersection-task counts (the summands of
    # ``intersection_tasks_total``); None on plans packed by the loop
    # reference.
    itasks_per_cell: Optional[np.ndarray] = None  # (q, q, q) int64


@dataclasses.dataclass
class StepStats:
    """Per-(device, step) probe work for the non-Cannon schedules.

    The lean sibling of :class:`PlanStats`: SUMMA broadcast rounds carry a
    ``(r, c, c)`` array, the 1D ring a ``(p, p)`` one; the last axis is
    always the schedule step.
    """

    probe_work_per_device_shift: np.ndarray  # (..., nsteps) int64
    probe_imbalance: float  # max/avg of per-device total probe work


@dataclasses.dataclass
class TCPlan:
    """Device-ready arrays + metadata for one grid factorization."""

    n: int
    m: int
    q: int  # square grid dimension
    nb: int  # local rows/cols per block = ceil(n / q)
    nnz_pad: int  # padded nnz per block
    tmax: int  # padded tasks per device
    dmax: int  # max adjacency-fragment length over all blocks
    chunk: int  # tasks per searchsorted chunk

    # stacked [q, q, ...] arrays; *_indptr (q,q,nb+1), *_indices (q,q,nnz_pad)
    a_indptr: np.ndarray
    a_indices: np.ndarray
    b_indptr: np.ndarray
    b_indices: np.ndarray
    m_ti: np.ndarray  # (q, q, tmax) task row (local i)
    m_tj: np.ndarray  # (q, q, tmax) task row of B (local j)
    m_cnt: np.ndarray  # (q, q) valid task count

    stats: Optional[PlanStats] = None
    # canonical (un-skewed) blocks, kept on request
    blocks: Optional[List[List[BlockCSR]]] = None
    # (q, q, q) bool per-(device, shift) skip mask: True = the incoming
    # block pair can contribute (sparsity-aware step skipping); None for
    # un-skewed (SUMMA-placement) or analytic plans
    step_keep: Optional[np.ndarray] = None
    # (q, q, nnz_pad) host-staged row-encoded intersection keys of the B
    # placement — shifted alongside the B blocks so the global kernel
    # skips the per-step on-device key build
    b_aug: Optional[np.ndarray] = None
    # visit-order permutation σ of Cannon's initial alignment: step s
    # hands device (x, y) the k-panel z = σ[(x + y + s) % q] (identity
    # when None).  Chosen by the compaction stage to concentrate live
    # work onto few steps.
    skew_perm: Optional[Tuple[int, ...]] = None
    # globally-live steps + fused hop vector (compaction stage)
    compact: Optional[CompactSchedule] = None
    # deterministic kernel-shape autotune report (chunk, d_small/n_long,
    # tail_heavy) when the plan went through the autotune stage
    autotune: Optional[dict] = None
    # long/short task split from bucketize_plan / the autotune stage:
    # the first ``n_long`` tasks on every device need probes padded to
    # dmax, the rest fit in ``d_small``.  None = plan not split.
    n_long: Optional[int] = None
    d_small: Optional[int] = None
    # padded-probe waste accounting from bucketize_plan
    bucket_stats: Optional[dict] = None
    # hub-split side (repro_torch.pipeline.hubsplit.HubSide) when the
    # planner cut the heavy-tailed suffix off the schedule; its arrays
    # join device_arrays() and the engine adds its partial
    # (engine.HubCount).  The plan's own arrays then cover only the
    # residual graph.
    hub: Optional[object] = None

    # ------------------------------------------------------------------
    def device_arrays(self) -> Dict[str, np.ndarray]:
        out = dict(
            a_indptr=self.a_indptr,
            a_indices=self.a_indices,
            b_indptr=self.b_indptr,
            b_indices=self.b_indices,
            m_ti=self.m_ti,
            m_tj=self.m_tj,
            m_cnt=self.m_cnt,
        )
        if self.step_keep is not None:
            out["step_keep"] = self.step_keep
        if self.b_aug is not None:
            out["b_aug"] = self.b_aug
        if self.hub is not None:
            out.update(self.hub.device_arrays())
        return out

    def shape_structs(self, device="meta") -> Dict[str, torch.Tensor]:
        """Shape-only stand-ins (:func:`shape_structs_of`) for every device
        array.

        For analytic (shape-only) plans this reflects the *padded* sizes
        without ever allocating them.
        """
        shape_only = getattr(self, "_shape_only", None)
        if shape_only is None:
            shape_only = {k: (v.shape, v.dtype)
                          for k, v in self.device_arrays().items()}
        return shape_structs_of(shape_only, device)

    def dense_blocks(self) -> Dict[str, np.ndarray]:
        """Materialize dense block operands (oracle path, small n only)."""
        q, nb = self.q, self.nb
        out = {}
        for name in ("a", "b"):
            arr = np.zeros((q, q, nb, nb), dtype=np.float32)
            indptr = getattr(self, f"{name}_indptr")
            indices = getattr(self, f"{name}_indices")
            for x in range(q):
                for y in range(q):
                    ptr = indptr[x, y]
                    rows = np.repeat(np.arange(nb), np.diff(ptr))
                    arr[x, y, rows, indices[x, y, : ptr[-1]]] = 1.0
            out[f"{name}_dense"] = arr
        msk = np.zeros((q, q, nb, nb), dtype=np.float32)
        for x in range(q):
            for y in range(q):
                cnt = self.m_cnt[x, y]
                msk[x, y, self.m_ti[x, y, :cnt], self.m_tj[x, y, :cnt]] = 1.0
        out["m_dense"] = msk
        if self.step_keep is not None:
            out["step_keep"] = self.step_keep
        return out


def _stack_blocks(
    blocks: List[List[BlockCSR]],
    placement,  # (x, y) -> BlockCSR
    q: int,
    nb: int,
    nnz_pad: int,
) -> Tuple[np.ndarray, np.ndarray]:
    indptr = np.zeros((q, q, nb + 1), dtype=INT)
    indices = np.zeros((q, q, nnz_pad), dtype=INT)
    for x in range(q):
        for y in range(q):
            blk = placement(x, y)
            indptr[x, y] = blk.indptr.astype(INT)
            indices[x, y, : blk.nnz] = blk.indices.astype(INT)
            indices[x, y, blk.nnz :] = nb  # sentinel beyond any local col
    return indptr, indices


def build_plan(
    graph: Graph,
    q: int,
    *,
    skew: bool = True,
    chunk: int = 512,
    with_stats: bool = True,
    keep_blocks: bool = True,
    step_masks: bool = True,
    skew_perm: Optional[Tuple[int, ...]] = None,
    aug_keys: bool = False,
) -> TCPlan:
    """Plan the 2D-cyclic execution of a *degree-ordered* graph on q x q.

    ``skew=True`` applies Cannon's initial alignment at placement time;
    ``skew=False`` yields the canonical placement used by SUMMA (A at
    ``(x, y) -> U_{x,y}``, B at ``(x, y) -> U_{y,x}``).  ``skew_perm``
    generalizes the alignment with a visit-order permutation σ (device
    ``(x, y)`` sees panel ``z = σ[(x+y+s) % q]`` at step ``s`` — any σ
    is a correct Cannon schedule; the compaction stage picks one that
    concentrates live work).  ``aug_keys`` stages the
    row-encoded B intersection keys host-side for the global kernel.

    The implementation is the pipeline's vectorized packer
    (:func:`repro_torch.pipeline.stages.pack_tc_plan`): one lexsorted pass
    emits the stacked arrays directly.  :func:`_build_plan_loops` keeps
    the original per-block loop semantics as the byte-level reference
    the packer is tested against.
    """
    from ..pipeline.stages import pack_tc_plan

    return pack_tc_plan(
        graph,
        q,
        skew=skew,
        chunk=chunk,
        with_stats=with_stats,
        keep_blocks=keep_blocks,
        step_masks=step_masks,
        skew_perm=skew_perm,
        aug_keys=aug_keys,
    )


def _build_plan_loops(
    graph: Graph,
    q: int,
    *,
    skew: bool = True,
    chunk: int = 512,
    with_stats: bool = True,
    keep_blocks: bool = True,
    step_masks: bool = True,
    skew_perm: Optional[Tuple[int, ...]] = None,
    aug_keys: bool = False,
) -> TCPlan:
    """Loop-based reference planner (the pre-pipeline implementation).

    Retained so the tests can pin the vectorized packer to
    byte-identical output; not used on any runtime path.
    """
    n, m = graph.n, graph.m
    nb = -(-n // q)
    blocks = cyclic_blocks(graph, q, q)

    nnz_pad = max(1, max(blocks[x][y].nnz for x in range(q) for y in range(q)))
    tmax = nnz_pad  # tasks per device == nnz of its mask block

    assert skew_perm is None or skew, "skew_perm is a Cannon-placement knob"
    sp = list(skew_perm) if skew_perm is not None else list(range(q))
    if skew:
        a_place = lambda x, y: blocks[x][sp[(x + y) % q]]
        b_place = lambda x, y: blocks[y][sp[(x + y) % q]]
    else:
        a_place = lambda x, y: blocks[x][y]
        b_place = lambda x, y: blocks[y][x]

    a_indptr, a_indices = _stack_blocks(blocks, a_place, q, nb, nnz_pad)
    b_indptr, b_indices = _stack_blocks(blocks, b_place, q, nb, nnz_pad)

    m_ti = np.zeros((q, q, tmax), dtype=INT)
    m_tj = np.full((q, q, tmax), 0, dtype=INT)
    m_cnt = np.zeros((q, q), dtype=INT)
    for x in range(q):
        for y in range(q):
            blk = blocks[x][y]
            # expand CSR -> COO (ti = local i in grid-row x, tj = local j in
            # grid-row y of the B operand; j's *local* index is j // q which
            # is exactly the stored column's block-local row id)
            rows = np.repeat(
                np.arange(blk.n_rows, dtype=INT), np.diff(blk.indptr)
            )
            cols = blk.indices.astype(INT)
            m_ti[x, y, : rows.shape[0]] = rows
            m_tj[x, y, : cols.shape[0]] = cols
            m_cnt[x, y] = rows.shape[0]

    dmax = max(1, max(blocks[x][y].max_row_len() for x in range(q) for y in range(q)))

    probe = None
    stats = None
    if with_stats:
        tasks = np.array(
            [[blocks[x][y].nnz for y in range(q)] for x in range(q)],
            dtype=np.int64,
        )
        # probe work per (x, y, shift): for each task (i, j) with both
        # fragments non-empty, the map-based intersection is "performed"
        # (paper Table 4 counts these tasks; we also weight by min-fragment
        # length for the imbalance measure of Table 3).
        probe = np.zeros((q, q, q), dtype=np.int64)
        itasks = 0
        rowlen = {
            (x, y): np.diff(blocks[x][y].indptr) for x in range(q) for y in range(q)
        }
        for x in range(q):
            for y in range(q):
                blk = blocks[x][y]
                rows = np.repeat(np.arange(blk.n_rows), np.diff(blk.indptr))
                cols = blk.indices
                for s in range(q):
                    z = sp[(x + y + s) % q] if skew else (x + y + s) % q
                    la = rowlen[(x, z)][rows]
                    lb = rowlen[(y, z)][cols]
                    both = (la > 0) & (lb > 0)
                    itasks += int(both.sum())
                    probe[x, y, s] = int(np.minimum(la, lb)[both].sum())
        tot_idx = q * q * nnz_pad
        stats = PlanStats(
            tasks_per_device=tasks,
            nnz_per_block=tasks.copy(),
            probe_work_per_device_shift=probe,
            task_imbalance=float(tasks.max() / max(1.0, tasks.mean())),
            probe_imbalance=float(
                probe.sum(axis=2).max() / max(1.0, probe.sum(axis=2).mean())
            ),
            intersection_tasks_total=itasks,
            padding_fraction_indices=float(1.0 - m / max(1, tot_idx)),
            padding_fraction_tasks=float(1.0 - m / max(1, q * q * tmax)),
        )

    # per-(device, shift) skip mask — loop reference of the vectorized
    # derivation in pipeline.stages: device (x, y) at
    # shift s holds A = U_{x,z} and B = U_{y,z} with z = (x+y+s) % q, so
    # the step contributes only if the task list and both incoming
    # blocks are non-empty (refined to exact per-shift probe work when
    # stats were computed).
    step_keep = None
    if skew and step_masks:
        step_keep = np.zeros((q, q, q), dtype=bool)
        for x in range(q):
            for y in range(q):
                for s in range(q):
                    z = sp[(x + y + s) % q]
                    k = (
                        m_cnt[x, y] > 0
                        and blocks[x][z].nnz > 0
                        and blocks[y][z].nnz > 0
                    )
                    if probe is not None:
                        k = k and probe[x, y, s] > 0
                    step_keep[x, y, s] = k

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
        blocks=blocks if keep_blocks else None,
        step_keep=step_keep,
        b_aug=b_aug,
        skew_perm=tuple(sp) if skew_perm is not None else None,
    )


def bucketize_plan(plan: TCPlan, d_small: int = 32) -> TCPlan:
    """Statically reorder each device's tasks into long | short.

    A task is *long* iff under ANY Cannon pairing its probe (the A
    fragment, row ``i``) is longer than ``d_small``: the max over the
    panels ``z`` of block-row ``x``.  The planner reorders ``(m_ti,
    m_tj)`` so long tasks come first (stable) and records the per-plan
    maximum long count; ``method="search2"`` then runs long chunks at
    ``dmax`` and the rest at ``d_small``.  Needs the plan's canonical
    blocks (``keep_blocks``).  Returns a new plan with ``n_long``,
    ``d_small`` and ``bucket_stats`` (padded-probe work before and after,
    over all shifts) set.
    """
    plan = as_plan(plan)
    if plan.blocks is None:
        raise ValueError(
            "bucketize_plan needs the plan's canonical blocks: plan with "
            "keep_blocks=True"
        )
    q = plan.q
    rowlen = {
        (x, y): np.diff(plan.blocks[x][y].indptr)
        for x in range(q)
        for y in range(q)
    }
    m_ti = plan.m_ti.copy()
    m_tj = plan.m_tj.copy()
    n_long_max = 0
    waste_before = 0
    waste_after = 0
    for x in range(q):
        for y in range(q):
            cnt = int(plan.m_cnt[x, y])
            ti = plan.m_ti[x, y, :cnt]
            tj = plan.m_tj[x, y, :cnt]
            need = np.zeros(cnt, dtype=np.int64)
            for z in range(q):
                need = np.maximum(need, rowlen[(x, z)][ti])
            long_mask = need > d_small
            order = np.argsort(~long_mask, kind="stable")  # long first
            m_ti[x, y, :cnt] = ti[order]
            m_tj[x, y, :cnt] = tj[order]
            n_long = int(long_mask.sum())
            n_long_max = max(n_long_max, n_long)
            waste_before += cnt * plan.dmax
            waste_after += n_long * plan.dmax + (cnt - n_long) * d_small
    return dataclasses.replace(
        plan,
        m_ti=m_ti,
        m_tj=m_tj,
        n_long=n_long_max,
        d_small=d_small,
        bucket_stats=dict(
            padded_probe_before=float(waste_before * q),  # x shifts
            padded_probe_after=float(waste_after * q),
            reduction=float(waste_before / max(1, waste_after)),
        ),
    )


# per plan kind: its integer fields, its device grid (as meta keys), and
# its required arrays with their leading grid dims
_PLAN_LAYOUTS = {
    "cannon": (
        ("n", "m", "q", "nb", "nnz_pad", "tmax", "dmax", "chunk"),
        ("q", "q"),
        {k: ("q", "q") for k in ("a_indptr", "a_indices", "b_indptr",
                                 "b_indices", "m_ti", "m_tj", "m_cnt")},
    ),
    "summa": (
        ("n", "m", "r", "c", "nb_r", "nb_c", "npan", "a_nnz_pad",
         "b_nnz_pad", "tmax", "dmax", "chunk"),
        ("r", "c"),
        {k: ("r", "c") for k in ("a_indptr", "a_indices", "b_indptr",
                                 "b_indices", "m_ti", "m_tj", "m_cnt")},
    ),
    "oned": (
        ("n", "m", "p", "nb", "nnz_pad", "gmax", "dmax", "chunk"),
        ("p",),
        dict(indptr=("p",), indices=("p",), t_i=("p", "p"),
             t_j=("p", "p"), t_cnt=("p", "p")),
    ),
}


def plan_from_numpy(arrays: Dict[str, np.ndarray], meta: dict):
    """Build a plan from plain numpy arrays and Python scalars.

    The plan kind follows ``meta``: with ``p`` a
    :class:`~repro_torch.core.onedim.OneDPlan`, with ``r`` (and ``c``) a
    :class:`~repro_torch.core.summa.SummaPlan`, else a :class:`TCPlan`.
    ``arrays`` holds the keys of the kind's ``device_arrays`` (for a
    TCPlan ``a_indptr, a_indices, b_indptr, b_indices, m_ti, m_tj,
    m_cnt``; for a OneDPlan ``indptr, indices, t_i, t_j, t_cnt``; each
    optionally with ``step_keep``, and a TCPlan with ``b_aug``); ``meta``
    holds the kind's integer fields (``n, m, q, nb, nnz_pad, tmax, dmax,
    chunk`` for a TCPlan) and optionally ``n_long, d_small, autotune,
    live_steps`` — plus ``skew_perm`` (TCPlan) or ``broadcast`` (SUMMA).
    This is how plan state made elsewhere — for example by the JAX
    package's planner — is carried into this engine: the caller extracts
    the values, this function only assembles them.
    """
    kind = "oned" if "p" in meta else "summa" if "r" in meta else "cannon"
    scalars, grid, layout = _PLAN_LAYOUTS[kind]
    missing = [k for k in layout if k not in arrays]
    if missing:
        raise ValueError(f"plan_from_numpy: missing arrays {missing}")
    missing = [k for k in scalars if k not in meta]
    if missing:
        raise ValueError(f"plan_from_numpy: missing meta {missing}")
    for k, v in arrays.items():
        want = tuple(int(meta[d]) for d in layout.get(k, grid))
        if tuple(np.shape(v)[:len(want)]) != want:
            raise ValueError(
                f"plan_from_numpy: {k} has shape {np.shape(v)}, expected "
                f"leading grid dims {want}"
            )
    step_keep = arrays.get("step_keep")
    compact = None
    live = meta.get("live_steps")
    if live is not None:
        if step_keep is None:
            raise ValueError("live_steps need the step_keep mask they index")
        compact = CompactSchedule(
            n_total=int(np.shape(step_keep)[-1]),
            live_steps=tuple(int(s) for s in live),
        )
    n_long, d_small = meta.get("n_long"), meta.get("d_small")
    autotune = meta.get("autotune")
    common = dict(
        {k: int(meta[k]) for k in scalars},
        **{k: np.asarray(arrays[k]) for k in layout},
        step_keep=None if step_keep is None else np.asarray(step_keep, bool),
        compact=compact,
        autotune=None if autotune is None else dict(autotune),
        n_long=None if n_long is None else int(n_long),
        d_small=None if d_small is None else int(d_small),
    )
    if kind == "oned":
        from .onedim import OneDPlan

        return OneDPlan(**common)
    if kind == "summa":
        from .summa import SummaPlan

        return SummaPlan(broadcast=str(meta.get("broadcast", "auto")),
                         **common)
    skew_perm = meta.get("skew_perm")
    return TCPlan(
        b_aug=None if arrays.get("b_aug") is None
        else np.asarray(arrays["b_aug"]),
        skew_perm=None if skew_perm is None
        else tuple(int(v) for v in skew_perm),
        **common,
    )


def analytic_plan(
    n: int,
    m: int,
    q: int,
    *,
    dmax_block: int,
    nnz_slack: float = 1.25,
    chunk: int = 512,
    name: str = "analytic",
) -> TCPlan:
    """Shape-only plan for dry runs on graphs too large to materialize.

    Uses the paper's balance argument (cyclic distribution => per-block nnz
    ~ m / p with small slack; Table 3 measured <= 6% imbalance, we budget
    ``nnz_slack``) to size the padded arrays.  Its host arrays are empty
    placeholders and its ``m_cnt`` is all zeros — the engine skips a
    device with no tasks, so a walk rebinds the counts to ``tmax``
    (:mod:`repro_torch.launch.dryrun`).  Dry runs use
    :meth:`TCPlan.shape_structs` (no allocation).  ``name`` is accepted
    for the JAX package's signature and not stored.
    """
    del name
    nb = -(-n // q)
    nnz_pad = max(1, int(np.ceil(m / (q * q) * nnz_slack)))
    tmax = nnz_pad
    empty = np.zeros((q, q, 0), dtype=INT)
    plan = TCPlan(
        n=n,
        m=m,
        q=q,
        nb=nb,
        nnz_pad=nnz_pad,
        tmax=tmax,
        dmax=max(1, dmax_block),
        chunk=min(chunk, tmax),
        a_indptr=empty,
        a_indices=empty,
        b_indptr=empty,
        b_indices=empty,
        m_ti=empty,
        m_tj=empty,
        m_cnt=np.zeros((q, q), dtype=INT),
        stats=None,
        blocks=None,
    )
    plan._shape_only = dict(  # type: ignore[attr-defined]
        a_indptr=((q, q, nb + 1), INT),
        a_indices=((q, q, nnz_pad), INT),
        b_indptr=((q, q, nb + 1), INT),
        b_indices=((q, q, nnz_pad), INT),
        m_ti=((q, q, tmax), INT),
        m_tj=((q, q, tmax), INT),
        m_cnt=((q, q), INT),
    )
    return plan
