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
available from the packer.

Not carried over yet from the JAX package's module of the same name:
``shape_structs``, ``analytic_plan``, ``bucketize_plan``,
``resolve_broadcast`` and ``dense_blocks``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .decomp import BlockCSR, cyclic_blocks
from .graph import Graph

__all__ = [
    "TCPlan",
    "build_plan",
    "plan_from_numpy",
    "PlanStats",
    "CompactSchedule",
    "compact_live_steps",
    "as_plan",
    "resolve_step_mask",
    "resolve_compact_steps",
    "host_aug_keys",
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


def resolve_compact_steps(plan, compact) -> Optional[Tuple[int, ...]]:
    """Resolve a ``compact`` request against the plan.

    ``None`` auto-enables compaction iff the planner staged a
    :class:`CompactSchedule` that actually elides something.  An
    explicit ``True`` on a plan without one is an error.
    """
    cs = getattr(as_plan(plan), "compact", None)
    if compact is None:
        if cs is None or cs.n_elided == 0:
            return None
    elif not compact:
        return None
    else:
        if cs is None:
            raise ValueError(
                "plan carries no compacted schedule; re-plan through the "
                "pipeline with step_masks=True (or leave compact=None)"
            )
    return cs.live_steps


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
    # long/short task split from the autotune stage:
    # the first ``n_long`` tasks on every device need probes padded to
    # dmax, the rest fit in ``d_small``.  None = plan not split.
    n_long: Optional[int] = None
    d_small: Optional[int] = None
    # hub-split side; always None until the hub-split stage is ported
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


def plan_from_numpy(arrays: Dict[str, np.ndarray], meta: dict) -> TCPlan:
    """Build a :class:`TCPlan` from plain numpy arrays and Python scalars.

    ``arrays`` holds the keys of :meth:`TCPlan.device_arrays` (``a_indptr,
    a_indices, b_indptr, b_indices, m_ti, m_tj, m_cnt`` and optionally
    ``step_keep`` / ``b_aug``); ``meta`` holds ``n, m, q, nb, nnz_pad,
    tmax, dmax, chunk`` and optionally ``n_long, d_small, autotune,
    skew_perm, live_steps``.  This is how plan state made elsewhere — for
    example by the JAX package's planner — is carried into this engine:
    the caller extracts the values, this function only assembles them.
    """
    required = ("a_indptr", "a_indices", "b_indptr", "b_indices",
                "m_ti", "m_tj", "m_cnt")
    missing = [k for k in required if k not in arrays]
    if missing:
        raise ValueError(f"plan_from_numpy: missing arrays {missing}")
    q = int(meta["q"])
    for k, v in arrays.items():
        if tuple(np.shape(v)[:2]) != (q, q):
            raise ValueError(
                f"plan_from_numpy: {k} has shape {np.shape(v)}, expected "
                f"leading grid dims ({q}, {q})"
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
    skew_perm = meta.get("skew_perm")
    n_long, d_small = meta.get("n_long"), meta.get("d_small")
    autotune = meta.get("autotune")
    return TCPlan(
        n=int(meta["n"]),
        m=int(meta["m"]),
        q=q,
        nb=int(meta["nb"]),
        nnz_pad=int(meta["nnz_pad"]),
        tmax=int(meta["tmax"]),
        dmax=int(meta["dmax"]),
        chunk=int(meta["chunk"]),
        a_indptr=np.asarray(arrays["a_indptr"]),
        a_indices=np.asarray(arrays["a_indices"]),
        b_indptr=np.asarray(arrays["b_indptr"]),
        b_indices=np.asarray(arrays["b_indices"]),
        m_ti=np.asarray(arrays["m_ti"]),
        m_tj=np.asarray(arrays["m_tj"]),
        m_cnt=np.asarray(arrays["m_cnt"]),
        step_keep=None if step_keep is None else np.asarray(step_keep, bool),
        b_aug=None if arrays.get("b_aug") is None else np.asarray(arrays["b_aug"]),
        skew_perm=None if skew_perm is None else tuple(int(v) for v in skew_perm),
        compact=compact,
        autotune=None if autotune is None else dict(autotune),
        n_long=None if n_long is None else int(n_long),
        d_small=None if d_small is None else int(d_small),
    )
