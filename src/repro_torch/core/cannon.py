"""Cannon-schedule triangle counting (the paper's §5.1) on a logical grid.

Logical device ``(x, y)`` of the ``q x q`` grid starts with the pre-skewed
blocks ``A = U_{x,(x+y)%q}`` and ``B = U_{y,(x+y)%q}`` (see
:mod:`repro_torch.core.plan`) and performs ``q`` steps of {count local
pair against the static task list, shift A left, shift B up}.

This module is a thin *configuration* of :mod:`repro_torch.core.engine`:
``build_cannon_fn`` composes the CSR operand store, the
:class:`~repro_torch.core.engine.CannonSchedule`, a count kernel and a
Reduction — the schedule body lives in the engine, once.
``build_cannon_tile_fn`` swaps in the bit-tile store and
``build_cannon_dense_fn`` the dense oracle store; ``build_cannon_stepper``
runs the same schedule one shift a call for checkpointed runs.

Multi-pod (2.5D): with ``npods`` pods the A and B blocks are replicated
over a leading pod dimension, pod ``t`` starts at skew offset ``t``
(:func:`pod_stack_arrays`) and runs every ``npods``-th shift; the task
lists are not replicated.  Memory ×npods for A and B, shifts ÷npods.
Only the CSR path takes pods, as in the JAX package.

Every builder takes ``mesh=``: a :class:`~repro_torch.launch.mesh.DeviceMesh`
of the grid's shape (``(q, q)``, or ``(npods, q, q)`` with pods) whose
positions hold the arrays that ``PlanArtifact.staged(mesh)`` spreads over
it (:func:`cannon_in_specs`); the function then takes those arrays only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from . import engine
from .engine import (
    CannonSchedule,
    CSRStore,
    DenseStore,
    Reduction,
    TileStore,
    make_csr_kernel,
)
from .plan import as_plan, resolve_compact_steps, resolve_step_mask

__all__ = ["build_cannon_fn", "build_cannon_tile_fn", "build_cannon_dense_fn",
           "build_cannon_stepper", "cannon_in_specs", "pod_stack_arrays"]


def cannon_in_specs(row_axis: str, col_axis: str,
                    pod_axis: Optional[str] = None) -> Dict[str, Tuple[str, ...]]:
    """The mesh axes each of the plan's stacked arrays is split over, by
    name (the JAX package's partition specs): the A and B operands (and
    ``b_aug``) and the pod-strided ``step_keep`` over every axis, the task
    lists and the hub side over the grid's two, so every pod holds a
    replica of them."""
    axes = engine.GridAxes(row_axis, col_axis, pod_axis)
    specs = {k: axes.all for k in ("a_indptr", "a_indices", "b_indptr",
                                   "b_indices", "b_aug", engine.MASK_NAME)}
    specs.update({k: (axes.row, axes.col) for k in ("m_ti", "m_tj", "m_cnt")
                  + engine.HubCount.names})
    return specs


def pod_stack_arrays(arrays: Dict, npods: int, q: int) -> Dict:
    """Stack A/B operands with per-pod skew offsets (numpy, host side).

    ``A0_t[x, y] = A0[x, (y+t) % q]`` and ``B0_t[x, y] = B0[(x+t) % q, y]``
    put pod ``t`` at Cannon skew offset ``t`` so it can execute shifts
    ``t, t+npods, ...`` only.  The planner's ``step_keep`` mask is
    pod-strided the same way: pod ``t``'s local step ``s`` is global
    shift ``t + s * npods``, so its mask slice is ``step_keep[..., t::npods]``.
    Task lists and the hub side are not stacked: the mask block is
    stationary.
    """
    out = dict(arrays)
    for key in ("a_indptr", "a_indices"):
        out[key] = np.stack(
            [np.roll(arrays[key], -t, axis=1) for t in range(npods)]
        )
    for key in ("b_indptr", "b_indices", "b_aug"):
        if key not in arrays:
            continue
        out[key] = np.stack(
            [np.roll(arrays[key], -t, axis=0) for t in range(npods)]
        )
    if "step_keep" in arrays:
        out["step_keep"] = np.stack(
            [arrays["step_keep"][:, :, t::npods] for t in range(npods)]
        )
    return out


def _engine_fn(plan, store, *, reduce_global, use_step_mask, double_buffer,
               compact, reduce_strategy, batched=False, hub=None, npods=1,
               elide_shifts=False, mesh=None):
    """The engine composition shared by every ``build_cannon_*`` fn: the skip
    mask and the compacted schedule come from the CSR plan."""
    use_step_mask = resolve_step_mask(plan, use_step_mask)
    live = resolve_compact_steps(plan, compact, batched=batched, npods=npods)
    schedule = CannonSchedule(
        q=plan.q, double_buffer=double_buffer, live_steps=live, npods=npods,
        elide_shifts=elide_shifts,
    )
    return engine.build_engine_fn(
        store,
        schedule,
        m_cnt=plan.m_cnt,
        step_keep=plan.step_keep if use_step_mask else None,
        reduction=Reduction(global_sum=reduce_global, strategy=reduce_strategy),
        batched=batched,
        hub=hub,
        mesh=mesh,
    )


def _refuse_hub(plan, message):
    """The tile and dense paths stage arrays of their own and have no slot
    for the hub-split partial: refuse a hub plan loudly."""
    if getattr(plan, "hub", None) is not None:
        raise ValueError(message)


def build_cannon_fn(
    plan,
    *,
    method: str = "search",
    probe_shorter: bool = True,
    reduce_global: bool = True,
    use_step_mask: Optional[bool] = None,
    double_buffer: bool = True,
    compact: Optional[bool] = None,
    reduce_strategy: str = "auto",
    batched: bool = False,
    npods: int = 1,
    fused_tile: Optional[int] = None,
    use_blob: bool = True,
    compress_lengths: bool = False,
    elide_shifts: bool = False,
    mesh=None,
):
    """Build the counting function for ``plan`` on its ``(q, q)`` grid, or
    on the ``(npods, q, q)`` grid of ``npods`` 2.5D pods.  With ``mesh``
    (a :class:`~repro_torch.launch.mesh.DeviceMesh` of that shape) it
    counts the arrays ``PlanArtifact.staged(mesh)`` spread over the mesh.

    ``plan`` may be a raw :class:`~repro_torch.core.plan.TCPlan` or a
    pipeline :class:`~repro_torch.pipeline.artifact.PlanArtifact`.
    Returns a callable ``fn(**staged_arrays)`` over the plan's stacked
    tensors yielding the global triangle count (a 0-dim int64 tensor on
    the tensors' device) or the ``(q, q)`` per-device counts if
    ``reduce_global=False``.  The device is wherever the staged tensors
    live.
    ``method``: any registered CSR kernel — ``"search"`` (flat padding),
    ``"search2"`` (gather-free keys in two length buckets; requires a
    split plan from ``bucketize=True`` or the autotune stage),
    ``"global"`` (gather-free keys), ``"fused"`` (the CUDA intersection
    kernel, one launch a device-step over both buckets; requires a
    maxfrag-split plan from ``autotune='fused'``).
    ``use_step_mask=None`` auto-enables sparsity-aware step skipping
    when the plan carries ``step_keep``; ``compact=None`` auto-enables
    the compacted kept-step schedule (dead-shift elision + fused
    multi-hop shifts) when the plan staged one that elides a step; the
    global and search2 kernels pick up planner-staged ``b_aug``
    intersection keys when the plan carries them (no other method reads
    them, so none carries them along).
    ``double_buffer`` picks the body on a mesh — step ``s + 2``'s shift
    issued before step ``s`` counts, or step ``s + 1``'s — and gives the
    same count (see :class:`~repro_torch.core.engine.CannonSchedule`).  A
    hub-split plan
    adds its hub partial (:class:`~repro_torch.core.engine.HubCount`,
    the plain search whatever ``method`` counts the residual).
    ``batched=True`` builds the multi-graph function of
    :mod:`repro_torch.pipeline.batch` (``plan.m_cnt`` / ``step_keep``
    then carry the leading batch dimension).
    ``npods > 1`` runs the 2.5D schedule over tensors staged by
    :func:`pod_stack_arrays` (``npods`` must divide ``q``; compaction is
    off unless refused by ``compact=True``); ``reduce_strategy`` picks the
    final sum: ``"flat"``, ``"tree"`` (joint grid sum, then the binomial
    tree over the pods; needs a power-of-two pod count > 1) or ``"auto"``
    (tree whenever it applies).  ``fused_tile`` overrides the fused
    kernel's tile (the measured autotune passes its table's best).
    ``use_blob`` (default on) shifts each operand as one blob packed at
    every count; ``compress_lengths`` ships the rows' lengths as uint16
    pairs in the blob instead of the int32 indptr (needs ``use_blob`` and
    ``plan.dmax < 65536``).  ``elide_shifts`` is a timing probe (counts
    are wrong for q > 1): ``tc_run --time-split``'s count-only run.
    """
    plan = as_plan(plan)
    if method == "fused":
        engine.check_fused_split(plan)
    n_long = getattr(plan, "n_long", None)
    kernel = make_csr_kernel(
        method,
        dpad=plan.dmax,
        chunk=plan.chunk,
        probe_shorter=probe_shorter,
        n_long=n_long,
        d_small=getattr(plan, "d_small", None),
        fused_tile=fused_tile,
    )
    store = CSRStore(
        kernel,
        use_blob=use_blob,
        compress_lengths=compress_lengths,
        dmax=plan.dmax,
        with_aug=(method in ("global", "search2")
                  and getattr(plan, "b_aug", None) is not None),
    )
    return _engine_fn(
        plan, store, reduce_global=reduce_global, use_step_mask=use_step_mask,
        double_buffer=double_buffer, compact=compact,
        reduce_strategy=reduce_strategy, batched=batched,
        hub=engine.HubCount.from_plan(plan, probe_shorter=probe_shorter),
        npods=npods, elide_shifts=elide_shifts, mesh=mesh,
    )


def build_cannon_stepper(
    plan,
    mesh=None,
    *,
    method: str = "search",
    probe_shorter: bool = True,
    use_step_mask: Optional[bool] = None,
    double_buffer: bool = True,
    compact: Optional[bool] = None,
):
    """Shift-at-a-time Cannon for fault-tolerant runs.

    Returns ``one_shift(state, statics, step=s) -> state``
    (:func:`~repro_torch.core.engine.build_engine_stepper`) where ``state
    = (*carry, partial_counts)`` and ``partial_counts`` is the ``(q, q)``
    int64 per-device accumulator.  With the default double-buffered
    schedule the carry is two payload generations ``(a_indptr, a_indices,
    b_indptr, b_indices) x 2`` (``one_shift.n_carry == 8``), built once
    from the staged plan tensors by ``one_shift.prime`` (which issues the
    prologue shift); with ``double_buffer=False`` it is one (4 tensors).
    The host loop owns the shift index, checkpointing state between
    shifts so a restarted job resumes mid-loop.  Same store, schedule and
    kernel as :func:`build_cannon_fn` — only the loop owner differs.

    With a compacted plan (``compact=None`` auto) the host loop iterates
    ``one_shift.live_steps`` only — still passing original step indices,
    so checkpointed indices round-trip unchanged — and the carry is a
    *single* payload generation (4 tensors): each call's fused multi-hop
    shift lands exactly on the next live step, so there is no in-flight
    second buffer to keep.

    As in the JAX package the kernel is bound without the plan's bucket
    split, so ``method="search2"`` and ``method="fused"`` raise, and a
    hub-split plan is refused (the stepper has no slot for its partial).
    The carry holds the unpacked arrays (no blob, as in the JAX package),
    so either package loads the other's checkpoints.

    With ``mesh`` (a ``(q, q)`` :class:`~repro_torch.launch.mesh.DeviceMesh`)
    the stepper runs over the arrays ``PlanArtifact.staged(mesh)`` spreads
    over it, as the JAX package's runs over its mesh: the carry and
    ``partial_counts`` are mesh arrays, each position's blocks and its
    0-dim partial on its device, and each shift copies the blocks between
    positions.  They hold, position by position, the one-device stepper's
    values.
    """
    plan = as_plan(plan)
    if getattr(plan, "hub", None) is not None:
        raise ValueError(
            "the checkpointed stepper counts one schedule shift at a "
            "time and has no slot for the hub-split partial; plan with "
            "hub_split=False for fault-tolerant runs"
        )
    use_step_mask = resolve_step_mask(plan, use_step_mask)
    live = resolve_compact_steps(plan, compact)
    schedule = CannonSchedule(
        q=plan.q, double_buffer=double_buffer and live is None,
        live_steps=live,
    )
    kernel = make_csr_kernel(
        method, dpad=plan.dmax, chunk=plan.chunk, probe_shorter=probe_shorter,
    )
    return engine.build_engine_stepper(
        CSRStore(kernel, use_blob=False), schedule, m_cnt=plan.m_cnt,
        step_keep=plan.step_keep if use_step_mask else None, mesh=mesh,
    )


def build_cannon_tile_fn(
    plan,
    *,
    mode: str = "popcount",
    reduce_global: bool = True,
    use_step_mask: Optional[bool] = None,
    double_buffer: bool = True,
    compact: Optional[bool] = None,
    reduce_strategy: str = "auto",
    mesh=None,
):
    """Cannon schedule with the bit-tile kernels as the count path.

    Returns ``fn(**staged)`` over the tile plan's tensors
    (:func:`~repro_torch.core.tiles.stage_tile_plan`).  Tile stores shift
    exactly like the CSR blocks; the per-(device, shift) active-triple
    lists are static (planner-joined) and selected by the ORIGINAL step
    index, also under a compacted schedule.  ``mode`` is ``"popcount"``
    or ``"mxu"`` (same count).  With ``mesh`` (a ``(q, q)``
    :class:`~repro_torch.launch.mesh.DeviceMesh`) it counts the tile
    arrays staged over it, each position's kernel on its device.  The skip mask and the compaction come from
    the *CSR* plan.  Unlike the JAX package's, it takes no tile plan: the
    tile shapes travel with the staged tensors.  A hub-split plan is
    refused.
    """
    plan = as_plan(plan)
    _refuse_hub(
        plan,
        "the bit-tile path stages its own arrays and would drop the "
        "hub-split partial; plan with hub_split=False for method "
        "'tile'",
    )
    return _engine_fn(
        plan, TileStore(mode=mode), reduce_global=reduce_global,
        use_step_mask=use_step_mask, double_buffer=double_buffer,
        compact=compact, reduce_strategy=reduce_strategy, mesh=mesh,
    )


def build_cannon_dense_fn(
    plan,
    *,
    reduce_global: bool = True,
    use_step_mask: Optional[bool] = None,
    double_buffer: bool = True,
    compact: Optional[bool] = None,
    reduce_strategy: str = "auto",
    mesh=None,
):
    """Dense-operand Cannon (oracle path): blocks as 0/1 float32 matrices
    (``plan.dense_blocks()`` staged), counted by ``torch.matmul``.  A
    hub-split plan is refused.  ``mesh`` as for :func:`build_cannon_tile_fn`
    (a ``(q, q)`` mesh)."""
    plan = as_plan(plan)
    _refuse_hub(
        plan,
        "the dense oracle path stages its own blocks and would drop "
        "the hub-split partial; plan with hub_split=False for "
        "method 'dense'",
    )
    return _engine_fn(
        plan, DenseStore(), reduce_global=reduce_global,
        use_step_mask=use_step_mask, double_buffer=double_buffer,
        compact=compact, reduce_strategy=reduce_strategy, mesh=mesh,
    )
