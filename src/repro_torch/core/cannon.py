"""Cannon-schedule triangle counting (the paper's §5.1) on a logical grid.

Logical device ``(x, y)`` of the ``q x q`` grid starts with the pre-skewed
blocks ``A = U_{x,(x+y)%q}`` and ``B = U_{y,(x+y)%q}`` (see
:mod:`repro_torch.core.plan`) and performs ``q`` steps of {count local
pair against the static task list, shift A left, shift B up}.

This module is a thin *configuration* of :mod:`repro_torch.core.engine`:
``build_cannon_fn`` composes the CSR operand store, the
:class:`~repro_torch.core.engine.CannonSchedule`, a count kernel and a
Reduction — the schedule body lives in the engine, once.  Single pod
only: ``pod_stack_arrays`` and the 2.5D path are not carried over yet.
"""
from __future__ import annotations

from typing import Optional

from . import engine
from .engine import CannonSchedule, CSRStore, Reduction, make_csr_kernel
from .plan import as_plan, resolve_compact_steps, resolve_step_mask

__all__ = ["build_cannon_fn"]


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
):
    """Build the counting function for ``plan`` on its ``(q, q)`` grid.

    ``plan`` may be a raw :class:`~repro_torch.core.plan.TCPlan` or a
    pipeline :class:`~repro_torch.pipeline.artifact.PlanArtifact`.
    Returns a callable ``fn(**staged_arrays)`` over the plan's stacked
    tensors yielding the global triangle count (a 0-dim int64 tensor on
    the tensors' device) or the ``(q, q)`` per-device counts if
    ``reduce_global=False``.  The device is wherever the staged tensors
    live.
    ``method``: any registered CSR kernel — ``"search"`` (flat padding),
    ``"global"`` (gather-free keys), ``"fused"`` (the CUDA intersection
    kernel + long-row fallback; requires a maxfrag-split plan from
    ``autotune='fused'``).
    ``use_step_mask=None`` auto-enables sparsity-aware step skipping
    when the plan carries ``step_keep``; ``compact=None`` auto-enables
    the compacted kept-step schedule (dead-shift elision + fused
    multi-hop shifts) when the plan staged one that elides a step; the
    global kernel and the fused long-row fallback pick up planner-staged
    ``b_aug`` intersection keys when the plan carries them.
    ``double_buffer`` is accepted and gives the same count (see
    :class:`~repro_torch.core.engine.CannonSchedule`).
    """
    plan = as_plan(plan)
    use_step_mask = resolve_step_mask(plan, use_step_mask)
    live = resolve_compact_steps(plan, compact)
    schedule = CannonSchedule(
        q=plan.q, double_buffer=double_buffer, live_steps=live
    )
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
    )
    # fused consumes staged keys only in its long-row fallback — with
    # n_long == 0 carrying the aug tensor along would be pure shift bytes
    fused_wants_aug = method == "fused" and (n_long or 0) > 0
    store = CSRStore(
        kernel,
        with_aug=(
            (method == "global" or fused_wants_aug)
            and getattr(plan, "b_aug", None) is not None
        ),
    )
    return engine.build_engine_fn(
        store,
        schedule,
        m_cnt=plan.m_cnt,
        step_keep=plan.step_keep if use_step_mask else None,
        reduction=Reduction(global_sum=reduce_global, strategy=reduce_strategy),
    )
