"""Top-level triangle-counting API.

``count_triangles(graph, q=...)`` runs the full pipeline of the paper:
host planning (ingest → relabel → decompose → pack → stage, cached) ->
schedule -> global count, on a logical ``q x q`` grid held on one device
(including a 1x1 grid).  The bundled runner plans through
:mod:`repro_torch.pipeline`, so repeated counts of an already-seen graph
hit the content-addressed plan cache and skip planning and staging.

The count runs on the GPU unless the caller asks for the CPU:
``device=None`` resolves to ``cuda`` and raises where there is none
(:mod:`repro_torch.device`).

Schedules resolve via a registry: :func:`register_schedule` makes a new
schedule one registration away — the bundled one is ``cannon`` (the
paper).  The per-block count path is selected with ``method`` (any
registered CSR kernel: ``search``, ``global``, ``fused``).  Runners
receive the *raw* graph plus the relabel options on the
:class:`RunContext` (``reorder``/``cyclic_p``) — relabeling happens
inside the pipeline so the cache can skip it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from . import cannon as cannon_mod
from .engine import CSR_KERNELS
from .graph import Graph
from .plan import TCPlan

__all__ = [
    "TCResult",
    "RunContext",
    "check_count_overflow",
    "count_triangles",
    "register_schedule",
    "get_schedule",
    "available_schedules",
]

_INT32_MAX = 2**31 - 1


def check_count_overflow(total: int, count_dtype) -> int:
    """Validate a final triangle count against a requested ``count_dtype``.

    Counts are accumulated in int64 throughout; a caller that forces
    ``torch.int32`` is asking for a count that fits it, so a total that
    does not is an error, never a wrapped value.  Returns ``total``
    unchanged when it fits.
    """
    if count_dtype == torch.int32 and (total < 0 or total >= _INT32_MAX):
        raise OverflowError(
            f"triangle count {total} does not fit the requested int32 "
            "count dtype; pass count_dtype=torch.int64 (the default)"
        )
    return total


@dataclasses.dataclass
class TCResult:
    triangles: int
    plan: TCPlan
    preprocess_seconds: float
    count_seconds: float
    method: str
    schedule: str
    grid: tuple
    device: str = "cpu"
    # which autotune flavor governed kernel-shape selection for this run
    # ("percentile"; None when no autotune stage ran)
    autotune_mode: Optional[str] = None
    # the PlanArtifact this count ran from (None for caller-supplied raw
    # plans or schedules registered without plans_itself)
    artifact: Optional[object] = None


# ----------------------------------------------------------------------
# schedule registry
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """One registered schedule: how to plan and how to run.

    ``runner(graph, grid, ctx) -> (total, plan)`` does planning + tensor
    staging + engine-fn build + execution; ``grid`` is the ``(q, q)``
    shape and ``ctx`` the :class:`RunContext` of the current
    ``count_triangles`` call.  ``build_fn`` exposes the function that
    builds the raw engine fn.

    ``plans_itself`` marks runners that route the *raw* graph through
    :mod:`repro_torch.pipeline` themselves (reading ``ctx.reorder`` /
    ``ctx.cyclic_p`` / ``ctx.cache``), which is what lets cache hits
    skip the relabel too.  Runners registered without it get the
    already-relabeled graph.
    """

    name: str
    runner: Callable
    build_fn: Optional[Callable] = None
    plans_itself: bool = False


@dataclasses.dataclass
class RunContext:
    q: int
    method: str
    chunk: int
    probe_shorter: bool
    device: torch.device
    plan: Optional[TCPlan] = None
    # engine knobs: sparsity-aware step skipping (None = auto from the
    # plan's staged masks), the double-buffer knob (same count either
    # way), and schedule compaction (None = auto from the plan's staged
    # live list)
    use_step_mask: Optional[bool] = None
    double_buffer: bool = True
    compact: Optional[bool] = None
    reduce_strategy: str = "auto"
    # pipeline options: runners plan the *raw* graph through
    # repro_torch.pipeline with these, so cache hits skip the relabel too
    reorder: bool = True
    cyclic_p: Optional[int] = None
    cache: Optional[object] = None  # PlanCache; None -> default_cache()
    # resolved reporting fields (land on TCResult)
    autotune_mode: Optional[str] = None
    artifact: Optional[object] = None  # PlanArtifact set by the runner
    # set via mark_counting(): host-side planning/staging before this
    # point is reported as preprocess time, not count time
    counting_started_at: Optional[float] = None

    def mark_counting(self) -> None:
        """Host planning/staging is done; counting starts now."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.counting_started_at = time.perf_counter()

    def memo(self, key, build: Callable):
        """Per-artifact build-once helper (falls through when the runner
        has no artifact, e.g. a caller-supplied plan)."""
        if self.artifact is None:
            return build()
        return self.artifact.memo(key, build)


_SCHEDULES: Dict[str, ScheduleSpec] = {}


def register_schedule(
    name: str,
    runner: Callable,
    *,
    build_fn: Optional[Callable] = None,
    plans_itself: bool = False,
) -> None:
    """Register a schedule; ``count_triangles(..., schedule=name)`` then
    resolves to ``runner``.  Overwrites any previous registration."""
    _SCHEDULES[name] = ScheduleSpec(
        name=name, runner=runner, build_fn=build_fn, plans_itself=plans_itself
    )


def get_schedule(name: str) -> ScheduleSpec:
    try:
        return _SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown schedule {name!r}; registered: {available_schedules()}"
        ) from None


def available_schedules():
    return sorted(_SCHEDULES)


# ----------------------------------------------------------------------
# bundled schedule runner
# ----------------------------------------------------------------------
def _run_cannon(graph: Graph, grid, ctx: RunContext):
    if ctx.method not in CSR_KERNELS:
        raise ValueError(
            f"unknown count method {ctx.method!r} for the cannon schedule; "
            f"registered: {sorted(CSR_KERNELS)}"
        )
    plan = ctx.plan  # a caller-supplied plan is already relabeled and
    if plan is None:  # wins over the pipeline (reorder/cyclic_p unused)
        from ..pipeline import plan_cannon

        def plan_with(aug: bool):
            return plan_cannon(
                graph,
                ctx.q,
                chunk=ctx.chunk,
                reorder=ctx.reorder,
                cyclic_p=ctx.cyclic_p,
                keep_blocks=False,
                compact=ctx.compact is not False,
                # the fused kernel needs the two-sided maxfrag split
                autotune="fused" if ctx.method == "fused" else False,
                aug_keys=aug,
                cache=ctx.cache,
            )

        ctx.artifact = plan_with(ctx.method == "global")
        plan = ctx.artifact.plan
        if ctx.method == "fused":
            ctx.autotune_mode = "percentile"
            if (plan.n_long or 0) > 0:
                # only the long-row fallback consumes staged keys: re-plan
                # with them (deterministic, so only aug differs; its own
                # cache entry serves repeat counts warm), but skip it
                # entirely on kernel-only plans (n_long == 0)
                ctx.artifact = plan_with(True)
                plan = ctx.artifact.plan

    if ctx.artifact is not None:
        staged = ctx.artifact.staged(ctx.device)
    else:
        from ..pipeline.artifact import stage_arrays

        staged = stage_arrays(plan.device_arrays(), ctx.device)
    fn = ctx.memo(
        ("fn", ctx.method, ctx.probe_shorter, ctx.use_step_mask,
         ctx.double_buffer, ctx.compact, ctx.reduce_strategy),
        lambda: cannon_mod.build_cannon_fn(
            plan,
            method=ctx.method,
            probe_shorter=ctx.probe_shorter,
            use_step_mask=ctx.use_step_mask,
            double_buffer=ctx.double_buffer,
            compact=ctx.compact,
            reduce_strategy=ctx.reduce_strategy,
        ),
    )
    ctx.mark_counting()
    # the one device→host crossing of a count
    return int(fn(**staged)), plan


register_schedule(
    "cannon", _run_cannon, build_fn=cannon_mod.build_cannon_fn,
    plans_itself=True,
)


# ----------------------------------------------------------------------
# top-level entry point
# ----------------------------------------------------------------------
def count_triangles(
    graph: Graph,
    *,
    q: Optional[int] = None,
    method: str = "search",
    schedule: str = "cannon",
    probe_shorter: bool = True,
    chunk: int = 512,
    reorder: bool = True,
    cyclic_p: Optional[int] = None,
    count_dtype=None,
    plan: Optional[TCPlan] = None,
    use_step_mask: Optional[bool] = None,
    double_buffer: bool = True,
    compact: Optional[bool] = None,
    reduce_strategy: str = "auto",
    cache=None,
    autotune: str = "percentile",
    device=None,
) -> TCResult:
    """Count triangles with the paper's 2D algorithm.

    ``q`` is the logical grid dimension (default 1: degenerate but the
    identical code path); the whole ``q x q`` grid lives on ``device``.
    ``device=None`` means the current CUDA device and raises when there
    is none; pass ``device="cpu"`` to run on the CPU.
    ``schedule`` resolves via the registry (see
    :func:`available_schedules`); ``method`` picks the count kernel
    (``"search"``, ``"global"``, ``"fused"``).  ``method="fused"`` runs
    the hand-written CUDA intersection kernel with its long-row fallback
    — planning switches to the two-sided maxfrag autotune split it
    requires.
    ``cyclic_p`` enables the paper's initial cyclic redistribution
    (§5.3 step 1) as the pipeline's first relabel stage.
    ``use_step_mask`` controls sparsity-aware step skipping (None =
    auto: on when the plan staged ``step_keep`` masks; False forces the
    unmasked engine); ``compact`` controls the compacted kept-step
    schedule (None = auto: on when the planner's compaction stage elided
    a step; False keeps the full loop); ``double_buffer`` is accepted
    and gives the same count.  Planning goes through the
    content-addressed plan cache (``cache=None`` uses the process-wide
    default — pass a ``repro_torch.pipeline.PlanCache`` to isolate, or
    one with ``maxsize=0`` to disable): repeated counts of an
    already-seen graph skip relabel/plan/stage entirely.

    Counts are exact: accumulation is int64 everywhere and
    ``TCResult.triangles`` is a Python ``int``.  ``count_dtype`` may be
    ``torch.int32`` to demand a count that fits 32 bits — one that does
    not raises ``OverflowError``.  ``autotune`` must be ``"percentile"``
    (the measured-table mode is not carried over yet).
    """
    if autotune != "percentile":
        raise ValueError(
            f"unknown autotune mode {autotune!r}: only 'percentile' is "
            "available in repro_torch (the measured mode is not ported yet)"
        )
    if count_dtype is None:
        count_dtype = torch.int64
    if count_dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"count_dtype must be torch.int32 or torch.int64, got {count_dtype}"
        )
    device = resolve_device(device)
    artifact = None
    if plan is not None and hasattr(plan, "staged") and hasattr(plan, "plan"):
        # a PlanArtifact supplied as the plan: run its plan and reuse its
        # staged device tensors / fn memos
        artifact = plan
        plan = artifact.plan
    t0 = time.perf_counter()
    if plan is not None:
        q = plan.q
    q = q or 1

    spec = get_schedule(schedule)
    if not spec.plans_itself and (reorder or cyclic_p is not None):
        # runner contract without plans_itself: hand it the relabeled graph
        from ..pipeline import relabel_stage

        graph, _ = relabel_stage(graph, reorder=reorder, cyclic_p=cyclic_p)
        reorder, cyclic_p = False, None
    ctx = RunContext(
        q=q,
        method=method,
        chunk=chunk,
        probe_shorter=probe_shorter,
        device=device,
        plan=plan,
        use_step_mask=use_step_mask,
        double_buffer=double_buffer,
        compact=compact,
        reduce_strategy=reduce_strategy,
        reorder=reorder,
        cyclic_p=cyclic_p,
        cache=cache,
    )
    if artifact is not None:
        ctx.artifact = artifact
    total, out_plan = spec.runner(graph, (q, q), ctx)
    total = check_count_overflow(total, count_dtype)
    t2 = time.perf_counter()
    # host-side planning/staging counts as preprocessing (paper's ppt);
    # counting starts at the runner's mark and ends after the total has
    # crossed back to the host (which synchronises the device)
    t1 = ctx.counting_started_at or t0

    return TCResult(
        triangles=total,
        plan=out_plan,
        preprocess_seconds=t1 - t0,
        count_seconds=t2 - t1,
        method=ctx.method,
        schedule=schedule,
        grid=(q, q),
        device=str(device),
        autotune_mode=ctx.autotune_mode,
        artifact=ctx.artifact,
    )
