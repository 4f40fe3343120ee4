"""Top-level triangle-counting API.

``count_triangles(graph, q=...)`` runs the full pipeline of the paper:
host planning (ingest → relabel → decompose → pack → stage, cached) ->
schedule -> global count, on a logical grid held on one device (including
a 1x1 grid).  The bundled runners plan through :mod:`repro_torch.pipeline`,
so repeated counts of an already-seen graph hit the content-addressed plan
cache and skip planning and staging.

The count runs on the GPU unless the caller asks for the CPU:
``device=None`` resolves to ``cuda`` and raises where there is none
(:mod:`repro_torch.device`).

Schedules resolve via a registry: :func:`register_schedule` makes a new
schedule one registration away — the bundled ones are ``cannon`` (the
paper), ``summa`` (rectangular ``r x c`` grids) and ``oned`` (the 1D ring
baseline over ``p = r * c`` devices).  The per-block count path is
selected with ``method``: any registered CSR kernel (``search``,
``search2``, ``global``, ``fused``), ``auto`` (resolved from the plan's
autotune report), and on Cannon also the bit-tile kernels (``tile``) or
the dense oracle path (``dense``).  Runners
receive the *raw* graph plus the relabel options on the
:class:`RunContext` (``reorder``/``cyclic_p``) and the planner stages
(``rebalance_trials``/``hub_split``) — relabeling happens inside the
pipeline so the cache can skip it.  ``count_triangles_many`` batches
several graphs into one engine call; ``count_triangles_delta`` re-counts
a graph after a batch of edge edits through the delta ladder of
:mod:`repro_torch.pipeline.delta`.  ``npods`` adds the 2.5D pod
dimension (Cannon's replicated, skew-offset blocks) and
``reduce_strategy`` its tree reduction; ``autotune="measured"`` resolves
``method="auto"`` from the persisted timing table of
:mod:`repro_torch.kernels.tc_fused.autotune`.

``count_triangles(graph, mesh=make_grid_mesh(q, ...))`` spreads the grid
over a device mesh instead, as the JAX package's ``shard_map`` does: each
grid position's blocks lie on its device and shifts, broadcasts and the
reduction copy between devices (:mod:`repro_torch.core.engine`).  One
process drives every device of the mesh.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import torch

from ..device import resolve_device
from ..launch.mesh import DeviceMesh
from . import cannon as cannon_mod
from .engine import CSR_KERNELS, RingAxes
from .graph import Graph
from .onedim import OneDPlan, build_oned_fn
from .plan import TCPlan
from .summa import SummaPlan, build_summa_fn

__all__ = [
    "TCResult",
    "RunContext",
    "check_count_overflow",
    "count_triangles",
    "count_triangles_delta",
    "count_triangles_many",
    "make_grid_mesh",
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


def make_grid_mesh(q: int, row_axis="data", col_axis="model", npods=1,
                   pod_axis="pod", devices=None) -> DeviceMesh:
    """A ``q x q`` (with pods ``npods x q x q``) device mesh, axes
    ``(row_axis, col_axis)`` (``(pod_axis, row_axis, col_axis)``).

    ``devices=None`` takes the first ``q² · npods`` CUDA devices and raises
    when there is no CUDA device or fewer than that; an explicit list (the
    first ``q² · npods`` of it are used, in row-major grid order) may repeat
    a device — ``["cpu"] * n`` puts a mesh on the CPU, ``["cuda:0"] * 16``
    a 4 x 4 grid on one card."""
    q, npods = int(q), int(npods)
    if q < 1 or npods < 1:
        raise ValueError(f"q and npods must be >= 1, got q={q} npods={npods}")
    n = q * q * npods
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_grid_mesh(devices=None) takes CUDA devices and none is "
                "available; pass devices=['cpu'] * n for a CPU mesh")
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(f"need {n} devices, have {have}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    if npods > 1:
        return DeviceMesh((npods, q, q), (pod_axis, row_axis, col_axis),
                          tuple(devices[:n]))
    return DeviceMesh((q, q), (row_axis, col_axis), tuple(devices[:n]))


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
    # ("percentile" | "measured"; None when the method was explicit and no
    # autotune stage ran)
    autotune_mode: Optional[str] = None
    # measured mode only: did the shape-bucket entry come off disk?
    measured_table_hit: Optional[bool] = None
    # the PlanArtifact this count ran from (None for caller-supplied raw
    # plans or schedules registered without plans_itself)
    artifact: Optional[object] = None
    # skip-aware rebalance search report (set when rebalance_trials > 0
    # planned the artifact): trial history, best seed, baseline/best
    # masked critical path, skipped steps
    rebalance: Optional[dict] = None
    # hub-split report when the plan carries a hub side: h0 / hub_rows /
    # hub_nnz / hub_nnz_frac / hub_tasks / hub_dpad plus residual_mcp (the
    # residual plan's masked critical path; None when no stats were kept)
    hub: Optional[dict] = None
    # apply_delta report (level, dirty blocks/cells, replanned stages,
    # rebased, fn_inherited) when the count came through
    # count_triangles_delta; ``artifact`` is then the derived artifact,
    # to thread into the next count_triangles_delta call
    delta: Optional[dict] = None
    # supervised_count's record (attempts, restarts, demotions, regrids,
    # gave_up, total_backoff_seconds, the fault plan's fault_log)
    supervision: Optional[dict] = None


# ----------------------------------------------------------------------
# schedule registry
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """One registered schedule: how to plan and how to run.

    ``runner(graph, grid, ctx) -> (total, plan)`` does planning + tensor
    staging + engine-fn build + execution; ``grid`` is the grid shape —
    ``(q, q)``, the caller's ``grid=(r, c)``, or the shape a
    caller-supplied plan was made for — and ``ctx`` the
    :class:`RunContext` of the current ``count_triangles`` call.  ``build_fn`` exposes the function that
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
    npods: int = 1
    plan: Optional[TCPlan] = None
    # the device mesh the grid is spread over (None: all on ``device``,
    # which is then the mesh's first device)
    mesh: Optional[DeviceMesh] = None
    # engine knobs: sparsity-aware step skipping (None = auto from the
    # plan's staged masks), the double-buffer knob (same count either
    # way), and schedule compaction (None = auto from the plan's staged
    # live list)
    use_step_mask: Optional[bool] = None
    double_buffer: bool = True
    compact: Optional[bool] = None
    reduce_strategy: str = "auto"
    # SUMMA's panel-broadcast strategy (None = the plan's own)
    broadcast: Optional[str] = None
    # pipeline options: runners plan the *raw* graph through
    # repro_torch.pipeline with these, so cache hits skip the relabel too
    reorder: bool = True
    cyclic_p: Optional[int] = None
    # skip-aware rebalance: search this many relabeling seeds (0 = off)
    rebalance_trials: int = 0
    # hub-split stage: False = off, True = the default threshold, a
    # number = the threshold multiplier c
    hub_split: object = False
    cache: Optional[object] = None  # PlanCache; None -> default_cache()
    # autotune flavor for method 'auto'/'fused': "percentile" = the
    # analytic stage; "measured" = consult (and populate) the persisted
    # timing table keyed per shape bucket
    autotune: str = "percentile"
    measured_dir: Optional[str] = None  # measured-table dir override
    # fused-kernel tile override (measured mode feeds the table's best
    # shape through here)
    fused_tile: Optional[int] = None
    # resolved reporting fields (land on TCResult)
    autotune_mode: Optional[str] = None
    measured_table_hit: Optional[bool] = None
    artifact: Optional[object] = None  # PlanArtifact set by the runner
    # set via mark_counting(): host-side planning/staging before this
    # point is reported as preprocess time, not count time
    counting_started_at: Optional[float] = None

    def mark_counting(self, plan=None) -> None:
        """Host planning/staging is done; counting starts now.  Also the
        fault-injection window for this count: ``device_stage`` fires
        here, and with a ``plan`` each live original step index fires a
        ``step`` point before the first dispatch — so a fault armed at an
        elided step never fires, composing with schedule compaction."""
        from ..runtime import faultinject

        if faultinject.is_armed():
            faultinject.fire("device_stage")
            if plan is not None:
                compacted = self.compact is not False
                for s in faultinject.live_step_indices(plan, compacted):
                    faultinject.fire("step", step=s)
        self.synchronize()
        self.counting_started_at = time.perf_counter()

    def synchronize(self) -> None:
        """Wait for the run's device, or every CUDA device of its mesh."""
        devices = self.mesh.devices if self.mesh is not None else [self.device]
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def grid_mesh(self):
        """The mesh a schedule without a pod dimension runs on: pod 0's
        grid of a pod mesh (as on one device, SUMMA, ``tile`` and
        ``dense`` count as on one pod), else the run's mesh."""
        m = self.mesh
        return m.pod(0) if m is not None and len(m.shape) == 3 else m

    def key(self, *parts):
        """A memo key, with the mesh last where the run has one."""
        return parts + ((self.mesh,) if self.mesh is not None else ())

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
# count paths that stage arrays of their own, derived from the CSR plan
_DERIVED_METHODS = ("tile", "dense")


def _count_derived(plan, ctx: RunContext):
    """The tile and dense paths: their own arrays, derived from the CSR
    plan, are built, staged and memoised on the artifact before the count
    starts (they are planning).  ``tile`` packs the blocks into bit tiles
    and joins the tile triples; ``dense`` expands the blocks to
    ``(q, q, nb, nb)`` float32 (small graphs only)."""
    from ..pipeline.artifact import stage_arrays
    from .tiles import build_tile_plan, stage_tile_plan

    def timed(name, build):
        t0 = time.perf_counter()
        out = build()
        ctx.synchronize()
        if ctx.artifact is not None:
            ctx.artifact.stage_seconds[name] = time.perf_counter() - t0
        return out

    knobs = dict(use_step_mask=ctx.use_step_mask,
                 double_buffer=ctx.double_buffer, compact=ctx.compact)
    # neither path has a pod dimension (pods would replicate whole
    # rounds); as in the JAX package's runner the tile path sums flat
    # whatever reduce_strategy says, and the dense path takes it (so it
    # refuses "tree")
    mesh = ctx.grid_mesh()
    where = mesh if mesh is not None else ctx.device
    if ctx.method == "tile":
        tp = ctx.memo("tile_plan", lambda: timed(
            "tile_plan", lambda: build_tile_plan(plan)))
        staged = ctx.memo(ctx.key("tile_staged", str(ctx.device)),
                          lambda: timed("tile_stage",
                                        lambda: stage_tile_plan(tp, where)))
        build = lambda: cannon_mod.build_cannon_tile_fn(plan, mesh=mesh,
                                                        **knobs)
    else:
        knobs["reduce_strategy"] = ctx.reduce_strategy
        staged = ctx.memo(ctx.key("dense_staged", str(ctx.device)), lambda: (
            stage_arrays(plan.dense_blocks(), where)))
        build = lambda: cannon_mod.build_cannon_dense_fn(plan, mesh=mesh,
                                                         **knobs)
    fn = ctx.memo(ctx.key(ctx.method + "_fn", *knobs.values()), build)
    ctx.mark_counting(plan)
    return int(fn(**staged)), plan


def _resolve_auto_method(plan, fallback: str = "search") -> str:
    """Resolve ``method='auto'`` from the plan's autotune report:
    ``search2`` when the probe-length tail is heavy (and the plan
    carries the two-level split), plain ``search`` otherwise."""
    at = getattr(plan, "autotune", None)
    if (
        at
        and at.get("tail_heavy")
        and getattr(plan, "n_long", None) is not None
    ):
        return "search2"
    return fallback


def _consult_measured(ctx: RunContext, plan) -> dict:
    """Measured-autotune table lookup for a maxfrag-split plan: records
    ``autotune_mode``/``measured_table_hit`` on the context and returns
    the entry (timing it into the table on a miss — the one-time cost
    measured mode trades for shape-bucket-warm later runs)."""
    from ..kernels.tc_fused import measured_entry

    entry, hit = measured_entry(plan, device=ctx.device,
                                table_dir=ctx.measured_dir)
    ctx.autotune_mode = "measured"
    ctx.measured_table_hit = hit
    return entry


def _resolve_measured(ctx: RunContext, plan, fallback: Callable[[], str]):
    """``method`` ``auto`` or ``fused`` under ``autotune="measured"``:
    ``fused`` takes the table entry's best tile; ``auto`` becomes ``fused``
    with it where the table's verdict is the fused kernel, else
    ``fallback()`` (the schedule's percentile resolution)."""
    from ..kernels.tc_fused import predict_fused_wins

    entry = _consult_measured(ctx, plan)
    if ctx.method == "fused" or predict_fused_wins(entry):
        ctx.method = "fused"
        ctx.fused_tile = entry["best"]["tile"]
    else:
        ctx.method = fallback()


def _fused_split(ctx: RunContext) -> bool:
    """Plan with the two-sided maxfrag split: the fused kernel needs it,
    and the measured table is only defined over such plans, so
    ``method="auto"`` under measured mode plans the same way."""
    return ctx.method == "fused" or (
        ctx.method == "auto" and ctx.autotune == "measured"
    )


def _check_plan_kind(plan, cls, schedule: str) -> None:
    if not isinstance(plan, cls):
        raise ValueError(
            f"the {schedule} schedule runs a {cls.__name__}, got "
            f"{type(plan).__name__}"
        )


_PLAN_KINDS = {TCPlan: "cannon", SummaPlan: "summa", OneDPlan: "oned"}


def _staged(plan, ctx: RunContext, mesh=None):
    """The plan's tensors on the run's device, or spread over ``mesh``:
    the artifact's memoised copy, or a fresh one for a caller-supplied raw
    plan."""
    where = mesh if mesh is not None else ctx.device
    if ctx.artifact is not None:
        return ctx.artifact.staged(where)
    from ..pipeline.artifact import mesh_layout, stage_arrays

    if mesh is None:
        return stage_arrays(plan.device_arrays(), ctx.device)
    host, specs = mesh_layout(_PLAN_KINDS[type(plan)], plan.device_arrays(),
                              mesh)
    return stage_arrays(host, mesh, specs=specs)


def _pod_staged(plan, ctx: RunContext):
    """The plan's tensors with A and B stacked over ``ctx.npods`` pods
    (:func:`~repro_torch.core.cannon.pod_stack_arrays`) on the run's
    device, memoised per (pod count, device).  The single-pod A and B are
    never staged for it.  The arrays that are not stacked (task lists,
    task counts, hub side) are the single-pod tensors where the artifact
    already staged them on this device, else uploaded once for the pod
    count.  The stacked ``step_keep`` stays on the host, where the engine
    reads it.  The first call's seconds land in the artifact's
    ``stage_seconds["pod_stage_<npods>"]``."""
    from ..pipeline.artifact import stage_arrays

    # outside the memo: the artifact's memo lock is not reentrant
    single = (None if ctx.artifact is None
              else ctx.artifact.staged_if_any(ctx.device)) or {}

    def build():
        t0 = time.perf_counter()
        host = plan.device_arrays()
        pods = cannon_mod.pod_stack_arrays(host, ctx.npods, plan.q)
        pods.pop("step_keep", None)
        fresh = stage_arrays(
            {k: v for k, v in pods.items()
             if v is not host[k] or k not in single}, ctx.device)
        out = {k: fresh[k] if k in fresh else single[k] for k in pods}
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        if ctx.artifact is not None:
            ctx.artifact.stage_seconds[f"pod_stage_{ctx.npods}"] = (
                time.perf_counter() - t0)
        return out

    return ctx.memo(("pod_staged", ctx.npods, str(ctx.device)), build)


def _run_cannon(graph: Graph, grid, ctx: RunContext):
    methods = sorted(set(CSR_KERNELS) | set(_DERIVED_METHODS) | {"auto"})
    if ctx.method not in methods:
        raise ValueError(
            f"unknown count method {ctx.method!r} for the cannon schedule; "
            f"registered: {methods}"
        )
    plan = ctx.plan  # a caller-supplied plan is already relabeled and
    if plan is None:  # wins over the pipeline (reorder/cyclic_p unused)
        from ..pipeline import plan_cannon

        fused_split = _fused_split(ctx)

        def plan_with(aug: bool, method: str):
            return plan_cannon(
                graph,
                ctx.q,
                chunk=ctx.chunk,
                reorder=ctx.reorder,
                cyclic_p=ctx.cyclic_p,
                # blocks are only consumed by the tile join (and
                # search2's bucketizer, which the planner forces)
                keep_blocks=(method == "tile"),
                bucketize=(method == "search2"),
                rebalance_trials=ctx.rebalance_trials,
                compact=ctx.compact is not False,
                autotune="fused" if fused_split else (method == "auto"),
                aug_keys=aug,
                hub_split=ctx.hub_split,
                cache=ctx.cache,
            )

        # only the global and search2 kernels read staged row-encoded keys
        ctx.artifact = plan_with(ctx.method in ("global", "search2"),
                                 ctx.method)
        plan = ctx.artifact.plan
        auto = ctx.method == "auto"
        if ctx.method in ("auto", "fused"):
            ctx.autotune_mode = "percentile"
            if ctx.autotune == "measured":
                _resolve_measured(ctx, plan,
                                  lambda: _resolve_auto_method(plan))
        if ctx.method == "auto":
            ctx.method = _resolve_auto_method(plan)
        if auto and ctx.method == "search2":
            # auto resolved to a key-consuming kernel: re-plan with
            # staged keys (deterministic, so only the keys differ; its
            # own cache entry serves repeat counts warm)
            ctx.artifact = plan_with(True, "auto")
            plan = ctx.artifact.plan
    else:
        _check_plan_kind(plan, TCPlan, "cannon")
        if ctx.method == "auto":
            ctx.method = _resolve_auto_method(plan)

    if ctx.method in _DERIVED_METHODS:
        return _count_derived(plan, ctx)
    # the fn first: it refuses a pod count that does not divide q before
    # anything is staged for it (so a ``fused`` fault site fires before
    # ``device_stage`` and ``step`` here; the JAX package binds the kernel
    # after mark_counting)
    fn = ctx.memo(
        ctx.key("fn", ctx.method, ctx.probe_shorter, ctx.use_step_mask,
                ctx.double_buffer, ctx.compact, ctx.reduce_strategy,
                ctx.npods, ctx.fused_tile),
        lambda: cannon_mod.build_cannon_fn(
            plan,
            method=ctx.method,
            probe_shorter=ctx.probe_shorter,
            use_step_mask=ctx.use_step_mask,
            double_buffer=ctx.double_buffer,
            compact=ctx.compact,
            reduce_strategy=ctx.reduce_strategy,
            npods=ctx.npods,
            fused_tile=ctx.fused_tile,
            mesh=ctx.mesh,
        ),
    )
    if ctx.mesh is not None:  # a pod mesh stages the pods' stacked A, B
        staged = _staged(plan, ctx, ctx.mesh)
    elif ctx.npods > 1:
        staged = _pod_staged(plan, ctx)
    else:
        staged = _staged(plan, ctx)
    ctx.mark_counting(plan)
    # the one device→host crossing of a count
    return int(fn(**staged)), plan


def _run_summa(graph: Graph, grid, ctx: RunContext):
    splan = ctx.plan  # a caller-supplied plan wins over the pipeline
    if splan is None:
        from ..pipeline import plan_summa

        ctx.artifact = plan_summa(
            graph, *grid, chunk=ctx.chunk, reorder=ctx.reorder,
            cyclic_p=ctx.cyclic_p, rebalance_trials=ctx.rebalance_trials,
            compact=ctx.compact is not False,
            autotune="fused" if _fused_split(ctx)
            else (ctx.method == "auto"),
            broadcast=ctx.broadcast or "auto",
            hub_split=ctx.hub_split,
            cache=ctx.cache,
        )
        splan = ctx.artifact.plan
        if ctx.method in ("auto", "fused"):
            ctx.autotune_mode = "percentile"
            if ctx.autotune == "measured":
                _resolve_measured(ctx, splan,
                                  lambda: _resolve_auto_method(splan))
    else:
        _check_plan_kind(splan, SummaPlan, "summa")
    if ctx.method == "auto":
        ctx.method = _resolve_auto_method(splan)
    mesh = ctx.grid_mesh()
    staged = _staged(splan, ctx, mesh)
    ctx.mark_counting(splan)
    # SUMMA has no pod dimension: as in the JAX package, where every pod
    # runs the whole broadcast schedule and the grid sum is taken per
    # pod, pods and reduce_strategy leave the count as it is — the
    # schedule runs once and sums flat
    fn = ctx.memo(
        ctx.key("fn", ctx.method, ctx.probe_shorter, ctx.use_step_mask,
                ctx.compact, ctx.broadcast, ctx.fused_tile),
        lambda: build_summa_fn(
            splan,
            method=ctx.method,
            probe_shorter=ctx.probe_shorter,
            use_step_mask=ctx.use_step_mask,
            compact=ctx.compact,
            broadcast=ctx.broadcast,
            fused_tile=ctx.fused_tile,
            mesh=mesh,
        ),
    )
    return int(fn(**staged)), splan


def _run_oned(graph: Graph, grid, ctx: RunContext):
    # the ring runs over every device of the grid, pods included
    p = math.prod(grid) * ctx.npods
    oplan = ctx.plan  # a caller-supplied plan wins over the pipeline
    if oplan is None:
        from ..pipeline import plan_oned

        ctx.artifact = plan_oned(
            graph, p, chunk=ctx.chunk, reorder=ctx.reorder,
            cyclic_p=ctx.cyclic_p, rebalance_trials=ctx.rebalance_trials,
            compact=ctx.compact is not False,
            autotune="fused" if _fused_split(ctx)
            else (ctx.method == "auto"),
            hub_split=ctx.hub_split,
            cache=ctx.cache,
        )
        oplan = ctx.artifact.plan
        if ctx.method in ("auto", "fused"):
            ctx.autotune_mode = "percentile"
            if ctx.autotune == "measured":
                # the ring's global-id columns rule out the two-level
                # kernel: the percentile fallback is plain search
                _resolve_measured(ctx, oplan, lambda: "search")
    else:
        _check_plan_kind(oplan, OneDPlan, "oned")
    if ctx.method == "auto":
        # the ring's global-id columns rule out the two-level kernel
        ctx.method = "search"
    # the ring over every device of the mesh, in its order
    ring = (None if ctx.mesh is None
            else ctx.mesh.reshaped((ctx.mesh.size,), RingAxes().all))
    staged = _staged(oplan, ctx, ring)
    ctx.mark_counting(oplan)
    fn = ctx.memo(
        ctx.key("fn", ctx.method, ctx.probe_shorter, ctx.use_step_mask,
                ctx.compact, ctx.reduce_strategy, ctx.fused_tile),
        lambda: build_oned_fn(
            oplan,
            method=ctx.method,
            probe_shorter=ctx.probe_shorter,
            use_step_mask=ctx.use_step_mask,
            compact=ctx.compact,
            reduce_strategy=ctx.reduce_strategy,
            fused_tile=ctx.fused_tile,
            mesh=ring,
        ),
    )
    return int(fn(**staged)), oplan


register_schedule(
    "cannon", _run_cannon, build_fn=cannon_mod.build_cannon_fn,
    plans_itself=True,
)
register_schedule("summa", _run_summa, build_fn=build_summa_fn,
                  plans_itself=True)
register_schedule("oned", _run_oned, build_fn=build_oned_fn,
                  plans_itself=True)


def _plan_grid(plan) -> Optional[tuple]:
    """The logical grid a plan was made for: ``(q, q)``, ``(r, c)`` or
    ``(p,)``; ``None`` for anything else."""
    if isinstance(plan, OneDPlan):
        return (plan.p,)
    if isinstance(plan, SummaPlan):
        return (plan.r, plan.c)
    if isinstance(plan, TCPlan):
        return (plan.q, plan.q)
    return None


# ----------------------------------------------------------------------
# top-level entry point
# ----------------------------------------------------------------------
def count_triangles(
    graph: Graph,
    mesh: Optional[DeviceMesh] = None,
    *,
    q: Optional[int] = None,
    grid: Optional[tuple] = None,
    method: str = "search",
    schedule: str = "cannon",
    npods: int = 1,
    probe_shorter: bool = True,
    chunk: int = 512,
    reorder: bool = True,
    cyclic_p: Optional[int] = None,
    rebalance_trials: int = 0,
    hub_split: object = False,
    count_dtype=None,
    plan=None,
    use_step_mask: Optional[bool] = None,
    double_buffer: bool = True,
    compact: Optional[bool] = None,
    reduce_strategy: str = "auto",
    broadcast: Optional[str] = None,
    cache=None,
    autotune: str = "percentile",
    measured_dir: Optional[str] = None,
    fault_plan=None,
    device=None,
) -> TCResult:
    """Count triangles with the paper's 2D algorithm.

    ``q`` is the logical grid dimension (default 1: degenerate but the
    identical code path); ``grid=(r, c)`` gives the grid's shape instead,
    in place of the JAX package's mesh.  The whole grid lives on
    ``device``.  ``device=None`` means the current CUDA device and raises
    when there is none; pass ``device="cpu"`` to run on the CPU.
    ``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`, as
    :func:`make_grid_mesh` builds it; it excludes ``device``) spreads the
    grid over devices as the JAX package's mesh does: its last two axes
    are the grid (Cannon's ``q``, SUMMA's ``(r, c)``), a third leading
    axis the pods, and the ring runs over all its devices in order (it
    also takes a one-axis ``("flat",)`` mesh, as a ``1 x p`` grid).
    ``q``, ``grid`` and ``npods`` may be left out, and must agree with it
    where given.  A SUMMA, ``tile`` or ``dense`` count on a pod mesh runs
    on pod 0's grid.  The count is the one-device count, ``==``.
    ``schedule`` resolves via the registry (see
    :func:`available_schedules`): ``"cannon"`` needs a square grid,
    ``"summa"`` runs ``r x c`` (``q x q`` with ``q`` alone), ``"oned"``
    the ring of ``p = r * c`` devices (``q²``).  ``TCResult.grid`` is
    the grid that ran: ``(q, q)``, ``(r, c)`` or ``(p,)``; with pods
    ``(npods, q, q)`` (or ``(npods, r, c)``).
    ``npods > 1`` adds the 2.5D pod dimension, as the JAX package's
    ``(pod, row, col)`` mesh does: on Cannon the A and B blocks are
    replicated over the pods with per-pod skew offsets and pod ``t`` runs
    every ``npods``-th shift (``npods`` must divide ``q``; compaction is
    off, ``compact=True`` refused; the task lists are not replicated); the
    ring runs over all ``npods * r * c`` devices; SUMMA, ``tile`` and
    ``dense`` have no pod dimension and count as on one pod.
    ``reduce_strategy`` picks the final sum: ``"flat"``, ``"tree"`` (a
    joint sum per pod, then the binomial tree over the pods; needs a
    power-of-two pod count > 1) or ``"auto"`` (tree whenever it applies).
    As in the JAX package, SUMMA and ``tile`` sum flat whatever it says,
    and ``dense`` and the ring refuse ``"tree"``.
    ``method`` picks the count kernel (``"search"``, ``"search2"``,
    ``"global"``, ``"fused"``, ``"auto"``, and on Cannon ``"tile"``,
    ``"dense"``).  ``method="auto"`` plans through the deterministic
    autotune stage and resolves to ``search2`` when the probe-length tail
    is heavy, else ``search`` (always ``search`` on the ring, whose
    global-id columns rule the two-level kernel out); ``TCResult.method``
    reports the resolution.  ``method="search2"`` needs the bucketized
    plan Cannon's planner makes for it; on SUMMA and the ring it raises,
    as in the JAX package.
    ``method="fused"`` runs the hand-written CUDA intersection kernel, one
    launch a device-step over both buckets — planning switches to the
    two-sided maxfrag autotune split it requires.  ``method="tile"`` packs
    the blocks into 128x128-bit tiles and runs the popcount tile kernel
    over the planned tile triples (tile plan and stores count as
    preprocessing); ``method="dense"`` is the oracle path over dense 0/1
    blocks, for small graphs.  ``broadcast`` names SUMMA's panel-broadcast
    strategy (``"onehot"``, ``"chain"``, ``"auto"`` or ``None`` for the
    plan's own); on one device all of them give the same count.
    ``cyclic_p`` enables the paper's initial cyclic redistribution
    (§5.3 step 1) as the pipeline's first relabel stage.
    ``rebalance_trials > 0`` runs the skip-aware rebalance stage during
    planning (``TCResult.rebalance`` carries its report);
    ``hub_split`` (``True`` or a threshold multiplier c) runs the
    hub-split stage: rows of degree above c × the average degree are cut
    off the schedule and counted as a separate plain-search partial
    (``TCResult.hub``), while the residual takes the normal path with
    ``method``.  Both need planning through the pipeline: with a
    caller-supplied plan, or a schedule registered without
    ``plans_itself``, they raise.  The tile and dense paths refuse hub
    plans.
    ``use_step_mask`` controls sparsity-aware step skipping (None =
    auto: on when the plan staged ``step_keep`` masks; False forces the
    unmasked engine); ``compact`` controls the compacted kept-step
    schedule (None = auto: on when the planner's compaction stage elided
    a step; False keeps the full loop); ``double_buffer`` (Cannon) picks
    the loop body on a mesh: step ``s + 2``'s shift issued before step
    ``s`` counts (True), or step ``s + 1``'s (False), the copies beside
    the count on the cards' copy streams; the count is the same either
    way, and on one device the loop counts, then rolls.  Planning goes
    through the
    content-addressed plan cache (``cache=None`` uses the process-wide
    default — pass a ``repro_torch.pipeline.PlanCache`` to isolate, or
    one with ``maxsize=0`` to disable): repeated counts of an
    already-seen graph skip relabel/plan/stage entirely.

    Counts are exact: accumulation is int64 everywhere and
    ``TCResult.triangles`` is a Python ``int``.  ``count_dtype`` may be
    ``torch.int32`` to demand a count that fits 32 bits — one that does
    not raises ``OverflowError``.
    ``autotune`` selects the shape-selection flavour for ``method`` in
    (``"auto"``, ``"fused"``): ``"percentile"`` (the analytic stage) or
    ``"measured"`` (consult, or populate on a miss, the persisted timing
    table of :mod:`repro_torch.kernels.tc_fused.autotune`: ``auto``
    resolves to ``fused`` exactly where the table's timing says it beats
    the baseline, and ``fused`` takes the table's tile; ``measured_dir``
    overrides the table directory; ``TCResult.measured_table_hit`` says
    whether the entry came off disk).  Measured mode plans with the
    two-sided split and refuses a caller-supplied plan.
    ``fault_plan`` arms a :class:`repro_torch.runtime.FaultPlan` of
    deterministic typed faults for the duration of this call (testing the
    recovery paths of :func:`repro_torch.runtime.supervised_count`
    without real hardware faults).
    """
    if autotune not in ("percentile", "measured"):
        raise ValueError(
            f"unknown autotune mode {autotune!r}: "
            "expected percentile | measured"
        )
    if autotune == "measured" and plan is not None:
        raise ValueError(
            "autotune='measured' needs pipeline planning (the table is "
            "keyed off the planned shape bucket); drop the "
            "caller-supplied plan"
        )
    npods = int(npods)
    if npods < 1:
        raise ValueError(f"npods must be >= 1, got {npods}")
    if count_dtype is None:
        count_dtype = torch.int64
    if count_dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"count_dtype must be torch.int32 or torch.int64, got {count_dtype}"
        )
    if mesh is not None:
        if device is not None:
            raise ValueError("pass mesh or device, not both: a mesh places "
                             "every grid position on its own device")
        q, grid, npods = _mesh_grid(mesh, q, grid, npods, schedule)
        device = mesh.first
    device = resolve_device(device)
    artifact = None
    if plan is not None and hasattr(plan, "staged") and hasattr(plan, "plan"):
        # a PlanArtifact supplied as the plan: run its plan and reuse its
        # staged device tensors / fn memos
        artifact = plan
        plan = artifact.plan
    t0 = time.perf_counter()
    spec = get_schedule(schedule)
    if grid is not None:
        grid = tuple(int(v) for v in grid)
        if len(grid) != 2 or min(grid) < 1:
            raise ValueError(f"grid must be (r, c) with r, c >= 1, got {grid}")
        if q is not None and grid != (q, q):
            raise ValueError(f"q={q} and grid={grid} disagree")
    else:
        grid = _plan_grid(plan) or (q or 1, q or 1)
    if schedule == "cannon" and (len(grid) != 2 or grid[0] != grid[1]):
        raise ValueError(
            f"the cannon schedule needs a square grid, got {grid}; "
            "use schedule='summa' for a rectangular one"
        )
    q = grid[0]

    if rebalance_trials and (plan is not None or not spec.plans_itself):
        raise ValueError(
            "rebalance_trials requires planning through the pipeline: "
            "drop the caller-supplied plan and use a schedule registered "
            "with plans_itself=True"
        )
    from ..pipeline.hubsplit import normalize_hub_split

    if normalize_hub_split(hub_split) is not None and (
        plan is not None or not spec.plans_itself
    ):
        raise ValueError(
            "hub_split requires planning through the pipeline: drop the "
            "caller-supplied plan (it already carries — or lacks — its "
            "hub side) and use a schedule registered with "
            "plans_itself=True"
        )
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
        npods=npods,
        plan=plan,
        mesh=mesh,
        use_step_mask=use_step_mask,
        double_buffer=double_buffer,
        compact=compact,
        reduce_strategy=reduce_strategy,
        broadcast=broadcast,
        reorder=reorder,
        cyclic_p=cyclic_p,
        rebalance_trials=rebalance_trials,
        hub_split=hub_split,
        cache=cache,
        autotune=autotune,
        measured_dir=measured_dir,
    )
    if artifact is not None:
        ctx.artifact = artifact
    from ..runtime import faultinject

    with faultinject.armed(fault_plan):
        total, out_plan = spec.runner(graph, grid, ctx)
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
        grid=((npods, *grid) if npods > 1
              else _plan_grid(out_plan) or grid),
        device=(str(device) if mesh is None
                else ",".join(dict.fromkeys(str(d) for d in mesh.devices))),
        autotune_mode=ctx.autotune_mode,
        measured_table_hit=ctx.measured_table_hit,
        artifact=ctx.artifact,
        rebalance=getattr(ctx.artifact, "rebalance", None),
        hub=_hub_report(out_plan, ctx.artifact),
    )


def _mesh_grid(mesh, q, grid, npods, schedule):
    """``(q, grid, npods)`` of a count on ``mesh``, checked against the
    caller's."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh, got {type(mesh).__name__}")
    shape = tuple(mesh.shape)
    if len(shape) == 1 and schedule == "oned":
        shape = (1,) + shape  # the ring's ("flat",) mesh: a 1 x p grid
    if len(shape) not in (2, 3):
        raise ValueError(f"a grid mesh has 2 or 3 axes (the ring also takes "
                         f"1), got {shape}")
    mgrid, mpods = shape[-2:], (shape[0] if len(shape) == 3 else 1)
    if (grid is not None and tuple(grid) != mgrid) or (
            q is not None and (q, q) != mgrid) or (
            int(npods) not in (1, mpods)):
        raise ValueError(
            f"q={q}, grid={grid}, npods={npods} disagree with the mesh "
            f"{dict(zip(mesh.axis_names, shape))}")
    if schedule == "cannon" and mgrid[0] != mgrid[1]:
        raise ValueError(f"the cannon schedule needs a square mesh, got {shape}")
    return None, mgrid, mpods


def _hub_report(plan, artifact) -> Optional[dict]:
    """The hub side's report plus ``residual_mcp``: the residual plan's
    masked critical path, from the rebalance report when there is one,
    else from the plan's stats (``None`` without either)."""
    hub_side = getattr(plan, "hub", None)
    if hub_side is None:
        return None
    rep = hub_side.report()
    rb = getattr(artifact, "rebalance", None)
    stats = getattr(plan, "stats", None)
    if rb is not None:
        rep["residual_mcp"] = rb.get("best_masked_critical_path")
    elif stats is not None:
        from ..pipeline.rebalance import masked_critical_path

        rep["residual_mcp"] = masked_critical_path(
            stats.probe_work_per_device_shift,
            getattr(plan, "step_keep", None),
        )
    else:
        rep["residual_mcp"] = None
    return rep


def count_triangles_delta(
    graph: Graph,
    delta,
    mesh: Optional[DeviceMesh] = None,
    *,
    artifact=None,
    cache=None,
    rebase_every: int = 8,
    **kwargs,
) -> TCResult:
    """Count triangles of ``graph`` mutated by ``delta``, incrementally.

    ``delta`` is a :class:`repro_torch.pipeline.EdgeDelta` in **original**
    vertex ids.  The base plan is taken from ``artifact`` (the
    ``TCResult.artifact`` of a previous count — thread it through to
    stream deltas) or planned fresh from ``graph`` with ``kwargs``
    (``q`` / ``grid``, ``schedule``, ``method``, ``device``, ... as for
    :func:`count_triangles`); :func:`repro_torch.pipeline.apply_delta`
    then splices / re-packs only what the delta dirtied and the count
    runs from the derived artifact, reusing unchanged device tensors and
    (rebound) engine fns.  The result's ``delta`` field carries the apply
    report and its ``artifact`` the derived artifact for the next round;
    ``triangles`` is exact — identical to a cold count of the mutated
    graph.  On a ``mesh`` the derived artifact restages position by
    position: a position whose blocks the delta left unchanged keeps its
    tensors.
    """
    from ..pipeline.delta import apply_delta

    if kwargs.get("autotune") == "measured":
        raise ValueError(
            "autotune='measured' re-times shapes per plan; the delta "
            "path reuses engines and is keyed analytically — use the "
            "default percentile mode"
        )
    if artifact is None:
        base = count_triangles(graph, mesh, cache=cache, **kwargs)
        artifact = base.artifact
        if artifact is None:
            raise ValueError(
                "count_triangles_delta needs a pipeline-planned base "
                "(schedule registered with plans_itself=True and no "
                "caller-supplied raw plan)"
            )
    art2 = apply_delta(
        artifact, delta, cache=cache, rebase_every=rebase_every
    )
    # the derived artifact already fixed its relabeling, rebalance seed
    # and hub cut at plan time — re-count kwargs that would re-plan are
    # dropped (hub_split included: the derived plan either carries its
    # repacked hub side or was rebased with the config's knob)
    for drop in ("reorder", "cyclic_p", "rebalance_trials", "hub_split"):
        kwargs.pop(drop, None)
    res = count_triangles(
        art2.graph, mesh, plan=art2, reorder=False, rebalance_trials=0,
        cache=cache, **kwargs,
    )
    res.delta = art2.delta_report
    return res


def count_triangles_many(graphs, mesh=None, **kwargs):
    """Count triangles of many graphs in one engine call.

    Thin re-export of :func:`repro_torch.pipeline.count_triangles_many`
    (the batched front end): graphs are padded to shared shapes, stacked
    on a leading batch dimension, and run through the engine once;
    results match the per-graph :func:`count_triangles` totals exactly.
    """
    from ..pipeline import count_triangles_many as _many

    return _many(graphs, mesh, **kwargs)
