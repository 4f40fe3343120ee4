"""1D-decomposition baseline (the class of algorithms the paper beats).

Vertices are 1D-cyclically partitioned over all ``p`` devices, each device
stores only its own rows of U, and the row blocks rotate around a ring for
``p`` steps; a task ``(i, j)`` is counted at the step when ``owner(j)``'s
block arrives.  Columns are *global* vertex ids (both fragments of a task
live in the same global column space), so block-local row-encoded keys do
not apply: the fused kernel's long bucket takes the padded search's
function, ``method="auto"`` resolves to ``search``, and ``global`` keys
are built on the base ``n + 2`` (the JAX package builds them on
``nb + 1`` and miscounts the ring past ``p = 1``; ROADMAP.md, Queue C).

On one device, device ``d``'s block is ``indptr[d]``/``indices[d]`` and
a rotation is a ``torch.roll`` of a copy of them
(:class:`~repro_torch.core.engine.RingSchedule`); on a ring mesh each
block lies on its device and a rotation copies it to the next.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .graph import Graph

__all__ = ["OneDPlan", "build_oned_plan", "build_oned_fn"]


@dataclasses.dataclass
class OneDPlan:
    n: int
    m: int
    p: int
    nb: int  # local rows = ceil(n / p)
    nnz_pad: int  # padded nnz per device
    gmax: int  # padded tasks per (device, owner-of-j) group
    dmax: int  # max U row length (FULL rows — 1D keeps whole adjacency)
    chunk: int

    indptr: np.ndarray  # (p, nb + 1)
    indices: np.ndarray  # (p, nnz_pad) GLOBAL k ids of sorted rows, pad n + 1
    # tasks grouped by owner(j): device d, group o holds tasks whose j%p==o
    t_i: np.ndarray  # (p, p, gmax) local i
    t_j: np.ndarray  # (p, p, gmax) local j (= j // p)
    t_cnt: np.ndarray  # (p, p)
    # (p, p) bool: True = device d counts at ring step t
    step_keep: Optional[np.ndarray] = None
    # per-step probe work (repro_torch.core.plan.StepStats) when planned
    # with_stats
    stats: Optional[object] = None
    # globally-live ring steps (repro_torch.core.plan.CompactSchedule);
    # dead steps are reached via fused multi-hop rotations
    compact: Optional[object] = None
    # deterministic kernel-shape autotune report (pipeline stage)
    autotune: Optional[dict] = None
    # long/short task split set by the autotune stage (first ``n_long``
    # tasks per group need dmax probes, the rest fit in ``d_small``)
    n_long: Optional[int] = None
    d_small: Optional[int] = None
    # hub-split side (repro_torch.pipeline.hubsplit.HubSide) when the
    # planner cut the heavy-tailed suffix off the schedule; its arrays
    # join device_arrays() and the engine adds its partial
    # (engine.HubCount).  The plan's own arrays then cover only the
    # residual graph.
    hub: Optional[object] = None

    def device_arrays(self) -> Dict[str, np.ndarray]:
        out = dict(
            indptr=self.indptr,
            indices=self.indices,
            t_i=self.t_i,
            t_j=self.t_j,
            t_cnt=self.t_cnt,
        )
        if self.step_keep is not None:
            out["step_keep"] = self.step_keep
        if self.hub is not None:
            out.update(self.hub.device_arrays())
        return out

    def shape_structs(self, device="meta") -> Dict[str, "torch.Tensor"]:
        """Shape-only stand-ins for every device array
        (:func:`~repro_torch.core.plan.shape_structs_of`; ``meta`` tensors
        by default)."""
        from .plan import shape_structs_of

        return shape_structs_of(
            {k: (v.shape, v.dtype) for k, v in self.device_arrays().items()},
            device)


def build_oned_plan(graph: Graph, p: int, *, chunk: int = 512) -> OneDPlan:
    """1D-cyclic row partition + owner-grouped task lists — the
    pipeline's vectorised packer
    (:func:`repro_torch.pipeline.stages.pack_oned_plan`)."""
    from ..pipeline.stages import pack_oned_plan

    return pack_oned_plan(graph, p, chunk=chunk)


def build_oned_fn(
    plan,
    *,
    method: str = "search",
    probe_shorter: bool = True,
    reduce_global: bool = True,
    use_step_mask: Optional[bool] = None,
    compact: Optional[bool] = None,
    reduce_strategy: str = "auto",
    batched: bool = False,
    fused_tile: Optional[int] = None,
    elide_shifts: bool = False,
    mesh=None,
):
    """Build the ring's counting function: RingSchedule × OneDCSRStore ×
    kernel over the plan's ``(p,)`` ring.

    Returns ``fn(**staged_arrays)`` yielding the global count (a 0-dim
    int64 tensor) or the ``(p,)`` per-device counts with
    ``reduce_global=False``.  ``compact=None`` auto-enables dead-step
    elision with fused multi-hop rotations when the plan staged a
    compacted schedule.  ``reduce_strategy`` is accepted for symmetry
    with the 2D build functions: a ring has no pod axis, so ``"tree"`` is
    refused.  ``method="fused"`` needs a maxfrag-split plan and runs its
    long bucket with the padded search's function (global column ids).
    A hub-split plan adds its hub partial; ``batched=True`` builds the
    multi-graph function (see :func:`~repro_torch.core.cannon.build_cannon_fn`).
    ``fused_tile`` overrides the fused kernel's tile.  ``elide_shifts`` is
    a timing probe: no rotation, each device counts every group against
    its own block (counts are wrong for p > 1; ``tc_run --time-split``'s
    count-only run).  With ``mesh`` (a ``(p,)`` ring
    :class:`~repro_torch.launch.mesh.DeviceMesh`, ``("flat",)`` as the
    supervisor names it) it counts the arrays ``PlanArtifact.staged(mesh)``
    spread over the ring, each rotation a copy to the next device.
    """
    from . import engine
    from .engine import OneDCSRStore, Reduction, RingSchedule, make_csr_kernel
    from .plan import as_plan, resolve_compact_steps, resolve_step_mask

    plan = as_plan(plan)
    use_step_mask = resolve_step_mask(plan, use_step_mask)
    live = resolve_compact_steps(plan, compact, batched=batched)
    if method == "fused":
        engine.check_fused_split(plan)
    kernel = make_csr_kernel(
        method,
        dpad=plan.dmax,
        chunk=plan.chunk,
        probe_shorter=probe_shorter,
        sentinel=plan.n + 1,
        n_long=getattr(plan, "n_long", None),
        d_small=getattr(plan, "d_small", None),
        # the ring rotates whole adjacency rows: columns are global ids,
        # so the long bucket takes the padded search's function, not the
        # row-encoded keys', and the global kernel's keys need a base
        # past every global id (padding n + 1 included)
        fused_long_fallback="search",
        key_base=plan.n + 2,
        fused_tile=fused_tile,
    )
    store = OneDCSRStore(kernel, p=plan.p)
    schedule = RingSchedule(p=plan.p, live_steps=live,
                            elide_shifts=elide_shifts)
    return engine.build_engine_fn(
        store,
        schedule,
        m_cnt=plan.t_cnt,
        step_keep=plan.step_keep if use_step_mask else None,
        reduction=Reduction(global_sum=reduce_global, strategy=reduce_strategy),
        batched=batched,
        hub=engine.HubCount.from_plan(plan, probe_shorter=probe_shorter),
        mesh=mesh,
    )
