"""SUMMA-schedule triangle counting on rectangular ``r x c`` grids.

The paper notes (§8) that the algorithm extends to rectangular processor
grids with SUMMA; in the JAX package this is also the elastic-regrid
path (any ``r x c`` factorisation of the devices that are left).

Formulation: tasks (i, j) live on device ``(i % r, j % c)``; the reduction
index k is classed by ``k % c`` into ``c`` panels.  Round ``z``:

* panel ``A_{x,z}``  (rows i%r==x, cols k%c==z)  goes to every device of
  grid row ``x`` from its owner ``(x, z)``;
* panel ``B_{y,z}``  (rows j%c==y, cols k%c==z)  goes to every device of
  grid column ``y`` from its owner ``(z % r, y)`` (each device stores
  ``ceil(c/r)`` B panels).

With the whole grid on one device a broadcast is a read of the owner's
slice (:class:`~repro_torch.core.engine.SummaCSRStore`): the JAX package's
``"onehot"`` and ``"chain"`` strategies give the same views.  On a device
mesh a round copies the owner's panels along its row and column, by the
strategy's pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .graph import Graph

__all__ = ["SummaPlan", "build_summa_plan", "build_summa_fn"]


@dataclasses.dataclass
class SummaPlan:
    n: int
    m: int
    r: int
    c: int
    nb_r: int  # local rows of A / mask = ceil(n / r)
    nb_c: int  # local rows of B and local k-cols = ceil(n / c)
    npan: int  # B panels per device = ceil(c / r)
    a_nnz_pad: int
    b_nnz_pad: int
    tmax: int
    dmax: int
    chunk: int

    a_indptr: np.ndarray  # (r, c, nb_r + 1)
    a_indices: np.ndarray  # (r, c, a_nnz_pad)
    b_indptr: np.ndarray  # (r, c, npan, nb_c + 1)
    b_indices: np.ndarray  # (r, c, npan, b_nnz_pad)
    m_ti: np.ndarray  # (r, c, tmax)
    m_tj: np.ndarray  # (r, c, tmax)
    m_cnt: np.ndarray  # (r, c)
    # (r, c, c) bool: True = device (x, y) counts at broadcast round z
    step_keep: Optional[np.ndarray] = None
    # per-round probe work (repro_torch.core.plan.StepStats) when planned
    # with_stats
    stats: Optional[object] = None
    # globally-live broadcast rounds (repro_torch.core.plan.CompactSchedule)
    compact: Optional[object] = None
    # deterministic kernel-shape autotune report (pipeline stage)
    autotune: Optional[dict] = None
    # long/short task split set by the autotune stage (first ``n_long``
    # tasks per device need dmax probes, the rest fit in ``d_small``)
    n_long: Optional[int] = None
    d_small: Optional[int] = None
    # broadcast strategy the plan was staged for ("auto" | "onehot" |
    # "chain") — a planner cache-key component, resolved by build_summa_fn
    # via repro_torch.core.plan.resolve_broadcast
    broadcast: str = "auto"
    # hub-split side (repro_torch.pipeline.hubsplit.HubSide) when the
    # planner cut the heavy-tailed suffix off the schedule; its arrays
    # join device_arrays() and the engine adds its partial
    # (engine.HubCount).  The plan's own arrays then cover only the
    # residual graph.
    hub: Optional[object] = None

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


def build_summa_plan(graph: Graph, r: int, c: int, *,
                     chunk: int = 512) -> SummaPlan:
    """SUMMA planner — the pipeline's vectorised packer
    (:func:`repro_torch.pipeline.stages.pack_summa_plan`): A/mask blocks
    from one ``(r, c)`` lexsort pass, B panels gathered from one
    ``(c, c)`` pass."""
    from ..pipeline.stages import pack_summa_plan

    return pack_summa_plan(graph, r, c, chunk=chunk)


def build_summa_fn(
    plan,
    *,
    method: str = "search",
    probe_shorter: bool = True,
    reduce_global: bool = True,
    use_step_mask: Optional[bool] = None,
    compact: Optional[bool] = None,
    broadcast: Optional[str] = None,
    reduce_strategy: str = "auto",
    batched: bool = False,
    fused_tile: Optional[int] = None,
    elide_broadcast: bool = False,
    mesh=None,
):
    """Build the counting function for ``plan`` on its ``(r, c)`` grid:
    SummaSchedule × SummaCSRStore × kernel.

    Returns ``fn(**staged_arrays)`` yielding the global count (a 0-dim
    int64 tensor on the tensors' device) or the ``(r, c)`` per-device
    counts with ``reduce_global=False``.  ``use_step_mask=None``
    auto-enables skipping on the plan's ``step_keep``; ``compact=None``
    auto-enables round elision when the plan staged a compacted schedule
    that drops a round.  ``broadcast`` (``"onehot"``, ``"chain"``,
    ``"auto"``, or ``None`` for the plan's own) is resolved and checked
    as in the JAX package (:func:`~repro_torch.core.plan.resolve_broadcast`);
    on one device every strategy gives the same count.  ``method`` is any
    registered CSR kernel; ``"fused"`` needs a maxfrag-split plan.  A
    hub-split plan adds its hub partial; ``batched=True`` builds the
    multi-graph function (see :func:`~repro_torch.core.cannon.build_cannon_fn`).
    ``fused_tile`` overrides the fused kernel's tile.  ``elide_broadcast``
    is a timing probe: every device counts its local panel pair (counts
    are wrong past a 1 x 1 grid; ``tc_run --time-split``'s count-only run).
    With ``mesh`` (an ``(r, c)`` :class:`~repro_torch.launch.mesh.DeviceMesh`)
    it counts the arrays ``PlanArtifact.staged(mesh)`` spread over it, and
    each round copies its panels to their row and column
    (``broadcast`` picks the copy pattern).
    """
    from . import engine
    from .engine import Reduction, SummaCSRStore, SummaSchedule, make_csr_kernel
    from .plan import (
        as_plan,
        resolve_broadcast,
        resolve_compact_steps,
        resolve_step_mask,
    )

    plan = as_plan(plan)
    use_step_mask = resolve_step_mask(plan, use_step_mask)
    live = resolve_compact_steps(plan, compact, batched=batched)
    broadcast = resolve_broadcast(plan, broadcast, batched=batched)
    if method == "fused":
        engine.check_fused_split(plan)
    kernel = make_csr_kernel(
        method,
        dpad=plan.dmax,
        chunk=plan.chunk,
        probe_shorter=probe_shorter,
        sentinel=plan.nb_c + 1,
        n_long=getattr(plan, "n_long", None),
        d_small=getattr(plan, "d_small", None),
        fused_tile=fused_tile,
    )
    store = SummaCSRStore(kernel, r=plan.r, c=plan.c, broadcast=broadcast,
                          elide_broadcast=elide_broadcast)
    schedule = SummaSchedule(r=plan.r, c=plan.c, live_steps=live)
    return engine.build_engine_fn(
        store,
        schedule,
        m_cnt=plan.m_cnt,
        step_keep=plan.step_keep if use_step_mask else None,
        reduction=Reduction(global_sum=reduce_global, strategy=reduce_strategy),
        batched=batched,
        hub=engine.HubCount.from_plan(plan, probe_shorter=probe_shorter),
        mesh=mesh,
    )
