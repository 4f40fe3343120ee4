"""Batched front end: count many graphs in one engine call.

``count_triangles_many`` pads a list of graphs onto shared shapes —
vertex counts lifted to the batch maximum (isolated vertices are free),
index/task arrays padded to the batch-wide maxima — stacks every plan
array on a leading batch dimension, stages the stack on one device, and
runs the whole batch through the engine's batched function: **one**
staging and **one** call for the batch, versus one of each per graph in
a Python loop.  Where the JAX package maps the schedule over the batch
with ``lax.map``, the engine here loops over the leading dimension, each
graph with its own host task counts and skip mask.

The assembled program (stacked staged tensors + engine fn) is itself
cached under the tuple of graph digests, so a serving process that sees
the same batch again skips planning, padding and staging.  The padding
overhead of batching is measured and reported
(``ManyResult.padding_overhead``), never hidden.  Host numpy for the
planning half, the same padding as the JAX package's module of the same
name: the same graphs give the same stacked arrays byte for byte.
With ``mesh=`` the stack is spread over a device mesh instead, each grid
position holding its slice of every graph (the batch dimension leads each
block), and the engine runs the batch there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.graph import Graph
from ..device import resolve_device
from ..runtime import faultinject
from .artifact import stage_arrays
from .cache import PlanCache, default_cache, graph_digest
from .planner import relabel_cached
from .stages import pack_oned_plan, pack_summa_plan, pack_tc_plan

__all__ = ["ManyResult", "count_triangles_many"]

_CSR_METHODS = ("search", "search2", "global")


@dataclasses.dataclass
class ManyResult:
    """Per-graph triangle counts plus batch accounting."""

    triangles: List[int]
    schedule: str
    method: str
    grid: tuple
    batch: int
    plan_seconds: float  # planning + padding + staging (0-ish on cache hit)
    count_seconds: float
    padding_overhead: float  # stacked cells / sum(per-graph cells) - 1
    cache_hit: bool
    device: str = "cpu"


@dataclasses.dataclass
class _BatchProgram:
    fn: object
    staged: Dict
    grid: tuple
    padding_overhead: float


def _pad_last(arr: np.ndarray, size: int, fill) -> np.ndarray:
    """Pad the last axis of ``arr`` up to ``size`` with ``fill``."""
    if arr.shape[-1] == size:
        return arr
    out = np.full(arr.shape[:-1] + (size,), fill, dtype=arr.dtype)
    out[..., : arr.shape[-1]] = arr
    return out


def _stack(plans, pads: Dict[str, tuple]) -> Dict[str, np.ndarray]:
    """Stack per-graph plan arrays, padding each named array's last axis
    to the batch-wide size with its sentinel/zero fill."""
    out = {}
    for name, (size, fill) in pads.items():
        out[name] = np.stack(
            [_pad_last(p.device_arrays()[name], size, fill) for p in plans]
        )
    return out


def _padding_overhead(stacked: Dict, plans) -> float:
    batched = sum(v.size for v in stacked.values())
    single = sum(
        a.size for p in plans for a in p.device_arrays().values()
    )
    return float(batched / max(1, single) - 1.0)


def _batched_rep(plan, stacked, count_key, **fields):
    """The representative plan the batched builder reads: the first
    graph's, widened to the batch-wide shapes, with the *stacked* host
    task counts and skip masks (a leading batch dimension) the engine
    loop reads graph by graph."""
    return dataclasses.replace(
        plan, stats=None, step_keep=stacked.get("step_keep"),
        **{count_key: stacked[count_key]}, **fields,
    )


def _build_batch_program(
    graphs: Sequence[Graph],
    *,
    grid: tuple,
    schedule: str,
    method: str,
    chunk: int,
    reorder: bool,
    cyclic_p: Optional[int],
    probe_shorter: bool,
    device: torch.device,
    cache: PlanCache,
    mesh=None,
) -> _BatchProgram:
    # relabel each graph on its own vertex set (degree order must not see
    # the padding vertices), then lift all graphs to the shared n.
    relabeled = [
        relabel_cached(
            g, graph_digest(g), reorder=reorder, cyclic_p=cyclic_p,
            cache=cache,
        )[0]
        for g in graphs
    ]
    n_max = max(g.n for g in relabeled)
    lifted = [
        g if g.n == n_max else Graph(n=n_max, edges=g.edges, name=g.name)
        for g in relabeled
    ]

    if schedule == "cannon":
        from ..core.cannon import build_cannon_fn
        from ..core.plan import bucketize_plan

        q = grid[0]
        plans = [
            pack_tc_plan(
                g, q, skew=True, chunk=chunk, with_stats=False,
                keep_blocks=(method == "search2"),
                aug_keys=(method in ("global", "search2")),
            )
            for g in lifted
        ]
        if method == "search2":
            plans = [bucketize_plan(p) for p in plans]
        nnz_pad = max(p.nnz_pad for p in plans)
        tmax = max(p.tmax for p in plans)
        nb = plans[0].nb
        pads = dict(
            a_indptr=(nb + 1, 0),
            a_indices=(nnz_pad, nb),
            b_indptr=(nb + 1, 0),
            b_indices=(nnz_pad, nb),
            m_ti=(tmax, 0),
            m_tj=(tmax, 0),
            m_cnt=(plans[0].m_cnt.shape[-1], 0),
        )
        if plans[0].step_keep is not None:
            pads["step_keep"] = (q, False)  # (q, q, q) per graph, same q
        if plans[0].b_aug is not None:
            # tail-pad with the maximal key (row nb, col nb) so every
            # block's staged key array stays sorted after batch padding
            pads["b_aug"] = (nnz_pad, (nb + 1) * (nb + 1) - 1)
        stacked = _stack(plans, pads)
        rep = _batched_rep(
            plans[0], stacked, "m_cnt",
            nnz_pad=nnz_pad,
            tmax=tmax,
            dmax=max(p.dmax for p in plans),
            chunk=min(chunk, tmax),
            blocks=None,
        )
        if method == "search2":
            rep.n_long = max(p.n_long for p in plans)
            rep.d_small = plans[0].d_small
        fn = build_cannon_fn(
            rep, method=method, probe_shorter=probe_shorter, batched=True,
            mesh=mesh,
        )
        grid = (q, q)
    elif schedule == "summa":
        from ..core.summa import build_summa_fn

        r, c = grid
        plans = [pack_summa_plan(g, r, c, chunk=chunk) for g in lifted]
        a_nnz_pad = max(p.a_nnz_pad for p in plans)
        b_nnz_pad = max(p.b_nnz_pad for p in plans)
        tmax = max(p.tmax for p in plans)
        nb_c = plans[0].nb_c
        pads = dict(
            a_indptr=(plans[0].nb_r + 1, 0),
            a_indices=(a_nnz_pad, nb_c),
            b_indptr=(nb_c + 1, 0),
            b_indices=(b_nnz_pad, nb_c),
            m_ti=(tmax, 0),
            m_tj=(tmax, 0),
            m_cnt=(plans[0].m_cnt.shape[-1], 0),
        )
        if plans[0].step_keep is not None:
            pads["step_keep"] = (c, False)  # (r, c, c) per graph
        stacked = _stack(plans, pads)
        rep = _batched_rep(
            plans[0], stacked, "m_cnt",
            a_nnz_pad=a_nnz_pad,
            b_nnz_pad=b_nnz_pad,
            tmax=tmax,
            dmax=max(p.dmax for p in plans),
            chunk=min(chunk, tmax),
        )
        fn = build_summa_fn(
            rep, method=method, probe_shorter=probe_shorter, batched=True,
            mesh=mesh,
        )
        grid = (r, c)
    elif schedule == "oned":
        from ..core.onedim import build_oned_fn

        p_ring = int(np.prod(grid))
        if mesh is not None:  # the ring over the mesh's devices, in order
            from ..core.engine import RingAxes

            mesh = mesh.reshaped((p_ring,), RingAxes().all)
        plans = [pack_oned_plan(g, p_ring, chunk=chunk) for g in lifted]
        nnz_pad = max(p.nnz_pad for p in plans)
        gmax = max(p.gmax for p in plans)
        pads = dict(
            indptr=(plans[0].nb + 1, 0),
            indices=(nnz_pad, n_max + 1),
            t_i=(gmax, 0),
            t_j=(gmax, 0),
            t_cnt=(plans[0].t_cnt.shape[-1], 0),
        )
        if plans[0].step_keep is not None:
            pads["step_keep"] = (p_ring, False)  # (p, p) per graph
        stacked = _stack(plans, pads)
        rep = _batched_rep(
            plans[0], stacked, "t_cnt",
            nnz_pad=nnz_pad,
            gmax=gmax,
            dmax=max(p.dmax for p in plans),
            chunk=min(chunk, gmax),
        )
        fn = build_oned_fn(
            rep, method=method, probe_shorter=probe_shorter, batched=True,
            mesh=mesh,
        )
        grid = (p_ring,)
    else:
        raise ValueError(
            f"count_triangles_many supports schedules cannon/summa/oned, "
            f"got {schedule!r}"
        )

    overhead = _padding_overhead(stacked, plans)
    staged = (stage_arrays(stacked, device) if mesh is None
              else stage_arrays(stacked, mesh, batched=True))
    return _BatchProgram(
        fn=fn, staged=staged, grid=grid, padding_overhead=overhead
    )


def count_triangles_many(
    graphs: Sequence[Graph],
    mesh=None,
    *,
    q: Optional[int] = None,
    grid: Optional[tuple] = None,
    schedule: str = "cannon",
    method: str = "search",
    chunk: int = 512,
    reorder: bool = True,
    cyclic_p: Optional[int] = None,
    probe_shorter: bool = True,
    count_dtype=None,
    cache: Optional[PlanCache] = None,
    device=None,
) -> ManyResult:
    """Count triangles of many graphs with one engine call.

    Results are exactly the per-graph ``count_triangles`` totals (padding
    to shared shapes never changes a count, only adds measured overhead).
    ``method`` must be a CSR kernel (``search``/``search2``/``global``);
    the dense and tile operand stores and the fused kernel's maxfrag
    split are per-graph paths.  ``q`` / ``grid=(r, c)`` give the logical
    grid as in ``count_triangles`` (Cannon needs it square; the ring runs
    ``p = r * c``); the whole batch lives on ``device`` (``None`` = CUDA,
    raising without one).  The program cache key holds the tuple of graph
    digests in the JAX package's key layout, with the grid in place of
    the mesh and the device (or the mesh) at the end.  ``mesh`` (a
    ``(q, q)`` or ``(r, c)`` :class:`~repro_torch.launch.mesh.DeviceMesh`;
    it excludes ``device``) spreads the batch over its devices and gives
    the grid.
    """
    from ..core.api import check_count_overflow

    graphs = list(graphs)
    if not graphs:
        raise ValueError("count_triangles_many needs at least one graph")
    if method not in _CSR_METHODS:
        raise ValueError(
            f"batched counting supports CSR methods {_CSR_METHODS}, "
            f"got {method!r}"
        )
    if method == "search2" and schedule != "cannon":
        raise ValueError("method 'search2' is a cannon-schedule path")

    faultinject.fire("plan_stage", kind="many")
    t0 = time.perf_counter()
    if mesh is not None:
        if device is not None:
            raise ValueError("pass mesh or device, not both")
        if len(mesh.shape) != 2 or (grid is not None
                                    and tuple(grid) != tuple(mesh.shape)) or (
                q is not None and (q, q) != tuple(mesh.shape)):
            raise ValueError(
                f"a batch runs on a (row, col) mesh of its grid, got "
                f"{tuple(mesh.shape)} for q={q}, grid={grid}")
        grid, device = tuple(mesh.shape), mesh.first
    device = resolve_device(device)
    if grid is None:
        grid = (q or 1, q or 1)
    grid = tuple(int(v) for v in grid)
    if len(grid) != 2 or min(grid) < 1:
        raise ValueError(f"grid must be (r, c) with r, c >= 1, got {grid}")
    if schedule == "cannon" and grid[0] != grid[1]:
        raise ValueError(
            f"the cannon schedule needs a square grid, got {grid}; "
            "use schedule='summa' for a rectangular one"
        )
    q = grid[-1]
    if count_dtype is None:
        count_dtype = torch.int64
    cache = cache if cache is not None else default_cache()

    digests = tuple(graph_digest(g) for g in graphs)
    key = (
        "many", schedule, method, grid, q, chunk, reorder, cyclic_p,
        probe_shorter, str(count_dtype), digests,
        str(device) if mesh is None else mesh,
    )
    prog = cache.get(key)
    cache_hit = prog is not None
    if not cache_hit:
        prog = _build_batch_program(
            graphs,
            grid=grid, schedule=schedule, method=method, chunk=chunk,
            reorder=reorder, cyclic_p=cyclic_p,
            probe_shorter=probe_shorter, device=device, cache=cache,
            mesh=mesh,
        )
        cache.put(key, prog)
    for dev in dict.fromkeys(mesh.devices if mesh is not None else [device]):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    faultinject.fire("device_stage")
    totals = prog.fn(**prog.staged).tolist()  # the one device→host crossing
    counts = [check_count_overflow(int(t), count_dtype) for t in totals]
    t2 = time.perf_counter()

    return ManyResult(
        triangles=counts,
        schedule=schedule,
        method=method,
        grid=prog.grid,
        batch=len(graphs),
        plan_seconds=t1 - t0,
        count_seconds=t2 - t1,
        padding_overhead=prog.padding_overhead,
        cache_hit=cache_hit,
        device=str(device),
    )
