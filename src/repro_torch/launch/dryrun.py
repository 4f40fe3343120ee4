"""Dry run of the paper's graphs: size every triangle-count cell from
shapes alone.

The JAX package lowers and compiles each cell for a 256- or 512-chip mesh
and reads the compiled program's cost and memory.  The port holds the
whole logical grid on one card and compiles nothing: a cell is one call of
the port's real engine function (``build_cannon_fn`` / ``build_oned_fn``
with the stores, kernels and schedules they bind), walked on ``meta``
tensors by :func:`repro_torch.launch.roofline.walk_engine` — shape-only,
nothing allocated, no value read, and no card needed.  The walk is on
meta by design, not in place of a card.  A 1-billion-edge graph would
take far longer to plan on the host than to walk, so the plan is the
analytic one (:func:`repro_torch.core.plan.analytic_plan`), as in the JAX
package.  Every device-step of an analytic plan has the same shapes, so
the walk samples what repeats (one device-step's chunks, one schedule
step, one shift) and adds it once for every repeat; that is exact here.

Usage:
  python -m repro_torch.launch.dryrun --cell <graph>:<schedule>:<mesh>
  python -m repro_torch.launch.dryrun --list

Mesh names: "pod" = a 16x16 logical grid (256 logical devices),
"multipod" = 2x16x16 (512).  Schedules: ``cannon``, ``cannonopt``
(uint16-length blobs), ``cannon2l`` (two-level probes, gather-free keys
and uint16-length blobs), ``cannon25d`` (2 pods) and ``oned`` (the ring,
p = 256).  Each cell prints one JSON row: the JAX package's roofline
fields, ``nshifts``, ``nnz_pad_per_device``, ``grid_bytes`` and ``fits``
(:class:`~repro_torch.launch.roofline.RooflineReport`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import traceback
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["all_cells", "run_cell", "TCCell", "tc_cell", "main"]

Q = 16  # the production grid's side


def all_cells():
    """Every (graph, schedule, mesh) cell of the triangle-count matrix, in
    the JAX package's order."""
    from ..configs import TC_GRAPHS

    cells = []
    for g in TC_GRAPHS:
        for sched in ("cannon", "cannon25d", "oned"):
            mesh_name = "multipod" if sched == "cannon25d" else "pod"
            cells.append((g, sched, mesh_name))
    return cells


@dataclasses.dataclass
class TCCell:
    """One cell's program before it is walked: the analytic plan (and the
    ring's plan for ``oned``), the engine function rebound to full task
    counts, its meta arguments and the JAX package's ``nshifts``."""

    plan: object
    fn: object
    arrays: Dict[str, torch.Tensor]
    nshifts: int
    oplan: Optional[object] = None


def tc_cell(cfg, sched: str, chips: int, q: int = Q) -> TCCell:
    """The program of one triangle-count cell on a ``q x q`` grid (``Q``,
    the production side, in every cell; the ring takes ``p = chips``),
    with the JAX package's plan mutations.

    The engine skips a device whose task count is 0, and an analytic
    plan's ``m_cnt`` is all zeros (the JAX package compiles it as a traced
    argument, so its program carries the full padded work).  The function
    is therefore rebound to ``tmax`` tasks on every device (``gmax`` a
    group on the ring): every device-step counts the padded work.
    """
    from ..core.cannon import build_cannon_fn
    from ..core.onedim import OneDPlan, build_oned_fn
    from ..core.plan import analytic_plan

    plan = analytic_plan(
        cfg.n_vertices,
        cfg.n_edges,
        q,
        dmax_block=cfg.dmax_block_est,
        chunk=512,
    )
    structs = plan.shape_structs(device="meta")
    full = np.full(plan.m_cnt.shape, plan.tmax, dtype=plan.m_cnt.dtype)
    if sched == "cannon":
        fn = build_cannon_fn(plan, method="search")
        nshifts = q
    elif sched == "cannonopt":
        # beyond-paper variant: uint16-length blob compression
        fn = build_cannon_fn(plan, method="search", compress_lengths=True)
        nshifts = q
    elif sched == "cannon2l":
        # two-level bucketed probes + gather-free keys + uint16 blobs.
        # Analytic plans carry no blocks, so the long fraction is assumed
        # 20% at d_small=64, as in the JAX package
        plan.n_long = max(1, int(0.20 * plan.tmax))
        plan.d_small = 64
        fn = build_cannon_fn(plan, method="search2", compress_lengths=True)
        nshifts = q
    elif sched == "cannon25d":
        # pod-stacked operands: the leading pod dimension on A and B
        npods = 2
        for k in ("a_indptr", "a_indices", "b_indptr", "b_indices"):
            s = structs[k]
            structs[k] = torch.empty((npods,) + tuple(s.shape),
                                     dtype=s.dtype, device="meta")
        fn = build_cannon_fn(plan, method="search", npods=npods)
        nshifts = q // npods
    elif sched == "oned":
        p = chips
        nb = -(-cfg.n_vertices // p)
        nnz_pad = int(cfg.n_edges / p * 1.25)
        gmax = max(1, int(cfg.n_edges / (p * p) * 2.0))
        oplan = OneDPlan(
            n=cfg.n_vertices,
            m=cfg.n_edges,
            p=p,
            nb=nb,
            nnz_pad=nnz_pad,
            gmax=gmax,
            dmax=cfg.dmax_block_est * q,  # full rows: no /sqrt(p) shrink
            chunk=512,
            indptr=np.zeros((1,), np.int32),
            indices=np.zeros((1,), np.int32),
            t_i=np.zeros((1,), np.int32),
            t_j=np.zeros((1,), np.int32),
            t_cnt=np.zeros((1,), np.int32),
        )
        from ..core.plan import shape_structs_of

        structs = shape_structs_of(dict(
            indptr=((p, nb + 1), np.int32),
            indices=((p, nnz_pad), np.int32),
            t_i=((p, p, gmax), np.int32),
            t_j=((p, p, gmax), np.int32),
            t_cnt=((p, p), np.int32),
        ))
        fn = build_oned_fn(oplan)
        full = np.full((p, p), gmax, dtype=np.int32)
        return TCCell(plan, fn.rebind(m_cnt=full), structs, p, oplan)
    else:
        raise ValueError(sched)
    return TCCell(plan, fn.rebind(m_cnt=full), structs, nshifts)


def useful_ops(cfg) -> float:
    """Useful ops ~ the paper's probe count: m * (d_avg/2) log2(d) per
    full pass (the JAX package's formula)."""
    d_avg = 2.0 * cfg.n_edges / cfg.n_vertices
    return cfg.n_edges * (d_avg / 2.0) * max(1.0, math.log2(max(2, d_avg)))


def _run_tc_cell(cfg, sched: str, mesh, label: str) -> dict:
    """TC dry run from the analytic plan (shape-only, nothing
    allocated)."""
    from .roofline import roofline_from_walk, walk_engine

    cell = tc_cell(cfg, sched, mesh.size)
    walk = walk_engine(cell.fn, cell.arrays, sample=True)
    rep = roofline_from_walk(
        label,
        walk,
        mesh_name="multipod" if sched == "cannon25d" else "pod",
        chips=mesh.size,
        model_flops=useful_ops(cfg),
    )
    row = rep.row()
    row["nshifts"] = cell.nshifts
    row["nnz_pad_per_device"] = cell.plan.nnz_pad
    return row


def run_cell(arch: str, shape_name: str, mesh_name: str) -> dict:
    """The row of one cell.  Only the triangle-count graphs are walked:
    a config of another family raises."""
    from ..configs import get_config
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    if cfg.family != "tc":
        raise ValueError(
            f"the port's dry run walks triangle-count cells only; {arch!r} "
            f"is a {cfg.family!r} config")
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    return _run_tc_cell(cfg, shape_name, mesh,
                        f"{arch}:{shape_name}:{mesh_name}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry-run a triangle-count cell on meta tensors.")
    ap.add_argument("--cell", help="graph:schedule:mesh")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.list:
        for c in all_cells():
            print(":".join(c))
        return
    if not args.cell:
        ap.error("give --cell graph:schedule:mesh or --list")

    arch, shape_name, mesh_name = args.cell.split(":")
    try:
        row = run_cell(arch, shape_name, mesh_name)
        row["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        row = {
            "name": args.cell,
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:],
        }
    line = json.dumps(row)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    sys.exit(0 if row["status"] == "ok" else 1)


if __name__ == "__main__":
    main()
