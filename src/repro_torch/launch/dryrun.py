"""Dry run of every cell: size each model step and each triangle-count
graph from shapes alone.

The JAX package lowers and compiles each cell for a 256- or 512-chip mesh
and reads the compiled program's cost and memory.  The port holds a whole
cell on one card and compiles nothing: a cell is one call of the port's
own program, walked on ``meta`` tensors by
:mod:`repro_torch.launch.roofline` — shape-only, nothing allocated, no
value read, and no card needed.  The walk is on meta by design, not in
place of a card.  Its rows answer the port's own question: does this
step run unsharded on one card (``grid_bytes``, ``fits``)?  A
triangle-count row also answers the reference's: does each card hold its
share when the grid's positions lie one to a card (``card_bytes``,
``card_fits``: the same walk over a mesh of ``meta`` positions,
:func:`walk_cell_cards`)?

**Model cells** (5 LM archs x 3 shapes, 5 GNN / recsys archs x 4 shapes,
each under ``pod`` and ``multipod``): the reference's step per ``kind``
(``build_lm_{train,prefill,decode}_step``, ``build_gnn_train_step``,
``build_dlrm_{train,serve,retrieval}_step``) on the reference's
arguments — the dummy parameters, the optimiser state's shapes, the input
specs, step 0 — walked by :func:`~repro_torch.launch.roofline.walk_step`.
An LM step at full depth and batch would take minutes to walk, so it is
walked at one and two layers of each stack (dense and MoE apart; the MTP
layer is a constant) and, for training, at one and two microbatches, and
its counts are extrapolated to the config's own depth and microbatch
count (:func:`lm_walk_plan`): every layer of a stack and every microbatch
has the same shapes, so the products, ops and bytes are exactly affine in
each.  The live bytes are extrapolated at each point of the program where
the step makes tensors, and the peak is the most of them (see
:func:`lm_walk_plan`).  A GNN or DLRM step is walked whole.  The same cell under ``pod`` and ``multipod`` walks once a
process.

**Triangle-count cells**: the port's real engine function
(``build_cannon_fn`` / ``build_oned_fn`` with the stores, kernels and
schedules they bind) over the analytic plan
(:func:`repro_torch.core.plan.analytic_plan`), as in the JAX package,
walked by :func:`~repro_torch.launch.roofline.walk_engine`.  Every
device-step of an analytic plan has the same shapes, so the walk samples
what repeats (one device-step's chunks, one schedule step, one shift) and
adds it once for every repeat; that is exact here.

Usage:
  python -m repro_torch.launch.dryrun --cell <arch>:<shape>:<mesh>
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --fewest-cards

Mesh names: "pod" = a 16x16 logical grid (256 logical devices),
"multipod" = 2x16x16 (512).  Triangle-count schedules: ``cannon``,
``cannonopt`` (uint16-length blobs), ``cannon2l`` (two-level probes,
gather-free keys and uint16-length blobs), ``cannon25d`` (2 pods) and
``oned`` (the ring, p = 256).  Each cell prints one JSON row: the JAX
package's roofline fields, ``grid_bytes`` and ``fits``
(:class:`~repro_torch.launch.roofline.RooflineReport`), and for a
triangle-count cell ``nshifts``, ``nnz_pad_per_device``, ``card_bytes``
and ``card_fits``.  ``--fewest-cards`` prints, for each triangle-count
cell, the fewest cards that hold its count (:func:`fewest_cards`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["all_cells", "run_cell", "TCCell", "tc_cell", "ModelCell",
           "model_cell", "lm_walk_plan", "walk_cell", "walk_model_cell",
           "main"]

Q = 16  # the production grid's side


def all_cells():
    """Every (arch, shape, mesh) cell of the assignment matrix, in the JAX
    package's order: the model cells (an LM's ``long_500k`` skipped: every
    LM arch is full attention), then the triangle-count graphs."""
    from ..configs import ASSIGNED_ARCHS, TC_GRAPHS, get_config

    cells = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape_name, shape in cfg.shapes.items():
            if cfg.family == "lm" and shape.get("skip_full_attention"):
                continue
            for mesh_name in ("pod", "multipod"):
                cells.append((arch, shape_name, mesh_name))
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


def cell_mesh(cell: TCCell, sched: str, mesh):
    """``(DeviceMesh, arrays)``: the cell's meta arguments spread over a
    mesh of ``mesh``'s shape (the ring: one ``("flat",)`` axis of all its
    positions), every position on ``meta`` with its block of each array,
    split as the JAX package's in-specs split it (Cannon's task lists
    replicated over the pods)."""
    from ..core.cannon import cannon_in_specs
    from ..core.engine import MeshArray
    from .mesh import DeviceMesh

    shape, axes = tuple(mesh.shape), tuple(mesh.axis_names)
    specs = {}
    if sched == "oned":
        shape, axes = (math.prod(shape),), ("flat",)
    elif len(shape) == 3:
        specs = cannon_in_specs(axes[1], axes[2], axes[0])
    dmesh = DeviceMesh(shape, axes, ("meta",) * math.prod(shape))
    arrays = {}
    for k, v in cell.arrays.items():
        block = tuple(v.shape[len(specs.get(k, axes)):])
        arrays[k] = MeshArray(dmesh, {
            pos: torch.empty(block, dtype=v.dtype, device="meta")
            for pos in np.ndindex(*shape)})
    return dmesh, arrays


def walk_cell_cards(cfg, sched: str, mesh, per_card: int = 1):
    """The sampled walk of one triangle-count cell over a mesh of
    ``mesh``'s positions (:func:`cell_mesh`), ``per_card`` consecutive
    positions (in row-major order) a card; its ``cards`` hold each card's
    books (:class:`~repro_torch.launch.roofline.CardWalk`)."""
    from .roofline import walk_engine

    cell = tc_cell(cfg, sched, mesh.size, q=mesh.shape[-1])
    dmesh, arrays = cell_mesh(cell, sched, mesh)
    index = {pos: i for i, pos in enumerate(np.ndindex(*dmesh.shape))}
    return walk_engine(cell.fn, arrays, sample=True,
                       cards=lambda pos: index[pos] // per_card)


def fewest_cards(cfg, sched: str, mesh, memory: Optional[int] = None):
    """``(cards, card_bytes)``: the fewest cards of ``memory`` bytes each
    (default :func:`~repro_torch.launch.roofline.card_memory_bytes`) that
    hold the cell's count with its positions spread evenly (a power of two
    dividing the mesh's positions, consecutive positions on a card), and
    the walk's largest card peak there; ``(None, peak at one a card)``
    where even one position a card does not fit."""
    from .roofline import card_memory_bytes

    memory = card_memory_bytes() if memory is None else memory
    n = mesh.size

    def peak(cards):
        walk = walk_cell_cards(cfg, sched, mesh, per_card=n // cards)
        return max(c.peak_bytes for c in walk.cards.values())

    lo, hi = 1, n  # the answer is a power of two in [lo, hi]
    best = peak(hi)
    if best > memory:
        return None, best
    while lo < hi:
        mid = 1 << ((lo.bit_length() + hi.bit_length() - 2) // 2)
        got = peak(mid)
        if got <= memory:
            hi, best = mid, got
        else:
            lo = mid * 2
    return hi, best


def _run_tc_cell(cfg, sched: str, mesh, label: str) -> dict:
    """TC dry run from the analytic plan (shape-only, nothing
    allocated)."""
    from .roofline import card_memory_bytes, roofline_from_walk, walk_engine

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
    cards = walk_cell_cards(cfg, sched, mesh).cards
    row["card_bytes"] = max(c.peak_bytes for c in cards.values())
    row["card_fits"] = row["card_bytes"] <= card_memory_bytes()
    return row


# ======================================================================
# the model cells
# ======================================================================
def _gnn_model_flops(cfg, shape) -> float:
    """The JAX package's useful FLOPs of a GNN train step."""
    if shape["kind"] == "sampled":
        b = shape["batch_nodes"]
        f1, f2 = shape["fanout"]
        e = b * f1 + b * f1 * f2
        n = b * (1 + f1 + f1 * f2)
    elif shape["kind"] == "batched":
        n = shape["n_nodes"] * shape["batch"]
        e = shape["n_edges"] * shape["batch"]
    else:
        n, e = shape["n_nodes"], shape["n_edges"]
    d = cfg.d_hidden
    if cfg.arch == "gat":
        per_layer = 2 * n * d * d * cfg.n_heads + 6 * e * d * cfg.n_heads
    elif cfg.arch == "graphcast":
        per_layer = 2 * e * (2 * d) * d * 2 + 2 * n * (2 * d) * d * 2
    else:  # equivariant: TP/eSCN dominated
        s = (cfg.l_max + 1) ** 2
        per_layer = 6 * e * d * d * s
    return 3.0 * cfg.n_layers * per_layer  # fwd + bwd ~ 3x fwd


def _recsys_model_flops(cfg, shape) -> float:
    """The JAX package's useful FLOPs of a DLRM step."""
    if shape["kind"] == "retrieval":
        return 2.0 * shape["n_candidates"] * cfg.embed_dim
    b = shape["batch"]
    mlp = 0
    dims = cfg.bot_mlp
    for i in range(len(dims) - 1):
        mlp += 2 * dims[i] * dims[i + 1]
    dims = cfg.top_mlp
    for i in range(len(dims) - 1):
        mlp += 2 * dims[i] * dims[i + 1]
    inter = 2 * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
    mult = 3.0 if shape["kind"] == "train" else 1.0
    return mult * b * (mlp + inter)


def _metrics_specs(out):
    return {k: () for k in out[2]}


@dataclasses.dataclass
class ModelCell:
    """One model cell's step before it is walked: the step on ``meta``,
    the reference's arguments as meta trees (``args``), the JAX package's
    sharding spec of each (``arg_specs``), the spec of the step's result
    (``out_specs(result)``), the segments the walk keeps apart and the
    reference's ``model_flops``."""

    fn: object
    args: tuple
    arg_specs: tuple
    out_specs: object
    model_flops: float
    segments: Optional[dict] = None


def model_cell(cfg, shape: dict, mesh) -> ModelCell:
    """The step of one model cell, following the JAX package's
    ``run_cell``: the same step per ``kind`` and the same arguments.  The
    specs are the reference's ``in_shardings`` (and its ``out_shardings``
    where it names them: the LM train and decode steps).  Where it names
    none, a result takes its input's spec (parameters and optimiser
    state), the batch's (a prediction a row) or none (metrics, the top
    100)."""
    from ..models.steps import spec

    if cfg.family == "lm":
        from ..models import steps
        from .roofline import model_flops_lm

        dp = steps._dp_spec(mesh)
        kind = shape["kind"]
        mf = model_flops_lm(cfg, shape)
        if kind == "train":
            fn, info = steps.build_lm_train_step(cfg, mesh, device="meta")
            specs = steps.lm_input_specs(cfg, shape, step="train")
            bspec = {"tokens": spec(dp, None), "labels": spec(dp, None)}
            return ModelCell(
                fn, (info["dummy"], info["opt_shape"], specs["batch"], 0),
                (info["params"], info["opt"], bspec, ()),
                lambda out: (info["params"], info["opt"],
                             _metrics_specs(out)), mf,
                {"microbatch": (steps, "_microbatch_grads")})
        if kind == "prefill":
            fn, info = steps.build_lm_prefill_step(cfg, mesh, device="meta")
            specs = steps.lm_input_specs(cfg, shape, step="prefill")
            return ModelCell(fn, (info["dummy"], specs["tokens"]),
                             (info["params"], spec(dp, None)),
                             lambda out: spec(dp), mf)
        if kind == "decode":
            fn, info = steps.build_lm_decode_step(cfg, mesh, device="meta")
            specs = steps.lm_input_specs(cfg, shape, step="decode")
            return ModelCell(
                fn, (info["dummy"], specs["cache"], specs["token"],
                     specs["cache_len"]),
                (info["params"], info["cache"], spec(dp), spec(dp)),
                lambda out: (spec(dp), info["cache"]), mf)
        raise ValueError(f"no LM step of kind {kind!r}")
    if cfg.family == "gnn":
        from ..models import gnn_steps as gs

        d_feat = gs.gnn_feat_dim(cfg, shape)
        batch = gs.gnn_input_specs(cfg, shape)
        build, info = gs.build_gnn_train_step(cfg, mesh, d_feat,
                                              device="meta")
        opt_shape = info["opt_init"](info["dummy"])
        return ModelCell(
            build(batch), (info["dummy"], opt_shape, batch, 0),
            (info["params"], gs._replicated(opt_shape),
             info["batch_specs"](batch), ()),
            lambda out: (info["params"], gs._replicated(opt_shape),
                         _metrics_specs(out)),
            _gnn_model_flops(cfg, shape))
    if cfg.family == "recsys":
        from ..models import gnn_steps as gs

        specs = gs.recsys_input_specs(cfg, shape)
        mf = _recsys_model_flops(cfg, shape)
        dp = gs._dp_axes(mesh)
        if shape["kind"] == "train":
            fn, info = gs.build_dlrm_train_step(cfg, mesh, device="meta")
            opt_shape = info["opt_init"](info["dummy"])
            return ModelCell(
                fn, (info["dummy"], opt_shape, specs, 0),
                (info["params"], info["opt"], info["batch"], ()),
                lambda out: (info["params"], info["opt"],
                             _metrics_specs(out)), mf)
        if shape["kind"] == "retrieval":
            fn, info = gs.build_dlrm_retrieval_step(cfg, mesh, device="meta")
            return ModelCell(
                fn, (info["dummy"], specs["dense"], specs["cand_ids"]),
                (info["params"], (), info["cand_ids"]),
                lambda out: tuple(() for _ in out), mf)
        fn, info = gs.build_dlrm_serve_step(cfg, mesh, device="meta")
        return ModelCell(
            fn, (info["dummy"], specs["dense"], specs["sparse_ids"]),
            (info["params"], spec(dp, None), spec(dp, None, None)),
            lambda out: spec(dp), mf)
    raise ValueError(cfg.family)


def lm_walk_plan(cfg, shape: dict):
    """The walks an LM cell is extrapolated from: a list of ``(coefficient,
    cfg, shape)``, the cell's step being ``Σ coefficient · walk``
    (:func:`~repro_torch.launch.roofline.combine_walks`).

    Each stack (the dense one where the config has it, and the main one)
    is walked at one layer and at two, the other at one; a train step at
    one microbatch and at two (global batch ``mb`` and ``2·mb``).  The
    counts are ``Q(x, n) = A(x) + n·B(x)`` with ``A`` and ``B`` affine in
    the depths ``x``: every layer of a stack and every microbatch has the
    same shapes, and the optimiser's work grows with the layers only.  With
    ``t = n − 1`` and ``d_i`` the depths past the base, the coefficient of
    the base at one microbatch is ``(1 − Σd)(1 − t)``, at two ``(1 − Σd)·t``,
    and of stack ``i`` one layer deeper ``d_i(1 − t)`` and ``d_i·t``; a
    walk whose coefficient is 0 is left out.

    The live bytes are combined the same way at each point of the program
    where tensors are made (:func:`~repro_torch.launch.roofline.combine_walks`),
    and the peak is the most of them.  A train step's peak equals a full
    walk's, on the smoke configs stretched to four and five layers and on
    chatglm3-6b's and qwen2-0.5b's own depth; a serving step's is over by
    up to 0.29 % on the stretched configs and 0.02 % at qwen2-0.5b's own
    depth (its first layer holds less than the later ones), never under
    (``tests/test_torch_dryrun_walks.py``).  Refused, as a sampled engine walk refuses uneven
    device-steps: a step kind other than train, prefill and decode, a
    batch that the microbatch does not divide, and an MoE config without a
    MoE layer."""
    from ..models.transformer import _stack_sizes

    kind = shape["kind"]
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"no LM walk of kind {kind!r}")
    dense, main = _stack_sizes(cfg)
    if main < 1:
        raise ValueError(
            f"{cfg.name}: {cfg.n_layers} layers and {dense} dense ones leave "
            "the main stack empty; the affine walk needs one layer of it")
    base = (1 if dense else 0, 1)
    d = (dense - base[0], main - base[1])
    # (coefficient, depths): the base, and each stack one layer deeper
    points = [(1 - sum(d), base)] + [
        (d[i], tuple(b + (j == i) for j, b in enumerate(base)))
        for i in range(2) if base[i]]
    n, mults = 1, (1,)
    if kind == "train":
        b = shape["global_batch"]
        mb = min(cfg.microbatch_size, b)
        if b % mb:
            raise ValueError(f"{cfg.name}: a batch of {b} does not split into "
                             f"microbatches of {mb}")
        n = b // mb
        if n > 1:
            mults = (1, 2)
    t = n - 1
    plan = []
    for c, depth in points:
        wcfg = dataclasses.replace(cfg, first_dense_layers=depth[0]
                                   if cfg.moe else cfg.first_dense_layers,
                                   n_layers=depth[0] + depth[1])
        for m in mults:
            cm = c * ((1 - t) if m == 1 else t) if len(mults) > 1 else c
            wshape = dict(shape)
            if kind == "train":
                wshape["global_batch"] = mb * m
            if cm:
                plan.append((cm, wcfg, wshape))
    return plan


def walk_cell(cfg, shape: dict, meshes=None):
    """The walk of ``cfg``'s step at ``shape``, ``(StepWalk, outputs)``:
    an LM step combined from the walks of :func:`lm_walk_plan`, a GNN or
    DLRM step walked whole.  ``outputs`` maps each name of ``meshes`` (a
    dict of name to mesh; default the pod) to one device's bytes of the
    step's result.  The steps ignore the mesh but for their specs, so one
    walk serves every mesh."""
    from .mesh import make_production_mesh
    from .roofline import combine_walks, shard_bytes, walk_step

    meshes = meshes or {"pod": make_production_mesh()}
    plan = (lm_walk_plan(cfg, shape) if cfg.family == "lm"
            else [(1, cfg, shape)])
    terms, outputs = [], {m: 0 for m in meshes}
    for c, wcfg, wshape in plan:
        cells = {m: model_cell(wcfg, wshape, mesh)
                 for m, mesh in meshes.items()}
        cell = next(iter(cells.values()))
        walk = walk_step(cell.fn, *cell.args, segments=cell.segments)
        for m, mesh in meshes.items():
            outputs[m] += c * shard_bytes(
                walk.result, cells[m].out_specs(walk.result), mesh)
        walk.result = None
        terms.append((c, walk))
    return combine_walks(terms), outputs


_WALKS: Dict[Tuple[str, str], tuple] = {}


def walk_model_cell(arch: str, shape_name: str):
    """The walk of one model cell, ``(StepWalk, outputs, seconds)``, once a
    process (:func:`walk_cell` on both production meshes)."""
    from ..configs import get_config
    from .mesh import make_production_mesh

    key = (arch, shape_name)
    if key not in _WALKS:
        cfg = get_config(arch)
        meshes = {m: make_production_mesh(multi_pod=m == "multipod")
                  for m in ("pod", "multipod")}
        t0 = time.perf_counter()
        walk, outputs = walk_cell(cfg, cfg.shapes[shape_name], meshes)
        _WALKS[key] = (walk, outputs, time.perf_counter() - t0)
    return _WALKS[key]


def _run_model_cell(cfg, shape_name: str, mesh, mesh_name: str,
                    label: str) -> dict:
    from .roofline import roofline_from_step, shard_bytes, tree_tensors

    shape = cfg.shapes[shape_name]
    cell = model_cell(cfg, shape, mesh)
    walk, outputs, _ = walk_model_cell(cfg.name, shape_name)
    staged = sum(t.numel() * t.element_size()
                 for t in tree_tensors(list(cell.args)))
    if walk.staged_bytes != staged:
        raise ValueError(
            f"{label}: the combined walks stage {walk.staged_bytes} bytes, "
            f"the cell's arguments are {staged}: the affine rule failed")
    rep = roofline_from_step(
        label, walk, mesh_name=mesh_name, chips=mesh.size,
        model_flops=cell.model_flops,
        args_per_device=shard_bytes(cell.args, cell.arg_specs, mesh),
        outputs_per_device=outputs[mesh_name])
    return rep.row()


def run_cell(arch: str, shape_name: str, mesh_name: str) -> dict:
    """The row of one cell: a model step's walk, or a triangle-count
    graph's engine walk."""
    from ..configs import get_config
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    label = f"{arch}:{shape_name}:{mesh_name}"
    if cfg.family == "tc":
        return _run_tc_cell(cfg, shape_name, mesh, label)
    if cfg.family in ("lm", "gnn", "recsys"):
        return _run_model_cell(cfg, shape_name, mesh, mesh_name, label)
    raise ValueError(cfg.family)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Dry-run a cell on meta tensors.")
    ap.add_argument("--cell", help="arch:shape:mesh")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--fewest-cards", action="store_true",
                    help="for each triangle-count cell, the fewest cards "
                         "that hold its count (fewest_cards), one JSON line "
                         "each")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.list:
        for c in all_cells():
            print(":".join(c))
        return
    if args.fewest_cards:
        from ..configs import TC_GRAPHS, get_config
        from .mesh import make_production_mesh

        for arch, sched, mesh_name in all_cells():
            if arch not in TC_GRAPHS:
                continue
            mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
            cards, peak = fewest_cards(get_config(arch), sched, mesh)
            print(json.dumps(dict(name=f"{arch}:{sched}:{mesh_name}",
                                  positions=mesh.size, cards=cards,
                                  card_bytes=peak)), flush=True)
        return
    if not args.cell:
        ap.error("give --cell arch:shape:mesh or --list")

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
