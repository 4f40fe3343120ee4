"""Step builders, sharding specs and input specs for the GNN and recsys
families (the JAX package's ``models/gnn_steps.py``).

The reference compiles each step with ``jax.jit`` over a device mesh; on
one card a step is an eager function.  The sharding recipe survives as
data, as :mod:`.steps` keeps the LM's: a spec is a tuple of axis names
(``None`` for a replicated dimension).  GNN edge arrays go over the
flattened ``(pod, data, model)`` axes and node arrays over their node
dimension; recsys batches over ``(pod, data)`` with the concatenated
embedding table row-sharded over ``model``.  Input specs are meta
tensors.  ``mesh`` may be ``None`` (one card: ``("data", "model")``) or a
:class:`~repro_torch.launch.mesh.LogicalMesh`.

On a :class:`~repro_torch.launch.mesh.DeviceMesh` every step runs
sharded by those specs: parameters, AdamW's moments and the batch as
:class:`~.sharding.ShardedTensor` shards (``info["shard"]``,
``info["opt_init"]``, ``info["shard_batch"]``; a host batch is sharded by
the step itself), the model bodies in lockstep over the positions
(:mod:`.lockstep`: the gathers, scatters and sums GSPMD inserts, written
out), and each gradient shard summed over the positions that hold it but
saw other rows — every axis for a GNN (parameters replicated, nodes and
edges sharded over all of them), ``(pod, data)`` for DLRM (never over
``model``: its positions hold one data group's rows alike).  A step on a
mesh takes no ``device``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import GNNConfig, RecsysConfig
from ..device import resolve_device
from ..launch.mesh import DeviceMesh
from ..optim import make_optimizer
from ..optim._tree import tree_leaves, tree_map
from ..optim.adamw import adamw_update, global_sq_sum
from . import lockstep, sharding
from .dlrm import (dlrm_forward, dlrm_init, dlrm_loss, dlrm_retrieval,
                   padded_rows)
from .gnn.equiformer_v2 import equiformer_energy, equiformer_init
from .gnn.gat import gat_apply, gat_init
from .gnn.graphcast import graphcast_apply, graphcast_init
from .gnn.nequip import nequip_energy_forces, nequip_init
from .lockstep import Mean, Psum
from .steps import _assemble, _check_sharded, _no_device, _on, spec

__all__ = [
    "gnn_init",
    "gnn_loss",
    "build_gnn_train_step",
    "gnn_batch_specs",
    "gnn_input_specs",
    "gnn_feat_dim",
    "dlrm_param_specs",
    "build_dlrm_train_step",
    "build_dlrm_serve_step",
    "build_dlrm_retrieval_step",
    "recsys_input_specs",
]

EQUIVARIANT = ("nequip", "equiformer_v2")


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names) if mesh is not None else ("data", "model")


def _all_axes(mesh) -> Tuple[str, ...]:
    names = _axis_names(mesh)
    return tuple(a for a in ("pod", "data", "model") if a in names)


def _dp_axes(mesh) -> Tuple[str, ...]:
    names = _axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _replicated(tree):
    return tree_map(lambda x: (None,) * x.dim(), tree)


def _grads(loss_fn, params):
    """``(loss, metrics, grads)`` of ``loss_fn(live)``: ``live`` are fresh
    leaves holding ``params``' values, and ``grads`` has ``params``'
    structure (zeros where the loss does not reach a leaf, as
    ``jax.grad`` gives)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live)
        flat = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    it = iter(flat)
    grads = tree_map(lambda p: _or_zeros(next(it), p), live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def _train_step(loss_fn, opt_update, dev, check):
    def step(params, opt_state, batch, step_i):
        check(params)
        batch = {k: _on(dev, v) for k, v in batch.items()}
        _, metrics, grads = _grads(lambda p: loss_fn(p, batch), params)
        with torch.no_grad():
            new_p, new_o, stats = opt_update(grads, opt_state, params,
                                             int(step_i))
        return new_p, new_o, {**metrics, **stats}

    return step


def _checker(dev: torch.device):
    def check(params):
        got = tree_leaves(params)[0].device
        if got != dev:
            raise ValueError(f"the parameters lie on {got}, the step runs "
                             f"on {dev}: move them first")

    return check


# ----------------------------------------------------------------------
# GNN
# ----------------------------------------------------------------------
def gnn_init(gen, cfg: GNNConfig, d_feat: int, *, device=None):
    """The reference's parameter tree of ``cfg.arch``, drawn from ``gen``
    on ``device`` (``"meta"`` draws nothing)."""
    if cfg.arch == "gat":
        return gat_init(gen, cfg, d_feat, device=device)
    if cfg.arch == "graphcast":
        return graphcast_init(gen, cfg, d_feat, device=device)
    if cfg.arch == "nequip":
        return nequip_init(gen, cfg, device=device)
    if cfg.arch == "equiformer_v2":
        return equiformer_init(gen, cfg, device=device)
    raise ValueError(cfg.arch)


@lockstep.body
def gnn_loss(params, cfg: GNNConfig, batch):
    """``(loss, {"loss": loss})``: energy (and NequIP's force) MSE, GAT's
    masked cross-entropy, GraphCast's MSE.  On a mesh ``batch`` is each
    position's shards (:func:`gnn_batch_specs`) and the means and sums
    run over the global nodes."""
    if cfg.arch in EQUIVARIANT:
        args = (params, cfg, batch["species"], batch["positions"],
                batch["edge_src"], batch["edge_dst"], batch["graph_id"],
                batch["energy"].shape[0])
        if cfg.arch == "nequip":
            energy, forces = yield from lockstep.call(nequip_energy_forces,
                                                      *args)
            loss = torch.mean((energy - batch["energy"]) ** 2)
            loss = loss + (yield Mean((forces - batch["forces"]) ** 2))
        else:
            energy = yield from lockstep.call(equiformer_energy, *args)
            loss = torch.mean((energy - batch["energy"]) ** 2)
        return loss, {"loss": loss}
    if cfg.arch == "gat":
        logits = yield from lockstep.call(gat_apply, params, cfg,
                                          batch["feats"], batch["edge_src"],
                                          batch["edge_dst"])
        mask = batch["label_mask"]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, batch["labels"].long()[:, None])[:, 0]
        ce = (yield Psum(torch.sum((logz - gold) * mask), "loss")) / (
            torch.clamp((yield Psum(torch.sum(mask), "loss")), min=1.0))
        return ce, {"loss": ce}
    if cfg.arch == "graphcast":
        pred = yield from lockstep.call(graphcast_apply, params, cfg,
                                        batch["feats"], batch["edge_src"],
                                        batch["edge_dst"])
        mse = yield Mean((pred - batch["target"]) ** 2)
        return mse, {"loss": mse}
    raise ValueError(cfg.arch)


def gnn_batch_specs(batch, mesh=None) -> Dict[str, Tuple]:
    """The reference's input sharding of each batch entry: edge arrays
    over all axes, other arrays over their first dimension, ``energy``
    and scalars replicated."""
    axes = _all_axes(mesh)
    out = {}
    for k, v in batch.items():
        if k.startswith("edge"):
            out[k] = spec(axes)
        elif v.ndim >= 1 and k not in ("energy",):
            out[k] = spec(axes, *([None] * (v.ndim - 1)))
        else:
            out[k] = ()
    return out


def build_gnn_train_step(cfg: GNNConfig, mesh=None, d_feat: int = 0, *,
                         device=None):
    """``(build, info)``: ``build(batch)`` returns the step
    ``fn(params, opt_state, batch, step) -> (params, opt_state, metrics)``
    on ``device`` (default: the CUDA device), AdamW at lr 5e-3 without
    weight decay (the GAT paper's settings); ``metrics`` holds ``loss``
    and ``grad_norm``.  NequIP's loss on forces is differentiated twice:
    the forces keep their graph, and the outer gradient is over the
    parameters only.  ``info`` carries ``params`` (spec tree),
    ``opt_init``, ``dummy`` (meta tensors) and ``batch_specs``
    (:func:`gnn_batch_specs` on this mesh).  On a :class:`DeviceMesh`
    the step runs sharded (:func:`_gnn_train_step_mesh`)."""
    if isinstance(mesh, DeviceMesh):
        _no_device(device)
        return _gnn_train_step_mesh(cfg, mesh, d_feat)
    dev = resolve_device(device)
    opt_init, opt_update = make_optimizer("adamw", lambda s: 5e-3,
                                          weight_decay=0.0)
    step = _train_step(lambda p, b: gnn_loss(p, cfg, b), opt_update, dev,
                       _checker(dev))

    def build(batch_struct):
        del batch_struct  # the reference compiles for it; eager runs any
        return step

    dummy = gnn_init(None, cfg, d_feat, device="meta")
    return build, dict(params=_replicated(dummy), opt_init=opt_init,
                       dummy=dummy,
                       batch_specs=lambda b: gnn_batch_specs(b, mesh))


def _pad_to(x: int, mult: int = 512) -> int:
    return ((x + mult - 1) // mult) * mult


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def gnn_input_specs(cfg: GNNConfig, shape: dict) -> Dict[str, torch.Tensor]:
    """Meta tensors standing for each batch entry of a GNN shape cell.

    Node/edge counts are padded to a multiple of 512 so the arrays shard
    evenly on both production meshes (the pipeline pads with masked no-op
    edges on real runs)."""
    f32, i32 = torch.float32, torch.int32
    if shape["kind"] == "sampled":
        b = shape["batch_nodes"]
        f1, f2 = shape["fanout"]
        n = b * (1 + f1 + f1 * f2) + 1
        e = b * f1 + b * f1 * f2 + 1
    elif shape["kind"] == "batched":
        n = shape["n_nodes"] * shape["batch"]
        e = shape["n_edges"] * shape["batch"]
    else:
        n, e = shape["n_nodes"], shape["n_edges"]
    n, e = _pad_to(n), _pad_to(e)
    d_feat = shape.get("d_feat", 128)
    batch = {"edge_src": _meta((e,), i32), "edge_dst": _meta((e,), i32)}
    if cfg.arch in EQUIVARIANT:
        n_graphs = shape.get("batch", 1)
        batch.update(
            species=_meta((n,), i32),
            positions=_meta((n, 3), f32),
            graph_id=_meta((n,), i32),
            energy=_meta((n_graphs,), f32),
        )
        if cfg.arch == "nequip":
            batch["forces"] = _meta((n, 3), f32)
    elif cfg.arch == "gat":
        batch.update(
            feats=_meta((n, d_feat), f32),
            labels=_meta((n,), i32),
            label_mask=_meta((n,), f32),
        )
    else:  # graphcast
        nv = cfg.n_vars or d_feat
        batch.update(feats=_meta((n, nv), f32), target=_meta((n, nv), f32))
    return batch


def gnn_feat_dim(cfg: GNNConfig, shape: dict) -> int:
    if cfg.arch in EQUIVARIANT:
        return 0
    if cfg.arch == "graphcast":
        return cfg.n_vars
    return shape.get("d_feat", 128)


# ----------------------------------------------------------------------
# recsys (DLRM)
# ----------------------------------------------------------------------
def _big_table(x) -> bool:
    return x.dim() == 2 and x.shape[0] > 4096


def dlrm_param_specs(params, *, tp="model"):
    """The concatenated table row-sharded over ``tp``; the MLPs
    replicated."""
    return tree_map(lambda x: spec(tp, None) if _big_table(x)
                    else (None,) * x.dim(), params)


def _dlrm_opt_specs(opt_state):
    def leaf(x):
        if _big_table(x):
            return spec("model", None)
        if x.dim() >= 1 and x.shape[0] > 4096:  # adafactor factored rows
            return spec("model")
        return (None,) * x.dim()

    return tree_map(leaf, opt_state)


def _dlrm_dummy(cfg):
    return dlrm_init(None, cfg, device="meta")


def build_dlrm_train_step(cfg: RecsysConfig, mesh=None, *, device=None):
    """``(fn, info)``: ``fn(params, opt_state, batch, step)`` on ``device``
    (default: the CUDA device), AdamW at lr 1e-3 with its default weight
    decay; ``batch`` holds ``dense``, ``sparse_ids`` and ``labels``
    (numpy or tensors); ``metrics`` holds ``loss`` and ``grad_norm``.
    ``info`` carries ``params`` and ``opt`` (spec trees), ``batch``
    (its specs), ``opt_init`` and ``dummy`` (meta tensors).  On a
    :class:`DeviceMesh` the step runs sharded
    (:func:`_dlrm_train_step_mesh`)."""
    if isinstance(mesh, DeviceMesh):
        _no_device(device)
        return _dlrm_train_step_mesh(cfg, mesh)
    dev = resolve_device(device)
    opt_init, opt_update = make_optimizer("adamw", lambda s: 1e-3)
    fn = _train_step(
        lambda p, b: dlrm_loss(p, cfg, b["dense"], b["sparse_ids"],
                               b["labels"]),
        opt_update, dev, _checker(dev))
    dummy = _dlrm_dummy(cfg)
    return fn, dict(params=dlrm_param_specs(dummy),
                    opt=_dlrm_opt_specs(opt_init(dummy)), opt_init=opt_init,
                    dummy=dummy, batch=_dlrm_batch_specs(mesh))


def build_dlrm_serve_step(cfg: RecsysConfig, mesh=None, *, device=None):
    """``(fn, info)``: ``fn(params, dense, sparse_ids)`` -> click
    probabilities (B,), ``sigmoid`` of the forward.  On a
    :class:`DeviceMesh` the batch goes over ``(pod, data)`` and the
    probabilities come back in global batch order on position
    ``(0, ...)``'s device."""
    if isinstance(mesh, DeviceMesh):
        _no_device(device)
        return _dlrm_serve_step_mesh(cfg, mesh)
    dev = resolve_device(device)
    check = _checker(dev)

    @torch.no_grad()
    def serve(params, dense, sparse_ids):
        check(params)
        return torch.sigmoid(dlrm_forward(params, cfg, _on(dev, dense),
                                          _on(dev, sparse_ids)))

    dummy = _dlrm_dummy(cfg)
    return serve, dict(params=dlrm_param_specs(dummy), dummy=dummy)


def build_dlrm_retrieval_step(cfg: RecsysConfig, mesh=None, *, device=None):
    """``(fn, info)``: ``fn(params, dense, cand_ids)`` -> the top 100
    ``(values, indices)`` of one query against the candidates (sharded
    over every axis in the reference, and on a :class:`DeviceMesh`: the
    global top 100 on position ``(0, ...)``'s device)."""
    if isinstance(mesh, DeviceMesh):
        _no_device(device)
        return _dlrm_retrieval_step_mesh(cfg, mesh)
    dev = resolve_device(device)
    check = _checker(dev)

    @torch.no_grad()
    def retrieve(params, dense, cand_ids):
        check(params)
        return dlrm_retrieval(params, cfg, _on(dev, dense),
                              _on(dev, cand_ids))

    dummy = _dlrm_dummy(cfg)
    return retrieve, dict(params=dlrm_param_specs(dummy), dummy=dummy,
                          cand_ids=spec(_all_axes(mesh)))


# ----------------------------------------------------------------------
# the steps on a device mesh
# ----------------------------------------------------------------------
def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [q for k in sorted(tree)
                for q in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def _at(tree, p: int):
    """Position ``p``'s shards of a tree of :class:`ShardedTensor`."""
    return tree_map(lambda st: st.shards[p], tree)


def _shard_batch(batch, specs, mesh):
    """Each entry of a host batch (numpy or tensors) cut by ``specs``
    onto the mesh; an entry already sharded must be laid out so."""
    out = {}
    for k, want in specs.items():
        v = batch[k]
        if sharding.is_sharded(v):
            _check_sharded(v, want, mesh, "batch", k)
            out[k] = v
        else:
            out[k] = sharding.shard_tensor(torch.as_tensor(v), want, mesh)
    return out


def _grad_sum(mesh, path: str, g, axes):
    """Leaf ``path``'s gradient shards summed over ``axes``: the
    positions that hold the same shard of it but saw other rows.  A
    module function so a check can plant a fault in it."""
    del path
    return sharding.psum(g, mesh, axes, "grads")


def _mesh_train_step(mesh_run, pspecs, ospecs, loss_steps, lr, **adamw):
    """The train step on ``mesh_run``: ``loss_steps(params, batch)`` (a
    body returning ``(loss, metrics)``) run on every position's shards in
    lockstep, one backward from every position's loss (each seeded with
    one: the loss is replicated), each gradient summed over the row axes
    its spec does not name (:func:`_grad_sum`), AdamW shard by shard from
    the global norm (:func:`~repro_torch.optim.adamw.global_sq_sum`)."""
    mesh, lay = mesh_run.mesh, mesh_run.lay
    paths, leaf_specs = _paths(pspecs), tree_leaves(pspecs)

    def step(params, opt_state, shards, step_i):
        _check_sharded(params, pspecs, mesh, "parameters")
        _check_sharded(opt_state, ospecs, mesh, "optimiser state")
        live = [tree_map(lambda st: st.shards[p].detach().requires_grad_(True),
                         params) for p in range(lay.n)]
        with torch.enable_grad():
            outs = lockstep.run(mesh_run, [
                loss_steps(live[p], _at(shards, p)) for p in range(lay.n)])
            losses = [o[0] for o in outs]
            flat = [x for tree in live for x in tree_leaves(tree)]
            gs = torch.autograd.grad(
                losses, flat, grad_outputs=[torch.ones_like(x)
                                            for x in losses],
                allow_unused=True)
        nl = len(paths)
        summed = []
        for i, (path, sp) in enumerate(zip(paths, leaf_specs)):
            named = {a for e in sp for a in sharding._axes(e)}
            axes = tuple(a for a in mesh_run.rows if a not in named)
            summed.append(_grad_sum(mesh, path, [
                _or_zeros(gs[p * nl + i], flat[p * nl + i]).detach()
                for p in range(lay.n)], axes))
        del live, flat, gs
        it = iter(summed)
        grads = tree_map(lambda _: next(it), pspecs)
        with torch.no_grad():
            gsq = global_sq_sum(mesh, grads, pspecs)
            new = []
            for p in range(lay.n):
                new.append(adamw_update(
                    tree_map(lambda g: g[p], grads), _at(opt_state, p),
                    _at(params, p), int(step_i), lr=lr, gsq=gsq[p],
                    **adamw))
        metrics = {k: v.detach() for k, v in outs[0][1].items()}
        return (_assemble(params, [o[0] for o in new]),
                _assemble(opt_state, [o[1] for o in new]),
                {**metrics, **new[0][2]})

    return step


def _mesh_info(mesh, pspecs, ospecs, opt_shape, dummy, **extra):
    def opt_init(params):
        _check_sharded(params, pspecs, mesh, "parameters")
        return sharding.zeros_like_specs(opt_shape, ospecs, mesh)

    return dict(params=pspecs, opt=ospecs, opt_init=opt_init, dummy=dummy,
                opt_shape=opt_shape,
                shard=lambda t: sharding.shard_tree(t, pspecs, mesh),
                **extra)


def _gnn_train_step_mesh(cfg: GNNConfig, mesh, d_feat: int):
    """:func:`build_gnn_train_step` on a :class:`DeviceMesh`: nodes and
    edges sharded over every axis (:func:`gnn_batch_specs`), parameters
    and AdamW's moments replicated, each position's gradients psum-ed
    over every axis.  ``build(batch)`` returns ``fn(params, opt_state,
    batch, step)`` on shards (``info["shard"]``, ``info["opt_init"]``);
    ``batch`` a host batch or ``info["shard_batch"]``'s shards."""
    axes = _all_axes(mesh)
    opt_init, _ = make_optimizer("adamw", lambda s: 5e-3, weight_decay=0.0)
    dummy = gnn_init(None, cfg, d_feat, device="meta")
    pspecs = _replicated(dummy)
    opt_shape = opt_init(dummy)
    inner = _mesh_train_step(lockstep.MeshRun(mesh, axes), pspecs,
                             _replicated(opt_shape),
                             lambda p, b: gnn_loss.steps(p, cfg, b),
                             lambda s: 5e-3, weight_decay=0.0)

    def build(batch_struct):
        specs = gnn_batch_specs(batch_struct, mesh)

        def step(params, opt_state, batch, step_i):
            return inner(params, opt_state, _shard_batch(batch, specs, mesh),
                         step_i)

        return step

    return build, _mesh_info(
        mesh, pspecs, _replicated(opt_shape), opt_shape, dummy,
        batch_specs=lambda b: gnn_batch_specs(b, mesh),
        shard_batch=lambda b: _shard_batch(b, gnn_batch_specs(b, mesh),
                                           mesh))


def _dlrm_mesh(cfg, mesh, rows):
    dummy = _dlrm_dummy(cfg)
    pspecs = dlrm_param_specs(dummy)
    run = lockstep.MeshRun(mesh, rows, table_spec=pspecs["emb"]["table"],
                           table_rows=padded_rows(cfg))
    return dummy, pspecs, run


def _dlrm_batch_specs(mesh):
    dp = _dp_axes(mesh)
    return {"dense": spec(dp, None), "sparse_ids": spec(dp, None, None),
            "labels": spec(dp)}


def _dlrm_train_step_mesh(cfg: RecsysConfig, mesh):
    """:func:`build_dlrm_train_step` on a :class:`DeviceMesh`: the batch
    over ``(pod, data)``, the table row-sharded over ``model`` (more than
    4096 rows; else replicated) with its moments, the MLPs replicated;
    every gradient psum-ed over ``(pod, data)`` only."""
    dummy, pspecs, run = _dlrm_mesh(cfg, mesh, _dp_axes(mesh))
    opt_init, _ = make_optimizer("adamw", lambda s: 1e-3)
    opt_shape = opt_init(dummy)
    ospecs = _dlrm_opt_specs(opt_shape)
    bspecs = _dlrm_batch_specs(mesh)
    inner = _mesh_train_step(
        run, pspecs, ospecs,
        lambda p, b: dlrm_loss.steps(p, cfg, b["dense"], b["sparse_ids"],
                                     b["labels"]),
        lambda s: 1e-3)

    def fn(params, opt_state, batch, step_i):
        return inner(params, opt_state, _shard_batch(batch, bspecs, mesh),
                     step_i)

    return fn, _mesh_info(
        mesh, pspecs, ospecs, opt_shape, dummy, batch=bspecs,
        shard_batch=lambda b: _shard_batch(b, bspecs, mesh))


def _dlrm_serve_step_mesh(cfg: RecsysConfig, mesh):
    dp = _dp_axes(mesh)
    dummy, pspecs, run = _dlrm_mesh(cfg, mesh, dp)
    bspecs = _dlrm_batch_specs(mesh)

    @torch.no_grad()
    def serve(params, dense, sparse_ids):
        _check_sharded(params, pspecs, mesh, "parameters")
        b = _shard_batch({"dense": dense, "sparse_ids": sparse_ids},
                         {k: bspecs[k] for k in ("dense", "sparse_ids")},
                         mesh)
        logits = lockstep.run(run, [
            dlrm_forward.steps(_at(params, p), cfg, b["dense"].shards[p],
                               b["sparse_ids"].shards[p])
            for p in range(run.lay.n)])
        probs = [torch.sigmoid(x) for x in logits]
        return sharding.all_gather(probs, mesh, dp, 0, "out")[0]

    return serve, dict(params=pspecs, dummy=dummy,
                       shard=lambda t: sharding.shard_tree(t, pspecs, mesh))


def _dlrm_retrieval_step_mesh(cfg: RecsysConfig, mesh):
    axes = _all_axes(mesh)
    dummy, pspecs, run = _dlrm_mesh(cfg, mesh, axes)

    @torch.no_grad()
    def retrieve(params, dense, cand_ids):
        _check_sharded(params, pspecs, mesh, "parameters")
        b = _shard_batch({"dense": dense, "cand_ids": cand_ids},
                         {"dense": (), "cand_ids": spec(axes)}, mesh)
        return lockstep.run(run, [
            dlrm_retrieval.steps(_at(params, p), cfg, b["dense"].shards[p],
                                 b["cand_ids"].shards[p])
            for p in range(run.lay.n)])[0]

    return retrieve, dict(params=pspecs, dummy=dummy, cand_ids=spec(axes),
                          shard=lambda t: sharding.shard_tree(t, pspecs, mesh))


def recsys_input_specs(cfg: RecsysConfig, shape: dict):
    """Meta tensors standing for each input of a recsys shape cell."""
    f32, i32 = torch.float32, torch.int32
    if shape["kind"] == "retrieval":
        return dict(
            dense=_meta((1, cfg.n_dense), f32),
            cand_ids=_meta((_pad_to(shape["n_candidates"]),), i32),
        )
    b = shape["batch"]
    batch = dict(
        dense=_meta((b, cfg.n_dense), f32),
        sparse_ids=_meta((b, cfg.n_sparse, cfg.multi_hot), i32),
    )
    if shape["kind"] == "train":
        batch["labels"] = _meta((b,), f32)
    return batch
