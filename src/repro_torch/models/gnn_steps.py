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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import GNNConfig, RecsysConfig
from ..device import resolve_device
from ..optim import make_optimizer
from ..optim._tree import tree_leaves, tree_map
from .dlrm import dlrm_forward, dlrm_init, dlrm_loss, dlrm_retrieval
from .gnn.equiformer_v2 import equiformer_energy, equiformer_init
from .gnn.gat import gat_apply, gat_init
from .gnn.graphcast import graphcast_apply, graphcast_init
from .gnn.nequip import nequip_energy_forces, nequip_init
from .steps import _on, spec

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


def gnn_loss(params, cfg: GNNConfig, batch):
    """``(loss, {"loss": loss})``: energy (and NequIP's force) MSE, GAT's
    masked cross-entropy, GraphCast's MSE."""
    if cfg.arch in EQUIVARIANT:
        args = (params, cfg, batch["species"], batch["positions"],
                batch["edge_src"], batch["edge_dst"], batch["graph_id"],
                batch["energy"].shape[0])
        if cfg.arch == "nequip":
            energy, forces = nequip_energy_forces(*args)
            loss = torch.mean((energy - batch["energy"]) ** 2)
            loss = loss + torch.mean((forces - batch["forces"]) ** 2)
        else:
            energy = equiformer_energy(*args)
            loss = torch.mean((energy - batch["energy"]) ** 2)
        return loss, {"loss": loss}
    if cfg.arch == "gat":
        logits = gat_apply(params, cfg, batch["feats"], batch["edge_src"],
                           batch["edge_dst"])
        mask = batch["label_mask"]
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, 1, batch["labels"].long()[:, None])[:, 0]
        ce = torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                           min=1.0)
        return ce, {"loss": ce}
    if cfg.arch == "graphcast":
        pred = graphcast_apply(params, cfg, batch["feats"],
                               batch["edge_src"], batch["edge_dst"])
        mse = torch.mean((pred - batch["target"]) ** 2)
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
        elif v.dim() >= 1 and k not in ("energy",):
            out[k] = spec(axes, *([None] * (v.dim() - 1)))
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
    (:func:`gnn_batch_specs` on this mesh)."""
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
    (its specs), ``opt_init`` and ``dummy`` (meta tensors)."""
    dev = resolve_device(device)
    opt_init, opt_update = make_optimizer("adamw", lambda s: 1e-3)
    fn = _train_step(
        lambda p, b: dlrm_loss(p, cfg, b["dense"], b["sparse_ids"],
                               b["labels"]),
        opt_update, dev, _checker(dev))
    dummy = _dlrm_dummy(cfg)
    dp = _dp_axes(mesh)
    return fn, dict(params=dlrm_param_specs(dummy),
                    opt=_dlrm_opt_specs(opt_init(dummy)), opt_init=opt_init,
                    dummy=dummy,
                    batch={"dense": spec(dp, None),
                           "sparse_ids": spec(dp, None, None),
                           "labels": spec(dp)})


def build_dlrm_serve_step(cfg: RecsysConfig, mesh=None, *, device=None):
    """``(fn, info)``: ``fn(params, dense, sparse_ids)`` -> click
    probabilities (B,), ``sigmoid`` of the forward."""
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
    over every axis in the reference)."""
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
