"""AdamW with fp32 moments and decoupled weight decay.

Params, grads and states are dicts of tensors (nested dicts allowed), as
the JAX package's are pytrees; each update returns new tensors and leaves
its inputs as they were.
"""
from __future__ import annotations

import torch

from ._tree import tree_leaves, tree_map

__all__ = ["adamw_init", "adamw_update", "global_sq_sum"]


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def adamw_update(
    grads,
    state,
    params,
    step,
    *,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
    gsq=None,
):
    """One step: the global grad-norm clip, then the bias-corrected Adam
    update with decoupled weight decay.  Returns ``(params, state,
    {"grad_norm": ...})``.  ``gsq``, where given, is the gradients' global
    sum of squares (a mesh's shards update one by one, the norm being the
    whole tree's: :func:`global_sq_sum`)."""
    lr_t = lr(step) if callable(lr) else lr
    # global grad-norm clip
    if gsq is None:
        gsq = sum(
            torch.sum(torch.square(g.to(torch.float32)))
            for g in tree_leaves(grads)
        )
    gnorm = torch.sqrt(gsq)
    # a true division: ``scalar / tensor`` would multiply by a reciprocal
    scale = torch.clamp(
        torch.full_like(gnorm, clip_norm) / torch.clamp(gnorm, min=1e-9),
        max=1.0)
    bc1 = 1 - b1 ** (step + 1)
    bc2 = 1 - b2 ** (step + 1)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        mhat = m2 / bc1
        vhat = v2 / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(
            torch.float32)
        return (p.to(torch.float32) - lr_t * delta).to(p.dtype), m2, v2

    out = tree_map(upd, grads, state["m"], state["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2)}, {"grad_norm": gnorm}


def global_sq_sum(mesh, grads, specs):
    """The global sum of squares of a tree of gradient shards (lists, one
    tensor a position) laid out by ``specs``, on every position: each
    position sums the leaves it owns (index 0 along every axis a leaf's
    spec does not name, so a leaf replicated over an axis counts once,
    not once per position), and a psum over every axis adds them."""
    from ..models import sharding

    lay = sharding.layout(mesh)
    local = [torch.zeros((), dtype=torch.float32, device=d)
             for d in lay.devices]
    for g, spec in zip(tree_leaves(grads), tree_leaves(specs)):
        for p in lay.owners(spec, g[0].dim()):
            local[p] = local[p] + torch.sum(torch.square(
                g[p].to(torch.float32)))
    return sharding.psum(local, mesh, lay.names, "grads")
