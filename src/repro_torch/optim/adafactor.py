"""Adafactor (factored second moments) for memory-constrained giants.

For a (r, c) matrix the second moment is stored as row/col means
(r + c floats instead of r*c); vectors fall back to full moments.
~4 bytes/param optimizer state vs AdamW's 8.
"""
from __future__ import annotations

import torch

from ._tree import tree_map

__all__ = ["adafactor_init", "adafactor_update", "adafactor_update_mesh"]


def _factored(shape):
    return len(shape) >= 2


def adafactor_init(params):
    def init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {
                "vr": torch.zeros(p.shape[:-1], **f32),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32),
            }
        return {"v": torch.zeros(p.shape, **f32)}

    return {"v": tree_map(init, params)}


def adafactor_update(
    grads,
    state,
    params,
    step,
    *,
    lr,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
):
    """One step with the factored ``vr`` / ``vc`` states of a matrix and
    the RMS update clip.  Returns ``(params, state, {})``."""
    lr_t = lr(step) if callable(lr) else lr
    beta = 1.0 - (step + 1.0) ** -decay

    def upd(g, v, p):
        g = g.to(torch.float32)
        g2 = torch.square(g) + eps
        if _factored(p.shape):
            vr = beta * v["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * v["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = (
                vr[..., None]
                * vc[..., None, :]
                / torch.clamp(torch.mean(vr, dim=-1)[..., None, None],
                              min=eps)
            )
            u = g * torch.rsqrt(torch.clamp(denom, min=eps))
            nv = {"vr": vr, "vc": vc}
        else:
            vf = beta * v["v"] + (1 - beta) * g2
            u = g * torch.rsqrt(torch.clamp(vf, min=eps))
            nv = {"v": vf}
        # update clipping (RMS)
        rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        newp = p.to(torch.float32) - lr_t * (
            u + weight_decay * p.to(torch.float32)
        )
        return newp.to(p.dtype), nv

    out = tree_map(upd, grads, state["v"], params)
    return (
        tree_map(lambda o: o[0], out),
        {"v": tree_map(lambda o: o[1], out)},
        {},
    )


def adafactor_update_mesh(mesh, grads, state, params, step, *, lr,
                          decay: float = 0.8, eps: float = 1e-30,
                          clip_threshold: float = 1.0,
                          weight_decay: float = 0.0):
    """:func:`adafactor_update` shard by shard on a mesh: ``params`` and
    ``state`` trees of :class:`~repro_torch.models.sharding.ShardedTensor`
    (the state under ``steps._opt_specs``), ``grads`` a tree of lists of
    the parameters' shards.  Every mean the update takes over a sharded
    dimension is a psum of the shards' sums over that dimension's axes
    over its global size: the factored ``vr`` (over the last dimension)
    and ``vc`` (over the one before), ``vr``'s mean, and the update's RMS
    over the whole leaf.  Returns ``(params, state, {})``."""
    from ..models import sharding as sh

    lr_t = lr(step) if callable(lr) else lr
    beta = 1.0 - (step + 1.0) ** -decay
    axes = sh._axes

    def psum(xs, entries):
        names = tuple(a for e in entries for a in axes(e))
        return sh.psum(xs, mesh, names, "opt")

    def upd(g, v, p):
        spec, shape = p.spec, p.shape
        g = [x.to(torch.float32) for x in g]
        g2 = [torch.square(x) + eps for x in g]
        if _factored(shape):
            rs = psum([x.sum(dim=-1) for x in g2], spec[-1:])
            cs = psum([x.sum(dim=-2) for x in g2], spec[-2:-1])
            vr = [beta * o + (1 - beta) * (r / shape[-1])
                  for o, r in zip(v["vr"].shards, rs)]
            vc = [beta * o + (1 - beta) * (c / shape[-2])
                  for o, c in zip(v["vc"].shards, cs)]
            mvr = psum([r.sum(dim=-1) for r in vr], spec[-2:-1])
            u = []
            for x, r, c, m in zip(g, vr, vc, mvr):
                denom = (r[..., None] * c[..., None, :]
                         / torch.clamp((m / shape[-2])[..., None, None],
                                       min=eps))
                u.append(x * torch.rsqrt(torch.clamp(denom, min=eps)))
            nv = {"vr": v["vr"].with_shards(vr),
                  "vc": v["vc"].with_shards(vc)}
        else:
            vf = [beta * o + (1 - beta) * x
                  for o, x in zip(v["v"].shards, g2)]
            u = [x * torch.rsqrt(torch.clamp(f, min=eps))
                 for x, f in zip(g, vf)]
            nv = {"v": v["v"].with_shards(vf)}
        numel = 1
        for n in shape:
            numel *= n
        sq = psum([torch.sum(torch.square(x)) for x in u], spec)
        out = []
        for x, s_, w in zip(u, sq, p.shards):
            rms = torch.sqrt(s_ / numel + eps)
            x = x / torch.clamp(rms / clip_threshold, min=1.0)
            w32 = w.to(torch.float32)
            out.append((w32 - lr_t * (x + weight_decay * w32)).to(w.dtype))
        return p.with_shards(out), nv

    res = tree_map(upd, grads, state["v"], params)
    return (tree_map(lambda o: o[0], res),
            {"v": tree_map(lambda o: o[1], res)}, {})
