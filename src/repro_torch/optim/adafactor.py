"""Adafactor (factored second moments) for memory-constrained giants.

For a (r, c) matrix the second moment is stored as row/col means
(r + c floats instead of r*c); vectors fall back to full moments.
~4 bytes/param optimizer state vs AdamW's 8.
"""
from __future__ import annotations

import torch

from ._tree import tree_map

__all__ = ["adafactor_init", "adafactor_update"]


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
