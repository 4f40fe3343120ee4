"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(the JAX package's ``models/moe.py``).

The (token, k) assignments are sorted by expert id (a stable sort), each
expert keeps at most ``capacity`` tokens (the overflow goes to a pad row
and is dropped), tokens are gathered into an ``(E, C, d)`` batch, the
expert SwiGLU runs as one grouped product, and the results are added back
with ``index_add_``, weighted by the router's probabilities.  The router
runs in float32; its top k breaks ties toward the lower expert index, as
``lax.top_k`` does (``torch.topk`` promises no order among equals).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import nn

__all__ = ["moe_init", "moe_apply", "swiglu_init", "swiglu_apply",
           "route", "capacity"]


def swiglu_init(gen, d: int, d_ff: int, dtype=torch.float32,
                n_experts: int = 0, device=None, lead=()):
    lead = (*lead, n_experts) if n_experts else tuple(lead)
    s = 1.0 / math.sqrt(d)
    s2 = 1.0 / math.sqrt(d_ff)
    kw = dict(dtype=dtype, device=device)
    return {
        "w_gate": nn.uniform(gen, (*lead, d, d_ff), -s, s, **kw),
        "w_in": nn.uniform(gen, (*lead, d, d_ff), -s, s, **kw),
        "w_out": nn.uniform(gen, (*lead, d_ff, d), -s2, s2, **kw),
    }


def swiglu_apply(p, x):
    gate = nn.silu(nn.matmul(x, p["w_gate"]))
    return nn.matmul(gate * nn.matmul(x, p["w_in"]), p["w_out"])


def moe_init(gen, d: int, n_experts: int, moe_d_ff: int, n_shared: int = 0,
             dtype=torch.float32, device=None, lead=()):
    p = {
        "router": nn.dense_init(gen, d, n_experts, dtype=dtype, device=device,
                                lead=lead),
        "experts": swiglu_init(gen, d, moe_d_ff, dtype, n_experts=n_experts,
                               device=device, lead=lead),
    }
    if n_shared:
        p["shared"] = swiglu_init(gen, d, n_shared * moe_d_ff, dtype,
                                  device=device, lead=lead)
    return p


def capacity(t: int, top_k: int, e: int,
             capacity_factor: float = 1.25) -> int:
    """Tokens an expert keeps: ``max(1, int(factor · T · k / E))``."""
    return max(1, int(capacity_factor * t * top_k / e))


def route(p, x, top_k: int):
    """The router in float32: ``(probs (T, E), top_p (T, k) renormalised,
    top_i (T, k))``."""
    logits = nn.dense(p["router"], x.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts equal probabilities in index order
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i


def moe_apply(p, x, *, top_k: int, capacity_factor: float = 1.25):
    """x: (T, d) -> (T, d); returns (y, aux) with the Switch load-balancing
    loss (float32)."""
    t, d = x.shape
    e = p["router"]["w"].shape[1]
    dev = x.device
    probs, top_p, top_i = route(p, x, top_k)

    cap = capacity(t, top_k, e, capacity_factor)
    flat_e = top_i.reshape(-1)  # (T*k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(top_k)
    flat_w = top_p.reshape(-1)

    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    # rank within the expert's group (se is sorted)
    pos = torch.arange(t * top_k, device=dev) - torch.searchsorted(
        se, se, right=False)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)  # overflow -> pad row

    xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    xe[slot] = x[st]
    xe = xe[:-1].reshape(e, cap, d)
    ex = p["experts"]
    gate = torch.einsum("ecd,edf->ecf", xe, ex["w_gate"])
    up = torch.einsum("ecd,edf->ecf", xe, ex["w_in"])
    ye = torch.einsum("ecf,efd->ecd", nn.silu(gate) * up, ex["w_out"])
    ye_flat = ye.reshape(e * cap, d)
    w = torch.where(keep, sw, 0.0)[:, None].to(x.dtype)
    contrib = w * ye_flat[torch.clamp_max(slot, e * cap - 1)]
    y = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, st, contrib)

    if "shared" in p:
        y = y + swiglu_apply(p["shared"], x)

    # Switch-style load-balancing aux loss, on each token's first choice
    me = probs.mean(dim=0)  # (E,)
    fe = F.one_hot(top_i[:, 0], e).to(torch.float32).mean(dim=0)
    aux = e * torch.sum(me * fe)
    return y, aux
