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

from . import nn, sharding

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


# ----------------------------------------------------------------------
# on a device mesh (lists with one tensor a position; see .sharding)
# ----------------------------------------------------------------------
def route_on_mesh(routers, xs, top_k: int):
    """:func:`route` at every position, on its own tokens (``routers``
    each position's ``{"w": ...}``): a list of ``(probs, top_p,
    top_i)``."""
    return [route({"router": r}, x, top_k) for r, x in zip(routers, xs)]


def moe_apply_mesh(mesh, p, xs, *, top_k: int, ep: bool, tp="model",
                   dp=("data",), capacity_factor: float = 1.25):
    """:func:`moe_apply` over a microbatch whose tokens are spread over
    ``dp`` (in order along ``dp``, each position's tokens after those
    of the positions before it), ``xs`` replicated over ``tp``; ``p``
    holds each position's expert weights gathered over the FSDP axis.

    The dispatch keeps the reference's global semantics: the capacity is
    ``capacity(T, k, E)`` over the global T and an assignment's rank within its
    expert is its place in the global stable order of (expert, token),
    from the per-expert counts of the positions before it along ``dp``
    (an all-gather of E integers).  With ``ep`` the experts lie in blocks
    over ``tp`` (the specs' ``P(tp, ...)``; the reference's docstring says
    cyclic) and each position runs its own; without, every position runs
    every expert on its chunk of ``moe_d_ff``.  Each position fills its
    experts' capacity slots with its own tokens only, adds their outputs
    into its tokens, and a psum over ``tp`` (the shared experts' row-
    parallel product included) completes them.  The aux loss of a
    position is its share: ``E · Σ me_pos · fe``, ``me_pos`` its
    probabilities' sum over the global T and ``fe`` the global first-
    choice frequency (a psum over ``dp``); the shares add up over ``dp``
    to the reference's.  Returns ``(ys, aux)``, lists."""
    lay = sharding.layout(mesh)
    dp = tuple(a for a in dp if a in lay.names)
    routes = route_on_mesh(p["router"], xs, top_k)
    e = p["router"][0]["w"].shape[1]
    # the microbatch's global tokens: the rows of one group along dp
    tg = sum(xs[j].shape[0] for j in lay.groups(dp)[0])
    cap = capacity(tg, top_k, e, capacity_factor)
    counts = [torch.bincount(r[2].reshape(-1), minlength=e)[None]
              for r in routes]
    counts = sharding.all_gather(counts, mesh, dp, 0, "route")
    xr = sharding.replicate(xs, mesh, tp, "act")
    top_pr = sharding.replicate([r[1] for r in routes], mesh, tp, "act")
    ex = p["experts"]
    ys, fes = [], []
    for q in range(lay.n):
        x = xr[q]
        t = x.shape[0]
        probs, _, top_i = routes[q]
        dev = x.device
        offset = counts[q][:lay.index(q, dp)].sum(dim=0)  # (E,)
        flat_e = top_i.reshape(-1)
        flat_t = torch.arange(t, device=dev).repeat_interleave(top_k)
        order = torch.argsort(flat_e, stable=True)
        se, st = flat_e[order], flat_t[order]
        sw = top_pr[q].reshape(-1)[order]
        rank = (torch.arange(t * top_k, device=dev)
                - torch.searchsorted(se, se, right=False) + offset[se])
        keep = rank < cap
        e0, e1 = (sharding.chunk(e, lay.size(tp), lay.index(q, tp)) if ep
                  else (0, e))
        el = e1 - e0
        mine = keep & (se >= e0) & (se < e1)
        slot = torch.where(mine, (se - e0) * cap + rank, el * cap)
        xe = torch.zeros((el * cap + 1, x.shape[1]), dtype=x.dtype,
                         device=dev)
        xe[slot] = x[st]
        xe = xe[:-1].reshape(el, cap, x.shape[1])
        gate = torch.einsum("ecd,edf->ecf", xe, ex["w_gate"][q])
        up = torch.einsum("ecd,edf->ecf", xe, ex["w_in"][q])
        ye = torch.einsum("ecf,efd->ecd", nn.silu(gate) * up, ex["w_out"][q])
        ye_flat = ye.reshape(el * cap, x.shape[1])
        w = torch.where(mine, sw, 0.0)[:, None].to(x.dtype)
        contrib = w * ye_flat[torch.clamp(slot, max=max(el * cap - 1, 0))]
        y = torch.zeros_like(x).index_add_(0, st, contrib)
        if "shared" in p:
            sh = p["shared"]
            g_ = nn.silu(nn.matmul(x, sh["w_gate"][q]))
            y = y + nn.matmul(g_ * nn.matmul(x, sh["w_in"][q]),
                              sh["w_out"][q])
        ys.append(y)
        fes.append(F.one_hot(top_i[:, 0], e).to(torch.float32).sum(dim=0))
    ys = sharding.psum(ys, mesh, tp, "act")
    fes = sharding.psum(fes, mesh, dp, "route")
    aux = [e * torch.sum((r[0].sum(dim=0) / tg) * (f.detach() / tg))
           for r, f in zip(routes, fes)]
    return ys, aux
