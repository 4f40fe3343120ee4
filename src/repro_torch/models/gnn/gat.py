"""Graph Attention Network (GAT, arXiv:1710.10903), Cora config (the JAX
package's ``models/gnn/gat.py``).

SDDMM edge scores -> segment softmax -> SpMM, all on edge lists through
the :mod:`repro_torch.sparse` substrate, one body for one device and a
device mesh (:mod:`repro_torch.models.lockstep`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import lockstep, nn
from ..lockstep import Gather, Rows, ScatterSum, SegmentSoftmax

__all__ = ["gat_init", "gat_apply"]


def _layer_init(gen, d_in, d_out, heads, dtype, device):
    return {
        "w": nn.dense_init(gen, d_in, heads * d_out, dtype=dtype,
                           device=device),
        "a_src": nn.normal(gen, (heads, d_out), 0.1, dtype=dtype,
                           device=device),
        "a_dst": nn.normal(gen, (heads, d_out), 0.1, dtype=dtype,
                           device=device),
    }


def gat_init(gen, cfg, d_feat: int, *, device=None):
    dtype = getattr(torch, cfg.dtype)
    layers = {}
    d_in = d_feat
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.d_out if last else cfg.d_hidden
        layers[f"layer{i}"] = _layer_init(gen, d_in, d_out, cfg.n_heads,
                                          dtype, device)
        d_in = d_out * (1 if last else cfg.n_heads)
    return layers


def _gat_layer(p, x, edge_src, edge_dst, n_nodes, heads, *, concat, act):
    h = nn.dense(p["w"], x)
    d_out = p["a_src"].shape[1]
    h = h.reshape(-1, heads, d_out)  # (N, H, d)
    h = yield Gather(h)  # every node's rows, for the edges
    s_src = torch.einsum("nhd,hd->nh", h, p["a_src"])
    s_dst = torch.einsum("nhd,hd->nh", h, p["a_dst"])
    logits = F.leaky_relu(s_src[edge_src] + s_dst[edge_dst],
                          negative_slope=0.2)  # (E, H)
    alpha = yield SegmentSoftmax(logits, edge_dst, n_nodes)  # (E, H)
    msg = h[edge_src] * alpha[..., None]  # (E, H, d)
    out = yield ScatterSum(msg, edge_dst, n_nodes)  # (N, H, d)
    if concat:
        out = out.reshape(-1, heads * d_out)
    else:
        out = torch.mean(out, dim=1)
    return act(out) if act is not None else out


@lockstep.body
def gat_apply(params, cfg, feats, edge_src, edge_dst):
    """feats (N, d_feat) -> logits (N, d_out).  Self-loops are the caller's
    responsibility (Cora preprocessing adds them).  On a mesh ``feats``
    is each position's node rows and the edges its edges (global ids)."""
    n = yield Rows(feats)
    edge_src, edge_dst = edge_src.long(), edge_dst.long()
    x = feats
    nl = cfg.n_layers
    for i in range(nl):
        last = i == nl - 1
        x = yield from _gat_layer(
            params[f"layer{i}"],
            x,
            edge_src,
            edge_dst,
            n,
            cfg.n_heads,
            concat=not last,
            act=None if last else F.elu,
        )
    return x
