"""GraphCast-style encode-process-decode mesh GNN (arXiv:2212.12794; the
JAX package's ``models/gnn/graphcast.py``).

Homogeneous formulation: the lat/lon<->mesh frontends are stubbed (the
inputs are features already on the mesh); the processor is the published
16-layer, 512-wide interaction network with sum aggregation, residual
updates, and LayerNorm.
"""
from __future__ import annotations

import torch

from .. import lockstep, nn
from ..lockstep import Gather, Rows, ScatterSum

__all__ = ["graphcast_init", "graphcast_apply"]


def graphcast_init(gen, cfg, d_feat: int, *, device=None):
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_hidden
    kw = dict(dtype=dtype, device=device)
    params = {
        "encoder": nn.mlp_init(gen, (d_feat, d, d), **kw),
        "decoder": nn.mlp_init(gen, (d, d, cfg.d_out), **kw),
    }
    for i in range(cfg.n_layers):
        params[f"proc{i}"] = {
            "edge_mlp": nn.mlp_init(gen, (2 * d, d, d), **kw),
            "node_mlp": nn.mlp_init(gen, (2 * d, d, d), **kw),
            "ln_e": nn.layernorm_init(d, dtype, device),
            "ln_n": nn.layernorm_init(d, dtype, device),
        }
    return params


@lockstep.body
def graphcast_apply(params, cfg, feats, edge_src, edge_dst):
    """feats (N, n_vars) -> next-state prediction (N, n_vars)."""
    n = yield Rows(feats)
    edge_src, edge_dst = edge_src.long(), edge_dst.long()
    h = nn.mlp(params["encoder"], feats)
    for i in range(cfg.n_layers):
        p = params[f"proc{i}"]
        h_all = yield Gather(h)
        e_in = torch.cat([h_all[edge_src], h_all[edge_dst]], dim=-1)
        m = nn.layernorm(p["ln_e"], nn.mlp(p["edge_mlp"], e_in))
        agg = yield ScatterSum(m, edge_dst, n)
        upd = nn.mlp(p["node_mlp"], torch.cat([h, agg], dim=-1))
        h = h + nn.layernorm(p["ln_n"], upd)  # residual processor step
    return nn.mlp(params["decoder"], h)
