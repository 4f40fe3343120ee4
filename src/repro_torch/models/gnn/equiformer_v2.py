"""Equiformer-v2 (arXiv:2306.12059): equivariant graph attention with
eSCN SO(2) convolutions (the JAX package's
``models/gnn/equiformer_v2.py``).

The eSCN trick (arXiv:2302.03655): rotate each edge's irrep features into
a frame where the edge points along +z; there an SO(3)-equivariant
convolution is *block-diagonal in m*, and truncating to m <= m_max cuts
the tensor-product cost from O(L^6) to O(L^3).  The rotation ``D(R_edge)``
comes from :class:`.irreps.RotationBasis` (analytic Z-rotations and
constant J matrices).

Per block: eSCN message (SO(2) linear over m <= m_max, radially modulated)
-> graph attention (scalar-channel logits, segment softmax) -> aggregation
-> equivariant LayerNorm + per-l linear + gated nonlinearity + scalar FFN.

The init copies the reference's key use: every ``post/l{l}`` of a layer
is drawn from one key, so the matrices are equal across l; here one
matrix is drawn and shared the same way.
"""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ...sparse.segment import segment_sum
from .. import lockstep, nn
from ..lockstep import Gather, Psum, Rows, ScatterSum, SegmentSoftmax
from .irreps import RotationBasis, _z_pairing
from .nequip import _embed, _per_l, _shared, bessel_rbf, edge_geometry

__all__ = ["equiformer_init", "equiformer_energy"]

N_SPECIES = 16


def _sl(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


def equiformer_init(gen, cfg, *, device=None):
    dtype = getattr(torch, cfg.dtype)
    c, lm = cfg.d_hidden, cfg.l_max
    kw = dict(dtype=dtype, device=device)
    params = {
        "embed": nn.embed_init(gen, N_SPECIES, c, dtype, device),
        "readout": nn.mlp_init(gen, (c, c, 1), **kw),
    }
    n_m0 = lm + 1  # one m=0 component per l
    for i in range(cfg.n_layers):
        layer: Dict = {
            "radial": nn.mlp_init(gen, (cfg.n_rbf, 32, c), **kw),
            "w_m0": nn.dense_init(gen, c * n_m0, c * n_m0, **kw),
            "attn": nn.dense_init(gen, c, cfg.n_heads, **kw),
            "ffn": nn.mlp_init(gen, (c, 2 * c, c), **kw),
            "gate": nn.dense_init(gen, c, lm * c, **kw),
            "post": _shared(gen, c, lm, dtype, device),
        }
        for m in range(1, cfg.m_max + 1):
            n_lm = lm + 1 - m  # number of l's carrying this |m|
            if n_lm <= 0:
                continue
            layer[f"w_m{m}_r"] = nn.dense_init(gen, c * n_lm, c * n_lm, **kw)
            layer[f"w_m{m}_i"] = nn.dense_init(gen, c * n_lm, c * n_lm, **kw)
        params[f"layer{i}"] = layer
    return params


@functools.lru_cache(maxsize=None)
def _m_indexing(lm: int):
    """Per-l paired-basis metadata: (Q, pairs) from the Schur pairing."""
    qs, pairs = [], []
    for l in range(lm + 1):
        q, p = _z_pairing(l)
        qs.append(np.asarray(q, np.float32))
        pairs.append(p)
    return qs, pairs


@functools.lru_cache(maxsize=None)
def _q_tensors(lm: int, device: torch.device):
    return [torch.as_tensor(q, device=device) for q in _m_indexing(lm)[0]]


def _escn_message(layer_p, cfg, x_rot):
    """SO(2) linear conv on edge-frame features, m truncated to m_max.

    x_rot: (E, C, S) edge-aligned features.  Components are mapped into the
    per-l paired basis (Qᵀ f) where the z-rotation acts as per-|m| 2x2
    blocks; m=0 lines get a real linear over (C * n_l0), |m|>=1 pairs get
    a complex-structured linear; m > m_max is dropped (the eSCN cut).
    """
    c, lm = cfg.d_hidden, cfg.l_max
    _, pairs = _m_indexing(lm)
    qs = _q_tensors(lm, x_rot.device)
    e = x_rot.shape[0]

    # project into paired basis per l
    u = [torch.einsum("ecs,st->ect", x_rot[..., _sl(l)], qs[l].to(x_rot.dtype))
         for l in range(lm + 1)]
    # collect m=0 components (per l, the lines not in any pair).  Pairs
    # with negative Schur m rotate with the OPPOSITE orientation under the
    # residual z-rotation gauge; flipping the second component's sign maps
    # them to +|m| so one complex-linear map per |m| stays equivariant.
    m0_feats, m0_loc = [], []
    m_feats = {m: [] for m in range(1, cfg.m_max + 1)}
    m_loc = {m: [] for m in range(1, cfg.m_max + 1)}
    for l in range(lm + 1):
        d = 2 * l + 1
        in_pair = set()
        for (i, j, m) in pairs[l]:
            in_pair.add(i)
            in_pair.add(j)
            mm = int(round(abs(m)))
            sgn = 1.0 if m > 0 else -1.0
            if mm <= cfg.m_max:
                m_feats[mm].append(
                    torch.stack([u[l][..., i], sgn * u[l][..., j]], dim=-1)
                )  # (E, C, 2)
                m_loc[mm].append((l, i, j, sgn))
        for i in range(d):
            if i not in in_pair:
                m0_feats.append(u[l][..., i])  # (E, C)
                m0_loc.append((l, i))

    # the output's lines, per l; a line no map writes (m > m_max) is zero
    out_u = [[None] * (2 * l + 1) for l in range(lm + 1)]
    # m = 0: real linear across (l, channel)
    f0 = torch.cat(m0_feats, dim=-1).reshape(e, -1)  # (E, C*n_l0)
    y0 = nn.dense(layer_p["w_m0"], f0).reshape(e, c, len(m0_loc))
    for idx, (l, i) in enumerate(m0_loc):
        out_u[l][i] = y0[..., idx]
    # |m| >= 1: complex-structured linear shared over the 2 components
    for m in range(1, cfg.m_max + 1):
        if not m_feats[m]:
            continue
        fm = torch.stack(m_feats[m], dim=2)  # (E, C, n_lm, 2)
        n_lm = fm.shape[2]
        re = fm[..., 0].reshape(e, -1)
        im = fm[..., 1].reshape(e, -1)
        wr, wi = layer_p[f"w_m{m}_r"], layer_p[f"w_m{m}_i"]
        yr = nn.dense(wr, re) - nn.dense(wi, im)
        yi = nn.dense(wi, re) + nn.dense(wr, im)
        yr = yr.reshape(e, c, n_lm)
        yi = yi.reshape(e, c, n_lm)
        for idx, (l, i, j, sgn) in enumerate(m_loc[m]):
            out_u[l][i] = yr[..., idx]
            out_u[l][j] = sgn * yi[..., idx]

    # back from paired basis
    out = []
    zero = x_rot.new_zeros((e, c))
    for l in range(lm + 1):
        ul = torch.stack([v if v is not None else zero for v in out_u[l]],
                         dim=-1)
        out.append(torch.einsum("ect,st->ecs", ul, qs[l].to(ul.dtype)))
    return torch.cat(out, dim=-1)


def _equiv_layernorm(x, eps=1e-6):
    """RMS over (channel, component) per l-subspace — rotation invariant."""
    lm = int(np.sqrt(x.shape[-1])) - 1
    outs = []
    for l in range(lm + 1):
        blk = x[..., _sl(l)]
        norm = torch.sqrt(torch.mean(torch.sum(blk ** 2, dim=-1), dim=-1)
                          + eps)
        outs.append(blk / norm[..., None, None])
    return torch.cat(outs, dim=-1)


def _rotate(d_align, x, lm, back=False):
    """Each l block of x (E, C, S) by its edge's rotation (E, d, d), or by
    the rotation's transpose on the way ``back``."""
    eq = "eji,ecj->eci" if back else "eij,ecj->eci"
    return torch.cat([torch.einsum(eq, d_align[l], x[..., _sl(l)])
                      for l in range(lm + 1)], dim=-1)


@lockstep.body
def equiformer_energy(params, cfg, species, positions, edge_src, edge_dst,
                      graph_id, n_graphs):
    n = species.shape[0]
    n_all = yield Rows(species)
    c, lm = cfg.d_hidden, cfg.l_max
    edge_src, edge_dst = edge_src.long(), edge_dst.long()
    rb = RotationBasis(lm, device=positions.device)
    x = _embed(params, species, n, c, lm, positions.dtype)

    r, unit = edge_geometry((yield Gather(positions)), edge_src, edge_dst)
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff)
    # zero-length edges (self loops / padding) have no defined alignment
    # frame — their messages are masked out (required for equivariance)
    edge_ok = (r > 1e-6).to(positions.dtype)[:, None, None]
    # per-l alignment rotations (E, d, d)
    d_align = [rb.align_z(l, unit) for l in range(lm + 1)]

    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        xs = (yield Gather(_equiv_layernorm(x)))[edge_src]  # (E, C, S)
        x_rot = _rotate(d_align, xs, lm)  # into the edge frame
        msg = _escn_message(p, cfg, x_rot)
        msg = msg * nn.mlp(p["radial"], rbf)[:, :, None]  # radial modulation
        msg = msg * edge_ok  # degenerate-edge mask
        msg = _rotate(d_align, msg, lm, back=True)
        # graph attention on scalar channel
        logits = nn.dense(p["attn"], msg[..., 0])  # (E, heads)
        alpha = yield SegmentSoftmax(logits, edge_dst, n_all)  # (E, heads)
        msg = msg * torch.mean(alpha, dim=-1)[:, None, None]
        agg = yield ScatterSum(msg, edge_dst, n_all)
        agg = _per_l(agg, p["post"], lm)
        # gated nonlinearity + scalar FFN (added to the l=0 line)
        scal = agg[..., 0]
        gates = torch.sigmoid(nn.dense(p["gate"], scal).reshape(-1, lm, c))
        parts = [(nn.silu(scal) + nn.mlp(p["ffn"], scal))[..., None]]
        for l in range(1, lm + 1):
            parts.append(agg[..., _sl(l)] * gates[:, l - 1, :, None])
        x = x + torch.cat(parts, dim=-1)

    e_atom = nn.mlp(params["readout"], x[..., 0])[:, 0]
    return (yield Psum(segment_sum(e_atom, graph_id, n_graphs), "energy"))
