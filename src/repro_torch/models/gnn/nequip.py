"""NequIP (arXiv:2101.03164): E(3)-equivariant interatomic potential (the
JAX package's ``models/gnn/nequip.py``).

Species embedding into l=0 channels; per layer a Clebsch-Gordan
tensor-product interaction ``h_j ⊗ Y(r̂_ij)`` with radial weights from a
Bessel-RBF MLP; sum aggregation; per-l self-interaction linears; gated
nonlinearity (scalars SiLU, higher-l gated by scalar channels); scalar MLP
readout summed into total energy; forces by ``-∂E/∂positions`` (autograd,
with the graph kept when the caller differentiates the forces again).
Irreps layout: features as (N, C, (l_max+1)^2) concatenated real irreps.

The init copies the reference's key use: every ``self/l{l}`` of a layer
is drawn from one key, and so is every ``post/l{l}``, so the matrices are
equal across l.  Here one matrix is drawn and shared the same way.
"""
from __future__ import annotations

import math

import torch

from ...sparse.segment import segment_sum
from .. import lockstep, nn
from ..lockstep import Gather, Grad, Psum, Rows, ScatterSum
from .irreps import _cg_tensor, sph_dim, sph_harm, tp_paths

__all__ = ["nequip_init", "nequip_energy", "nequip_energy_forces",
           "bessel_rbf"]

N_SPECIES = 16


def _sl(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


def bessel_rbf(r, n_rbf: int, cutoff: float):
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    rc = cutoff
    x = torch.clamp(r / rc, 1e-6, 1.0)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = torch.sin(n[None, :] * math.pi * x[:, None]) / x[:, None]
    # polynomial cutoff (p=6)
    p = 6.0
    env = (
        1.0
        - (p + 1) * (p + 2) / 2 * x ** p
        + p * (p + 2) * x ** (p + 1)
        - p * (p + 1) / 2 * x ** (p + 2)
    )
    return basis * env[:, None]


def _shared(gen, c, lm, dtype, device):
    """``{l{l}: one dense}`` for every l: one matrix, as the reference's
    one key gives it."""
    w = nn.dense_init(gen, c, c, dtype=dtype, device=device)
    return {f"l{l}": w if l == 0 else {"w": w["w"].clone()}
            for l in range(lm + 1)}


def nequip_init(gen, cfg, *, device=None):
    dtype = getattr(torch, cfg.dtype)
    c, lm = cfg.d_hidden, cfg.l_max
    paths = tp_paths(list(range(lm + 1)), lm, lm)
    kw = dict(dtype=dtype, device=device)
    params = {
        "embed": nn.embed_init(gen, N_SPECIES, c, dtype, device),
        "readout": nn.mlp_init(gen, (c, c, 1), **kw),
    }
    for i in range(cfg.n_layers):
        params[f"layer{i}"] = {
            "radial": nn.mlp_init(gen, (cfg.n_rbf, 32, len(paths) * c), **kw),
            # per-l self interaction (channel mixing)
            "self": _shared(gen, c, lm, dtype, device),
            "post": _shared(gen, c, lm, dtype, device),
            "gate": nn.dense_init(gen, c, lm * c, **kw),  # scalars->gates
        }
    return params


def _cg_edge_terms(cfg, y_edge):
    """``einsum("ej,ijk->eik", Y_l2, CG)`` of every path with ``l2 > 0``
    (``None`` where ``l2 == 0``): the harmonics' half of the CG
    contraction.  It is the same in every layer, so it is made once a
    forward, as XLA's common-subexpression pass makes it once in the
    reference's compiled step, and its gradient is summed over the layers
    before its one backward product.  A path with ``l2 == 0`` keeps the
    three-operand einsum, which contracts the features with the CG matrix
    and scales by ``Y_0`` after, as XLA does."""
    lm = cfg.l_max
    return [
        None if l2 == 0 else torch.einsum(
            "ej,ijk->eik", y_edge[..., _sl(l2)],
            _cg_tensor(l1, l2, l3, y_edge.dtype, y_edge.device))
        for l1, l2, l3 in tp_paths(list(range(lm + 1)), lm, lm)
    ]


def _tensor_product_messages(layer_p, cfg, x, edge_src, y_edge, cg_terms,
                             rbf):
    """Per-edge CG tensor product with radial weights, summed into l_out:
    ``einsum("eci,ej,ijk->eck")``, taken as ``"eci,eik->eck"`` over the
    layer-independent terms of :func:`_cg_edge_terms` where it has one
    (the order in which ``torch.einsum`` contracts the three operands)."""
    c, lm = cfg.d_hidden, cfg.l_max
    paths = tp_paths(list(range(lm + 1)), lm, lm)
    w = nn.mlp(layer_p["radial"], rbf)  # (E, n_paths * C)
    w = w.reshape(-1, len(paths), c)
    xs = x[edge_src]  # (E, C, S)
    out = [None] * (lm + 1)
    for pi, (l1, l2, l3) in enumerate(paths):
        if cg_terms[pi] is None:
            cg = _cg_tensor(l1, l2, l3, xs.dtype, xs.device)
            t = torch.einsum("eci,ej,ijk->eck", xs[..., _sl(l1)],
                             y_edge[..., _sl(l2)], cg)
        else:
            t = torch.einsum("eci,eik->eck", xs[..., _sl(l1)], cg_terms[pi])
        term = w[:, pi, :, None] * t
        out[l3] = term if out[l3] is None else out[l3] + term
    return torch.cat(out, dim=-1)


def _gate(layer_p, cfg, x):
    """Equivariant gated nonlinearity."""
    c, lm = cfg.d_hidden, cfg.l_max
    scalars = x[..., 0]  # (N, C)
    gated = [nn.silu(scalars)[..., None]]
    if lm > 0:
        gates = torch.sigmoid(
            nn.dense(layer_p["gate"], scalars).reshape(-1, lm, c)
        )
        for l in range(1, lm + 1):
            gated.append(x[..., _sl(l)] * gates[:, l - 1, :, None])
    return torch.cat(gated, dim=-1)


def _per_l(x, mats, lm):
    """``einsum('ncs,cd->nds')`` of each l block with its matrix."""
    return torch.cat(
        [torch.einsum("ncs,cd->nds", x[..., _sl(l)], mats[f"l{l}"]["w"])
         for l in range(lm + 1)], dim=-1)


def _embed(params, species, n, c, lm, dtype):
    """(N, C, S) features: the species embedding in the l=0 line, zero
    elsewhere."""
    x0 = params["embed"]["table"][species.long()].to(dtype)
    rest = x0.new_zeros((n, c, sph_dim(lm) - 1))
    return torch.cat([x0[..., None], rest], dim=-1)


def edge_geometry(positions, edge_src, edge_dst):
    """``(r, unit)`` of every edge.  Self-loop and padding edges have zero
    length: the ``1e-12`` terms keep their length and gradient finite."""
    vec = positions[edge_dst] - positions[edge_src]
    r = torch.linalg.norm(vec + 1e-12, dim=-1)
    unit = vec / (r[:, None] + 1e-12)
    return r, unit


@lockstep.body
def nequip_energy(params, cfg, species, positions, edge_src, edge_dst,
                  graph_id, n_graphs):
    """Total energy per graph: (n_graphs,).  On a mesh the node arrays
    are each position's rows and the edges its edges (global ids); the
    energy's per-graph sums are psum-ed, so every position holds it."""
    n = species.shape[0]
    n_all = yield Rows(species)
    c, lm = cfg.d_hidden, cfg.l_max
    edge_src, edge_dst = edge_src.long(), edge_dst.long()
    x = _embed(params, species, n, c, lm, positions.dtype)

    r, unit = edge_geometry((yield Gather(positions)), edge_src, edge_dst)
    y_edge = sph_harm(lm, unit)  # (E, S)
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff)
    cg_terms = _cg_edge_terms(cfg, y_edge)

    for i in range(cfg.n_layers):
        p = params[f"layer{i}"]
        xm = _per_l(x, p["self"], lm)  # self-interaction pre-mix
        msg = _tensor_product_messages(p, cfg, (yield Gather(xm)), edge_src,
                                       y_edge, cg_terms, rbf)
        agg = yield ScatterSum(msg, edge_dst, n_all)
        agg = _per_l(agg, p["post"], lm)
        x = x + _gate(p, cfg, agg)

    e_atom = nn.mlp(params["readout"], x[..., 0])[:, 0]  # (N,)
    return (yield Psum(segment_sum(e_atom, graph_id, n_graphs), "energy"))


@lockstep.body
def nequip_energy_forces(params, cfg, species, positions, edge_src,
                         edge_dst, graph_id, n_graphs):
    """``(energies, forces)``, forces ``-∂ΣE/∂positions``.

    ``positions`` is taken as a fresh leaf that requires grad.  Where
    grad mode is on at the call (a train step), the forces keep their
    graph (``create_graph=True``), so a loss on them differentiates twice
    and reaches the parameters; the positions themselves get no gradient.
    On a mesh the energy is replicated and each position's copy is
    seeded with one (:class:`~repro_torch.models.lockstep.Grad`): the
    energy counts once, and each position gets its own atoms' forces.
    """
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        e = yield from nequip_energy.steps(params, cfg, species, pos,
                                           edge_src, edge_dst, graph_id,
                                           n_graphs)
        (grad,) = yield Grad(e.sum(), (pos,), keep)
    if not keep:
        e = e.detach()
    return e, -grad
